"""DeepSeek-Coder-33B [arXiv:2401.14196; hf]: llama-arch, GQA kv=8. A
copy of the JAX package's config, field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=19200, vocab_size=32256,
    activation="swiglu", rope_theta=1e5,
    train_microbatches=4,
)

SMOKE = dataclasses.replace(
    CONFIG, train_microbatches=1, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=160, vocab_size=256)
