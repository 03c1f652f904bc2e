"""DeepSeek-7B [arXiv:2401.02954; hf]: llama-arch, MHA (kv=32). A copy
of the JAX package's config, field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    head_dim=128, d_ff=11008, vocab_size=102400,
    activation="swiglu", rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256)
