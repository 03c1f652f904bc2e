"""StarCoder2-3B [arXiv:2402.19173; hf]: dense, GQA kv=2, RoPE,
plain-GELU FFN. A copy of the JAX package's config, field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    head_dim=128, d_ff=12288, vocab_size=49152,
    activation="gelu", rope_theta=1e5,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256)
