"""Gemma-7B [arXiv:2403.08295; hf]: dense, GeGLU, head_dim=256,
tied embeddings, sqrt(d) embed scale. A copy of the JAX package's
config, field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    head_dim=256, d_ff=24576, vocab_size=256000,
    activation="geglu", rope_theta=1e4,
    tie_embeddings=True, scale_embed=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=128, vocab_size=256)
