"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM; VQ image tokens
share the 65536 vocab; qk-norm. Modality frontend = stub (VQ tokens or
precomputed patch embeddings). A copy of the JAX package's config,
field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22016, vocab_size=65536,
    activation="swiglu", rope_theta=1e4, qk_norm=True,
    frontend="vision", train_microbatches=4,
)

SMOKE = dataclasses.replace(
    CONFIG, train_microbatches=1, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256)
