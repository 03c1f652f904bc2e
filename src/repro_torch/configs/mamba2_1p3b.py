"""Mamba2-1.3B [arXiv:2405.21060]: SSD (state-space duality),
attention-free, d_inner=2d, head_dim=64, ssm_state=128. A copy of the
JAX package's config, field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, d_ff=0, vocab_size=50280,
    rope_theta=0.0,
    ssm_inner=4096, ssm_heads=64, ssm_head_dim=64, ssm_state=128,
    ssm_groups=1, ssm_conv=4,
    subquadratic=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, vocab_size=256,
    ssm_inner=128, ssm_heads=8, ssm_head_dim=16, ssm_state=16)
