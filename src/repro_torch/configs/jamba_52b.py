"""Jamba-v0.1 52B [arXiv:2403.19887; hf]: hybrid Mamba+attention 1:7
interleave, MoE 16 experts top-2 every other layer. A copy of the
JAX package's config, field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=65536,
    activation="swiglu", rope_theta=0.0,   # Jamba: no positional encoding
    num_experts=16, num_experts_per_tok=2, moe_d_ff=14336,
    moe_period=2, moe_offset=1,
    ssm_inner=8192, ssm_heads=128, ssm_head_dim=64, ssm_state=16,
    ssm_groups=1, ssm_conv=4,
    attn_period=8, attn_offset=3,
    subquadratic=True, opt_state_dtype="bfloat16", train_microbatches=8,
)

SMOKE = dataclasses.replace(
    CONFIG, train_microbatches=1, num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256, num_experts=4,
    num_experts_per_tok=2, moe_d_ff=128,
    ssm_inner=128, ssm_heads=8, ssm_head_dim=16, ssm_state=16,
    attn_period=8, attn_offset=3)
