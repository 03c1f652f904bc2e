"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-235B-A22B]: 128 experts top-8,
qk-norm, every layer MoE (no dense FFN). A copy of the
JAX package's config, field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=0, vocab_size=151936,
    activation="swiglu", rope_theta=1e6, qk_norm=True,
    num_experts=128, num_experts_per_tok=8, moe_d_ff=1536,
    moe_period=1, opt_state_dtype="bfloat16", train_microbatches=8,
)

SMOKE = dataclasses.replace(
    CONFIG, train_microbatches=1, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, vocab_size=256, num_experts=8, num_experts_per_tok=2,
    moe_d_ff=64)
