"""DeepSeek-V2 236B [arXiv:2405.04434; hf]: MLA (kv_lora=512),
2 shared + 160 routed top-6 experts, first layer dense. A copy of the
JAX package's config, field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=12288, vocab_size=102400,
    activation="swiglu", rope_theta=1e4,
    mla=True, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
    num_experts=160, num_experts_per_tok=6, num_shared_experts=2,
    moe_d_ff=1536, moe_period=1, first_dense_layers=1,
    opt_state_dtype="bfloat16", train_microbatches=16,
)

SMOKE = dataclasses.replace(
    CONFIG, train_microbatches=1, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256, kv_lora_rank=32,
    q_lora_rank=48, rope_head_dim=8, num_experts=8,
    num_experts_per_tok=2, num_shared_experts=1, moe_d_ff=64,
    first_dense_layers=1)
