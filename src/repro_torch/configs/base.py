"""Model configuration schema and registry of the port.

`ModelConfig` is a field-for-field copy of the JAX package's
`repro.configs.base.ModelConfig` with its derived properties (plain
data; the port keeps its own copy and imports nothing of `repro`). The
registry holds the reference's ten architectures, each config module a
copy of the reference's.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | ssm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    activation: str = "swiglu"   # swiglu | geglu
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    qk_norm: bool = False
    scale_embed: bool = False    # gemma-style sqrt(d) input scaling
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_period: int = 1          # MoE FFN every `period` layers
    moe_offset: int = 0
    first_dense_layers: int = 0
    moe_capacity_factor: float = 1.25
    # --- MLA (deepseek-v2) ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    # --- SSM (mamba2 / jamba) ---
    ssm_inner: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_state: int = 128
    ssm_groups: int = 1
    ssm_conv: int = 4
    attn_period: int = 0         # hybrid: attention every `attn_period`
    attn_offset: int = 0         # ... layers, at index `attn_offset`
    # --- enc-dec (seamless) ---
    enc_dec: bool = False
    enc_layers: int = 0
    # --- modality frontend stub ---
    frontend: Optional[str] = None   # 'audio' | 'vision' | None
    # --- numerics / training ---
    dtype: str = "bfloat16"
    remat: str = "full"          # full | dots | dots_no_batch | none
    train_microbatches: int = 1  # gradient-accumulation splits per step
    optimizer: str = "adamw"     # adamw | adafactor
    opt_state_dtype: str = "float32"
    # long-context applicability (assignment rules)
    subquadratic: bool = False

    # ---- derived ----
    @property
    def is_attn_layer(self):
        """layer index -> True if attention (vs mamba) mixer."""
        if self.attn_period == 0:
            return lambda l: self.ssm_inner == 0
        return lambda l: (l % self.attn_period) == self.attn_offset

    @property
    def is_moe_layer(self):
        if self.num_experts == 0:
            return lambda l: False
        return lambda l: (l >= self.first_dense_layers
                          and (l % self.moe_period) == self.moe_offset)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        layers = self.enc_layers + L if self.enc_dec else L
        for l in range(layers):
            dec_layer = (not self.enc_dec) or l >= self.enc_layers
            if self.is_attn_layer(l if not self.enc_dec else
                                  max(l - self.enc_layers, 0)):
                if self.mla:
                    n += d * self.q_lora_rank
                    n += self.q_lora_rank * self.num_heads * (
                        self.head_dim + self.rope_head_dim)
                    n += d * (self.kv_lora_rank + self.rope_head_dim)
                    n += 2 * self.kv_lora_rank * self.num_heads * \
                        self.head_dim
                    n += self.num_heads * self.head_dim * d
                else:
                    n += d * self.num_heads * self.head_dim * 2
                    n += d * self.num_kv_heads * self.head_dim * 2
                if self.enc_dec and dec_layer:  # cross attention
                    n += d * self.num_heads * self.head_dim * 2
                    n += d * self.num_kv_heads * self.head_dim * 2
            else:
                n += self.d_model * (2 * self.ssm_inner + 2 *
                                     self.ssm_groups * self.ssm_state
                                     + self.ssm_heads)
                n += self.ssm_inner * d
            mats = 3 if self.activation in ("swiglu", "geglu") else 2
            if self.is_moe_layer(l):
                n += d * self.num_experts  # router
                n += self.num_experts * 3 * d * self.moe_d_ff
                n += self.num_shared_experts * 3 * d * self.moe_d_ff
            elif self.d_ff:
                n += mats * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        layers = range(self.num_layers)
        inactive = 0
        for l in layers:
            if self.is_moe_layer(l):
                inactive += (self.num_experts - self.num_experts_per_tok) \
                    * 3 * self.d_model * self.moe_d_ff
        return full - inactive


# --arch id -> config module: every architecture of the reference
ARCH_IDS = {
    "mamba2-1.3b": "mamba2_1p3b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma-7b": "gemma_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "deepseek-7b": "deepseek_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "chameleon-34b": "chameleon_34b",
    "jamba-v0.1-52b": "jamba_52b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def _module(arch: str):
    """The config module of `arch` (an --arch id or a module name)."""
    if arch in ARCH_IDS or arch in ARCH_IDS.values():
        return importlib.import_module(
            f"repro_torch.configs.{ARCH_IDS.get(arch, arch)}")
    raise ValueError(f"unknown arch {arch!r}; available: "
                     f"{sorted(ARCH_IDS)}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
