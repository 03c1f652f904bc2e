"""GQA attention mixer of the port (+RoPE, optional qk-norm).

The counterpart of the GQA block of `repro.models.attention`
(`gqa_init`, `gqa_apply`, `decode_attend`). Layout: activations
(B, S, d); q, k, v (B, S, H, Dh), query head h reading KV head
h // (H // Hkv).

Prefill writes k and v into cache rows [0, S) in the cache's dtype and
attends those rows through `kernels.ops.flash_attention` (the CUDA
kernel K5 on the card, `ref.flash_attention_ref` on the CPU); the
reference runs `jnp_flash` there, the oracle of the Pallas kernel that
K5 replaces. The (B, S, H, Dh) tensors go to the kernel as transposed
views, without a copy. Decode writes row kv_len and attends the first
kv_len + 1 rows through `decode_attend`, plain tensor code (the
reference has no kernel for it either).

Unlike the reference, which returns a new cache, the cache is updated in
place: a full-width StarCoder2-3B cache for 4 requests of 2064 tokens
is 254 MB, and a copy per decode step would move all of it every token.

Cache layout per layer: {"k", "v": (B, max_len, Hkv, Dh)} in the compute
dtype. MLA (ROADMAP queue A item 11c) and cross attention (item 11f) are
not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import ParamInit, rms_norm, rope


def gqa_init(init: ParamInit, cfg) -> dict:
    """One layer's attention weights in the reference's names and shapes
    (without its leading layer axis): wq (d, H, Dh), wk and wv (d, Hkv,
    Dh), wo (H, Dh, d), and the zero qnorm / knorm (Dh,) under
    `qk_norm`."""
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    p = {"wq": init.dense((d, H, Dh), fan_in=d),
         "wk": init.dense((d, Hkv, Dh), fan_in=d),
         "wv": init.dense((d, Hkv, Dh), fan_in=d),
         "wo": init.dense((H, Dh, d), fan_in=H * Dh)}
    if cfg.qk_norm:
        p["qnorm"] = init.zeros((Dh,))
        p["knorm"] = init.zeros((Dh,))
    return p


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, kv_len: int) -> torch.Tensor:
    """One query token against the first `kv_len` cache rows. q:
    (B, 1, H, D); caches (B, Smax, Hkv, D). q is scaled by D^-1/2 in its
    own dtype, as the reference does, then everything is f32. Returns
    (B, 1, H, D) in q's dtype."""
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    qg = (q * D ** -0.5).reshape(B, Hkv, H // Hkv, D).to(torch.float32)
    k = k_cache[:, :kv_len].to(torch.float32)
    v = v_cache[:, :kv_len].to(torch.float32)
    p = torch.softmax(torch.einsum("bhgd,bthd->bhgt", qg, k), dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p, v)
    return o.reshape(B, 1, H, D).to(q.dtype)


class GQAAttention(nn.Module):
    """The GQA attention layer (`gqa_apply`) over fixed weights in the
    compute dtype; `weights` maps the names of `gqa_init` to
    tensors."""

    def __init__(self, cfg, weights: dict):
        super().__init__()
        self.cfg = cfg
        for name, w in weights.items():
            self.register_parameter(name, nn.Parameter(w,
                                                       requires_grad=False))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[dict] = None, *,
                kv_len: Optional[int] = None,
                force: Optional[str] = None):
        """x: (B, S, d); positions broadcastable to (B, S). Without
        `kv_len` a prefill: k and v fill cache rows [0, S) when `cache`
        is given, and the causal attention runs through
        `ops.flash_attention` (`force` pins its path). With `kv_len` (an
        int) one decode step (S == 1) against `cache`. Returns (out
        (B, S, d), the cache, updated in place, or None)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = (x @ self.wq.flatten(1)).view(B, S, H, Dh)
        k = (x @ self.wk.flatten(1)).view(B, S, Hkv, Dh)
        v = (x @ self.wv.flatten(1)).view(B, S, Hkv, Dh)
        if cfg.qk_norm:
            q = rms_norm(q, self.qnorm)
            k = rms_norm(k, self.knorm)
        if cfg.rope_theta:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)

        if kv_len is not None:
            if cache is None or S != 1:
                raise ValueError("a decode step takes one token and a "
                                 "cache")
            cache["k"][:, kv_len] = k[:, 0]
            cache["v"][:, kv_len] = v[:, 0]
            o = decode_attend(q, cache["k"], cache["v"], kv_len + 1)
        else:
            if cache is not None:
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
                k, v = cache["k"][:, :S], cache["v"][:, :S]
            o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=True,
                                    force=force).transpose(1, 2)
        return o.reshape(B, S, H * Dh) @ self.wo.flatten(0, 1), cache


__all__ = ["GQAAttention", "decode_attend", "gqa_init"]
