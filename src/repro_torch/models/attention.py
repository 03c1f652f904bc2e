"""Attention mixers of the port: GQA (+RoPE, optional qk-norm) and
DeepSeek-V2's MLA.

The counterpart of `repro.models.attention` (`gqa_init`, `gqa_apply`,
`decode_attend`, `mla_init`, `mla_apply`). Layout: activations
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

MLA (`MLAAttention`) caches the compressed latent instead: prefill
decompresses K and V and runs the same kernel at a q.k width of
head_dim + rope_head_dim (192) and a value width of head_dim (128);
decode is the reference's absorbed form against the latent cache, plain
tensor code.

For training (`lm.forward_train_loss`) the prefill call runs under
autograd: `attend` wraps it in `FlashAttention`, an autograd function
whose forward is the same `ops.flash_attention` call (K5 on the card)
and whose backward is `ops.flash_attention_bwd` (K7 on the card, the
plain `ref.flash_attention_bwd_ref` on the CPU; `force="ref"` pins the
plain versions of both). With no input requiring a gradient (serving,
under `inference_mode`) `attend` is the plain call.

Cross attention (an encoder-decoder's decoder layers, SeamlessM4T):
`GQAAttention.cross_kv` projects the encoder output once a prefill into
the layer's "cross_k" and "cross_v" cache (no RoPE, no k-norm), and
`GQAAttention.cross` attends q (q-normed, no RoPE) to all of its rows,
non-causal: through `ops.flash_attention` in a prefill (K5 on the card,
its non-causal branch with S != T), through `decode_attend` in a
decode step. An encoder's self-attention is the same layer's forward
with `causal=False`.

Cache layout per layer: {"k", "v": (B, max_len, Hkv, Dh)} for GQA,
{"ckv": (B, max_len, kv_lora_rank), "krope": (B, max_len,
rope_head_dim)} for MLA, plus {"cross_k", "cross_v": (B, S_src, Hkv,
Dh)} in a decoder layer with cross attention, in the compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import ParamInit, rms_norm, rope


class FlashAttention(torch.autograd.Function):
    """`ops.flash_attention` with its gradient: forward the kernel (K5
    on CUDA), backward `ops.flash_attention_bwd` (K7 on CUDA) from the
    saved q, k, v and o; `force` pins both paths, as in `ops`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int,
                force: Optional[str]):
        o = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                force=force)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.q_offset, ctx.force = causal, q_offset, force
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(
            q, k, v, o, do, causal=ctx.causal, q_offset=ctx.q_offset,
            force=ctx.force)
        return dq, dk, dv, None, None, None


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True,
           force: Optional[str] = None) -> torch.Tensor:
    """Prefill attention from position 0, causal unless `causal` is
    False (the layout of `ops.flash_attention`): through
    `FlashAttention` when autograd records and an input requires a
    gradient, else the plain call."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, 0, force)
    return ops.flash_attention(q, k, v, causal=causal, force=force)


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
                force: Optional[str] = None, causal: bool = True):
        """x: (B, S, d); positions broadcastable to (B, S). Without
        `kv_len` a prefill: k and v fill cache rows [0, S) when `cache`
        is given, and the attention, causal unless `causal` is False
        (an encoder's), runs through `ops.flash_attention` (`force` pins
        its path). With `kv_len` (an int) one decode step (S == 1)
        against `cache`. Returns (out (B, S, d), the cache, updated in
        place, or None)."""
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
            o = attend(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal,
                       force=force).transpose(1, 2)
        return o.reshape(B, S, H * Dh) @ self.wo.flatten(0, 1), cache

    def cross_kv(self, enc_out: torch.Tensor):
        """The cross-attention k and v (B, S_src, Hkv, Dh) of the encoder
        output `enc_out` (B, S_src, d): its projections alone, without
        RoPE or k-norm (the reference's `_fill_cross`)."""
        B, T, _ = enc_out.shape
        shape = (B, T, self.cfg.num_kv_heads, self.cfg.head_dim)
        return ((enc_out @ self.wk.flatten(1)).view(shape),
                (enc_out @ self.wv.flatten(1)).view(shape))

    def cross(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              decode: bool = False,
              force: Optional[str] = None) -> torch.Tensor:
        """Cross attention (`gqa_apply(cross_kv=(k, v))`): q projected
        from x (B, S, d) and q-normed under `qk_norm`, without RoPE,
        attends every row of the encoder's k and v (B, S_src, Hkv, Dh),
        non-causal: through `ops.flash_attention` in a prefill (`force`
        pins its path), through `decode_attend` in a decode step
        (`decode`, S == 1). Returns (B, S, d)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Dh = cfg.num_heads, cfg.head_dim
        q = (x @ self.wq.flatten(1)).view(B, S, H, Dh)
        if cfg.qk_norm:
            q = rms_norm(q, self.qnorm)
        if decode:
            o = decode_attend(q, k, v, k.shape[1])
        else:
            o = attend(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=False,
                       force=force).transpose(1, 2)
        return o.reshape(B, S, H * Dh) @ self.wo.flatten(0, 1)


def mla_init(init: ParamInit, cfg) -> dict:
    """One layer's MLA weights in the reference's names and shapes
    (without its leading layer axis): wq_a (d, r_q), wq_b (r_q, H,
    dn + dr), wkv_a (d, r_kv + dr), wk_b and wv_b (r_kv, H, dn), wo
    (H, dn, d) and the zero kv_norm (r_kv,), with dn = head_dim and
    dr = rope_head_dim."""
    d, H = cfg.d_model, cfg.num_heads
    dn, dr = cfg.head_dim, cfg.rope_head_dim
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    return {"wq_a": init.dense((d, r_q), fan_in=d),
            "wq_b": init.dense((r_q, H, dn + dr), fan_in=r_q),
            "wkv_a": init.dense((d, r_kv + dr), fan_in=d),
            "wk_b": init.dense((r_kv, H, dn), fan_in=r_kv),
            "wv_b": init.dense((r_kv, H, dn), fan_in=r_kv),
            "wo": init.dense((H, dn, d), fan_in=H * dn),
            "kv_norm": init.zeros((r_kv,))}


class MLAAttention(nn.Module):
    """DeepSeek-V2's multi-head latent attention (`mla_apply`) over fixed
    weights in the compute dtype; `weights` maps the names of `mla_init`
    to tensors."""

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
        `kv_len` a prefill: the latent ckv and the rotated k_rope fill
        cache rows [0, S) when `cache` is given; K (no-RoPE part
        decompressed from ckv, k_rope broadcast over the heads) and V
        (decompressed) go with q to `ops.flash_attention`, causal, at
        widths (dn + dr, dn) (`force` pins its path). With `kv_len` (an
        int) one decode step (S == 1) in the absorbed form against the
        first kv_len + 1 cache rows. Returns (out (B, S, d), the cache,
        updated in place, or None)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, dn, dr = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
        r_kv = cfg.kv_lora_rank
        q = ((x @ self.wq_a) @ self.wq_b.flatten(1)).view(B, S, H, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = rope(q_rope, positions, cfg.rope_theta)
        kv_a = x @ self.wkv_a
        ckv = rms_norm(kv_a[..., :r_kv], self.kv_norm)
        k_rope = rope(kv_a[:, :, None, r_kv:], positions,
                      cfg.rope_theta)[:, :, 0]

        if kv_len is not None:
            if cache is None or S != 1:
                raise ValueError("a decode step takes one token and a "
                                 "cache")
            cache["ckv"][:, kv_len] = ckv[:, 0]
            cache["krope"][:, kv_len] = k_rope[:, 0]
            o = self._absorbed(q_nope, q_rope, cache["ckv"][:, :kv_len + 1],
                               cache["krope"][:, :kv_len + 1], x.dtype)
        else:
            if cache is not None:
                cache["ckv"][:, :S] = ckv
                cache["krope"][:, :S] = k_rope
            k_nope = (ckv @ self.wk_b.flatten(1)).view(B, S, H, dn)
            v = (ckv @ self.wv_b.flatten(1)).view(B, S, H, dn)
            k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)],
                          dim=-1)
            qf = torch.cat([q_nope, q_rope], dim=-1)
            o = attend(qf.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), force=force).transpose(1, 2)
        return o.reshape(B, S, H * dn) @ self.wo.flatten(0, 1), cache

    def _absorbed(self, q_nope, q_rope, ckv, krope, dtype):
        """The reference's absorbed decode: q_nope folded through wk_b
        into the latent (in the compute dtype), f32 scores against the
        latent cache plus the RoPE part, scaled by (dn + dr)^-1/2; the
        f32 softmax weights the latent, which wv_b (as f32) decompresses;
        the output in `dtype`. q_*: (B, 1, H, .); ckv, krope: the cache
        rows to attend. Returns (B, 1, H, dn)."""
        f32 = torch.float32
        scale = (self.cfg.head_dim + self.cfg.rope_head_dim) ** -0.5
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, self.wk_b)
        s = torch.einsum("bshr,btr->bhst", q_abs.to(f32), ckv.to(f32))
        s = s + torch.einsum("bshk,btk->bhst", q_rope.to(f32),
                             krope.to(f32))
        p = torch.softmax(s * scale, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", p, ckv.to(f32))
        return torch.einsum("bshr,rhk->bshk", o_lat,
                            self.wv_b.to(f32)).to(dtype)


__all__ = ["FlashAttention", "GQAAttention", "MLAAttention", "attend",
           "decode_attend", "gqa_init", "mla_init"]
