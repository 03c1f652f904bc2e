"""Mamba-2 (SSD) mixer block of the port — attention-free sequence mixing.

The counterpart of `repro.models.mamba`. Prefill runs the chunked SSD
scan through `kernels.ops.ssd_scan` (the CUDA kernel K4 on the card,
`ref.ssd_chunked_ref` on the CPU); decode is the O(1) single-step
recurrence `ssd_decode_step` against the carried (H, Dh, N) state plus a
(k-1)-deep causal-conv window, as plain tensor code (the reference has
no kernel for it either).

For training (`lm.forward_train_loss`) the prefill scan runs under
autograd: `scan` wraps it in `SSDScan`, an autograd function whose
forward is the same `ops.ssd_scan` call (K4 on the card) and whose
backward is `ops.ssd_scan_bwd` (K8 on the card, the plain
`ref.ssd_chunked_bwd_ref` on the CPU; `force="ref"` pins the plain
versions of both). A train call has no cache: no initial state and no
final state is differentiated. With no input requiring a gradient
(serving, under `inference_mode`) `scan` is the plain call.

Cache layout per layer: {"conv": (B, k-1, C_conv) in the compute dtype,
"ssd": (B, H, Dh, N) f32}.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import ParamInit, rms_norm

# the mixer's weights, in the reference's names and (per layer) shapes
PARAM_NAMES = ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
               "norm", "out_proj")
CHUNK = 128   # the SSD scan's chunk length (the reference's lc)


class SSDScan(torch.autograd.Function):
    """`ops.ssd_scan`'s y with its gradient: forward the kernel (K4 on
    CUDA) from a zero state, backward `ops.ssd_scan_bwd` (K8 on CUDA)
    from the saved x, dt, a, b and c; `force` pins both paths, as in
    `ops`."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, lc: int, force: Optional[str]):
        y, _ = ops.ssd_scan(x, dt, a, b, c, lc=lc, force=force)
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.lc, ctx.force = lc, force
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a, b, c = ctx.saved_tensors
        dx, ddt, da, db, dc = ops.ssd_scan_bwd(x, dt, a, b, c, dy,
                                               lc=ctx.lc, force=ctx.force)
        return dx, ddt, da.to(a.dtype), db, dc, None, None


def scan(x, dt, a, b, c, *, init_state=None, lc: int = CHUNK,
         force: Optional[str] = None):
    """The prefill scan (the layout of `ops.ssd_scan`): through `SSDScan`
    when autograd records and an input requires a gradient, returning
    (y, None), else the plain call, returning (y, final state). A
    recorded call takes no initial state (it raises: its gradient would
    be lost)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, b, c)):
        if init_state is not None:
            raise ValueError("a differentiated SSD scan starts from a zero "
                             "state: no init_state")
        return SSDScan.apply(x, dt, a, b, c, lc, force), None
    return ops.ssd_scan(x, dt, a, b, c, init_state=init_state, lc=lc,
                        force=force)


def ssd_decode_step(x, dt, a, b, c, state):
    """One-token recurrence. x: (B, H, Dh); dt: (B, H); a: (H,); b, c:
    (B, G, N); state: (B, H, Dh, N) f32. Returns (y (B, H, Dh) in x's
    dtype, state')."""
    rep = x.shape[1] // b.shape[1]
    bh = b.repeat_interleave(rep, dim=1).to(torch.float32)
    ch = c.repeat_interleave(rep, dim=1).to(torch.float32)
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    decay = torch.exp(dtf * a)[..., None, None]
    state = decay * state + dtf[..., None, None] * (
        xf[..., None] * bh[:, :, None, :])
    y = torch.einsum("bhdn,bhn->bhd", state, ch)
    return y.to(x.dtype), state


def mamba_init(init: ParamInit, cfg) -> dict:
    """One layer's mixer weights, drawn as the reference's `mamba_init`
    scales them (without its leading layer axis)."""
    d, di = cfg.d_model, cfg.ssm_inner
    H, G, N = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    kconv = cfg.ssm_conv
    c_conv = di + 2 * G * N
    proj_out = 2 * di + 2 * G * N + H
    return {
        "in_proj": init.dense((d, proj_out), fan_in=d),
        "conv_w": init.dense((kconv, c_conv), fan_in=kconv),
        "conv_b": init.zeros((c_conv,)),
        "a_log": init.zeros((H,)),
        "dt_bias": init.zeros((H,)),
        "d_skip": init.zeros((H,)),
        "norm": init.zeros((di,)),
        "out_proj": init.dense((di, d), fan_in=di),
    }


class Mamba2Mixer(nn.Module):
    """The Mamba-2 mixer (`mamba_apply`) over fixed weights in the
    compute dtype; `weights` maps `PARAM_NAMES` to tensors."""

    def __init__(self, cfg, weights: dict):
        super().__init__()
        self.cfg = cfg
        for k in PARAM_NAMES:
            self.register_parameter(
                k, nn.Parameter(weights[k], requires_grad=False))

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None, *,
                force: Optional[str] = None):
        """x: (B, S, d). With S == 1 and a cache, one decode step against
        it; otherwise a prefill, which fills a new cache when `cache` is
        given (`force` pins the SSD scan's path, see `ops.ssd_scan`).
        Returns (out (B, S, d), new cache or None)."""
        cfg = self.cfg
        B, S, _ = x.shape
        di, H, Dh = cfg.ssm_inner, cfg.ssm_heads, cfg.ssm_head_dim
        G, N, kconv = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
        c_conv = di + 2 * G * N

        zxbcdt = x @ self.in_proj
        z = zxbcdt[..., :di]
        xbc = zxbcdt[..., di:di + c_conv]
        dt_raw = zxbcdt[..., di + c_conv:]
        a = -torch.exp(self.a_log.to(torch.float32))

        if S == 1 and cache is not None:
            window = torch.cat([cache["conv"], xbc], dim=1)      # (B, k, C)
            xbc_c = (window * self.conv_w[None]).sum(1) + self.conv_b
            xbc_c = F.silu(xbc_c)
            xs = xbc_c[..., :di].reshape(B, H, Dh)
            bs = xbc_c[..., di:di + G * N].reshape(B, G, N)
            cs = xbc_c[..., di + G * N:].reshape(B, G, N)
            dt = F.softplus(dt_raw[:, 0] + self.dt_bias)         # (B, H)
            y, s_new = ssd_decode_step(xs, dt, a, bs, cs, cache["ssd"])
            y = y + self.d_skip[:, None] * xs
            y = rms_norm(y.reshape(B, 1, di), self.norm) * F.silu(z)
            return y @ self.out_proj, {"conv": window[:, 1:], "ssd": s_new}

        # prefill: causal depthwise conv as the reference's padded window sum
        xp = torch.cat([xbc.new_zeros(B, kconv - 1, c_conv), xbc], dim=1)
        conv = xp[:, :S] * self.conv_w[0]
        for i in range(1, kconv):
            conv = conv + xp[:, i:i + S] * self.conv_w[i]
        conv = F.silu(conv + self.conv_b)
        xs = conv[..., :di].reshape(B, S, H, Dh)
        bs = conv[..., di:di + G * N].reshape(B, S, G, N)
        cs = conv[..., di + G * N:].reshape(B, S, G, N)
        dt = F.softplus(dt_raw + self.dt_bias)                   # (B, S, H)
        y, s_fin = scan(xs, dt, a, bs, cs, force=force)
        y = y + self.d_skip[None, None, :, None] * xs
        y = rms_norm(y.reshape(B, S, di), self.norm) * F.silu(z)
        out = y @ self.out_proj
        if cache is None:
            return out, None
        # the last k-1 raw xbc values feed the next decode step's window
        # (a copy, so that the cache does not keep all of xp alive)
        return out, {"conv": xp[:, S:].clone(), "ssd": s_fin}


__all__ = ["Mamba2Mixer", "PARAM_NAMES", "SSDScan", "mamba_init", "scan",
           "ssd_decode_step"]
