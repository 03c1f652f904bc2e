"""Mixture-of-Experts FFN of the port (GShard/DeepSeek-style), on one
device.

The counterpart of `repro.models.moe` (`moe_init`, `_pack`, `moe_apply`)
without a mesh: top-k routing, a static-capacity pack of the (token,
choice) pairs into an (E * cap, d) buffer, the per-expert GLU FFN as
three batched products, the weighted combine, and the shared experts.
On one device the reference's all_to_all over the expert axis is the
identity (`moe.py:97-101`); its mesh path (`_sharded_moe_body`) comes
with the sharded pool (ROADMAP queue A item 8).

Each step follows the reference's rounding and order:
* router logits in x's dtype, then an f32 softmax;
* top-k by a stable descending sort, so that among equal probabilities
  the lower expert index comes first, as `jax.lax.top_k` orders them
  (`torch.topk` promises no order); the k weights normalised by
  max(sum, 1e-9) in f32, then cast to x's dtype;
* capacity cap = max(4, ceil(T k capacity_factor / E)) from the call's
  own token count T = B S;
* each pair's rank within its expert from a cumulative one-hot count
  over the pairs in row-major (token, choice) order; pairs at rank >=
  cap are dropped (their weight is 0, their token not packed);
* the combine adds each token's k weighted contributions one choice at
  a time in x's dtype: the reference's scatter-add in pair order, with
  no atomics (`index_add_` on CUDA adds in no fixed order).

Plain tensor code: the reference has no kernel here, and its products
are XLA's matmuls.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models.common import (ParamInit, activation,
                                       glu_activation, glu_ffn)


def moe_init(init: ParamInit, cfg) -> dict:
    """One layer's MoE weights in the reference's names and shapes
    (without its leading layer axis): router (d, E), wi_gate and wi_up
    (E, d, f), wo (E, f, d); with shared experts also shared_gate and
    shared_up (d, fs) and shared_down (fs, d), fs = f x the shared
    count."""
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": init.dense((d, E), fan_in=d),
         "wi_gate": init.dense((E, d, f), fan_in=d),
         "wi_up": init.dense((E, d, f), fan_in=d),
         "wo": init.dense((E, f, d), fan_in=f)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_gate"] = init.dense((d, fs), fan_in=d)
        p["shared_up"] = init.dense((d, fs), fan_in=d)
        p["shared_down"] = init.dense((fs, d), fan_in=fs)
    return p


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k routing of tokens x (T, d): (weights (T, k) in x's dtype,
    expert ids (T, k) int64), the k highest softmax probabilities in
    descending order, lower expert first among equals."""
    probs = torch.softmax((x @ router).to(torch.float32), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w.to(x.dtype), top_e


def capacity(T: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert for T tokens (the reference's `cap`)."""
    return int(max(4, math.ceil(T * k * capacity_factor / E)))


def pack(pair_expert: torch.Tensor, E: int, cap: int):
    """(T k,) expert ids in (token, choice) order -> (slot (T k,) into an
    (E cap) buffer, keep (T k,) bool): a pair's rank is the count of
    earlier pairs with its expert; pairs at rank >= cap are dropped
    (their slot is clamped to the expert's last, as the reference's
    `_pack` does)."""
    onehot = torch.nn.functional.one_hot(pair_expert, E)
    rank = onehot.cumsum(0).gather(1, pair_expert[:, None])[:, 0] - 1
    keep = rank < cap
    return pair_expert * cap + torch.clamp(rank, max=cap - 1), keep


def moe_apply(cfg, w, x: torch.Tensor, *,
              capacity_factor: Optional[float] = None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) through one layer's MoE weights `w` (the
    names of `moe_init`). `capacity_factor` defaults to the config's.
    Dropped pairs are packed into a spare last row of the buffer, which
    no expert reads, so that the pack needs no host sync."""
    capacity_factor = (capacity_factor if capacity_factor is not None
                       else cfg.moe_capacity_factor)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    act = activation(glu_activation(cfg))
    xt = x.reshape(B * S, d)
    T = xt.shape[0]
    top_w, top_e = route(xt, w["router"], k)
    cap = capacity(T, k, E, capacity_factor)
    slot, keep = pack(top_e.reshape(-1), E, cap)
    ptok = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = xt.new_zeros(E * cap + 1, d)
    buf[torch.where(keep, slot, E * cap)] = xt[ptok]
    h = buf[:E * cap].view(E, cap, d)
    g = torch.bmm(h, w["wi_gate"])
    u = torch.bmm(h, w["wi_up"])
    o = torch.bmm(act(g) * u, w["wo"]).view(E * cap, d)
    slot = slot.view(T, k)
    wgt = torch.where(keep, top_w.reshape(-1), top_w.new_zeros(())).view(
        T, k)
    out = torch.zeros_like(xt)
    for j in range(k):
        out = out + o[slot[:, j]] * wgt[:, j, None]
    out = out.view(B, S, d)
    if cfg.num_shared_experts:
        out = out + glu_ffn(x, w["shared_gate"], w["shared_up"],
                            w["shared_down"], glu_activation(cfg))
    return out


class MoEFFN(nn.Module):
    """The MoE FFN (`moe_apply`) over fixed weights in the compute
    dtype; `weights` maps the names of `moe_init` to tensors."""

    def __init__(self, cfg, weights: dict):
        super().__init__()
        self.cfg = cfg
        for name, t in weights.items():
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_apply(self.cfg, dict(self.named_parameters()), x)


__all__ = ["MoEFFN", "capacity", "moe_apply", "moe_init", "pack", "route"]
