"""Plain PyTorch versions of the port's kernels.

The CPU path of `kernels.ops` runs these, and `chip_smoke.py` holds each
CUDA kernel against them on the card (`force="ref"`). They repeat the
kernels' arithmetic op for op, so on the same inputs the results are
equal bit for bit; they are no yardstick of speed.

* `contention_ref` is the counterpart of `repro.kernels.ref.contention_ref`
  with a leading batch axis.
* `tick_walk_ref` is the sequential part of the coordinator tick that
  XLA ran as `while_loop`s in `repro.core.jax_coordinator.tick_core`:
  the all-or-none MADD admission and the work-conservation fill. It is
  a Python loop over the compacted priority list (vectorized across the
  batch lanes), reading the loop bounds on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BIG = 1e30   # the MADD "port not used" sentinel (f32-representable)


def contention_ref(a_send: torch.Tensor, a_recv: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
    """(B, C, P) {0,1} incidence x2 + (B, C) active -> (B, C) int32:
    for each active coflow, the number of OTHER active coflows sharing at
    least one sender or receiver port with it; 0 when inactive."""
    act = active.to(torch.float32).unsqueeze(-1)
    a_s = a_send.to(torch.float32) * act
    a_r = a_recv.to(torch.float32) * act
    share = a_s @ a_s.transpose(-1, -2) + a_r @ a_r.transpose(-1, -2)
    blocks = share > 0.5
    k = blocks.sum(-1) - torch.diagonal(blocks, dim1=-2, dim2=-1).long()
    return torch.where(active, k, 0).to(torch.int32)


class WalkFlows(NamedTuple):
    """Per-flow inputs of the flow-granular work-conservation fill.
    Flows are stored contiguous per coflow: every flow f with cid[f] = c
    lies in [flow_lo[c], flow_hi[c]) (the `traces.batch` layout)."""
    cid: torch.Tensor      # (B, F) int64 owning coflow
    src: torch.Tensor      # (B, F) int64 sender port
    dst: torch.Tensor      # (B, F) int64 receiver port
    live: torch.Tensor     # (B, F) bool
    flow_lo: torch.Tensor  # (B, C) int64 segment start
    flow_hi: torch.Tensor  # (B, C) int64 segment end


def _madd(avail, inv, bigm, rows, c):
    """Each lane's MADD equal rate for coflow c: min over the 2P
    columns of avail * (1 / cnt) (+ BIG where the coflow has no flow)."""
    return (avail * inv[rows, c] + bigm[rows, c]).amin(-1)


def tick_walk_ref(order: torch.Tensor, n_live: torch.Tensor,
                  cnt: torch.Tensor, avail0: torch.Tensor,
                  min_rate: torch.Tensor, wc: torch.Tensor,
                  flows: Optional[WalkFlows] = None):
    """The coordinator's sequential walks, lane by lane in lock step.

    order (B, C) int64 priority permutation whose first n_live[b] entries
    are the coflows with live ports; cnt (B, C, 2P) f32 live-flow counts
    [senders | receivers]; avail0 (B, 2P) f32 port capacities; min_rate
    (B,) f32 admission floor; wc (B,) f32 work-conservation gate (> 0 =
    on). Returns (rate, admitted, wc_rate, wc_flow): with `flows` the
    per-flow greedy fill (`wc_rate` all zero, as in the reference),
    without it the coflow-granular fill (`wc_flow` None).
    """
    B, C, P2 = cnt.shape
    dev = cnt.device
    rows = torch.arange(B, device=dev)
    has = cnt > 0
    inv = torch.where(has, 1.0 / cnt.clamp(min=1e-9), 0.0)
    bigm = torch.where(has, 0.0, BIG)
    n_live = n_live.long()
    avail = avail0.clone()
    rate = torch.zeros(B, C, dtype=torch.float32, device=dev)
    admitted = torch.zeros(B, C, dtype=torch.bool, device=dev)

    # D1/D2 all-or-none admission with MADD equal rates
    # (jax_coordinator.py:311-322)
    for k in range(int(n_live.max()) if B else 0):
        on = k < n_live
        c = order[:, k]
        r = _madd(avail, inv, bigm, rows, c)
        ok = on & (r >= min_rate) & (r < BIG)
        r = torch.where(ok, r, 0.0)
        avail = avail - r[:, None] * cnt[rows, c]
        rate[rows, c] = torch.where(on, r, rate[rows, c])
        admitted[rows, c] = torch.where(on, ok, admitted[rows, c])

    # D4 work conservation, gated by wc via the trip count
    n_wc = torch.where(wc > 0, n_live, 0)
    wc_rate = torch.zeros(B, C, dtype=torch.float32, device=dev)
    if flows is None:
        # coflow-granular fill (jax_coordinator.py:330-340)
        for j in range(int(n_wc.max()) if B else 0):
            on = j < n_wc
            c = order[:, j]
            r = _madd(avail, inv, bigm, rows, c)
            ok = on & ~admitted[rows, c] & (r > 0) & (r < BIG)
            r = torch.where(ok, r, 0.0)
            avail = avail - r[:, None] * cnt[rows, c]
            wc_rate[rows, c] = torch.where(on, r, wc_rate[rows, c])
        return rate, admitted, wc_rate, None

    # per-flow greedy fill (jax_coordinator.py:387-407): live flows of
    # missed coflows in (coflow priority, flow index) order
    P = P2 // 2
    F = flows.cid.shape[1]
    ar_c = torch.arange(C, device=dev).expand(B, C)
    hp = torch.zeros(B, C, dtype=torch.bool, device=dev).scatter_(
        1, order, ar_c < n_live[:, None])
    invp = torch.empty_like(order).scatter_(1, order, ar_c)
    missed = hp & ~admitted
    cand = flows.live & missed.gather(1, flows.cid) & (wc > 0)[:, None]
    # lexsort((arange(F), invp[cid], ~cand)) as stable sorts, least
    # significant key first
    flist = torch.arange(F, device=dev).expand(B, F)
    for key in (invp.gather(1, flows.cid), (~cand).long()):
        o = torch.sort(key.gather(1, flist), dim=-1, stable=True).indices
        flist = flist.gather(1, o)
    n_cand = cand.sum(-1)
    a_s, a_r = avail[:, :P].clone(), avail[:, P:].clone()
    wc_flow = torch.zeros(B, F, dtype=torch.float32, device=dev)
    for i in range(int(n_cand.max()) if B else 0):
        on = i < n_cand
        f = flist[:, i]
        sp = flows.src[rows, f]
        dq = flows.dst[rows, f]
        r = torch.minimum(a_s[rows, sp], a_r[rows, dq]).clamp(min=0.0)
        r = torch.where(on, r, 0.0)
        a_s[rows, sp] = a_s[rows, sp] - r
        a_r[rows, dq] = a_r[rows, dq] - r
        wc_flow[rows, f] = torch.where(on, r, wc_flow[rows, f])
    return rate, admitted, wc_rate, wc_flow


__all__ = ["BIG", "WalkFlows", "contention_ref", "tick_walk_ref"]
