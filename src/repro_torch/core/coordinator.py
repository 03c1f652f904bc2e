"""The Saath coordinator tick (paper Fig. 7) on batched torch tensors.

The port of `repro.core.jax_coordinator`: one tick is Eq. 1 per-flow
queue thresholds, the §4.3 re-queue, FIFO starvation deadlines, LCoF
ordering, all-or-none MADD admission and work conservation. Where the
JAX package `vmap`s a single-trace tick, every tensor here carries an
explicit leading lane axis B, and every reduction the tick makes over a
trace is a per-lane reduction over the last dimension.

Three kernels of `kernels.ops` run inside: the LCoF contention count
(CUDA kernel K1 on the card; the Pallas kernel in the reference), the
admission + work-conservation walk (K2; XLA `while_loop`s in the
reference) and, under a leaf-spine fabric with `wc_fill="maxmin"`, the
max-min fair fill (K3; the Pallas kernel `maxmin_pallas` in the
reference). Everything else is plain PyTorch in f32, in the reference's
operation order, so that a CPU run agrees with the JAX package to the
last bit wherever the reference's arithmetic is order-independent.

The big switch and the leaf-spine fabric (`cnt_x`/`bw_x` link inputs,
both work-conservation fills) are ported, clairvoyant only: pilot
sampling (`s_mixed`/`s_m`) is a later slice (ROADMAP queue A item 6).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.queues import CROSS_EPS
from repro_torch.kernels import ops
from repro_torch.kernels.ref import WalkFlows

F32 = torch.float32


class CoordParams(NamedTuple):
    """Static coordinator parameters (see core.params.SchedulerParams)."""
    thresholds: tuple          # (K,) Q_q^hi, last = +inf
    deadline_factor: float = 2.0
    min_rate_frac: float = 1e-3
    bw_ref: float = 1.0        # reference port bandwidth for t_min
    growth: float = 0.0        # E; 0 = infer from thresholds
    work_conservation: bool = True   # D4 leftover-bandwidth fill
    dynamics_requeue: bool = True    # §4.3 median-based re-queue
    lcof: bool = True                # LCoF contention ordering (Fig. 10)
    per_flow_threshold: bool = True  # Eq. 1 vs Aalo total-bytes queues
    clairvoyant: bool = True         # False = pilot sampling (not ported)

    @staticmethod
    def from_params(p) -> "CoordParams":
        return CoordParams(
            tuple(p.thresholds()), p.deadline_factor,
            p.min_rate_frac, p.port_bw, p.growth,
            work_conservation=p.work_conservation,
            dynamics_requeue=p.dynamics_requeue,
            clairvoyant=p.clairvoyant)


def _queue_spans(thresholds, growth: float = 0.0) -> list:
    """Per-queue residence spans (core.queues.min_queue_residence in the
    reference): span_q = Q_q^hi - Q_q^lo; the unbounded last queue uses
    one growth step beyond its lower bound."""
    K = len(thresholds)
    los = (0.0,) + tuple(thresholds[:-1])
    if not growth:
        growth = (thresholds[1] / thresholds[0]) if K > 2 else 2.0
    spans = [h - l for h, l in zip(thresholds, los)]
    spans[K - 1] = (los[K - 1] * growth - los[K - 1]) if K > 1 \
        else thresholds[0]
    return spans


class DynCoordParams(NamedTuple):
    """Coordinator parameters as f32 tensors. `from_cp` builds one
    unbatched setting ((K,) and () leaves); the tick takes them with a
    leading lane axis ((B, K) and (B,)), see `lanes`."""
    thresholds: torch.Tensor       # (K,) last = +inf
    span: torch.Tensor             # (K,) queue residence spans
    deadline_factor: torch.Tensor  # ()
    min_rate_frac: torch.Tensor    # ()
    bw_ref: torch.Tensor           # ()
    wc: torch.Tensor               # () 1 = work conservation on
    requeue: torch.Tensor          # () 1 = §4.3 dynamics re-queue on
    lcof: torch.Tensor             # () 1 = LCoF ordering (0 = FIFO-in-q)
    per_flow: torch.Tensor         # () 1 = Eq. 1 per-flow thresholds

    @staticmethod
    def from_cp(cp: CoordParams, device="cpu") -> "DynCoordParams":
        if not cp.clairvoyant and cp.dynamics_requeue:
            raise NotImplementedError(
                "non-clairvoyant (pilot-sampling) re-queue is not ported "
                "yet: ROADMAP queue A item 6")

        def t(x):
            return torch.tensor(x, dtype=F32, device=device)

        return DynCoordParams(
            t(list(cp.thresholds)),
            t(_queue_spans(cp.thresholds, cp.growth)),
            t(cp.deadline_factor), t(cp.min_rate_frac), t(cp.bw_ref),
            t(1.0 if cp.work_conservation else 0.0),
            t(1.0 if cp.dynamics_requeue else 0.0),
            t(1.0 if cp.lcof else 0.0),
            t(1.0 if cp.per_flow_threshold else 0.0))

    def lanes(self, B: int) -> "DynCoordParams":
        """The same parameters with a leading lane axis of size B (leaves
        that already carry one are kept)."""
        return DynCoordParams(*(
            x.expand(B, *x.shape) if x.dim() == (1 if i < 2 else 0) else x
            for i, x in enumerate(self)))


class CoordState(NamedTuple):
    queue: torch.Tensor     # (B, C) int64, -1 = unseen
    deadline: torch.Tensor  # (B, C) f32
    running: torch.Tensor   # (B, C) bool — admitted in the previous tick


def init_state(B: int, C: int, device="cpu") -> CoordState:
    return CoordState(
        torch.full((B, C), -1, dtype=torch.int64, device=device),
        torch.full((B, C), float("inf"), dtype=F32, device=device),
        torch.zeros((B, C), dtype=torch.bool, device=device))


class CoflowBatch(NamedTuple):
    """One coordinator tick's view of the fabric (padded to C, P)."""
    active: torch.Tensor   # (B, C) bool
    arrival: torch.Tensor  # (B, C) int64 arrival RANK (exact FIFO order)
    m: torch.Tensor        # (B, C) f32 max bytes sent by any flow (Eq. 1)
    width: torch.Tensor    # (B, C) int64 flow count N_c
    cnt_s: torch.Tensor    # (B, C, P) f32 live-flow counts, sender ports
    cnt_r: torch.Tensor    # (B, C, P) f32 live-flow counts, receivers
    bw_s: torch.Tensor     # (B, P) f32
    bw_r: torch.Tensor     # (B, P) f32
    # optional refinements (None = mechanism not compiled in):
    total: Optional[torch.Tensor] = None  # (B, C) f32 total bytes sent
    #                     (Aalo queues for the per_flow_threshold=0 ablation)
    mixed: Optional[torch.Tensor] = None  # (B, C) bool both finished and
    #                     live flows (§4.3 re-queue candidates)
    m_dyn: Optional[torch.Tensor] = None  # (B, C) f32 estimated remaining
    #                     length from the finished-flow median
    # leaf-spine fabric (None = big switch): per-(coflow, link) live
    # counts and link capacities, uplinks before downlinks (2Lf columns)
    cnt_x: Optional[torch.Tensor] = None  # (B, C, 2Lf) f32
    bw_x: Optional[torch.Tensor] = None   # (B, 2Lf) f32


# Per-flow companion of CoflowBatch for flow-granular work conservation
# (cid, src, dst, live, flow_lo, flow_hi, and on a leaf-spine fabric the
# up/dn leaf ids with the sentinel Lf): flows are stored contiguous per
# coflow, so a flow's priority inside the missed list is (coflow
# priority, flow index) — the kernel walks the [flow_lo, flow_hi)
# segments in coflow priority order.
FlowView = WalkFlows


def _queue_of(value: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """Smallest q with value < Q_q^hi per lane (th (B, K) sorted, last
    +inf), with core.queues.CROSS_EPS so that landings exactly on a
    threshold decide as in the f64 reference."""
    return torch.searchsorted(th.contiguous(),
                              (value * (1.0 + CROSS_EPS)).contiguous(),
                              right=True)


def _lexsort(keys, C: int, B: int, device) -> torch.Tensor:
    """jnp.lexsort over the last axis with the LAST key primary, as a
    chain of stable sorts from arange(C) up to the primary key."""
    idx = torch.arange(C, device=device).expand(B, C)
    for key in keys:
        o = torch.sort(key.gather(1, idx), dim=-1, stable=True).indices
        idx = idx.gather(1, o)
    return idx


def schedule_tick(state: CoordState, batch: CoflowBatch, now, *,
                  cp: CoordParams, flows: Optional[FlowView] = None,
                  wc_fill: str = "greedy", force: Optional[str] = None):
    """One Fig. 7 coordinator tick under static parameters (every lane
    the same setting). Returns (new_state, out)."""
    B = batch.active.shape[0]
    dev = batch.active.device
    now = torch.as_tensor(now, dtype=F32, device=dev).expand(B)
    return tick_core(state, batch, now,
                     DynCoordParams.from_cp(cp, dev).lanes(B),
                     flows=flows, wc_fill=wc_fill, force=force)


def tick_core(state: CoordState, batch: CoflowBatch, now: torch.Tensor,
              dp: DynCoordParams, *, flows: Optional[FlowView] = None,
              wc_fill: str = "greedy", force: Optional[str] = None):
    """The Fig. 7 tick with tensor parameters: `now` (B,) f32, `dp` with
    a leading lane axis. Returns (new_state, out) with per-coflow MADD
    rates, admission mask, queue, contention, expiry, priority order and
    the work-conservation rates (per flow when `flows` is given: the
    greedy walk, or with `wc_fill="maxmin"` the max-min fair fill)."""
    if wc_fill not in ("greedy", "maxmin"):
        raise ValueError(f"unknown wc_fill {wc_fill!r}")
    th = dp.thresholds
    B, C, P = batch.cnt_s.shape
    dev = batch.cnt_s.device
    act = batch.active
    widthf = batch.width.to(F32)

    # D3: per-flow thresholds (Eq. 1); the Fig. 10 A/N ablation
    # (per_flow=0) uses Aalo total-bytes queues
    qval = batch.m * widthf
    if batch.total is not None:
        qval = torch.where((dp.per_flow > 0)[:, None], qval, batch.total)
    q = _queue_of(qval, th)
    # §4.3 cluster dynamics: re-queue by the estimated remaining length
    if batch.mixed is not None:
        q_dyn = _queue_of(batch.m_dyn * widthf, th)
        use_dyn = (dp.requeue > 0)[:, None] & batch.mixed & act
        q = torch.where(use_dyn, q_dyn, q)
    q = torch.where(act, q, state.queue.clamp(min=0))

    # D5: FIFO-derived deadlines, refreshed on queue entry
    entered = act & (q != state.queue)
    K = th.shape[-1]
    cq = torch.zeros((B, K), dtype=F32, device=dev).scatter_add_(
        1, q, act.to(F32))
    t_min = dp.span.gather(1, q) / (batch.width.clamp(min=1)
                                    * dp.bw_ref[:, None])
    deadline = torch.where(
        entered,
        now[:, None] + dp.deadline_factor[:, None]
        * cq.gather(1, q).clamp(min=1.0) * t_min,
        state.deadline)
    expired = act & (now[:, None] >= deadline)

    # LCoF contention (CUDA kernel on the card)
    pos_s, pos_r = batch.cnt_s > 0, batch.cnt_r > 0
    k = ops.contention(pos_s, pos_r, act, force=force)

    # order: expired first (by deadline), then (queue, k, stability,
    # arrival); coflows with no live ports and inactive coflows last, so
    # the order's first n_live entries are the admission list. The
    # arrival rank stays a live key for expired coflows too, so exact
    # deadline ties break by a layout-independent order.
    hp = act & (pos_s.any(-1) | pos_r.any(-1))
    not_running = (~state.running).to(torch.int64)
    primary = torch.where(~hp, 2, torch.where(expired, 0, 1))
    dl_key = torch.where(expired & hp, deadline, 0.0)
    lc = (dp.lcof > 0)[:, None]
    key_q = torch.where(expired, 0, q)
    key_k = torch.where(expired | ~lc, 0, k)
    key_st = torch.where(expired | ~lc, 0, not_running)
    perm = _lexsort((batch.arrival, key_st, key_k, key_q, dl_key, primary),
                    C, B, dev)

    # D1/D2 all-or-none MADD admission and D4 work conservation, walked
    # in `perm` order (CUDA kernel on the card). On a leaf-spine fabric
    # the MADD min also runs over the coflow's uplink/downlink counts:
    # the same arithmetic over W = 2P + 2Lf columns.
    min_rate = dp.min_rate_frac * dp.bw_ref
    cnt = [batch.cnt_s, batch.cnt_r]
    avail0 = [batch.bw_s, batch.bw_r]
    Lf = 0
    if batch.cnt_x is not None:
        cnt.append(batch.cnt_x)
        avail0.append(batch.bw_x)
        Lf = batch.cnt_x.shape[-1] // 2
    cnt = torch.cat(cnt, dim=-1)                             # (B, C, W)
    avail0 = torch.cat(avail0, dim=-1)                       # (B, W)
    n_live = hp.sum(-1)
    maxmin = flows is not None and wc_fill == "maxmin"
    rate, admitted, wc_rate, wc_flow, avail = ops.tick_walk(
        perm, n_live, cnt, avail0, min_rate, dp.wc,
        None if maxmin else flows, num_links=Lf, admit_only=maxmin,
        force=force)
    if maxmin:
        # max-min fair water-filling over the leftover flows (jax_
        # coordinator.py:359-385; CUDA kernel on the card): the live
        # flows of missed coflows, gated by dp.wc, on the capacity the
        # admission left, ports and links alike
        missed = hp & ~admitted
        cand = flows.live & missed.gather(1, flows.cid) \
            & (dp.wc > 0)[:, None]
        wc_flow = ops.maxmin_rates(flows.src, flows.dst, cand, avail,
                                   up=flows.up, dn=flows.dn, num_links=Lf,
                                   force=force)
        wc_flow = torch.where(cand, wc_flow, 0.0)

    new_state = CoordState(queue=torch.where(act, q, state.queue),
                           deadline=deadline, running=admitted)
    out = {"rate": rate, "wc_rate": wc_rate, "wc_flow": wc_flow,
           "admitted": admitted, "queue": q, "contention": k,
           "expired": expired, "order": perm}
    return new_state, out


__all__ = ["CoordParams", "DynCoordParams", "CoordState", "CoflowBatch",
           "FlowView", "init_state", "schedule_tick", "tick_core"]
