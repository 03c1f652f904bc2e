"""Batched fleet replay on torch tensors: the port of the offline part of
`repro.fabric.jax_engine`.

A fleet of B traces replays as one batched computation: every state
tensor carries a leading lane axis (the reference's `vmap` over traces,
written out), and each event step is one call of `_tick` for all lanes.
Semantics are the reference's (DESIGN.md §3): a fixed-step simulation on
the δ grid that jumps from one grid-quantized event (arrival, flow
completion, queue-threshold crossing, starvation deadline) to the next,
integrating the constant rates across the jump and recording completion
instants exactly.

The host drives chunks of `chunk` event steps and reads `all(finished)`
once per chunk, as the reference does; inside a chunk nothing reads the
device (the tick's sequential loops run in the walk kernel). Entry
points run on CUDA unless the caller passes ``device="cpu"``; without a
card and without that, they raise.

The big switch and the leaf-spine fabric (`fabric.topology`, with the
greedy or the max-min work-conservation fill) are ported, with known
(clairvoyant) or pilot-learned coflow sizes: a learned replay packs the
pilot mask (`traces.batch.pack(..., sampling=True)`) and the tick's
fifth structure switch, `with_sampling`, builds the pilot estimate that
the learned §4.3 re-queue reads (DESIGN.md §12).

The online half (reference `jax_engine.py:753-1006`) serves
`repro_torch.api.SaathSession` and `SessionPool`: `_tick` with `n_end`
caps every lane at its own horizon tick and resumes a capped schedule
interval from its stored rates and anchor, `session_advance` steps a
slab to those horizons, `session_plan_tick` runs one planning tick, and
`scatter_rows` / `gather_rows` move single rows of the device slab.
Where the reference loops on the device (`while_loop`), the port loops
on the host: chunks of 1, 2, 4, ... up to `chunk` event steps, with one
read of a one-element "lanes open" flag after each chunk.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import coordinator as co
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric.metrics import nan_row_mean
from repro_torch.fabric.topology import wc_fill_of
from repro_torch.kernels import ops
from repro_torch.traces.batch import TraceBatch, pack, to_device

F32 = torch.float32

# completion slop: a flow whose remaining bytes are within REL_EPS of
# what this tick delivers completes now (f32 cannot resolve finer)
REL_EPS = 1e-5
# max ticks one event jump may skip on live state
MAX_JUMP_TICKS = 1024.0
# an idle lane (no live flows) jumps to its next arrival in one step,
# bounded by the f32-exact tick range
IDLE_JUMP_TICKS = float(1 << 22)
# with the §4.3 re-queue on, the cap mirrors the reference simulator's
# 200δ re-evaluation cadence (the remaining-length estimate drifts
# continuously, so both replays must re-invoke the coordinator alike)
DYNAMICS_JUMP_TICKS = 200.0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another; raises when CUDA is asked for (or defaulted to) and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return dev


class EngineParams(NamedTuple):
    """Tensor scheduler knobs: a DynCoordParams plus the δ grid step.
    Leaves are unbatched for one setting or carry a leading lane axis
    (a sweep); `lanes` broadcasts to B lanes."""
    dp: co.DynCoordParams
    delta: torch.Tensor    # () or (B,) f32 seconds

    @staticmethod
    def from_scheduler(p: SchedulerParams, *,
                       work_conservation: "bool | None" = None,
                       dynamics_requeue: "bool | None" = None,
                       lcof: bool = True,
                       per_flow_threshold: bool = True,
                       clairvoyant: "bool | None" = None,
                       device="cpu") -> "EngineParams":
        cp = co.CoordParams.from_params(p)
        cp = cp._replace(
            work_conservation=(cp.work_conservation
                               if work_conservation is None
                               else work_conservation),
            dynamics_requeue=(cp.dynamics_requeue
                              if dynamics_requeue is None
                              else dynamics_requeue),
            lcof=lcof, per_flow_threshold=per_flow_threshold,
            clairvoyant=(cp.clairvoyant if clairvoyant is None
                         else clairvoyant))
        return EngineParams(co.DynCoordParams.from_cp(cp, device),
                            torch.tensor(p.delta, dtype=F32, device=device))

    def lanes(self, B: int) -> "EngineParams":
        d = self.delta
        return EngineParams(self.dp.lanes(B),
                            d.expand(B) if d.dim() == 0 else d)


class EngineState(NamedTuple):
    """Per-lane replay state (every leaf has a leading lane axis).

    The four trailing leaves exist only in session states (None in an
    offline replay; reference `jax_engine.py:84-111`): the pending event
    horizon of a schedule interval that an advance's `n_end` cap cut, so
    that the next advance resumes the stored rates from the stored
    anchor instead of re-evaluating the boundary tick."""
    coord: co.CoordState
    sent: torch.Tensor      # (B, F) f32 bytes
    done: torch.Tensor      # (B, F) bool
    fct: torch.Tensor       # (B, F) f32 absolute completion time (0 until done)
    finished: torch.Tensor  # (B, C) bool
    cct: torch.Tensor       # (B, C) f32 completion - arrival (nan until done)
    t0: torch.Tensor        # (B,) f32 grid origin (0)
    tick: torch.Tensor      # (B,) int32 next tick index
    rate: Optional[torch.Tensor] = None       # (B, F) f32 pending rates
    pend_sent: Optional[torch.Tensor] = None  # (B, F) f32 sent at the anchor
    pend_tick: Optional[torch.Tensor] = None  # (B,) f32 anchor tick
    pend_next: Optional[torch.Tensor] = None  # (B,) f32 horizon tick (0 = none)


class EngineResult(NamedTuple):
    cct: np.ndarray       # (B, C) nan for unfinished/padded coflows
    fct: np.ndarray       # (B, F) nan for unfinished/padded flows
    sent: np.ndarray      # (B, F) bytes
    finished: np.ndarray  # (B, C) bool (padded coflows report True)
    ticks: int            # max δ-grid ticks simulated across the batch
    events: int           # event steps executed

    @property
    def avg_cct(self) -> np.ndarray:
        """(B,) mean CCT per trace over its real coflows; NaN for a row
        with none finished."""
        return nan_row_mean(self.cct)


def _init_state(tb: TraceBatch) -> EngineState:
    """Batched state init; the δ grid is pinned at t=0 for every lane."""
    B, F = tb.cid.shape
    C = tb.arrival.shape[1]
    dev = tb.cid.device
    return EngineState(
        coord=co.init_state(B, C, dev),
        sent=torch.zeros((B, F), dtype=F32, device=dev),
        done=~tb.flow_valid,
        fct=torch.zeros((B, F), dtype=F32, device=dev),
        finished=~tb.coflow_valid,
        cct=torch.full((B, C), float("nan"), dtype=F32, device=dev),
        t0=torch.zeros((B,), dtype=F32, device=dev),
        tick=torch.zeros((B,), dtype=torch.int32, device=dev))


def _segments(s: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Sums over contiguous index ranges [lo, hi) (any trailing shape of
    lo/hi) from prefix sums `s` (B, F + 1): two boundary gathers."""
    B = s.shape[0]
    flat_hi, flat_lo = hi.reshape(B, -1), lo.reshape(B, -1)
    return (s.gather(1, flat_hi) - s.gather(1, flat_lo)).reshape(hi.shape)


def _segment_sum(data: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Sum `data` (B, F) over contiguous index ranges [lo, hi) via one
    prefix sum (`ops.prefix_sum`, K6 on the card) and two boundary
    gathers. The prefix sums add in the JAX package's scan order, so
    float data rounds as the reference's does on any device; 0/1 counts
    are exact in any order."""
    return _segments(ops.prefix_sum(data), lo, hi)


def _segment_max(data: torch.Tensor, seg: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Max of non-negative `data` (B, F) per coflow id `seg` -> (B, C),
    0 for invalid coflows. A scatter-max is exact in any order; pad
    flows may share a real coflow's id, so their data must be 0."""
    out = torch.zeros(valid.shape, dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(1, seg, data, reduce="amax", include_self=True)
    return torch.where(valid, out, 0.0)


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of trees of one structure (nested tuples and
    NamedTuples, None leaves kept as None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        out = (tree_map(fn, *xs) for xs in zip(tree, *rest))
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def _select(lane: torch.Tensor, new, old):
    """Per-lane `where(lane, new, old)` over every leaf of two state
    trees, `lane` (B,) broadcast to each leaf's rank: an exact bit
    select, NaNs included."""
    return tree_map(lambda a, b: torch.where(
        lane.view(-1, *(1,) * (a.dim() - 1)), a, b), new, old)


def _views(state: EngineState, tb: TraceBatch, now: torch.Tensor,
           eps_t: torch.Tensor, *, per_flow_wc: bool, with_dynamics: bool,
           with_ablations: bool, with_sampling: bool = False,
           active_gate: Optional[torch.Tensor] = None):
    """One tick's coordinator view of every lane: activation, per-(coflow,
    port) live counts, Eq. 1 m_c, on a leaf-spine batch the per-(coflow,
    link) live counts, and (when built in) the §4.3 finished-flow-median
    inputs, the pilot estimate and the ablation's total bytes.
    `active_gate` (B,) (sessions:
    `tick < n_end`, reference `jax_engine.py:199-220`) deactivates whole
    lanes whose step `_tick` discards anyway, so their walks are empty."""
    active = tb.coflow_valid & ~state.finished \
        & (tb.arrival <= (now + eps_t)[:, None])
    if active_gate is not None:
        active = active & active_gate[:, None]
    live = active.gather(1, tb.cid) & ~state.done & tb.flow_valid

    # the step's independent segment sums, each input written into its
    # rows of one buffer and summed by one K6 call (rows are independent,
    # so stacking them moves no bit): the sender and receiver live
    # counts, the ablation's total bytes, the leaf-spine uplink and
    # downlink counts, the live flows per coflow (a re-queue candidate
    # still has one), the learned pilot count and byte sum. Every input
    # is (B, F): the link permutations are packed (B, F) like the ports'
    # (traces/batch.py)
    leaf = tb.bw_up.shape[-1] > 0
    names = ["cnt_s", "cnt_r"]
    if with_ablations:
        names.append("total")
    if leaf:
        names += ["cnt_up", "cnt_dn"]
    if with_dynamics or with_sampling:
        names.append("n_live_c")
    if with_sampling:
        names += ["n_p", "p_sum"]
    B, F = live.shape
    buf = torch.empty((len(names), B, F), dtype=F32, device=live.device)
    rows = dict(zip(names, buf.unbind(0)))
    livef = rows["n_live_c"].copy_(live) if "n_live_c" in rows \
        else live.to(F32)
    for name, perm in (("cnt_s", tb.perm_src), ("cnt_r", tb.perm_dst),
                       ("cnt_up", tb.perm_up), ("cnt_dn", tb.perm_dn)):
        if name in rows:
            torch.gather(livef, 1, perm, out=rows[name])
    if with_ablations:
        torch.mul(state.sent, tb.flow_valid, out=rows["total"])
    if with_sampling:
        if tb.pilot is None:
            raise ValueError("with_sampling needs a TraceBatch packed "
                             "with sampling=True (no pilot mask)")
        pdone = rows["n_p"].copy_(tb.pilot & tb.flow_valid & state.done)
        torch.mul(pdone, tb.size, out=rows["p_sum"])
    sums = dict(zip(names, ops.prefix_sum(buf.view(-1, F)).view(
        len(names), B, F + 1).unbind(0)))

    m = _segment_max(state.sent * tb.flow_valid, tb.cid, tb.coflow_valid)
    cnt_s = _segments(sums["cnt_s"], tb.lo_src, tb.hi_src)
    cnt_r = _segments(sums["cnt_r"], tb.lo_dst, tb.hi_dst)
    total = _segments(sums["total"], tb.flow_lo, tb.flow_hi) \
        if with_ablations else None

    # leaf-spine: per-(coflow, link) live counts through the same sorted
    # segment layout as the ports, uplinks before downlinks; left out
    # (None) on a big-switch batch (Lf = 0)
    cnt_x = bw_x = link_up = link_dn = None
    if leaf:
        cnt_up = _segments(sums["cnt_up"], tb.lo_up, tb.hi_up)
        cnt_dn = _segments(sums["cnt_dn"], tb.lo_dn, tb.hi_dn)
        cnt_x = torch.cat([cnt_up, cnt_dn], dim=-1)      # (B, C, 2Lf)
        bw_x = torch.cat([tb.bw_up, tb.bw_dn], dim=-1)   # (B, 2Lf)
        link_up, link_dn = tb.link_up, tb.link_dn

    n_live_c = _segments(sums["n_live_c"], tb.flow_lo, tb.flow_hi) \
        if "n_live_c" in sums else None
    mixed = m_dyn = None
    if with_dynamics:
        # §4.3 remaining-length estimate: the EXACT median of finished-
        # flow sizes per coflow, as order statistics over the (cid,
        # size)-sorted layout: one cumsum of the done mask ranks each
        # done flow inside its segment, the two middle ranks are picked
        done_real = (state.done & tb.flow_valid).to(F32)
        d_s = done_real.gather(1, tb.perm_size)
        size_s = tb.size.gather(1, tb.perm_size)
        cid_s = tb.cid.gather(1, tb.perm_size)
        S = torch.cat([d_s.new_zeros((d_s.shape[0], 1)), d_s.cumsum(-1)],
                      dim=-1)
        S_lo = S.gather(1, tb.flow_lo)
        n_done = (S.gather(1, tb.flow_hi) - S_lo).to(torch.int64)   # (B, C)
        drank = (S[:, :-1] - S_lo.gather(1, cid_s)).to(torch.int64)  # (B, F)
        k1 = (n_done - 1).clamp(min=0) // 2
        k2 = n_done // 2
        hit1 = (d_s > 0.5) & (drank == k1.gather(1, cid_s))
        hit2 = (d_s > 0.5) & (drank == k2.gather(1, cid_s))
        # each hit mask selects at most one flow per segment: the pick is
        # a segment max (exact whatever else shares the lane)
        v1 = _segment_max(size_s * hit1, cid_s, tb.coflow_valid)
        v2 = _segment_max(size_s * hit2, cid_s, tb.coflow_valid)
        f_e = 0.5 * (v1 + v2)        # median (0 when nothing finished)
        rem_dyn = (f_e.gather(1, tb.cid) - state.sent).clamp(min=0.0) \
            * livef
        m_dyn = _segment_max(rem_dyn, tb.cid, tb.coflow_valid)
        mixed = active & (n_done > 0) & (n_live_c > 0.5)

    s_mixed = s_m = None
    if with_sampling:
        # learned-mode §4.3 inputs (reference `jax_engine.py:291-307`):
        # the size estimate is the MEAN finished-pilot size (a finished
        # flow's size is its delivered bytes, so only observable
        # quantities are read); a coflow with no finished pilot is no
        # re-queue candidate and keeps the bytes-sent placement. p_sum
        # is a float prefix-sum difference, summed in the reference's
        # order
        n_p = _segments(sums["n_p"], tb.flow_lo, tb.flow_hi)
        p_sum = _segments(sums["p_sum"], tb.flow_lo, tb.flow_hi)
        f_hat = p_sum / n_p.clamp(min=1.0)
        rem_s = (f_hat.gather(1, tb.cid) - state.sent).clamp(min=0.0) \
            * livef
        s_m = _segment_max(rem_s, tb.cid, tb.coflow_valid)
        s_mixed = active & (n_p > 0.5) & (n_live_c > 0.5)

    batch = co.CoflowBatch(active=active, arrival=tb.arrival_rank, m=m,
                           width=tb.width, cnt_s=cnt_s, cnt_r=cnt_r,
                           bw_s=tb.bw_send, bw_r=tb.bw_recv,
                           total=total, mixed=mixed, m_dyn=m_dyn,
                           cnt_x=cnt_x, bw_x=bw_x, s_mixed=s_mixed, s_m=s_m)
    flows = co.FlowView(cid=tb.cid, src=tb.src, dst=tb.dst, live=live,
                        flow_lo=tb.flow_lo, flow_hi=tb.flow_hi,
                        up=link_up, dn=link_dn) \
        if per_flow_wc else None
    return batch, flows, active, live, livef


def _tick(state: EngineState, tb: TraceBatch, ep: EngineParams, *,
          per_flow_wc: bool = True, with_dynamics: bool = True,
          with_ablations: bool = False,
          wc_maxmin: bool = False,
          with_sampling: bool = False,
          n_end: Optional[torch.Tensor] = None) -> EngineState:
    """Advance every lane one event step: schedule at the current δ
    tick, find the next instant the schedule could change, quantize it
    up to the δ grid, and integrate the constant rates across the jump.
    The flags are the reference's static structure switches.

    `n_end` (B,) f32 (sessions; reference `jax_engine.py:357-508`) caps
    each lane at its horizon tick: the jump never passes it, a schedule
    interval the cap cuts is stored (rates and anchor) and resumed by
    the next step instead of re-evaluated, stopping early only at an
    arrival submitted since the anchor, and a lane with tick >= n_end is
    an exact no-op on every leaf. None (offline) leaves all of that out.
    """
    session = n_end is not None
    delta = ep.delta
    tickf = state.tick.to(F32)
    now = state.t0 + tickf * delta
    eps_t = 1e-3 * delta
    can = tickf < n_end if session else None
    batch, flows, active, live, livef = _views(
        state, tb, now, eps_t, per_flow_wc=per_flow_wc,
        with_dynamics=with_dynamics, with_ablations=with_ablations,
        with_sampling=with_sampling, active_gate=can)
    total = batch.total
    coord, out = co.tick_core(state.coord, batch, now, ep.dp, flows=flows,
                              wc_fill="maxmin" if wc_maxmin else "greedy")
    # per-flow rates: MADD equal rate for admitted coflows + the work-
    # conservation fill
    r_f = out["rate"].gather(1, tb.cid) * livef
    if per_flow_wc:
        r_f = r_f + out["wc_flow"]
    else:
        r_f = r_f + out["wc_rate"].gather(1, tb.cid) * livef
    served = live & (r_f > 0)
    rem = tb.size - state.sent
    r_safe = r_f.clamp(min=1e-30)

    # ---- event horizon (per lane) -----------------------------------
    inf = float("inf")
    nowc, epsc = now[:, None], (now + eps_t)[:, None]
    t_fin = torch.where(served, nowc + rem / r_safe, inf).amin(-1)
    # queue-threshold crossing: flow f of coflow c crosses when sent_f
    # reaches Q_q^hi / N_c (Eq. 1), or the coflow's TOTAL bytes reach
    # Q_q^hi for the per_flow=0 ablation
    q = coord.queue.clamp(min=0)
    thq = ep.dp.thresholds.gather(1, q)
    lim = (thq / tb.width.clamp(min=1).to(F32)).gather(1, tb.cid)
    dt_th = torch.where(served & torch.isfinite(lim) & (lim > state.sent),
                        (lim - state.sent) / r_safe, inf)
    t_th = now + dt_th.amin(-1)
    if with_ablations:
        R_c = _segment_sum(r_f, tb.flow_lo, tb.flow_hi)
        dt_tot = torch.where(active & (R_c > 0) & torch.isfinite(thq)
                             & (thq > total),
                             (thq - total) / R_c.clamp(min=1e-30), inf)
        t_th = now + torch.where(ep.dp.per_flow > 0, dt_th.amin(-1),
                                 dt_tot.amin(-1))
    t_dl = torch.where(active & (coord.deadline > epsc), coord.deadline,
                       inf).amin(-1)
    t_arr = torch.where(tb.coflow_valid & (tb.arrival > epsc), tb.arrival,
                        inf).amin(-1)
    t_ev = torch.minimum(torch.minimum(t_fin, t_th),
                         torch.minimum(t_dl, t_arr))
    # the pilot estimate drifts continuously too (rem = f_hat - sent), so
    # learned mode keeps the same re-evaluation cadence
    jump = DYNAMICS_JUMP_TICKS if (with_dynamics or with_sampling) \
        else MAX_JUMP_TICKS
    n_ev = torch.where(torch.isfinite(t_ev),
                       torch.ceil((t_ev - state.t0) / delta - 1e-4),
                       tickf + jump)
    # an idle lane (nothing live) jumps its gap in one step
    hi = tickf + torch.where(live.any(-1), jump, IDLE_JUMP_TICKS)
    n_un = torch.clamp(n_ev, min=tickf + 1.0, max=hi)   # uncapped horizon

    if not session:
        n_next, r_use, r_use_safe, rem_a = n_un, r_f, r_safe, rem
        anchor_t, anchor_tick, anchor_sent = now, tickf, state.sent
        coord_new = coord
    else:
        cap = torch.maximum(n_end, tickf + 1.0)
        # pending-horizon resume: keep integrating the stored rates from
        # the stored anchor to the stored horizon, or to the δ tick of an
        # arrival submitted since the anchor (an event the offline loop
        # would have stopped at), instead of re-evaluating this tick
        pend_t = state.t0 + state.pend_tick * delta
        late = torch.where(tb.coflow_valid
                           & (tb.arrival > (pend_t + eps_t)[:, None]),
                           tb.arrival, inf).amin(-1)
        late_n = torch.maximum(
            torch.ceil((late - state.t0) / delta - 1e-4),
            state.pend_tick + 1.0)
        stop = torch.minimum(state.pend_next, late_n)
        resuming = (state.pend_next > tickf) & (stop > tickf)
        n_next = torch.where(resuming, torch.minimum(stop, cap),
                             torch.minimum(n_un, cap))
        r_use = torch.where(resuming[:, None], state.rate, r_f)
        r_use_safe = r_use.clamp(min=1e-30)
        anchor_t = torch.where(resuming, pend_t, now)
        anchor_tick = torch.where(resuming, state.pend_tick, tickf)
        anchor_sent = torch.where(resuming[:, None], state.pend_sent,
                                  state.sent)
        rem_a = tb.size - anchor_sent
        # a resumed interval does not re-invoke the coordinator: queue
        # moves and deadline refreshes happen only at evaluation instants
        coord_new = _select(resuming, state.coord, coord)
        served = live & (r_use > 0)

    # ---- integrate the constant rates across the interval, anchored at
    # the evaluation instant: an interval cut by n_end caps integrates to
    # the same f32 values as the offline one-shot step ----------------
    dt = (n_next - anchor_tick) * delta
    adv = r_use * dt[:, None]
    fin = served & (adv >= rem_a - REL_EPS * tb.size)
    fct = torch.where(fin, anchor_t[:, None] + rem_a / r_use_safe,
                      state.fct)
    sent = torch.where(fin, tb.size,
                       torch.minimum(tb.size, anchor_sent + adv))
    done = state.done | fin

    # coflow completions: CCT = last FCT - arrival
    undone = _segment_sum((tb.flow_valid & ~done).to(F32), tb.flow_lo,
                          tb.flow_hi)
    newly = active & (undone < 0.5)
    last_fct = _segment_max(fct * tb.flow_valid, tb.cid, tb.coflow_valid)
    cct = torch.where(newly, last_fct - tb.arrival, state.cct)
    tick = state.tick + (n_next - tickf).to(torch.int32)
    if not session:
        return EngineState(coord=coord, sent=sent, done=done, fct=fct,
                           finished=state.finished | newly, cct=cct,
                           t0=state.t0, tick=tick)
    # pending bookkeeping: cleared once the interval's horizon (or the
    # arrival stop) is reached, (re)armed when the cap cut this step's
    # interval; the anchor leaves always describe the interval just
    # integrated
    hit = n_next >= torch.where(resuming, stop, n_un)
    pend_next = torch.where(hit, 0.0,
                            torch.where(resuming, state.pend_next, n_un))
    new = EngineState(coord=coord_new, sent=sent, done=done, fct=fct,
                      finished=state.finished | newly, cct=cct,
                      t0=state.t0, tick=tick, rate=r_use,
                      pend_sent=anchor_sent, pend_tick=anchor_tick,
                      pend_next=pend_next)
    # at or past its horizon a lane's step is a pure no-op: the schedule
    # at tick n_end is evaluated by the next advance, once every arrival
    # up to it is in the slab
    return _select(can, new, state)


def _norm_features(features: tuple) -> tuple:
    """A features tuple in the full 5-slot form `(per_flow_wc,
    with_dynamics, with_ablations, wc_maxmin, with_sampling)`: a shorter
    tuple pads with False (reference `jax_engine.py:513-522`)."""
    f = tuple(features)
    if not 1 <= len(f) <= 5:
        raise ValueError(f"features tuple of length {len(f)}")
    return f + (False,) * (5 - len(f))


def _switches(features: tuple) -> dict:
    """`_tick`'s keyword structure switches of a features tuple."""
    names = ("per_flow_wc", "with_dynamics", "with_ablations", "wc_maxmin",
             "with_sampling")
    return dict(zip(names, _norm_features(features)))


def _run_chunk(state: EngineState, tb: TraceBatch, ep: EngineParams, *,
               chunk: int, features: tuple) -> EngineState:
    """`chunk` event steps for every lane, with no host read."""
    sw = _switches(features)
    for _ in range(chunk):
        state = _tick(state, tb, ep, **sw)
    return state


def default_max_ticks(tb: TraceBatch, delta: float, slack: float = 4.0,
                      ) -> int:
    """The reference's horizon bound: at every tick the head-of-line
    coflow progresses at its bottleneck rate, so the makespan is at most
    last_arrival + the serial bottleneck time (x slack). Takes a
    host-side (numpy) TraceBatch."""
    bw = np.where(tb.bw_send > 0, tb.bw_send, np.inf).min()
    per_port = np.zeros((tb.num_traces, 2, tb.num_ports))
    np.add.at(per_port, (np.arange(tb.num_traces)[:, None], 0, tb.src),
              tb.size * tb.flow_valid)
    np.add.at(per_port, (np.arange(tb.num_traces)[:, None], 1, tb.dst),
              tb.size * tb.flow_valid)
    serial = per_port.max(axis=(1, 2)) / bw
    Lf = tb.bw_up.shape[-1]
    if Lf:
        # oversubscribed uplinks/downlinks can be the bottleneck: each
        # link's bytes over its capacity (sentinel Lf = no link)
        per_link = np.zeros((tb.num_traces, 2, Lf + 1))
        rows = np.arange(tb.num_traces)[:, None]
        np.add.at(per_link, (rows, 0, tb.link_up), tb.size * tb.flow_valid)
        np.add.at(per_link, (rows, 1, tb.link_dn), tb.size * tb.flow_valid)
        cap = np.stack([tb.bw_up, tb.bw_dn], axis=1)  # (B, 2, Lf)
        t_link = np.where(cap > 0, per_link[:, :, :Lf] / np.maximum(
            cap, 1e-30), 0.0).max(axis=(1, 2))
        serial = np.maximum(serial, t_link)
    last = np.where(tb.coflow_valid, tb.arrival, 0.0).max(axis=1)
    tot = np.einsum("bf->b", tb.size * tb.flow_valid) / bw
    horizon = float((last + slack * np.maximum(serial, tot)).max())
    return max(int(np.ceil(horizon / delta)) + 2, 8)


def features_for(params: SchedulerParams, *, fidelity: str = "flow",
                 dynamics_requeue: "bool | None" = None,
                 lcof: bool = True,
                 per_flow_threshold: bool = True,
                 topology=None,
                 clairvoyant: "bool | None" = None) -> tuple:
    """The structure switches `(per_flow_wc, with_dynamics,
    with_ablations, wc_maxmin, with_sampling)` `_tick` runs with, derived
    as the reference's `features_for` derives them (`wc_maxmin` from a
    `LeafSpine`'s `wc_fill`). The §4.3 re-queue splits by clairvoyance:
    `with_dynamics` builds the exact finished-flow median (known sizes),
    `with_sampling` the pilot estimate (learned sizes)."""
    if fidelity not in ("flow", "coflow"):
        raise ValueError(f"unknown fidelity {fidelity!r}")
    dyn = bool(params.dynamics_requeue if dynamics_requeue is None
               else dynamics_requeue)
    cl = bool(params.clairvoyant if clairvoyant is None else clairvoyant)
    return (fidelity == "flow", dyn and cl,
            not (lcof and per_flow_threshold),
            wc_fill_of(topology) == "maxmin", dyn and not cl)


def simulate_batch(traces: "Sequence | TraceBatch",
                   params: Optional[SchedulerParams] = None, *,
                   max_ticks: Optional[int] = None, chunk: int = 128,
                   work_conservation: "bool | None" = None,
                   dynamics_requeue: "bool | None" = None,
                   lcof: bool = True,
                   per_flow_threshold: bool = True,
                   clairvoyant: "bool | None" = None,
                   fidelity: str = "flow",
                   topology=None,
                   device=None) -> EngineResult:
    """Replay a fleet of traces under one parameter setting (the front
    door is `repro_torch.api.run`). Mechanism switches default to the
    SchedulerParams fields (work_conservation / dynamics_requeue) or
    full SAATH (lcof / per_flow_threshold). `fidelity` picks per-flow
    ("flow") or coflow-granular ("coflow") work conservation;
    `topology` (None, `BigSwitch()` or `LeafSpine(...)`) the fabric."""
    params = params or SchedulerParams()
    dev = resolve_device(device)
    features = features_for(
        params, fidelity=fidelity, dynamics_requeue=dynamics_requeue,
        lcof=lcof, per_flow_threshold=per_flow_threshold,
        topology=topology, clairvoyant=clairvoyant)
    with_sampling = features[4]
    tb = traces if isinstance(traces, TraceBatch) else \
        pack(traces, port_bw=params.port_bw, topology=topology,
             sampling=with_sampling, pilot_frac=params.pilot_frac)
    if with_sampling and tb.pilot is None:
        raise ValueError("a non-clairvoyant replay needs a TraceBatch "
                         "packed with sampling=True")
    if max_ticks is None:
        max_ticks = default_max_ticks(tb, params.delta)
    ep = EngineParams.from_scheduler(
        params, work_conservation=work_conservation,
        dynamics_requeue=dynamics_requeue, lcof=lcof,
        per_flow_threshold=per_flow_threshold, clairvoyant=clairvoyant,
        device=dev)
    return _drive(to_device(tb, dev), ep, max_ticks, chunk,
                  features=features)


def simulate_sweep(trace, params_list: Sequence[SchedulerParams], *,
                   max_ticks: Optional[int] = None, chunk: int = 128,
                   fidelity: str = "flow", topology=None,
                   device=None) -> EngineResult:
    """Replay ONE trace under M parameter settings as one batched
    computation (lane i = setting i). Settings must share num_queues and
    port_bw; δ is per setting and the tick budget covers the smallest.
    Known and learned settings mix (the pilot estimate is built in when
    any setting learns; a known lane's `clairvoyant` leaf is then 1.0),
    and then they must share `pilot_frac` (reference
    `jax_engine.py:689-714`)."""
    if fidelity not in ("flow", "coflow"):
        raise ValueError(f"unknown fidelity {fidelity!r}")
    if len({len(p.thresholds()) for p in params_list}) != 1:
        raise ValueError("sweep settings must share num_queues")
    if len({p.port_bw for p in params_list}) != 1:
        raise ValueError("sweep settings must share port_bw")
    sampling_any = any(not p.clairvoyant for p in params_list)
    if sampling_any and len({p.pilot_frac for p in params_list}) > 1:
        # the pilot layout is packed into the row the sweep repeats
        raise ValueError("sweep settings must share pilot_frac")
    dev = resolve_device(device)
    feats = [features_for(p, fidelity=fidelity, topology=topology)
             for p in params_list]
    features = (fidelity == "flow", any(f[1] for f in feats), False,
                feats[0][3], any(f[4] for f in feats))
    tb1 = pack([trace], port_bw=params_list[0].port_bw, topology=topology,
               sampling=sampling_any, pilot_frac=params_list[0].pilot_frac)
    B = len(params_list)
    tb = TraceBatch(*(None if a is None else np.repeat(a, B, axis=0)
                      for a in tb1))
    eps = [EngineParams.from_scheduler(p, device=dev) for p in params_list]
    if sampling_any:
        eps = [e._replace(dp=e.dp.known()) for e in eps]
    ep = tree_map(lambda *xs: torch.stack(xs), *eps)
    min_delta = min(p.delta for p in params_list)
    if max_ticks is None:
        max_ticks = default_max_ticks(tb, min_delta)
    return _drive(to_device(tb, dev), ep, max_ticks, chunk,
                  features=features)


def _drive(tb: TraceBatch, ep: EngineParams, max_ticks: int, chunk: int,
           *, features: tuple, state: Optional[EngineState] = None,
           events: int = 0) -> EngineResult:
    """Run chunks until every lane's real coflows have finished (one
    host read per chunk) or `max_ticks` event steps ran, which raises.
    `state`/`events` resume a replay (see `from_reference`)."""
    B = tb.cid.shape[0]
    ep = ep.lanes(B)
    if state is None:
        state = _init_state(tb)
    # every event step advances >= 1 grid tick, so max_ticks also bounds
    # the event steps a terminating replay can need
    while events < max_ticks:
        state = _run_chunk(state, tb, ep, chunk=chunk, features=features)
        events += chunk
        if bool(state.finished.all()):
            break
    else:
        raise RuntimeError(
            f"torch engine: {int((~state.finished).sum())} coflows "
            f"unfinished after {events} event steps (raise max_ticks or "
            f"check the trace)")
    fct = state.fct.double().cpu().numpy()
    fct[~state.done.cpu().numpy()] = np.nan
    fct[~tb.flow_valid.cpu().numpy()] = np.nan
    return EngineResult(cct=state.cct.double().cpu().numpy(), fct=fct,
                        sent=state.sent.double().cpu().numpy(),
                        finished=state.finished.cpu().numpy(),
                        ticks=int(state.tick.max()), events=events)


# ---- online session support (repro_torch.api.SaathSession) ------------

def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on `device`: on a card through a pinned host buffer
    with a non-blocking copy (the caching host allocator keeps the
    buffer until the copy has run), so that no upload stalls the
    stream's host thread."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def scatter_rows(tree, idx: torch.Tensor, rows) -> None:
    """Write the k stacked rows of `rows` (a tree like `tree`, leaves on
    its device and of its dtypes) into rows `idx` (k,) of the slab
    `tree` in place (reference `jax_engine.py:753-773`): the pool's
    dirty-row upload. Rows are distinct, so `index_copy_` is exact."""
    tree_map(lambda a, u: a.index_copy_(0, idx, u), tree, rows)


def gather_rows(tree, idx: torch.Tensor):
    """Rows `idx` of a slab tree (reference `jax_engine.py:776-782`):
    the download half of the pool's row contract."""
    return tree_map(lambda a: a.index_select(0, idx), tree)


def _session_chunk(state: EngineState, tb: TraceBatch, ep: EngineParams,
                   n_end: torch.Tensor, steps: int, *,
                   features: tuple) -> EngineState:
    """`steps` session event steps of every lane, with no host read."""
    sw = _switches(features)
    for _ in range(steps):
        state = _tick(state, tb, ep, n_end=n_end, **sw)
    return state


def _lanes_open(state: EngineState, n_end: torch.Tensor) -> torch.Tensor:
    """Device bool: some lane is short of its horizon with a real coflow
    unfinished (reference `_session_while`'s loop condition)."""
    closed = (state.tick.to(F32) >= n_end) | state.finished.all(-1)
    return ~closed.all()


def session_advance(state: EngineState, tb: TraceBatch, ep: EngineParams,
                    *, n_end, chunk: int = 32,
                    features: tuple = (True, True, False, False, False),
                    max_steps: int = 10_000_000):
    """Step a session slab until every lane has reached its tick horizon
    `n_end` (a scalar or a (B,) host array of slab-relative ticks) or
    finished all its real coflows; a lane at its horizon is an exact
    no-op (reference `session_advance`, `jax_engine.py:914-965`, with
    `_session_while`, `:814-847`). `ep` carries a leading (B,) row axis.

    The loop runs on the host: chunks of 1, 2, 4, ... up to `chunk`
    event steps (a δ-cadence advance usually needs one or two), each
    followed by one read of the "lanes open" flag, the loop's only host
    synchronization. Returns (state, event steps run, flag reads);
    raises past `max_steps` event steps."""
    B = state.tick.shape[0]
    ne = np.broadcast_to(np.asarray(n_end, np.float32), (B,)).copy()
    ne = host_to_device(ne, state.tick.device)
    steps = reads = 0
    n = 1
    while steps < max_steps:
        k = min(n, chunk, max_steps - steps)
        state = _session_chunk(state, tb, ep, ne, k, features=features)
        steps += k
        reads += 1
        if not bool(_lanes_open(state, ne)):
            return state, steps, reads
        n *= 2
    raise RuntimeError(
        f"session_advance exceeded {max_steps} event steps before "
        f"reaching its tick horizon (check the slab)")


def session_plan_tick(state: EngineState, tb: TraceBatch,
                      ep: EngineParams, *,
                      features: tuple = (True, False, False, False, False),
                      row_mask: Optional[np.ndarray] = None):
    """One coordinator tick on the slab without integrating rates, the
    wave-planning mode (reference `jax_engine.py:968-1006`). Rows outside
    `row_mask` (B,) are exact no-ops and admit nothing; a planning row's
    pending capped interval is dropped. Returns (state with the post-tick
    coordinator carry and tick + 1, admitted (B, C) bool)."""
    sw = _switches(features)
    tickf = state.tick.to(F32)
    now = state.t0 + tickf * ep.delta
    eps_t = 1e-3 * ep.delta
    batch, flows, _, _, _ = _views(
        state, tb, now, eps_t, per_flow_wc=sw["per_flow_wc"],
        with_dynamics=sw["with_dynamics"],
        with_ablations=sw["with_ablations"],
        with_sampling=sw["with_sampling"])
    coord, out = co.tick_core(state.coord, batch, now, ep.dp, flows=flows,
                              wc_fill="maxmin" if sw["wc_maxmin"]
                              else "greedy")
    new = state._replace(coord=coord, tick=state.tick + 1)
    if state.pend_next is not None:
        new = new._replace(pend_next=torch.zeros_like(state.pend_next))
    B = state.tick.shape[0]
    mask = np.ones(B, bool) if row_mask is None else np.asarray(row_mask,
                                                                  bool)
    mask = host_to_device(mask, state.tick.device)
    return _select(mask, new, state), out["admitted"] & mask[:, None]


def _leaf(x, device, dtype):
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def from_reference(tb, params, state=None, *, device=None):
    """Carry the JAX package's replay data into the port's tensors.

    `tb` is a TraceBatch of numpy arrays (any NamedTuple with its field
    names, so the JAX package's works without being imported here);
    `params` an EngineParams-like (fields `dp`, `delta`) whose `dp` has
    DynCoordParams' fields; `state` optionally an offline EngineState-
    like (fields coord{queue, deadline, running}, sent, done, fct,
    finished, cct, t0, tick), with or without the session leaves (rate,
    pend_sent, pend_tick, pend_next: a `SessionPool.host_view()` state).
    Leaves may be numpy or anything `np.asarray` reads. Returns (tb,
    params, state) on `device`, with `params` broadcast to the batch's
    lanes and `state` None when none was given. Big-switch, leaf-spine
    and piloted batches are carried, and the `clairvoyant` leaf of a
    learned or mixed setting (None stays None)."""
    dev = resolve_device(device)
    t_tb = to_device(tb, dev)
    B = t_tb.cid.shape[0]
    dp = params.dp
    t_dp = co.DynCoordParams(*(
        None if getattr(dp, f, None) is None
        else _leaf(getattr(dp, f), dev, F32)
        for f in co.DynCoordParams._fields))
    t_ep = EngineParams(t_dp, _leaf(params.delta, dev, F32)).lanes(B)
    t_state = None
    if state is not None:
        c = state.coord
        session = {}
        if getattr(state, "rate", None) is not None:
            session = dict(
                rate=_leaf(state.rate, dev, F32),
                pend_sent=_leaf(state.pend_sent, dev, F32),
                pend_tick=_leaf(state.pend_tick, dev, F32),
                pend_next=_leaf(state.pend_next, dev, F32))
        t_state = EngineState(
            coord=co.CoordState(_leaf(c.queue, dev, torch.int64),
                                _leaf(c.deadline, dev, F32),
                                _leaf(c.running, dev, torch.bool)),
            sent=_leaf(state.sent, dev, F32),
            done=_leaf(state.done, dev, torch.bool),
            fct=_leaf(state.fct, dev, F32),
            finished=_leaf(state.finished, dev, torch.bool),
            cct=_leaf(state.cct, dev, F32),
            t0=_leaf(state.t0, dev, F32).expand(B).contiguous(),
            tick=_leaf(state.tick, dev, torch.int32).expand(B).contiguous(),
            **session)
    return t_tb, t_ep, t_state


__all__ = ["EngineParams", "EngineState", "EngineResult",
           "default_max_ticks", "features_for", "from_reference",
           "gather_rows", "host_to_device", "resolve_device",
           "scatter_rows", "session_advance", "session_plan_tick",
           "simulate_batch", "simulate_sweep", "tree_map"]
