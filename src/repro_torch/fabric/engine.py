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
greedy or the max-min work-conservation fill) are ported, clairvoyant
only: pilot sampling is ROADMAP queue A item 6, and the online-session
branch of `_tick` is queue A item 4.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import coordinator as co
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric.metrics import nan_row_mean
from repro_torch.fabric.topology import wc_fill_of
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
    """Per-lane replay state (every leaf has a leading lane axis)."""
    coord: co.CoordState
    sent: torch.Tensor      # (B, F) f32 bytes
    done: torch.Tensor      # (B, F) bool
    fct: torch.Tensor       # (B, F) f32 absolute completion time (0 until done)
    finished: torch.Tensor  # (B, C) bool
    cct: torch.Tensor       # (B, C) f32 completion - arrival (nan until done)
    t0: torch.Tensor        # (B,) f32 grid origin (0)
    tick: torch.Tensor      # (B,) int32 next tick index


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


def _segment_sum(data: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Sum `data` (B, F) over contiguous index ranges [lo, hi) (any
    trailing shape of lo/hi) via one cumsum and two boundary gathers.
    Exact for 0/1 counts; float data rounds by the card's scan order."""
    B = data.shape[0]
    s = torch.cat([data.new_zeros((B, 1)), data.cumsum(-1)], dim=-1)
    flat_hi, flat_lo = hi.reshape(B, -1), lo.reshape(B, -1)
    return (s.gather(1, flat_hi) - s.gather(1, flat_lo)).reshape(hi.shape)


def _segment_max(data: torch.Tensor, seg: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Max of non-negative `data` (B, F) per coflow id `seg` -> (B, C),
    0 for invalid coflows. A scatter-max is exact in any order; pad
    flows may share a real coflow's id, so their data must be 0."""
    out = torch.zeros(valid.shape, dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(1, seg, data, reduce="amax", include_self=True)
    return torch.where(valid, out, 0.0)


def _views(state: EngineState, tb: TraceBatch, now: torch.Tensor,
           eps_t: torch.Tensor, *, per_flow_wc: bool, with_dynamics: bool,
           with_ablations: bool):
    """One tick's coordinator view of every lane: activation, per-(coflow,
    port) live counts, Eq. 1 m_c, on a leaf-spine batch the per-(coflow,
    link) live counts, and (when built in) the §4.3 finished-flow-median
    inputs and the ablation's total bytes."""
    active = tb.coflow_valid & ~state.finished \
        & (tb.arrival <= (now + eps_t)[:, None])
    live = active.gather(1, tb.cid) & ~state.done & tb.flow_valid
    livef = live.to(F32)

    m = _segment_max(state.sent * tb.flow_valid, tb.cid, tb.coflow_valid)
    cnt_s = _segment_sum(livef.gather(1, tb.perm_src), tb.lo_src, tb.hi_src)
    cnt_r = _segment_sum(livef.gather(1, tb.perm_dst), tb.lo_dst, tb.hi_dst)
    total = _segment_sum(state.sent * tb.flow_valid, tb.flow_lo,
                         tb.flow_hi) if with_ablations else None

    # leaf-spine: per-(coflow, link) live counts through the same sorted
    # segment layout as the ports, uplinks before downlinks; left out
    # (None) on a big-switch batch (Lf = 0)
    cnt_x = bw_x = link_up = link_dn = None
    if tb.bw_up.shape[-1]:
        cnt_up = _segment_sum(livef.gather(1, tb.perm_up), tb.lo_up,
                              tb.hi_up)
        cnt_dn = _segment_sum(livef.gather(1, tb.perm_dn), tb.lo_dn,
                              tb.hi_dn)
        cnt_x = torch.cat([cnt_up, cnt_dn], dim=-1)      # (B, C, 2Lf)
        bw_x = torch.cat([tb.bw_up, tb.bw_dn], dim=-1)   # (B, 2Lf)
        link_up, link_dn = tb.link_up, tb.link_dn

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
        n_live_c = _segment_sum(livef, tb.flow_lo, tb.flow_hi)
        mixed = active & (n_done > 0) & (n_live_c > 0.5)

    batch = co.CoflowBatch(active=active, arrival=tb.arrival_rank, m=m,
                           width=tb.width, cnt_s=cnt_s, cnt_r=cnt_r,
                           bw_s=tb.bw_send, bw_r=tb.bw_recv,
                           total=total, mixed=mixed, m_dyn=m_dyn,
                           cnt_x=cnt_x, bw_x=bw_x)
    flows = co.FlowView(cid=tb.cid, src=tb.src, dst=tb.dst, live=live,
                        flow_lo=tb.flow_lo, flow_hi=tb.flow_hi,
                        up=link_up, dn=link_dn) \
        if per_flow_wc else None
    return batch, flows, active, live, livef


def _tick(state: EngineState, tb: TraceBatch, ep: EngineParams, *,
          per_flow_wc: bool = True, with_dynamics: bool = True,
          with_ablations: bool = False,
          wc_maxmin: bool = False) -> EngineState:
    """Advance every lane one event step: schedule at the current δ
    tick, find the next instant the schedule could change, quantize it
    up to the δ grid, and integrate the constant rates across the jump.
    The flags are the reference's static structure switches."""
    delta = ep.delta
    tickf = state.tick.to(F32)
    now = state.t0 + tickf * delta
    eps_t = 1e-3 * delta
    batch, flows, active, live, livef = _views(
        state, tb, now, eps_t, per_flow_wc=per_flow_wc,
        with_dynamics=with_dynamics, with_ablations=with_ablations)
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
    jump = DYNAMICS_JUMP_TICKS if with_dynamics else MAX_JUMP_TICKS
    n_ev = torch.where(torch.isfinite(t_ev),
                       torch.ceil((t_ev - state.t0) / delta - 1e-4),
                       tickf + jump)
    # an idle lane (nothing live) jumps its gap in one step
    hi = tickf + torch.where(live.any(-1), jump, IDLE_JUMP_TICKS)
    n_next = torch.clamp(n_ev, min=tickf + 1.0, max=hi)

    # ---- integrate the constant rates across the interval -----------
    dt = (n_next - tickf) * delta
    adv = r_f * dt[:, None]
    fin = served & (adv >= rem - REL_EPS * tb.size)
    fct = torch.where(fin, nowc + rem / r_safe, state.fct)
    sent = torch.where(fin, tb.size, torch.minimum(tb.size, state.sent + adv))
    done = state.done | fin

    # coflow completions: CCT = last FCT - arrival
    undone = _segment_sum((tb.flow_valid & ~done).to(F32), tb.flow_lo,
                          tb.flow_hi)
    newly = active & (undone < 0.5)
    last_fct = _segment_max(fct * tb.flow_valid, tb.cid, tb.coflow_valid)
    cct = torch.where(newly, last_fct - tb.arrival, state.cct)
    return EngineState(coord=coord, sent=sent, done=done, fct=fct,
                       finished=state.finished | newly, cct=cct,
                       t0=state.t0,
                       tick=state.tick + (n_next - tickf).to(torch.int32))


def _run_chunk(state: EngineState, tb: TraceBatch, ep: EngineParams, *,
               chunk: int, features: tuple) -> EngineState:
    """`chunk` event steps for every lane, with no host read."""
    per_flow_wc, with_dynamics, with_ablations, wc_maxmin = features
    for _ in range(chunk):
        state = _tick(state, tb, ep, per_flow_wc=per_flow_wc,
                      with_dynamics=with_dynamics,
                      with_ablations=with_ablations, wc_maxmin=wc_maxmin)
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
    with_ablations, wc_maxmin)` `_tick` runs with, derived as the
    reference's `features_for` derives its first four (`wc_maxmin` from
    a `LeafSpine`'s `wc_fill`); raises for the parts of the reference
    that are not ported yet."""
    if fidelity not in ("flow", "coflow"):
        raise ValueError(f"unknown fidelity {fidelity!r}")
    dyn = (params.dynamics_requeue if dynamics_requeue is None
           else dynamics_requeue)
    cl = params.clairvoyant if clairvoyant is None else clairvoyant
    if dyn and not cl:
        raise NotImplementedError(
            "non-clairvoyant (pilot-sampling) re-queue is not ported yet: "
            "ROADMAP queue A item 6")
    return (fidelity == "flow", bool(dyn), not (lcof and per_flow_threshold),
            wc_fill_of(topology) == "maxmin")


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
    tb = traces if isinstance(traces, TraceBatch) else \
        pack(traces, port_bw=params.port_bw, topology=topology)
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
    port_bw; δ is per setting and the tick budget covers the smallest."""
    if fidelity not in ("flow", "coflow"):
        raise ValueError(f"unknown fidelity {fidelity!r}")
    if len({len(p.thresholds()) for p in params_list}) != 1:
        raise ValueError("sweep settings must share num_queues")
    if len({p.port_bw for p in params_list}) != 1:
        raise ValueError("sweep settings must share port_bw")
    dev = resolve_device(device)
    feats = [features_for(p, fidelity=fidelity, topology=topology)
             for p in params_list]
    features = (fidelity == "flow", any(f[1] for f in feats), False,
                feats[0][3])
    tb1 = pack([trace], port_bw=params_list[0].port_bw, topology=topology)
    B = len(params_list)
    tb = TraceBatch(*(None if a is None else np.repeat(a, B, axis=0)
                      for a in tb1))
    eps = [EngineParams.from_scheduler(p, device=dev) for p in params_list]
    ep = EngineParams(
        co.DynCoordParams(*(torch.stack(xs) for xs in
                            zip(*(e.dp for e in eps)))),
        torch.stack([e.delta for e in eps]))
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


def _leaf(x, device, dtype):
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def from_reference(tb, params, state=None, *, device=None):
    """Carry the JAX package's replay data into the port's tensors.

    `tb` is a TraceBatch of numpy arrays (any NamedTuple with its field
    names, so the JAX package's works without being imported here);
    `params` an EngineParams-like (fields `dp`, `delta`) whose `dp` has
    DynCoordParams' fields; `state` optionally an offline EngineState-
    like (fields coord{queue, deadline, running}, sent, done, fct,
    finished, cct, t0, tick). Leaves may be numpy or anything
    `np.asarray` reads. Returns (tb, params, state) on `device`, with
    `params` broadcast to the batch's lanes and `state` None when none
    was given. Big-switch and leaf-spine batches are carried; raises for
    the parts of the reference not ported yet (pilot sampling, session
    states)."""
    dev = resolve_device(device)
    if getattr(tb, "pilot", None) is not None:
        raise NotImplementedError(
            "pilot-sampling batches are not ported yet: ROADMAP queue A "
            "item 6")
    t_tb = to_device(tb, dev)
    B = t_tb.cid.shape[0]
    dp = params.dp
    clair = getattr(dp, "clairvoyant", None)
    if clair is not None and (np.asarray(clair) <= 0).any():
        raise NotImplementedError(
            "non-clairvoyant lanes are not ported yet: ROADMAP queue A "
            "item 6")
    t_dp = co.DynCoordParams(*(_leaf(getattr(dp, f), dev, F32)
                               for f in co.DynCoordParams._fields))
    t_ep = EngineParams(t_dp, _leaf(params.delta, dev, F32)).lanes(B)
    t_state = None
    if state is not None:
        if getattr(state, "rate", None) is not None:
            raise NotImplementedError(
                "session states (pending horizons) are ROADMAP queue A "
                "item 4")
        c = state.coord
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
            tick=_leaf(state.tick, dev, torch.int32).expand(B).contiguous())
    return t_tb, t_ep, t_state


__all__ = ["EngineParams", "EngineState", "EngineResult",
           "default_max_ticks", "features_for", "from_reference",
           "resolve_device", "simulate_batch", "simulate_sweep"]
