"""Online scheduling sessions: `submit` / `advance` / `poll`.

The port of `repro.api.session` (527 lines). Offline `repro_torch.api.
run` replays traces whose arrivals are known up front; `SaathSession`
runs the same Fig. 7 coordinator as an open-loop service:

* ``submit(coflows)`` registers new coflows at the current session
  clock (each `Coflow.arrival` may also name a future instant);
* ``advance(dt)`` moves the session clock and schedules every δ-grid
  tick up to it;
* ``poll()`` returns (and retires) the coflows that completed since the
  last poll;
* ``plan_tick()`` runs one coordinator tick in wave-planning mode
  (admitted coflows complete instantly).

A session is a view onto one row of a `repro_torch.api.SessionPool`
slab (a standalone session owns a private one-row pool;
`SessionPool.session()` hands out rows of a shared multi-tenant slab).
The session keeps the host truth (live `_Entry`s, clock, global δ-grid
tick, row epoch, the pending event-horizon mirror) in f64, cast for cast
as the reference does; the pool owns the device-resident `TraceBatch`
and `EngineState` and every step of the engine.

Incremental replay is exact: the δ grid is pinned at the session epoch,
ticks at or past the advance horizon are pure no-ops, the schedule at a
tick is evaluated only once every arrival up to it has been submitted,
and a schedule interval that a horizon cap cut is resumed (stored rates,
anchored integration), not re-evaluated. Feeding a trace's coflows in at
their arrival times gives the offline replay's CCTs bit for bit.

``backend="torch"`` is the one backend. The reference's event-driven
numpy oracle (``backend="numpy"``) needs the host simulator and its
policies, which are ROADMAP queue A item 3b.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.coflow import Coflow
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric.state import FlowTable


@dataclasses.dataclass
class CompletedCoflow:
    """One finished coflow, as returned (once) by `poll`."""
    handle: int
    arrival: float
    cct: float              # seconds, arrival-relative
    fct: np.ndarray         # absolute per-flow completion times
    size: np.ndarray = None  # per-flow bytes (completions moved them all)


@dataclasses.dataclass
class _Entry:
    """Host mirror of one live coflow's dynamic state (the carry that
    survives slab re-packs)."""
    handle: int
    arrival: float
    rank: int               # session-global FIFO rank (submission order)
    src: np.ndarray
    dst: np.ndarray
    size: np.ndarray
    sent: np.ndarray
    done: np.ndarray
    fct: np.ndarray         # absolute, NaN until done
    rate: np.ndarray = None      # last schedule's per-flow rates
    pend_sent: np.ndarray = None  # sent at the pending-schedule anchor
    queue: int = -1
    deadline: float = math.inf
    running: bool = False
    finished: bool = False
    cct: float = math.nan


class SaathSession:
    """An online Saath coordinator over a fixed fabric.

    `params` are the paper's scheduler knobs; `num_ports` fixes the
    fabric (uniform `params.port_bw` per port). `mechanisms` takes the
    shared ablation switch names (`repro_torch.api.MECHANISM_KEYS`).
    `device` is where the private pool's slab lives: None = CUDA (raises
    without a card), "cpu" = the plain path. A session handed out by
    `SessionPool.session()` takes its params, fabric and device from the
    pool.
    """

    def __init__(self, params: Optional[SchedulerParams] = None, *,
                 num_ports: int, backend: str = "torch",
                 mechanisms: Optional[dict] = None,
                 fidelity: str = "flow", chunk: int = 32,
                 min_coflow_capacity: int = 16,
                 min_flow_capacity: int = 64,
                 topology=None, device=None,
                 _pool=None, _row: Optional[int] = None):
        if backend == "numpy":
            raise NotImplementedError(
                "the numpy session backend needs the host simulator and "
                "policies, which are not ported yet: ROADMAP queue A item "
                "3b; the JAX package has it: repro.api.SaathSession("
                "backend='numpy')")
        if backend != "torch":
            raise ValueError(
                f"unknown backend {backend!r}; available: torch")
        from repro_torch.api.scenario import check_mechanisms
        from repro_torch.fabric.topology import normalize_topology

        mech = check_mechanisms(mechanisms)
        self.num_ports = int(num_ports)
        self.backend = backend
        self.topology = normalize_topology(topology) if _pool is None \
            else _pool.topology

        self._clock = 0.0       # continuous session time
        self._tick = 0          # global δ-grid ticks already scheduled
        self._epoch = 0         # δ-grid tick the slab row is based at
        self._seq = 0           # next handle / global FIFO rank
        self._live: Dict[int, _Entry] = {}
        self._slots: List[_Entry] = []      # slab slot order
        self._flow_lo = self._flow_hi = None
        self._tb_dirty = True   # membership changed -> re-pack
        self._state_dirty = True  # dynamic state changed host-side
        self._host_stale = False  # device row ahead of the host entries
        self._new_done = False  # device row holds unseen completions
        self._host_done = False  # host-side completions awaiting a poll
        # pending capped schedule interval, as GLOBAL tick indices
        # (anchor tick, horizon tick); per-flow anchor rates/sent live
        # in the entries
        self._pend = None

        if _pool is not None:
            self._pool = _pool
            self._row = _row
            self.params = params if params is not None else _pool.params
        else:
            from repro_torch.api.pool import SessionPool

            pool = SessionPool(
                params, num_ports=num_ports, max_sessions=1,
                mechanisms=mech, fidelity=fidelity, chunk=chunk,
                min_coflow_capacity=min_coflow_capacity,
                min_flow_capacity=min_flow_capacity,
                topology=self.topology, device=device)
            pool._adopt(self)
            self._pool = pool
            self._row = 0
            self.params = pool.params

    # ---- public surface --------------------------------------------------

    @property
    def now(self) -> float:
        return self._clock

    @property
    def num_live(self) -> int:
        return len(self._live)

    @property
    def _C_cap(self) -> int:
        return self._pool._C_cap

    @property
    def _F_cap(self) -> int:
        return self._pool._F_cap

    def close(self) -> None:
        """Release this session's pool row (unfinished coflows are
        dropped). The session is unusable afterwards."""
        if self._pool is not None:
            self._pool.release(self)
        self._live.clear()

    def _check_open(self) -> None:
        if self._pool is None:
            raise RuntimeError("session was closed (its pool row was "
                               "released)")

    def submit(self, coflows: Sequence[Coflow]) -> List[int]:
        """Register coflows; returns their session handles. A coflow's
        `arrival` below the current clock is clamped to it (the
        coordinator cannot schedule the past)."""
        self._check_open()
        handles = []
        for cf in coflows:
            src = np.array([f.src for f in cf.flows], np.int32)
            dst = np.array([f.dst for f in cf.flows], np.int32)
            size = np.array([f.size for f in cf.flows], np.float64)
            if src.size == 0:
                raise ValueError("coflow needs at least one flow")
            ports = np.concatenate([src, dst])
            if ((ports < 0) | (ports >= self.num_ports)).any():
                raise ValueError(
                    f"flow port out of range for the {self.num_ports}-"
                    f"port fabric")
            w = src.size
            e = _Entry(
                handle=self._seq, arrival=max(float(cf.arrival),
                                              self._clock),
                rank=self._seq, src=src, dst=dst, size=size,
                sent=np.zeros(w), done=np.zeros(w, bool),
                fct=np.full(w, np.nan), rate=np.zeros(w),
                pend_sent=np.zeros(w))
            self._live[e.handle] = e
            handles.append(e.handle)
            self._seq += 1
        self._tb_dirty = True
        return handles

    def advance(self, dt: float) -> float:
        """Move the session clock by `dt` seconds, scheduling every
        δ-grid tick up to it; returns the new clock."""
        if dt < 0:
            raise ValueError("advance(dt) needs dt >= 0")
        self._check_open()
        self._clock += float(dt)
        n_end = int(math.floor(self._clock / self.params.delta + 1e-9))
        self._pool._advance([(self, n_end)])
        return self._clock

    def poll(self) -> List[CompletedCoflow]:
        """Completed-since-last-poll coflows. Retired slots are reclaimed
        lazily: a finished coflow left packed is a masked no-op to the
        engine, so the slab is re-packed only when the next `submit`
        changes membership. The device row is gathered back to the host
        only when it holds new completions."""
        if self._pool is not None:
            self._pool._materialize(completions_only=True)
        out = []
        for h in list(self._live):
            e = self._live[h]
            if e.finished:
                out.append(CompletedCoflow(handle=h, arrival=e.arrival,
                                           cct=float(e.cct),
                                           fct=e.fct.copy(),
                                           size=e.size.copy()))
                del self._live[h]
        self._host_done = any(e.finished for e in self._live.values())
        return out

    def drain(self, max_seconds: float = 3600.0,
              step: float = 1.0) -> List[CompletedCoflow]:
        """Advance until every submitted coflow has completed (or
        `max_seconds` of virtual time pass); returns all completions."""
        out = self.poll()
        spent = 0.0
        while self._live and spent < max_seconds:
            self.advance(step)
            spent += step
            out += self.poll()
        if self._live:
            raise RuntimeError(
                f"{len(self._live)} coflows unfinished after "
                f"{max_seconds}s of virtual time")
        return out

    def plan_tick(self) -> List[int]:
        """One coordinator tick in wave-planning mode: the admitted
        coflows complete instantly and their handles are returned; the
        clock moves one δ."""
        self._check_open()
        before = self._tick
        admitted = self._planned_admissions()
        self._tick = max(self._tick, before + 1)
        self._clock = max(self._clock, self._tick * self.params.delta)
        self.complete(admitted)
        return admitted

    def snapshot(self) -> Dict[int, dict]:
        """Per-live-coflow scheduler view, keyed by handle: queue,
        starvation deadline, admitted (`running`), finished, bytes sent.
        Materializes this session's device row only."""
        self._check_open()
        self._pool._materialize([self])
        return {h: {"queue": e.queue, "deadline": e.deadline,
                    "running": e.running, "finished": e.finished,
                    "sent": float(np.sum(e.sent))}
                for h, e in self._live.items()}

    def complete(self, handles: Sequence[int]) -> None:
        """Force-complete coflows at the current clock (wave planning /
        external cancellation)."""
        if self._pool is not None:
            # the untouched entries must be fresh before the row's state
            # is rebuilt from them at the next re-pack
            self._pool._materialize([self])
        now = self._clock
        for h in handles:
            e = self._live[h]
            if e.finished:
                continue
            e.sent[:] = e.size
            e.done[:] = True
            e.fct[:] = now
            e.finished = True
            e.cct = now - e.arrival
        if handles:
            self._host_done = True
        self._state_dirty = True
        # the stored schedule (and any capped interval of it) is stale
        self._pend = None

    def _rebuild_table(self) -> FlowTable:
        """The live coflows (slot order = submission order) as a fresh
        FlowTable with arrivals relative to the row epoch; the values of
        the reference's `FlowTable.from_trace` over `Coflow` objects,
        built from the entries' arrays without a per-flow loop."""
        self._slots = list(self._live.values())
        epoch_t = self._epoch * self.params.delta
        C = len(self._slots)
        width = np.array([e.size.size for e in self._slots], np.int32)
        hi = np.cumsum(width, dtype=np.int64).astype(np.int32)
        F = int(hi[-1]) if C else 0

        def cat(name, dtype):
            return np.concatenate([getattr(e, name) for e in self._slots]
                                  ).astype(dtype) if C \
                else np.zeros(0, dtype)

        P = self.num_ports
        return FlowTable(
            num_ports=P, num_coflows=C,
            cid=np.repeat(np.arange(C, dtype=np.int32), width),
            src=cat("src", np.int32), dst=cat("dst", np.int32),
            size=cat("size", np.float64), sent=np.zeros(F),
            rate=np.zeros(F), done=np.zeros(F, bool),
            fct=np.full(F, np.nan), first_sched=np.full(F, np.nan),
            arrival=np.array([e.arrival - epoch_t for e in self._slots],
                             np.float64),
            width=width, active=np.zeros(C, bool),
            finished=np.zeros(C, bool), cct=np.full(C, np.nan),
            flow_lo=(hi - width).astype(np.int32), flow_hi=hi,
            bw_send=np.full(P, self.params.port_bw),
            bw_recv=np.full(P, self.params.port_bw))

    def _planned_admissions(self) -> List[int]:
        live = [e for e in self._live.values() if not e.finished]
        if not live:
            return []
        adm = self._pool._plan_tick(self)
        return [e.handle for i, e in enumerate(self._slots)
                if adm[i] and not e.finished]


__all__ = ["SaathSession", "CompletedCoflow"]
