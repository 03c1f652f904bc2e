"""Multi-tenant serving plane: a fleet of `SaathSession`s on one slab.

The port of `repro.api.pool` (968 lines). A `SessionPool` hosts up to
`max_sessions` concurrent online sessions as rows of one batched
`TraceBatch` slab, so that one `fabric.engine.session_advance` steps
every tenant's coordinator at once: the marginal cost of a tenant is one
more lane of the batched tick.

Ownership (reference DESIGN.md §8):

* the pool owns the slab; the authoritative `TraceBatch` and
  `EngineState` tensors stay on the device between advances.
  Membership and state changes (`submit`, `release`, `complete`) mark
  rows dirty, and `_ensure` applies them as dirty-row scatters
  (`engine.scatter_rows` of host-staged `traces.batch.pack_row` rows):
  a clean row never crosses the host-device boundary again. A capacity
  growth is the one full rebuild;
* each `SaathSession` is a view onto one row: it keeps the host truth of
  its tenant and hands every device interaction to the pool. After an
  advance a row's host entries are stale until someone looks (`poll`,
  `snapshot`, a re-pack): `_materialize` then gathers exactly the stale
  rows back (`engine.gather_rows`), and a poll gathers only rows with
  new completions (the `_fresh` index).

Every row carries its own `EngineParams` (thresholds, δ, deadline
factor, the wc/requeue/lcof/per-flow switches): `session(params=...,
mechanisms=...)` admits a tenant under its own configuration, and the
stacked (B,)-leaf parameters ride the same batched tick. All tenants
share the pool's fabric, fidelity and queue count K; the structure
switches (`engine.features_for`) are OR-combined over the admitted rows
unless `features=` pins them at construction.

Rows advance to independent horizons (a per-row `n_end`; a lane at its
horizon is an exact no-op), so a pooled session's CCTs are bit for bit
those of the same session alone. Long-horizon rows re-base their δ-grid
epoch on re-pack past `REBASE_TICKS`, per row, so that f32 slab times
keep δ resolution; one advance never spans more than `MAX_REL_TICKS`
relative ticks (a longer one is split, re-packing between legs).

Deferred control download (the reference's async dispatch): `advance`
parks the device (tick, finished) tensors of its last step and returns;
one download at the next sync point (`_sync_ctl`: a poll, snapshot,
re-pack or `host_view`) covers a whole chain of advances. Only an
advance past `MAX_REL_TICKS` downloads them at once, to decide its
legs. On the card the download goes through
pinned host buffers with a non-blocking copy and an event the host waits
on, as do the row uploads. The port's advance loop runs on the host and
reads a one-element "lanes open" flag after each chunk of event steps, a
synchronization the reference's device-side loop does not have; those
reads are counted apart, under `io["loop_reads"]`.

`pool.io` counts every host-device crossing: full rebuild uploads, row
scatters and gathers, their bytes, the deferred control bytes, the
advances (`dispatches`) and the loop's flag reads.

Not ported: the sharded slab (`shards > 1`, ROADMAP queue A item 8),
non-clairvoyant tenants (item 6), and the reference's
`accounted_transfer` sanitizer carve-outs (item 10).
"""
from __future__ import annotations

import bisect
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import coordinator as co
from repro_torch.core.params import SchedulerParams

# re-base a row's grid epoch at the first re-pack past this relative
# tick: f32 keeps exact integers to 2^24, so re-basing at 2^20 leaves a
# 16x margin
REBASE_TICKS = 1 << 20
# hard per-advance cap on relative ticks: an advance spanning more is
# split into legs, each re-packing and re-basing the row
MAX_REL_TICKS = 1 << 22


def _tree_nbytes(tree) -> int:
    """Bytes of a tree of numpy arrays or tensors (None leaves: 0)."""
    if tree is None:
        return 0
    if isinstance(tree, tuple):
        return sum(_tree_nbytes(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)


class PoolFullError(RuntimeError):
    """The pool is at its admission cap (`max_sessions` live rows)."""


class SessionPool:
    """An admission-capped fleet of `SaathSession`s sharing one
    device-resident slab.

    All sessions share the pool's fabric (`num_ports`, `topology`),
    fidelity and queue count K; each admitted tenant may bring its own
    `SchedulerParams` and mechanism switches. `session()` admits a
    tenant (raising `PoolFullError` when the pool is full); `release()`
    (or `SaathSession.close()`) frees its row for the next one. `device`
    is where the slab lives: None = CUDA (raises without a card), "cpu"
    = the plain path.
    """

    def __init__(self, params: Optional[SchedulerParams] = None, *,
                 num_ports: int, max_sessions: int = 16,
                 mechanisms: Optional[dict] = None,
                 fidelity: str = "flow", chunk: int = 32,
                 min_coflow_capacity: int = 16,
                 min_flow_capacity: int = 64, shards: int = 1,
                 features: Optional[tuple] = None,
                 topology=None, device=None):
        from repro_torch.fabric import engine
        from repro_torch.fabric.topology import (leaf_links_for,
                                                 normalize_topology)

        self._eng = engine
        self.device = engine.resolve_device(device)
        self.num_ports = int(num_ports)
        # the fabric is pinned like num_ports and K: its link layout is
        # part of the slab's shape and wc_maxmin a structure switch
        self.topology = normalize_topology(topology)
        self._Lf = leaf_links_for(self.topology, self.num_ports)
        self.chunk = int(chunk)
        self.max_sessions = int(max_sessions)
        if self.max_sessions <= 0:
            raise ValueError("max_sessions must be positive")
        if shards != 1:
            if shards < 1:
                raise ValueError("shards must be >= 1")
            raise NotImplementedError(
                "the sharded pool (shards > 1) is not ported yet: ROADMAP "
                "queue A item 8")
        self._fidelity = fidelity
        if features is not None and len(features) == 3:
            # (pfw, dyn, abl): the fill switch rides the pool's topology
            features = tuple(features) + (
                getattr(self.topology, "wc_fill", "greedy") == "maxmin",)
        if features is not None and (
                len(features) != 4
                or not all(isinstance(b, (bool, np.bool_))
                           for b in features)):
            raise ValueError(
                "features must be a 4-tuple of bools (per_flow_wc, "
                "with_dynamics, with_ablations, wc_maxmin)")
        self._pinned = tuple(bool(b) for b in features) \
            if features is not None else None

        self.params, self._ep, self._base_features = \
            self._resolve(params or SchedulerParams(), mechanisms)

        self._C_cap = int(min_coflow_capacity)
        self._F_cap = int(min_flow_capacity)
        self._sessions: List[Optional[object]] = [None] * self.max_sessions
        self._free = list(range(self.max_sessions))
        self._blank_rows: set = set()
        self._tb = None        # TraceBatch, device tensors (authoritative)
        self._state = None     # EngineState, device tensors (authoritative)
        self._scratch = None   # 1-row numpy TraceBatch packing stage
        # host control mirrors: per-row relative tick (the no-op horizon
        # of rows an advance does not target) and per-coflow finished
        # flags (so that poll gathers only rows with new completions)
        self._ticks = None     # (B,) np.int32
        self._fin = None       # (B, C) np.bool_
        self._row_ep = [self._ep] * self.max_sessions
        self._row_feat = [self._base_features] * self.max_sessions
        self._ep_stack = None          # stacked (B,)-leaf EngineParams
        self._features_now = self._pinned or self._base_features
        # the parked device ctl of the last advance and the rows
        # awaiting its download
        self._ctl = None               # (tick, finished) | None
        self._pend_rows: dict = {}     # row -> (session, global n_end)
        # sessions whose `_new_done` is set (the completion bitmap)
        self._fresh: set = set()
        # host<->device transfer accounting
        self.io = dict(full_uploads=0, row_uploads=0, row_downloads=0,
                       upload_bytes=0, download_bytes=0, ctl_bytes=0,
                       dispatches=0, loop_reads=0)

    def _resolve(self, params: Optional[SchedulerParams],
                 mechanisms: Optional[dict]) -> tuple:
        """Validate one tenant's (params, mechanisms) against the pool's
        structure; returns (params, host EngineParams, features)."""
        from repro_torch.api.scenario import check_mechanisms

        mech = check_mechanisms(mechanisms)
        p = (params or self.params).with_mechanisms(mech)
        if hasattr(self, "params") and \
                p.num_queues != self.params.num_queues:
            raise ValueError(
                f"per-tenant params must share the pool's num_queues "
                f"(K={self.params.num_queues} is a slab shape); got "
                f"K={p.num_queues}")
        lcof = mech.get("lcof", True)
        per_flow = mech.get("per_flow_threshold", True)
        # raises for a non-clairvoyant re-queue (ROADMAP queue A item 6)
        feat = self._eng.features_for(
            p, fidelity=self._fidelity, lcof=lcof,
            per_flow_threshold=per_flow, topology=self.topology)
        ep = self._eng.EngineParams.from_scheduler(
            p, lcof=lcof, per_flow_threshold=per_flow)
        if self._pinned is not None:
            names = ("per_flow_wc", "with_dynamics", "with_ablations",
                     "wc_maxmin")
            for i, name in enumerate(names):
                if feat[i] and not self._pinned[i]:
                    raise ValueError(
                        f"tenant needs feature {name!r} but the pool "
                        f"pinned features={self._pinned} at construction; "
                        f"pin a superset")
        return p, ep, feat

    # ---- admission -------------------------------------------------------

    @property
    def num_sessions(self) -> int:
        return self.max_sessions - len(self._free)

    @property
    def sessions(self) -> list:
        return [s for s in self._sessions if s is not None]

    def session(self, params: Optional[SchedulerParams] = None,
                mechanisms: Optional[dict] = None):
        """Admit a new tenant session, with its own scheduler parameters
        and mechanism switches when given (pool defaults otherwise);
        raises `PoolFullError` when the pool is at its admission cap."""
        from repro_torch.api.session import SaathSession

        if not self._free:
            raise PoolFullError(
                f"SessionPool is full ({self.max_sessions} sessions); "
                f"release one (or raise max_sessions) to admit more")
        p, ep, feat = self._resolve(params, mechanisms)
        # the tenant's parameter row goes to the device with the next
        # stack: an upload, counted like every other
        self.io["upload_bytes"] += _tree_nbytes(ep)
        row = self._free.pop(0)
        sess = SaathSession(p, num_ports=self.num_ports,
                            topology=self.topology, _pool=self, _row=row)
        self._sessions[row] = sess
        self._blank_rows.discard(row)
        self._row_ep[row] = ep
        self._row_feat[row] = feat
        self._ep_stack = None
        return sess

    def release(self, sess) -> None:
        """Free a session's row (dropping any unfinished coflows); the
        row is recycled for the next admitted tenant."""
        row = sess._row
        if row is None or self._sessions[row] is not sess:
            raise ValueError("session does not belong to this pool")
        self._sessions[row] = None
        self._blank_rows.add(row)
        bisect.insort(self._free, row)
        sess._row = None
        sess._pool = None
        sess._host_stale = False
        sess._new_done = False
        sess._host_done = False
        self._fresh.discard(sess)
        # a parked ctl entry of the freed row is disarmed by the session
        # identity check in `_sync_ctl`
        self._row_ep[row] = self._ep
        self._row_feat[row] = self._base_features
        self._ep_stack = None

    def _adopt(self, sess) -> None:
        """Bind a standalone session as row 0 of this private pool."""
        assert self.max_sessions == 1 and self._free == [0]
        self._free.clear()
        self._sessions[0] = sess

    # ---- fleet stepping --------------------------------------------------

    def advance(self, dt: float) -> float:
        """Move every admitted session's clock by `dt` seconds and
        schedule all their δ-grid ticks in one batched advance (each row
        on its own δ grid); returns `dt`."""
        if dt < 0:
            raise ValueError("advance(dt) needs dt >= 0")
        targets = []
        for s in self.sessions:
            s._clock += float(dt)
            targets.append(
                (s, int(math.floor(s._clock / s.params.delta + 1e-9))))
        self._advance(targets)
        return float(dt)

    def poll(self) -> List[Tuple[object, object]]:
        """Completed-since-last-poll coflows across the fleet, as
        (session, CompletedCoflow) pairs."""
        self._materialize(completions_only=True)
        out = []
        for s in self.sessions:
            out.extend((s, d) for d in s.poll())
        return out

    def completed_sessions(self) -> list:
        """The sessions with completions not yet drained by a poll (new
        device completions or host force-completes): the harvest index
        a server walks, so that a clean tenant costs no host work. A
        sync point of the async contract."""
        self._sync_ctl()
        return [s for s in self.sessions if s._new_done or s._host_done]

    # ---- slab machinery --------------------------------------------------

    def _target_tick(self, s) -> int:
        """The session's tick, or the horizon of a still-parked async
        advance of its row, whichever is later."""
        pend = self._pend_rows.get(s._row)
        if pend is not None and pend[0] is s:
            return max(s._tick, pend[1])
        return s._tick

    def _step(self, ne: np.ndarray):
        """One `session_advance` of the whole slab to the per-row
        relative horizons `ne` (f32); the state stays on the device."""
        self._state, _, reads = self._eng.session_advance(
            self._state, self._tb, self._ep_stack, n_end=ne,
            chunk=self.chunk, features=self._features_now)
        self.io["dispatches"] += 1
        self.io["loop_reads"] += reads

    def _advance(self, targets) -> None:
        """Advance the given (session, global n_end) targets; rows not
        listed keep their tick (exact no-ops in the advance)."""
        work = {}
        for s, n_end in targets:
            if n_end <= self._target_tick(s):
                continue
            if not s._live:
                # nothing on the row: the grid moves on the host
                s._tick = n_end
                continue
            work[s._row] = (s, n_end)
        if not work:
            return
        if all(n_end - s._epoch <= MAX_REL_TICKS
               for s, n_end in work.values()):
            self._dispatch_async(work)
            return
        # a horizon past MAX_REL_TICKS is split into legs (each re-packs
        # and re-bases the epoch), whose decisions read the fresh ctl
        self._sync_ctl()
        while work:
            self._ensure()
            ne = self._ticks.astype(np.float32)
            for r, (s, n_end) in work.items():
                ne[r] = min(n_end, s._epoch + MAX_REL_TICKS) - s._epoch
            self._step(ne)
            tick_h, fin_h = self._download_ctl(self._state.tick,
                                               self._state.finished)
            nxt = {}
            for r, (s, n_end) in work.items():
                s._tick = s._epoch + int(tick_h[r])
                s._host_stale = True
                if (fin_h[r] != self._fin[r]).any():
                    s._new_done = True
                    self._fresh.add(s)
                if s._tick >= n_end or bool(fin_h[r].all()):
                    continue
                s._tb_dirty = True       # re-pack, re-base, go on
                nxt[r] = (s, n_end)
            self._ticks, self._fin = tick_h, fin_h
            work = nxt

    def _dispatch_async(self, work) -> None:
        """Advance and return without the control download: the device
        (tick, finished) of the last step are parked, and a chain of
        advances is downloaded once, at the next sync point. Rows not
        targeted ride on the possibly stale tick mirror as their
        horizon: a stale mirror can only under-ask, and a lane at or
        past its horizon is an exact no-op."""
        self._ensure()
        ne = self._ticks.astype(np.float32)
        for r, (s, n_end) in work.items():
            ne[r] = n_end - s._epoch     # the caller checked the cap
        self._step(ne)
        self._ctl = (self._state.tick, self._state.finished)
        for r, (s, n_end) in work.items():
            s._host_stale = True
            self._pend_rows[r] = (s, n_end)

    def _download(self, tree):
        """A device tree as numpy copies: on the card every leaf goes
        into a pinned buffer by a non-blocking copy, and the host waits
        on one event recorded after the copies."""
        eng = self._eng
        if self.device.type != "cuda":
            return eng.tree_map(lambda a: a.numpy().copy(), tree)
        pinned = eng.tree_map(lambda a: torch.empty(
            a.shape, dtype=a.dtype, pin_memory=True).copy_(
                a, non_blocking=True), tree)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return eng.tree_map(lambda a: a.numpy(), pinned)

    def _download_ctl(self, tick_dev, fin_dev):
        """The (tick, finished) control mirrors as numpy, counted under
        `ctl_bytes`."""
        tick_h, fin_h = self._download((tick_dev, fin_dev))
        self.io["ctl_bytes"] += tick_h.nbytes + fin_h.nbytes
        return tick_h, fin_h

    def _sync_ctl(self) -> None:
        """Consume the deferred control download of the async chain: one
        transfer of the (tick, finished) mirrors covers every advance
        since the last sync. Runs before anything reads or writes the
        host ctl mirrors (poll's completion scan, snapshots, scatters,
        rebuilds, `host_view`)."""
        if self._ctl is None:
            return
        tick_dev, fin_dev = self._ctl
        self._ctl = None
        tick_h, fin_h = self._download_ctl(tick_dev, fin_dev)
        pend, self._pend_rows = self._pend_rows, {}
        short = []
        for r, (s, n_end) in pend.items():
            if s._row != r or self._sessions[r] is not s:
                continue          # released (maybe recycled) row
            s._tick = s._epoch + int(tick_h[r])
            if (fin_h[r] != self._fin[r]).any():
                s._new_done = True
                self._fresh.add(s)
            if s._tick < n_end and not bool(fin_h[r].all()):
                short.append((r, s._tick, n_end))
        self._ticks, self._fin = tick_h, fin_h
        if short:
            raise RuntimeError(
                f"async session_advance stopped short of its horizon on "
                f"rows {short} (step budget exhausted?)")

    def _plan_tick(self, sess) -> np.ndarray:
        """One wave-planning coordinator tick for one session's row; the
        other rows are masked no-ops. Returns the row's admitted mask."""
        self._ensure()
        mask = np.zeros(self.max_sessions, bool)
        mask[sess._row] = True
        self._state, admitted = self._eng.session_plan_tick(
            self._state, self._tb, self._ep_stack,
            features=self._features_now, row_mask=mask)
        self.io["dispatches"] += 1
        adm_all = self._download(admitted)
        self.io["ctl_bytes"] += adm_all.nbytes
        sess._host_stale = True
        self._materialize([sess])
        return adm_all[sess._row]

    def _ensure(self) -> None:
        """Flush host-side changes to the device slab: released rows are
        re-blanked and dirty rows re-packed, both as row scatters; clean
        rows never re-upload. A capacity growth (a row outgrowing the
        shared flow or coflow capacity, grown geometrically) is the one
        full rebuild; row state is carried through the host entries."""
        need_c = need_f = 0
        for s in self.sessions:
            if s._tb_dirty:
                need_c = max(need_c, len(s._live))
                need_f = max(need_f, sum(e.size.size
                                         for e in s._live.values()))
        grew = False
        while self._C_cap < need_c:
            self._C_cap *= 2
            grew = True
        while self._F_cap < need_f:
            self._F_cap *= 2
            grew = True
        if self._ep_stack is None and self._pinned is None:
            feats = [self._base_features] + \
                [self._row_feat[s._row] for s in self.sessions]
            self._features_now = tuple(
                any(f[i] for f in feats) for i in range(4))
        if self._tb is None or grew:
            self._rebuild()
        else:
            self._scatter_dirty()
        if self._ep_stack is None:
            eng = self._eng
            stack = eng.tree_map(lambda *xs: torch.stack(xs),
                                 *self._row_ep)
            self._ep_stack = eng.tree_map(
                lambda x: eng.host_to_device(x.numpy(), self.device),
                stack)

    def _scatter_dirty(self) -> None:
        from repro_torch.traces.batch import row_of, stack_rows

        dirty = [s for s in self.sessions
                 if s._tb_dirty or s._state_dirty]
        if not dirty and not self._blank_rows:
            return
        # re-packing reads the host entries: sync the dirty rows first
        self._materialize(dirty)
        tb_rows, st_rows = [], []
        for r in sorted(self._blank_rows):
            self._blank_scratch()
            tb_rows.append((r, row_of(self._scratch, 0)))
            st_rows.append((r, self._blank_state_row()))
        self._blank_rows.clear()
        for s in dirty:
            if s._tb_dirty:
                self._pack_row_np(self._scratch_tb(), 0, s)
                tb_rows.append((s._row, row_of(self._scratch, 0)))
            st_rows.append((s._row, self._state_row(s)))
            s._state_dirty = False
        for r, row in st_rows:
            self._ticks[r] = int(row.tick)
            self._fin[r] = row.finished
        eng = self._eng
        st_idx = eng.host_to_device(
            np.array([r for r, _ in st_rows], np.int64), self.device)
        st_payload = eng.tree_map(lambda *xs: np.stack(xs),
                                  *[p for _, p in st_rows])
        self.io["upload_bytes"] += _tree_nbytes(st_payload)
        eng.scatter_rows(self._state, st_idx,
                         self._to_slab(st_payload, self._state))
        if tb_rows:
            tb_idx = eng.host_to_device(
                np.array([r for r, _ in tb_rows], np.int64), self.device)
            tb_payload = stack_rows([p for _, p in tb_rows])
            self.io["row_uploads"] += len(tb_rows)
            self.io["upload_bytes"] += _tree_nbytes(tb_payload)
            eng.scatter_rows(self._tb, tb_idx,
                             self._to_slab(tb_payload, self._tb))

    def _to_slab(self, host_tree, like_tree):
        """A host tree on the slab's device, each leaf in the dtype of
        its slab counterpart (index leaves are int64 there)."""
        return self._eng.tree_map(
            lambda a, like: self._eng.host_to_device(
                np.asarray(a), self.device).to(like.dtype),
            host_tree, like_tree)

    def _scratch_tb(self):
        from repro_torch.traces.batch import empty_batch

        if self._scratch is None:
            self._scratch = empty_batch(
                1, flow_capacity=self._F_cap,
                coflow_capacity=self._C_cap,
                port_capacity=self.num_ports, leaf_links=self._Lf)
        return self._scratch

    def _blank_scratch(self):
        from repro_torch.traces.batch import blank_row

        blank_row(self._scratch_tb(), 0)

    def _rebuild(self) -> None:
        """Full-slab rebuild (first build, or a capacity growth): pack
        every row on the host and upload the whole slab once, the only
        path that moves full mirrors to the device."""
        from repro_torch.traces.batch import empty_batch, to_device

        self._materialize()
        self._scratch = None
        tb = empty_batch(self.max_sessions, flow_capacity=self._F_cap,
                         coflow_capacity=self._C_cap,
                         port_capacity=self.num_ports,
                         leaf_links=self._Lf)
        rows = [self._blank_state_row() for _ in range(self.max_sessions)]
        self._blank_rows.clear()
        for s in self.sessions:
            s._tb_dirty = True
            self._pack_row_np(tb, s._row, s)
            rows[s._row] = self._state_row(s)
            s._state_dirty = False
        eng = self._eng
        state = eng.tree_map(lambda *xs: np.stack(xs), *rows)
        self.io["full_uploads"] += 1
        self.io["upload_bytes"] += _tree_nbytes(tb) + _tree_nbytes(state)
        self._tb = to_device(tb, self.device)
        self._state = eng.tree_map(
            lambda a: eng.host_to_device(a, self.device), state)
        self._ticks = state.tick.copy()
        self._fin = state.finished.copy()

    def _pack_row_np(self, tb, r: int, s) -> None:
        """Pack one session's live coflows into row `r` of a numpy
        TraceBatch (the 1-row scratch for scatters, the full slab for
        rebuilds), re-basing the row's grid epoch when due."""
        from repro_torch.traces.batch import pack_row

        if s._tick - s._epoch >= REBASE_TICKS:
            # re-base the row's grid epoch: slab times are stored
            # relative to it, restoring δ resolution in f32
            s._epoch = s._tick
        table = s._rebuild_table()
        pack_row(tb, r, table, arrival_rank=[e.rank for e in s._slots],
                 topology=self.topology if self._Lf else None)
        s._flow_lo = table.flow_lo.copy()
        s._flow_hi = table.flow_hi.copy()
        s._tb_dirty = False

    def _blank_state_row(self):
        C, F = self._C_cap, self._F_cap
        return self._eng.EngineState(
            coord=co.CoordState(np.full((C,), -1, np.int64),
                             np.full((C,), np.inf, np.float32),
                             np.zeros((C,), bool)),
            sent=np.zeros((F,), np.float32),
            done=np.ones((F,), bool),
            fct=np.zeros((F,), np.float32),
            finished=np.ones((C,), bool),
            cct=np.full((C,), np.nan, np.float32),
            t0=np.float32(0.0),
            tick=np.int32(0),
            rate=np.zeros((F,), np.float32),
            pend_sent=np.zeros((F,), np.float32),
            pend_tick=np.float32(0.0),
            pend_next=np.float32(0.0))

    def _state_row(self, s):
        """One row of engine state rebuilt from the session's host
        entries (the carry that survives re-packs), as unbatched numpy
        arrays ready to scatter; pads and retired slots stay blank:
        done/finished, zero rates (reference `pool.py:805-871`)."""
        row = self._blank_state_row()
        epoch_t = s._epoch * s.params.delta
        for i, e in enumerate(s._slots):
            lo, hi = s._flow_lo[i], s._flow_hi[i]
            row.sent[lo:hi] = e.sent
            row.done[lo:hi] = e.done
            row.fct[lo:hi] = np.where(
                e.done, np.nan_to_num(e.fct) - epoch_t, 0.0)
            row.finished[i] = e.finished
            row.cct[i] = e.cct
            row.coord.queue[i] = e.queue
            row.coord.deadline[i] = e.deadline - epoch_t \
                if np.isfinite(e.deadline) else np.inf
            row.coord.running[i] = e.running
            row.rate[lo:hi] = e.rate
            row.pend_sent[lo:hi] = e.pend_sent
        row = row._replace(tick=np.int32(s._tick - s._epoch))
        if s._pend is not None:
            row = row._replace(
                pend_tick=np.float32(s._pend[0] - s._epoch),
                pend_next=np.float32(s._pend[1] - s._epoch))
        return row

    def _materialize(self, sessions=None,
                     completions_only: bool = False) -> None:
        """Gather the stale rows of the device state back into their
        sessions' host entries, in one gather (absolute f64 times rebuilt
        from the row epochs). `sessions` restricts the sync to the rows a
        caller inspects; `completions_only` (the poll fast path) syncs
        only rows whose control mirror shows new completions. A sync
        point of the async contract."""
        if self._state is None:
            return
        self._sync_ctl()
        if completions_only and not self._fresh:
            return
        stale = [s for s in (self.sessions if sessions is None
                             else sessions)
                 if s._host_stale
                 and (s._new_done or not completions_only)]
        if not stale:
            return
        eng = self._eng
        idx = eng.host_to_device(np.array([s._row for s in stale],
                                          np.int64), self.device)
        host = self._download(eng.gather_rows(self._state, idx))
        self.io["row_downloads"] += len(stale)
        self.io["download_bytes"] += _tree_nbytes(host)
        for j, s in enumerate(stale):
            self._sync_row(s, host, j)
            s._host_stale = False
            s._new_done = False
            self._fresh.discard(s)

    def _sync_row(self, s, st, j: int) -> None:
        """Mirror row `j` of the gathered host state into session `s`'s
        entries, absolute f64 times rebuilt from the row epoch
        (reference `pool.py:910-947`)."""
        epoch_t = s._epoch * s.params.delta
        sent = np.asarray(st.sent[j], np.float64)
        done = np.asarray(st.done[j])
        fct = np.asarray(st.fct[j], np.float64)
        finished = np.asarray(st.finished[j])
        cct = np.asarray(st.cct[j], np.float64)
        queue = np.asarray(st.coord.queue[j])
        deadline = np.asarray(st.coord.deadline[j], np.float64)
        running = np.asarray(st.coord.running[j])
        rate = np.asarray(st.rate[j], np.float64)
        pend_sent = np.asarray(st.pend_sent[j], np.float64)
        for i, e in enumerate(s._slots):
            lo, hi = s._flow_lo[i], s._flow_hi[i]
            e.sent = sent[lo:hi].copy()
            e.done = done[lo:hi].copy()
            e.fct = np.where(e.done, fct[lo:hi] + epoch_t, np.nan)
            e.rate = rate[lo:hi].copy()
            e.pend_sent = pend_sent[lo:hi].copy()
            e.finished = bool(finished[i])
            e.cct = float(cct[i])
            e.queue = int(queue[i])
            e.deadline = float(deadline[i] + epoch_t)
            e.running = bool(running[i])
        tick_rel = int(st.tick[j])
        s._tick = s._epoch + tick_rel
        self._ticks[s._row] = tick_rel        # keep the ctl mirror true
        if not s._host_done and \
                any(e.finished for e in s._live.values()):
            s._host_done = True   # gathered completions await a poll
        pn = float(st.pend_next[j])
        s._pend = (s._epoch + int(st.pend_tick[j]), s._epoch + int(pn)) \
            if pn > tick_rel else None

    # ---- debug/oracle view ----------------------------------------------

    def host_view(self) -> tuple:
        """Numpy copies of the device slab as (TraceBatch, EngineState),
        the lazily built debug and oracle view (the device tensors stay
        authoritative); (None, None) before the first advance."""
        if self._tb is None:
            return None, None
        self._sync_ctl()
        tb_h = self._download(self._tb)
        st_h = self._download(self._state)
        self.io["download_bytes"] += _tree_nbytes(tb_h) + _tree_nbytes(st_h)
        return tb_h, st_h


__all__ = ["SessionPool", "PoolFullError", "REBASE_TICKS",
           "MAX_REL_TICKS"]
