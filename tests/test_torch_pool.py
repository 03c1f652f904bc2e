"""The port's `SessionPool` against standalone sessions and the JAX
package's pool, on the CPU: the counterparts of `tests/test_pool.py` and
`tests/test_pool_fuzz.py`.

A pooled fleet changes how the slab is stepped (one batched advance for
every row), never the arithmetic: every pooled session's completions are
bit for bit those of the same session run standalone, and the per-coflow
CCTs and FCTs equal the JAX pool's on the same script. Admission, row
recycling, idle rows, single-row advances, the `io` ledger (clean rows
never re-upload; the async control download is charged once per sync
point, the port's loop flag reads apart), per-row epoch re-basing and
per-tenant parameters follow the reference's tests; a seeded fuzz
replays random interleavings of submit / advance / poll / release /
re-admission three ways.
"""
import dataclasses

import numpy as np
import pytest

from repro.api import SessionPool as JaxPool
from repro_torch.api import PoolFullError, SaathSession, SessionPool
from repro_torch.core.coflow import Coflow, Flow
from repro_torch.core.params import SchedulerParams

from tests.test_pool import PARAMS as JPARAMS, PORTS
from tests.test_pool import _coflows as jax_coflows
from tests.test_pool_fuzz import OPS, ROWS, _run_script

PARAMS = SchedulerParams(**dataclasses.asdict(JPARAMS))


def _coflows(seed, n, base=0, spread=2.0):
    """tests/test_pool.py's workload as the port's own objects."""
    return [Coflow(c.cid, c.arrival,
                   [Flow(f.fid, f.src, f.dst, f.size) for f in c.flows])
            for c in jax_coflows(seed, n, base=base, spread=spread)]


def _pool(**kw):
    return SessionPool(PARAMS, num_ports=PORTS, device="cpu", **kw)


def _solo(params=PARAMS):
    return SaathSession(params, num_ports=PORTS, device="cpu")


def _harvest(results, sessions):
    for i, s in enumerate(sessions):
        results[i].update({d.handle: (d.cct, tuple(d.fct))
                           for d in s.poll()})


def _seq_advance(sessions, dt):
    for s in sessions:
        s.advance(dt)


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_bitwise_equals_standalone_and_the_jax_pool(seed):
    """tests/test_pool.py's adversarial script (session 2 admitted
    mid-run, session 0 doubling the shared coflow capacity with a burst,
    session 1 finishing early): the pooled rows equal standalone
    sessions bit for bit, and the JAX pool's CCTs and FCTs."""
    workloads = [(seed, 6, 0, 2.0), (seed + 50, 2, 0, 0.5),
                 (seed + 100, 5, 0, 2.0)]
    burst = (seed + 200, 20, 500, 1.0)

    def script(make_session, advance_all, make_coflows):
        sessions = [make_session(), make_session()]
        results = [dict(), dict(), dict()]
        for s, w in zip(sessions, workloads[:2]):
            s.submit(sorted(make_coflows(*w),
                            key=lambda c: (c.arrival, c.cid)))
        for step in range(200):
            if step == 3:
                s2 = make_session()
                s2.submit(sorted(make_coflows(*workloads[2]),
                                 key=lambda c: (c.arrival, c.cid)))
                sessions.append(s2)
            if step == 5:
                sessions[0].submit(sorted(make_coflows(*burst),
                                          key=lambda c: (c.arrival, c.cid)))
            advance_all(sessions, 0.9)
            _harvest(results, sessions)
            if not any(s.num_live for s in sessions):
                return results
        raise RuntimeError("script failed to drain")

    pool = _pool(max_sessions=4)
    pooled = script(pool.session, lambda s, dt: pool.advance(dt), _coflows)
    assert pool._C_cap >= 26                     # the burst doubled it
    assert pool.io["full_uploads"] >= 2
    solo = script(_solo, _seq_advance, _coflows)
    assert pooled == solo
    jpool = JaxPool(JPARAMS, num_ports=PORTS, max_sessions=4)
    want = script(jpool.session, lambda s, dt: jpool.advance(dt),
                  jax_coflows)
    assert pooled == want


def test_pool_admission_cap_and_row_recycling():
    pool = _pool(max_sessions=2)
    a, b = pool.session(), pool.session()
    assert pool.num_sessions == 2
    with pytest.raises(PoolFullError, match="full"):
        pool.session()
    a.submit(_coflows(3, 2))
    pool.advance(0.5)
    pool.release(a)                  # frees row 0 (drops a's coflows)
    with pytest.raises(RuntimeError, match="closed"):
        a.advance(0.1)
    with pytest.raises(ValueError, match="does not belong"):
        pool.release(a)
    c = pool.session()               # recycled row
    assert c._row == 0 and pool.num_sessions == 2
    c.submit(_coflows(4, 2))
    done = []
    for _ in range(100):
        pool.advance(1.0)
        done += c.poll()
        if not c.num_live:
            break
    assert len(done) == 2 and all(np.isfinite(d.cct) for d in done)
    assert b.num_live == 0 and b.now > 0


def test_pool_idle_sessions_do_not_block_the_fleet():
    pool = _pool(max_sessions=3)
    idle = pool.session()
    busy = pool.session()
    busy.submit(_coflows(7, 3))
    done = []
    for _ in range(100):
        pool.advance(1.0)
        done += busy.poll()
        if not busy.num_live:
            break
    assert len(done) == 3
    assert idle.num_live == 0 and idle.now == busy.now


def test_single_session_advance_leaves_other_rows_unchanged():
    """`advance` on one pooled view moves only its row: every leaf of
    the other row is the same, bit for bit (NaNs included)."""
    pool = _pool(max_sessions=2)
    a, b = pool.session(), pool.session()
    a.submit(_coflows(9, 3))
    b.submit(_coflows(10, 3))
    b.advance(0.7)                               # b mid-run, pending
    _, before = pool.host_view()
    a.advance(200.0)
    _, after = pool.host_view()

    def leaves(t):
        for x in t:
            if isinstance(x, tuple):
                yield from leaves(x)
            elif x is not None:
                yield x

    for x, y in zip(leaves(before), leaves(after)):
        np.testing.assert_array_equal(x[1], y[1])
    assert a.now == 200.0 and b.now == 0.7
    assert len(a.poll()) == 3        # a drained alone
    assert not b.poll()
    b.advance(200.0)
    assert len(b.poll()) == 3


def test_session_advance_past_every_horizon_is_a_no_op():
    """Mid-run, with every lane at its horizon (pending intervals
    armed), `session_advance` changes no leaf of the slab, NaNs
    included, in one step and one flag read."""
    from repro_torch.fabric import engine as eng

    pool = _pool(max_sessions=3)
    for i, s in enumerate([pool.session() for _ in range(3)]):
        s.submit(_coflows(40 + i, 5))
    pool.advance(0.55)
    pool._sync_ctl()
    assert (pool._state.pend_next > pool._state.tick.float()).any()
    before = eng.tree_map(lambda a: a.clone(), pool._state)
    state, steps, reads = eng.session_advance(
        pool._state, pool._tb, pool._ep_stack,
        n_end=pool._ticks.astype(np.float32),
        features=pool._features_now)
    assert steps == reads == 1
    eng.tree_map(lambda a, b: np.testing.assert_array_equal(
        a.numpy(), b.numpy()), state, before)


def test_pool_clean_rows_never_reupload():
    """After the first full upload, advances over clean rows move no
    slab bytes to the device; a submit scatters just its row; host
    mirrors materialize on demand (snapshot), not per advance."""
    pool = _pool(max_sessions=3)
    a, b = pool.session(), pool.session()
    a.submit([Coflow(0, 0.0, [Flow(0, 0, 1, 500.0)])])
    b.submit([Coflow(0, 0.0, [Flow(0, 2, 3, 500.0)])])
    pool.advance(1.0)                     # first _ensure: one full upload
    io = pool.io
    assert io["full_uploads"] == 1
    base_rows, base_bytes = io["row_uploads"], io["upload_bytes"]
    downloads = io["row_downloads"]
    for _ in range(5):
        pool.advance(1.0)                 # clean rows: nothing uploads
    assert io["full_uploads"] == 1
    assert io["row_uploads"] == base_rows
    assert io["upload_bytes"] == base_bytes
    assert io["row_downloads"] == downloads
    a.submit([Coflow(1, a.now, [Flow(1, 1, 2, 500.0)])])  # dirty ONE row
    pool.advance(1.0)
    assert io["full_uploads"] == 1
    assert io["row_uploads"] == base_rows + 1
    downloads = io["row_downloads"]
    assert a.poll() == [] and b.poll() == []     # nothing completed
    assert io["row_downloads"] == downloads
    assert a.snapshot()[0]["sent"] > 0
    assert io["row_downloads"] > downloads
    tb, st = pool.host_view()
    assert isinstance(tb.size, np.ndarray)
    assert int(np.asarray(st.tick).max()) > 0


def test_pool_epoch_rebase_is_per_row():
    """One row ages past REBASE_TICKS and re-bases on its next re-pack
    while its neighbour stays at epoch 0; both keep δ resolution."""
    from repro_torch.api.pool import REBASE_TICKS

    t_off = 2.0 * REBASE_TICKS * PARAMS.delta
    rng = np.random.default_rng(17)

    def workload(base):
        cfs, fid = [], 0
        for c in range(5):
            w = int(rng.integers(1, 4))
            flows = [Flow(fid + i, int(rng.integers(0, PORTS)),
                          int(rng.integers(0, PORTS)),
                          float(rng.integers(4, 60) * 0.25))
                     for i in range(w)]
            fid += w
            cfs.append(Coflow(c, base + 0.25 * int(rng.integers(0, 8)),
                              flows))
        return cfs

    state = rng.bit_generator.state
    base_cfs = workload(0.0)
    rng.bit_generator.state = state
    late_cfs = workload(t_off)

    ref = _solo()
    ref.submit(base_cfs)
    want = {d.handle: (d.cct, tuple(d.fct))
            for d in ref.drain(step=5.0, max_seconds=500.0)}

    pool = _pool(max_sessions=2)
    old, young = pool.session(), pool.session()
    old.advance(t_off)
    old.submit(late_cfs)
    young.submit(base_cfs)
    got_old, got_young = {}, {}
    for _ in range(200):
        pool.advance(5.0)
        got_old.update({d.handle: (d.cct, tuple(np.asarray(d.fct)
                                                - t_off))
                        for d in old.poll()})
        got_young.update({d.handle: (d.cct, tuple(d.fct))
                          for d in young.poll()})
        if not (old.num_live or young.num_live):
            break
    assert not (old.num_live or young.num_live)
    assert old._epoch >= REBASE_TICKS, "the old row never re-based"
    assert young._epoch == 0, "re-basing leaked onto the young row"
    assert got_old == want and got_young == want


def test_pool_heterogeneous_params_bitwise_vs_standalone():
    """Three tenants under three SchedulerParams (pool default, a huge
    start threshold, 2x δ) on one slab equal three standalone sessions
    with their own params, bit for bit."""
    slow = dataclasses.replace(PARAMS, start_threshold=1e9)
    coarse = dataclasses.replace(PARAMS, delta=2e-2)
    trio = [PARAMS, slow, coarse]
    workloads = [_coflows(30 + i, 4) for i in range(3)]

    def drive(sessions, advance_all):
        results = [dict(), dict(), dict()]
        for s, w in zip(sessions, workloads):
            s.submit(sorted(w, key=lambda c: (c.arrival, c.cid)))
        for _ in range(200):
            advance_all(sessions, 0.9)
            _harvest(results, sessions)
            if not any(s.num_live for s in sessions):
                return results
        raise RuntimeError("failed to drain")

    pool = _pool(max_sessions=3)
    pooled_sessions = [pool.session(params=p) for p in trio]
    pooled = drive(pooled_sessions, lambda s, dt: pool.advance(dt))
    solo = drive([_solo(p) for p in trio], _seq_advance)
    assert pooled == solo
    assert all(v["queue"] <= 0 for v in
               pooled_sessions[1].snapshot().values())
    with pytest.raises(ValueError, match="num_queues"):
        _pool(max_sessions=1).session(
            params=dataclasses.replace(PARAMS, num_queues=4))


def test_pool_pinned_features_refuse_a_tenant_outside_them():
    pool = _pool(max_sessions=2, features=(True, True, False))
    pool.session()
    with pytest.raises(ValueError, match="with_ablations"):
        pool.session(mechanisms={"per_flow_threshold": False})
    with pytest.raises(ValueError, match="4-tuple"):
        _pool(features=(True, True))


def test_pool_async_ctl_download_charged_once_at_sync_point():
    """A chain of advances moves no control bytes until the first sync
    point, which downloads (tick, finished) once; the loop's flag reads
    are counted apart under `loop_reads`, at least one per advance."""
    pool = _pool(max_sessions=2)
    a = pool.session()
    a.submit([Coflow(0, 0.0, [Flow(0, 0, 1, 500.0)])])
    pool.advance(0.5)
    base_ctl = pool.io["ctl_bytes"]
    base_disp = pool.io["dispatches"]
    base_reads = pool.io["loop_reads"]
    for _ in range(5):
        pool.advance(0.5)
    assert pool._ctl is not None
    assert pool.io["dispatches"] == base_disp + 5
    assert pool.io["loop_reads"] >= base_reads + 5
    assert pool.io["ctl_bytes"] == base_ctl
    expect = pool._ticks.nbytes + pool._fin.nbytes
    assert a.poll() == []                   # the sync point
    assert pool._ctl is None
    assert pool.io["ctl_bytes"] == base_ctl + expect
    assert a.poll() == []
    assert pool.io["ctl_bytes"] == base_ctl + expect


def test_pool_advance_past_max_rel_ticks_runs_in_legs():
    """One advance spanning more than MAX_REL_TICKS runs in legs, each
    re-packing and re-basing the row, with the control download at each
    leg; the coflow completes as it does under short advances."""
    from repro_torch.api.pool import MAX_REL_TICKS, REBASE_TICKS

    span = 1.5 * MAX_REL_TICKS * PARAMS.delta
    late = [Coflow(0, span - 10.0, [Flow(0, 0, 1, 5.0), Flow(1, 2, 1, 3.0)])]
    out = []
    for step in (span + 50.0, span / 6):
        pool = _pool(max_sessions=1)
        s = pool.session()
        s.submit(late)
        while s.num_live:
            pool.advance(step)
            out += [(d.cct, tuple(d.fct)) for d in s.poll()]
        assert s._epoch >= REBASE_TICKS
        if step > span:
            assert pool.io["ctl_bytes"] > 0 and pool.io["dispatches"] >= 2
    assert len(out) == 2 and out[0] == out[1]


def _script(seed: int):
    """A seeded op script shaped as tests/test_pool_fuzz.py's `scripts`:
    5-10 steps of 0-2 ops each, then a fleet advance of 0.4, 0.9 or 1.7
    seconds."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(int(rng.integers(5, 11))):
        ops = [(OPS[int(rng.integers(len(OPS)))],
                int(rng.integers(ROWS)), int(rng.integers(10_000)))
               for _ in range(int(rng.integers(0, 3)))]
        steps.append((ops, float(rng.choice([0.4, 0.9, 1.7]))))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzzed_interleavings_match_standalone_and_the_jax_pool(seed):
    """Random interleavings (submit, burst past the capacity, poll,
    single-row advance, release, re-admission) replayed by
    tests/test_pool_fuzz.py's `_run_script`: the port's pool equals
    standalone port sessions and the JAX pool, completion for
    completion."""
    steps = _script(seed)
    pool = _pool(max_sessions=ROWS)
    pooled = _run_script(steps, pool.session,
                         lambda live, dt: pool.advance(dt))
    solo = _run_script(steps, _solo, _seq_advance)
    assert pooled == solo, "pooled rows diverged from standalone sessions"
    jpool = JaxPool(JPARAMS, num_ports=PORTS, max_sessions=ROWS)
    want = _run_script(steps, jpool.session,
                       lambda live, dt: jpool.advance(dt))
    assert pooled == want, "the port's pool diverged from the JAX pool"
