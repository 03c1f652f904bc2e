"""The port's online `SaathSession` against its offline replay and the
JAX package's sessions, on the CPU.

On `tests/test_session.py`'s own inputs (`_trace(seed)`, its unit-scale
parameters, 6 ports):

* submitting a trace's coflows at their arrival times reproduces the
  port's offline `run` bit for bit, and the JAX package's
  `SaathSession(backend="jax")` per-coflow CCTs bit for bit; the JAX
  numpy oracle within its own bar (rtol 1e-2, atol 2δ);
* the Aalo-queue ablation online equals the port's offline run bit for
  bit here, and the JAX session bit for bit too (ROADMAP C2);
* slab growth, slot recycling, poll-once, long-horizon re-basing and bad
  input behave as the reference's tests demand; `plan_tick` admits the
  JAX session's handles tick by tick;
* a JAX session row holding a pending capped interval, carried across
  with `from_reference`, finishes in the port's `session_advance` with
  the JAX session's CCTs bit for bit;
* the parts not ported yet raise, naming their ROADMAP queue A item
  (learned-size sessions run: tests/test_torch_sampling.py; the numpy
  session backend: tests/test_torch_policies.py).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.api import SaathSession as JaxSession
from repro.core.params import SchedulerParams as JParams
from repro.fabric.state import FlowTable as JFlowTable
from repro.traces import batch as jbatch
from repro_torch.api import Scenario, SaathSession, SessionPool, run
from repro_torch.core.coflow import Coflow, Flow, Trace
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric import engine
from repro_torch.fabric.state import FlowTable
from repro_torch.fabric.topology import LeafSpine
from repro_torch.traces import batch as pbatch

from tests.test_session import (PARAMS as JPARAMS, PORTS,
                                _replay_online as jax_replay_online,
                                _trace as jax_trace)

PARAMS = SchedulerParams(**dataclasses.asdict(JPARAMS))
ABLATION = {"per_flow_threshold": False}


def _port_trace(tr) -> Trace:
    """The same trace as the port's own objects (no shared classes)."""
    return Trace(tr.num_ports, [
        Coflow(c.cid, c.arrival,
               [Flow(f.fid, f.src, f.dst, f.size) for f in c.flows])
        for c in tr.coflows])


def _replay_online(trace: Trace, **kw) -> np.ndarray:
    """Submit the trace's coflows at their arrival times, polling as it
    goes; return the CCTs in cid order (tests/test_session.py's replay
    on the port)."""
    sess = SaathSession(PARAMS, num_ports=PORTS, device="cpu", **kw)
    ccts = {}
    for c in sorted(trace.coflows, key=lambda c: (c.arrival, c.cid)):
        sess.advance(max(c.arrival - sess.now, 0.0))
        h = sess.submit([c])[0]
        ccts[h] = c.cid
        for d in sess.poll():
            ccts[d.handle] = (ccts[d.handle], d.cct)
    for d in sess.drain(step=5.0, max_seconds=500.0):
        ccts[d.handle] = (ccts[d.handle], d.cct)
    out = np.full(len(trace.coflows), np.nan)
    for cid, cct in ccts.values():
        out[cid] = cct
    return out


def _offline(trace: Trace, mechanisms=None, topology=None) -> np.ndarray:
    return run(Scenario(trace=trace, params=PARAMS, device="cpu",
                        mechanisms=mechanisms,
                        topology=topology)).row_cct()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_online_equals_the_port_offline_run_bitwise(seed):
    tr = _port_trace(jax_trace(seed))
    np.testing.assert_array_equal(_replay_online(tr), _offline(tr))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_online_equals_the_jax_session_bitwise(seed):
    tr = jax_trace(seed)
    np.testing.assert_array_equal(_replay_online(_port_trace(tr)),
                                  jax_replay_online(tr, "jax"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_online_within_the_numpy_oracle_bar(seed):
    tr = jax_trace(seed)
    np.testing.assert_allclose(_replay_online(_port_trace(tr)),
                               jax_replay_online(tr, "numpy"), rtol=1e-2,
                               atol=2 * PARAMS.delta)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ablation_online_bitwise_offline_and_c2_bar_to_jax(seed):
    """The Aalo-queue ablation sums float bytes per coflow, in the JAX
    package's scan order (`ops.prefix_sum`): on the CPU the port's
    online and offline replays agree bit for bit, and so does the JAX
    session (ROADMAP C2, closed)."""
    tr = jax_trace(seed)
    got = _replay_online(_port_trace(tr), mechanisms=ABLATION)
    np.testing.assert_array_equal(
        got, _offline(_port_trace(tr), mechanisms=ABLATION))
    np.testing.assert_array_equal(
        got, jax_replay_online(tr, "jax", mechanisms=ABLATION))


def test_leafspine_maxmin_online_equals_offline_bitwise():
    """The session branch under a leaf-spine fabric with the max-min
    fill (the path of kernel K3)."""
    topo = LeafSpine(hosts_per_leaf=2, oversub=2.0, wc_fill="maxmin")
    tr = _port_trace(jax_trace(1))
    np.testing.assert_array_equal(_replay_online(tr, topology=topo),
                                  _offline(tr, topology=topo))


def test_session_slab_grows_geometrically_and_recycles_slots():
    sess = SaathSession(PARAMS, num_ports=PORTS, device="cpu",
                        min_coflow_capacity=4, min_flow_capacity=64)
    rng = np.random.default_rng(7)

    def burst(k, base):
        cfs = []
        for i in range(k):
            w = int(rng.integers(1, 4))
            flows = [Flow(j, int(rng.integers(0, PORTS)),
                          int(rng.integers(0, PORTS)),
                          float(rng.uniform(1.0, 8.0)))
                     for j in range(w)]
            cfs.append(Coflow(base + i, sess.now, flows))
        return sess.submit(cfs)

    burst(6, 0)                       # > 4 -> capacity doubles to 8
    sess.advance(1.0)
    assert sess._C_cap == 8
    done = sess.drain(step=5.0, max_seconds=500.0)
    assert len(done) == 6
    cap_after_first = sess._C_cap
    for round_ in range(3):           # churn: slots are recycled
        burst(6, 100 * (round_ + 1))
        done = sess.drain(step=5.0, max_seconds=500.0)
        assert len(done) == 6
        assert all(np.isfinite(d.cct) and d.cct > 0 for d in done)
    assert sess._C_cap == cap_after_first, "freed rows were not recycled"
    assert sess._pool.io["full_uploads"] == 1   # grown before the build


def test_session_poll_returns_each_coflow_exactly_once():
    tr = _port_trace(jax_trace(4))
    sess = SaathSession(PARAMS, num_ports=PORTS, device="cpu")
    handles = sess.submit(sorted(tr.coflows, key=lambda c: c.arrival))
    seen = []
    for _ in range(200):
        sess.advance(2.0)
        seen += [d.handle for d in sess.poll()]
        if not sess.num_live:
            break
    assert sorted(seen) == sorted(handles)
    assert len(seen) == len(set(seen))
    assert sess.poll() == []


def test_session_long_horizon_keeps_delta_resolution():
    """A workload 2^21 ticks into virtual time replays bit for bit as
    the same workload at t = 0: re-basing the row epoch keeps δ
    resolution in the f32 slab (tests/test_session.py:132)."""
    from repro_torch.api.pool import REBASE_TICKS

    t_off = 2.0 * REBASE_TICKS * PARAMS.delta
    rng = np.random.default_rng(11)

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
    rng.bit_generator.state = state              # identical draws
    late_cfs = workload(t_off)

    sess0 = SaathSession(PARAMS, num_ports=PORTS, device="cpu")
    sess0.submit(base_cfs)
    want = {d.handle: (d.cct, tuple(d.fct - 0.0))
            for d in sess0.drain(step=5.0, max_seconds=500.0)}

    late = SaathSession(PARAMS, num_ports=PORTS, device="cpu")
    late.advance(t_off)                          # idle, nothing packed
    assert late._epoch == 0
    late.submit(late_cfs)
    got = {d.handle: (d.cct, tuple(np.asarray(d.fct) - t_off))
           for d in late.drain(step=5.0, max_seconds=500.0)}
    assert late._epoch >= REBASE_TICKS
    assert got == want, "long-horizon session lost δ resolution"


def test_session_rejects_bad_input():
    sess = SaathSession(PARAMS, num_ports=4, device="cpu")
    with pytest.raises(ValueError, match="port out of range"):
        sess.submit([Coflow(0, 0.0, [Flow(0, 9, 1, 5.0)])])
    with pytest.raises(ValueError, match="at least one flow"):
        sess.submit([Coflow(0, 0.0, [])])
    with pytest.raises(ValueError, match="dt >= 0"):
        sess.advance(-1.0)
    with pytest.raises(ValueError, match="available: torch"):
        SaathSession(PARAMS, num_ports=4, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="work_conservation"):
        SaathSession(PARAMS, num_ports=4, mechanisms={"wc": True},
                     device="cpu")
    sess.close()
    with pytest.raises(RuntimeError, match="closed"):
        sess.advance(0.1)


@pytest.mark.parametrize("make, match", [
    (lambda: SessionPool(PARAMS, num_ports=4, shards=2, device="cpu"),
     "item 8"),
])
def test_unported_parts_raise_naming_their_item(make, match):
    with pytest.raises(NotImplementedError, match=match):
        make()


def test_session_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SaathSession(PARAMS, num_ports=PORTS)


def test_plan_tick_admits_the_jax_sessions_handles():
    """Wave planning, tick by tick: the port's admitted handles are the
    JAX session's at every tick until the workload is planned out."""
    tr = jax_trace(6, n=10)
    order = sorted(tr.coflows, key=lambda c: (c.arrival, c.cid))
    js = JaxSession(JPARAMS, num_ports=PORTS, backend="jax")
    ps = SaathSession(PARAMS, num_ports=PORTS, device="cpu")
    js.submit(order)
    ps.submit(sorted(_port_trace(tr).coflows,
                     key=lambda c: (c.arrival, c.cid)))
    waves = 0
    for _ in range(400):
        want, got = js.plan_tick(), ps.plan_tick()
        assert got == want and ps.now == js.now
        waves += bool(got)
        assert [d.handle for d in ps.poll()] == \
            [d.handle for d in js.poll()]
        if not js.num_live:
            break
    assert waves >= 3 and not ps.num_live


def test_jax_session_with_pending_horizon_finishes_in_the_port():
    """Advance a JAX session until its row holds a capped interval
    (pend_next > tick), carry `pool.host_view()` across, and finish it
    with the port's `session_advance`: the JAX session's CCTs, bit for
    bit."""
    tr = jax_trace(5)
    js = JaxSession(JPARAMS, num_ports=PORTS, backend="jax")
    js.submit(sorted(tr.coflows, key=lambda c: (c.arrival, c.cid)))
    for _ in range(400):
        js.advance(0.03)
        tb_h, st_h = js._pool.host_view()
        if st_h.pend_next[0] > st_h.tick[0] and \
                not st_h.finished[0].all():
            break
    else:
        pytest.fail("the JAX session never held a pending interval")
    ep = jax.tree_util.tree_map(np.asarray, js._pool._ep_stack)
    tb, ep_t, st = engine.from_reference(tb_h, ep, st_h, device="cpu")
    assert float(st.pend_next[0]) > int(st.tick[0])
    st, steps, reads = engine.session_advance(
        st, tb, ep_t, n_end=int(st_h.tick[0]) + 100_000,
        features=engine.features_for(PARAMS))
    assert bool(st.finished.all()) and steps >= reads >= 1
    want = {d.handle: d.cct
            for d in js.drain(step=5.0, max_seconds=500.0)}
    got = st.cct[0].double().numpy()
    assert want == {h: float(got[h]) for h in want}


def test_pack_row_with_ranks_row_of_and_stack_rows_equal_the_reference():
    tr = jax_trace(2, n=9)
    jt = JFlowTable.from_trace(tr, JPARAMS.port_bw)
    pt = FlowTable.from_trace(_port_trace(tr), PARAMS.port_bw)
    ranks = list(range(100, 100 + len(tr.coflows)))[::-1]
    kw = dict(flow_capacity=64, coflow_capacity=16, port_capacity=PORTS)
    jb, pb = jbatch.empty_batch(2, **kw), pbatch.empty_batch(2, **kw)
    jbatch.pack_row(jb, 1, jt, arrival_rank=ranks)
    pbatch.pack_row(pb, 1, pt, arrival_rank=ranks)
    np.testing.assert_array_equal(pb.arrival_rank[1, :9], ranks)
    jrows = [jbatch.row_of(jb, b) for b in (1, 0)]
    prows = [pbatch.row_of(pb, b) for b in (1, 0)]
    for jr, pr in zip(jrows, prows):
        for name, a, b in zip(jbatch.TraceBatch._fields, jr, pr):
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.shape == b.shape and a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    js, ps = jbatch.stack_rows(jrows), pbatch.stack_rows(prows)
    assert js._fields == ps._fields
    for name in js._fields:
        a, b = getattr(js, name), getattr(ps, name)
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(ValueError, match="at least one row"):
        pbatch.stack_rows([])
