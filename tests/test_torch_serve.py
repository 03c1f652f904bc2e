"""The port's `CoflowServer` on the CPU: a counterpart of each test of
`tests/test_serve.py` (admission at the row cap, evict-then-reregister
row recycling, per-tenant `Result` isolation, heterogeneous per-tenant
params in one advance, trim-on-poll retention, fault propagation, the
harvest index, quota shedding and deferral), on its own inputs
(`_coflows`, unit-scale parameters, 6 ports).

Where the reference asserts no recompile and no unaccounted transfer,
the port asserts on the pool's `io` ledger: no full upload beyond the
first once the slab is warm.

A parity test drives the same registrations, submissions and advances
through `repro.launch.serve.CoflowServer` and the port's: known tenants
agree bit for bit in `result()`, `aggregates()` and `stats()`, a learned
tenant at ROADMAP C9's bar (rtol 1e-2, atol 2δ).
"""
import dataclasses

import numpy as np
import pytest

from repro.launch import serve as jserve
from repro_torch.api.session import CompletedCoflow
from repro_torch.core.coflow import Coflow, Flow
from repro_torch.core.params import SchedulerParams
from repro_torch.launch.serve import (AdmissionError, CoflowServer,
                                      QuotaExceededError, TenantAggregates,
                                      TenantQuota, TenantResult)

from tests.test_serve import PARAMS as JPARAMS, PORTS
from tests.test_serve import _coflows as jax_coflows

PARAMS = SchedulerParams(**dataclasses.asdict(JPARAMS))


def _coflows(seed, n, base=0, spread=2.0):
    """tests/test_serve.py's workload as the port's own objects."""
    return [Coflow(c.cid, c.arrival,
                   [Flow(f.fid, f.src, f.dst, f.size) for f in c.flows])
            for c in jax_coflows(seed, n, base=base, spread=spread)]


def _server(params=PARAMS, **kw):
    return CoflowServer(params, num_ports=PORTS, device="cpu", **kw)


def _drain(srv, tenants, max_steps=200, step=1.0):
    for _ in range(max_steps):
        srv.advance(step)
        if not any(srv.num_live(t) for t in tenants):
            return
    raise RuntimeError("server failed to drain")


def test_server_evict_then_reregister_recycles_the_row():
    srv = _server(max_tenants=2)
    srv.register("a")
    srv.register("b")
    with pytest.raises(AdmissionError):
        srv.register("c")
    srv.submit("a", _coflows(0, 2))
    srv.submit("b", _coflows(1, 2))
    srv.advance(0.5)                      # a/b mid-flight
    srv.evict("a")                        # drops a's unfinished work
    srv.register("c")                     # the freed row, recycled
    assert srv.occupancy == (2, 2)
    srv.submit("c", _coflows(2, 3))
    _drain(srv, ["b", "c"])
    assert len(srv.poll("c")) == 3
    assert len(srv.poll("b")) == 2        # b rode through the churn
    with pytest.raises(KeyError, match="unknown tenant"):
        srv.poll("a")
    # a second evict/register cycle on the warm slab moves rows, never
    # the whole slab
    uploads = srv.pool.io["full_uploads"]
    srv.evict("c")
    srv.register("d")
    srv.submit("d", _coflows(3, 1))
    _drain(srv, ["b", "d"])
    assert len(srv.poll("d")) == 1
    assert srv.pool.io["full_uploads"] == uploads


def test_server_per_tenant_result_isolation_under_interleaving():
    srv = _server(max_tenants=3)
    for t in ("x", "y", "z"):
        srv.register(t)
    srv.submit("x", _coflows(10, 3))
    srv.submit("y", _coflows(11, 2))
    srv.advance(2.0)
    srv.submit("z", _coflows(12, 4))      # z starts late
    srv.advance(2.0)
    srv.submit("x", _coflows(13, 2, base=100))  # x tops up mid-run
    _drain(srv, ["x", "y", "z"])
    res = {t: srv.result(t) for t in ("x", "y", "z")}
    assert [int(res[t].num_coflows[0]) for t in "xyz"] == [5, 2, 4]
    for t in "xyz":
        assert np.isfinite(res[t].avg_cct[0])
        assert np.isfinite(res[t].makespan[0])
    polls = {t: srv.poll(t) for t in "xyz"}
    assert [len(polls[t]) for t in "xyz"] == [5, 2, 4]
    assert all(srv.poll(t) == [] for t in "xyz")
    for t, n in (("x", 5), ("y", 2), ("z", 4)):
        after = srv.result(t)
        assert int(after.num_coflows[0]) == n
        np.testing.assert_allclose(after.avg_cct, res[t].avg_cct)
        np.testing.assert_allclose(after.makespan, res[t].makespan)


def test_server_heterogeneous_tenant_params_in_one_advance():
    slow = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=1e9,
                           growth=4.0, num_queues=5)
    srv = _server(max_tenants=2)
    srv.register("fast")                      # pool defaults: S = 4.0
    srv.register("slow", params=slow)         # S = 1e9: never demoted
    wl = [Coflow(0, 0.0, [Flow(0, 0, 1, 12.0)])]
    h_fast = srv.submit("fast", wl)[0]
    h_slow = srv.submit("slow", wl)[0]
    d0 = srv.pool.io["dispatches"]
    srv.advance(6.0)
    assert srv.pool.io["dispatches"] == d0 + 1   # one fleet advance
    assert srv._tenants["fast"].snapshot()[h_fast]["queue"] >= 1
    assert srv._tenants["slow"].snapshot()[h_slow]["queue"] == 0
    _drain(srv, ["fast", "slow"])
    assert len(srv.poll("fast")) == 1 and len(srv.poll("slow")) == 1


def test_server_rejects_incompatible_tenant_params():
    srv = _server(max_tenants=2)
    with pytest.raises(ValueError, match="num_queues"):
        srv.register("bad", params=SchedulerParams(num_queues=3))
    assert srv.occupancy == (0, 2)
    srv.register("ok")
    with pytest.raises(ValueError, match="mechanism"):
        srv.register("worse", mechanisms={"wc": True})
    with pytest.raises(ValueError, match="already registered"):
        srv.register("ok")


def test_server_trim_on_poll_keeps_aggregates_stable_and_memory_bounded():
    srv = _server(max_tenants=1, history_limit=8)
    srv.register("t")
    total = 0
    for round_ in range(4):
        srv.submit("t", _coflows(50 + round_, 3, base=10 * round_))
        _drain(srv, ["t"])
        total += 3
        assert len(srv.poll("t")) == 3
        assert srv.stats()["retained"] == 0
        agg = srv.aggregates("t")
        assert agg.coflows == total and agg.trimmed == 0
    res1, res2 = srv.result("t"), srv.result("t")
    assert int(res1.num_coflows[0]) == total
    np.testing.assert_allclose(res1.avg_cct, res2.avg_cct)
    np.testing.assert_allclose(res1.makespan, res2.makespan)
    assert np.isfinite(res1.avg_cct[0]) and res1.avg_cct[0] > 0
    assert isinstance(res1, TenantResult)
    for round_ in range(4):
        srv.submit("t", _coflows(90 + round_, 3, base=100 + 10 * round_))
        _drain(srv, ["t"])
        total += 3
    assert srv.stats()["retained"] <= 8
    agg = srv.aggregates("t")
    assert agg.coflows == total and agg.trimmed == 12 - 8
    assert isinstance(agg, TenantAggregates)
    res = srv.result("t")
    assert int(res.num_coflows[0]) == total and res.cct.shape[1] <= 8
    np.testing.assert_allclose(res.avg_cct[0], agg.cct_sum / agg.coflows)


def test_server_noncap_runtime_error_propagates_untouched(monkeypatch):
    srv = _server(max_tenants=2)

    def boom(*a, **k):
        raise RuntimeError("engine exploded mid-admission")

    monkeypatch.setattr(srv.pool, "session", boom)
    with pytest.raises(RuntimeError, match="engine exploded") as ei:
        srv.register("t")
    assert not isinstance(ei.value, AdmissionError)
    assert srv.rejected == 0 and "t" not in srv.tenants
    monkeypatch.undo()
    srv.register("a")
    srv.register("b")
    with pytest.raises(AdmissionError, match="admission cap"):
        srv.register("c")
    assert srv.rejected == 1


def test_aggregates_zero_flow_completions_yield_nan_makespan():
    agg = TenantAggregates()
    agg.fold([CompletedCoflow(handle=0, arrival=0.0, cct=0.0,
                              fct=np.array([]))])
    assert agg.coflows == 1 and np.isnan(agg.makespan)
    agg.fold([CompletedCoflow(handle=1, arrival=0.0, cct=2.5,
                              fct=np.array([2.5, 1.0]))])
    assert agg.makespan == 2.5


def test_tenant_result_lifts_lifetime_bytes():
    srv = _server(max_tenants=1)
    srv.register("t")
    wl = _coflows(7, 3)
    sent = sum(c.total_bytes for c in wl)
    srv.submit("t", wl)
    _drain(srv, ["t"])
    srv.poll("t")
    res = srv.result("t")
    assert res.cct.shape[1] == 0
    assert int(res.num_coflows[0]) == 3
    np.testing.assert_allclose(res.total_bytes[0], sent)


def test_advance_harvests_only_completed_rows():
    srv = _server(max_tenants=3)
    polls = {t: 0 for t in ("busy", "idle", "empty")}
    for t in polls:
        srv.register(t)
        sess = srv._tenants[t]
        orig = sess.poll

        def counted(t=t, orig=orig):
            polls[t] += 1
            return orig()

        sess.poll = counted
    srv.submit("busy", _coflows(0, 2))
    srv.submit("idle", _coflows(1, 1, spread=0.0))
    steps = 0
    for _ in range(60):
        srv.advance(1.0)
        steps += 1
        if not (srv.num_live("busy") or srv.num_live("idle")):
            break
    assert steps < 60
    assert polls["empty"] == 0
    assert 1 <= polls["busy"] <= 3 and 1 <= polls["idle"] <= 3
    assert len(srv.poll("busy")) == 2 and len(srv.poll("idle")) == 1


def test_quota_reject_sheds_whole_batches():
    srv = _server(max_tenants=2)
    srv.register("q", quota=TenantQuota(max_live_coflows=2))
    srv.register("free")
    wl = _coflows(20, 3)
    with pytest.raises(QuotaExceededError):
        srv.submit("q", wl)
    assert srv.num_live("q") == 0
    assert srv.aggregates("q").shed == 3
    srv.submit("q", wl[:2])
    with pytest.raises(QuotaExceededError):
        srv.submit("q", wl[2:])
    assert srv.aggregates("q").shed == 4
    srv.submit("free", _coflows(21, 6))
    _drain(srv, ["q", "free"])
    assert len(srv.poll("q")) == 2 and len(srv.poll("free")) == 6
    st = srv.stats()
    assert st["shed"] == 4 and st["deferred"] == 0
    with pytest.raises(ValueError, match="policy"):
        TenantQuota(policy="drop")


def test_quota_defer_admits_as_budget_frees():
    srv = _server(max_tenants=1)
    srv.register("d", quota=TenantQuota(max_live_coflows=2,
                                        policy="defer"))
    handles = srv.submit("d", _coflows(30, 6, spread=0.0))
    assert len(handles) == 2 and srv.num_live("d") == 2
    agg = srv.aggregates("d")
    assert agg.deferred == 4 and agg.shed == 0
    assert srv.stats()["deferred_pending"] == 4
    done = 0
    for _ in range(100):
        srv.advance(1.0)
        done += len(srv.poll("d"))
        assert srv.num_live("d") <= 2
        if done:
            break
    assert done
    # steady state: deferred re-admission is row work, no full upload
    uploads = srv.pool.io["full_uploads"]
    for _ in range(300):
        srv.advance(1.0)
        done += len(srv.poll("d"))
        assert srv.num_live("d") <= 2
        if done == 6 and srv.stats()["deferred_pending"] == 0:
            break
    assert done == 6
    assert srv.pool.io["full_uploads"] == uploads
    assert srv.aggregates("d").coflows == 6
    assert srv.aggregates("d").shed == 0


def test_quota_slo_sheds_aged_deferrals_keeping_backlog_bounded():
    srv = _server(max_tenants=1)
    srv.register("o", quota=TenantQuota(max_live_coflows=1, slo=2.0,
                                        policy="defer"))
    srv.submit("o", _coflows(40, 12, spread=0.0))
    agg = srv.aggregates("o")
    assert agg.deferred == 11
    done = 0
    for _ in range(100):
        srv.advance(1.0)
        done += len(srv.poll("o"))
        assert srv.num_live("o") <= 1
        if srv.stats()["deferred_pending"] == 0 and \
                srv.num_live("o") == 0:
            break
    assert srv.stats()["deferred_pending"] == 0
    assert agg.shed > 0
    assert agg.coflows + agg.shed == 12 and done == agg.coflows


def test_server_pinned_sampling_takes_a_learned_tenant():
    """`features=` passes through: a server pinned with sampling admits
    a learned tenant beside a known one; one pinned without refuses."""
    srv = _server(max_tenants=2, features=(True, True, False, False, True))
    srv.register("known")
    srv.register("learned", mechanisms={"clairvoyant": False})
    srv.submit("known", _coflows(60, 3))
    srv.submit("learned", _coflows(60, 3))
    _drain(srv, ["known", "learned"])
    assert len(srv.poll("learned")) == 3
    bare = _server(max_tenants=2, features=(True, True, False, False))
    with pytest.raises(ValueError, match="with_sampling"):
        bare.register("learned", mechanisms={"clairvoyant": False})
    with pytest.raises(NotImplementedError, match="item 8"):
        _server(max_tenants=2, shards=2)


def _script(srv, quota_cls, make_coflows):
    """The same registrations, submissions and advances for either
    package's server: two known tenants (one under a defer quota), one
    learned, an eviction and a re-registration mid-run."""
    srv.register("k0")
    srv.register("k1", quota=quota_cls(max_live_coflows=2,
                                       policy="defer"))
    srv.register("l", mechanisms={"clairvoyant": False})
    srv.submit("k0", make_coflows(70, 4))
    srv.submit("k1", make_coflows(71, 5, spread=1.0))
    srv.submit("l", make_coflows(72, 4))
    for step in range(12):
        srv.advance(0.5)
        if step == 3:
            srv.evict("k0")
            srv.register("k2")
            srv.submit("k2", make_coflows(73, 3, base=10))
    _drain(srv, ["k1", "k2", "l"])
    return ({t: srv.result(t) for t in ("k1", "k2", "l")},
            {t: dataclasses.asdict(srv.aggregates(t))
             for t in ("k1", "k2", "l")}, srv.stats())


def test_server_matches_the_jax_server():
    jres, jagg, jst = _script(
        jserve.CoflowServer(JPARAMS, num_ports=PORTS, max_tenants=3),
        jserve.TenantQuota, jax_coflows)
    res, agg, st = _script(_server(max_tenants=3), TenantQuota, _coflows)
    assert st == jst
    for t in ("k1", "k2"):
        assert agg[t] == jagg[t], t
        for name in ("cct", "fct", "sent", "num_coflows", "avg_cct",
                     "makespan", "total_bytes"):
            np.testing.assert_array_equal(getattr(res[t], name),
                                          getattr(jres[t], name),
                                          err_msg=f"{t} {name}")
    assert agg["l"]["coflows"] == jagg["l"]["coflows"] == 4
    np.testing.assert_allclose(res["l"].cct, jres["l"].cct, rtol=1e-2,
                               atol=2 * PARAMS.delta)
    np.testing.assert_allclose(res["l"].avg_cct, jres["l"].avg_cct,
                               rtol=1e-2, atol=2 * PARAMS.delta)
