"""The port's coordinator tick against the JAX package's, on the CPU.

`repro_torch.core.coordinator.schedule_tick` (plain PyTorch versions of
both kernels) and `repro.core.jax_coordinator.schedule_tick` (the
contention through its plain reference, the walks as XLA while_loops)
take the same seeded inputs. The integer and ordering outputs must be
equal. Rates are held to rtol 1e-6, plus an absolute 1e-6 of the port
rate: XLA's CPU backend contracts `avail - r * cnt` into a fused
multiply-add while the port (and its CUDA kernel, built with
-fmad=false) rounds the product first, so the capacity left after
admission — a difference of port-sized numbers — may differ by a few
ulps of the port rate, and so may the work-conservation rates drawn
from it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.core import jax_coordinator as jc
from repro.core.params import SchedulerParams as JParams
from repro.core.policies.saath_jax import SaathJax
from repro_torch.core import coordinator as co
from repro_torch.core.params import SchedulerParams

from tests.test_jax_coordinator import mixed_state
from tests.test_properties import PARAMS, mid_state, traces
from tests.test_torch_cuda import UNIT, random_tick_inputs, torch_tick_args

EXACT = ("queue", "admitted", "order", "contention", "expired")
RATES = ("rate", "wc_rate", "wc_flow")


def _port_params(p: JParams) -> SchedulerParams:
    return SchedulerParams(**dataclasses.asdict(p))


def _jax_params(p: SchedulerParams) -> JParams:
    return JParams(**dataclasses.asdict(p))


def _compare(jax_out, jax_state, port_out, port_state, b=0, bw=1.0):
    for k in EXACT:
        np.testing.assert_array_equal(port_out[k][b].numpy(),
                                      np.asarray(jax_out[k]), err_msg=k)
    for k in RATES:
        if jax_out[k] is None:
            assert port_out[k] is None, k
            continue
        np.testing.assert_allclose(port_out[k][b].numpy(),
                                   np.asarray(jax_out[k]), rtol=1e-6,
                                   atol=1e-6 * bw, err_msg=k)
    # XLA's CPU backend contracts `now + df * cq * t_min` into one fused
    # multiply-add; the port rounds the product first, so a deadline may
    # sit 1 ulp away
    np.testing.assert_allclose(port_state.deadline[b].numpy(),
                               np.asarray(jax_state.deadline), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(port_state.queue[b].numpy(),
                                  np.asarray(jax_state.queue))


def _table_tick(table):
    """One tick on a FlowTable through both packages, from the padded
    views the JAX package's `saath-jax` policy builds."""
    pol = SaathJax(PARAMS)
    pol.reset(table)
    batch, flows = pol._views(table)
    js, jout = jc.schedule_tick(jc.init_state(pol._C), batch,
                                jnp.float32(1.0), cp=pol.cp, flows=flows)
    C, F = pol._C, pol._F

    def t(x, dtype):
        return torch.as_tensor(np.array(x)[None]).to(dtype)

    lo = np.full(C, table.flow_hi[-1] if table.num_coflows else 0)
    hi = lo.copy()
    lo[:table.num_coflows] = table.flow_lo
    hi[:table.num_coflows] = table.flow_hi
    i64, f32, b8 = torch.int64, torch.float32, torch.bool
    pbatch = co.CoflowBatch(
        active=t(batch.active, b8), arrival=t(batch.arrival, i64),
        m=t(batch.m, f32), width=t(batch.width, i64),
        cnt_s=t(batch.cnt_s, f32), cnt_r=t(batch.cnt_r, f32),
        bw_s=t(batch.bw_s, f32), bw_r=t(batch.bw_r, f32),
        total=t(batch.total, f32), mixed=t(batch.mixed, b8),
        m_dyn=t(batch.m_dyn, f32))
    pflows = co.FlowView(t(flows.cid, i64), t(flows.src, i64),
                         t(flows.dst, i64), t(flows.live, b8),
                         t(lo, i64), t(hi, i64))
    ps, pout = co.schedule_tick(co.init_state(1, C), pbatch, 1.0,
                                cp=co.CoordParams.from_params(
                                    _port_params(PARAMS)),
                                flows=pflows)
    assert pout["wc_flow"].shape == (1, F)
    _compare(jout, js, pout, ps, bw=PARAMS.port_bw)


@given(traces())
@settings(max_examples=30, deadline=None)
def test_tick_matches_jax_on_half_served_tables(trace):
    _table_tick(mid_state(trace))


@given(traces())
@settings(max_examples=30, deadline=None)
def test_tick_matches_jax_on_mixed_done_live_tables(trace):
    """The §4.3 re-queue inputs are live here (finished and live flows
    in one coflow)."""
    _table_tick(mixed_state(trace))


def _jax_lane(d, b, flows):
    leaf = "cnt_x" in d

    def opt(k):
        return jnp.asarray(d[k][b]) if leaf else None

    batch = jc.CoflowBatch(
        active=jnp.asarray(d["active"][b]),
        arrival=jnp.asarray(d["arrival"][b]),
        m=jnp.asarray(d["m"][b]), width=jnp.asarray(d["width"][b]),
        cnt_s=jnp.asarray(d["cnt_s"][b]), cnt_r=jnp.asarray(d["cnt_r"][b]),
        bw_s=jnp.asarray(d["bw_s"][b]), bw_r=jnp.asarray(d["bw_r"][b]),
        total=jnp.asarray(d["total"][b]), mixed=jnp.asarray(d["mixed"][b]),
        m_dyn=jnp.asarray(d["m_dyn"][b]), cnt_x=opt("cnt_x"),
        bw_x=opt("bw_x"))
    fv = jc.FlowView(jnp.asarray(d["cid"][b]), jnp.asarray(d["src"][b]),
                     jnp.asarray(d["dst"][b]), jnp.asarray(d["live"][b]),
                     up=opt("up"), dn=opt("dn")) if flows else None
    state = jc.CoordState(jnp.asarray(d["queue"][b]),
                          jnp.asarray(d["deadline"][b]),
                          jnp.asarray(d["running"][b]))
    return state, batch, fv


@pytest.mark.parametrize("flows", [True, False])
@pytest.mark.parametrize("params,mech", [
    (UNIT, {}),
    (UNIT, dict(lcof=False, per_flow_threshold=False)),
    (UNIT, dict(work_conservation=False)),
    (SchedulerParams(), {}),
])
def test_batched_tick_matches_jax_per_lane(params, mech, flows):
    """B=3 lanes in one batched port tick equal three JAX ticks: every
    per-trace reduction of the tick stays per lane."""
    B, C, P = 3, 48, 6
    d = random_tick_inputs(B, C, P, seed=len(mech) + 7 * flows,
                           params=params)
    cp = co.CoordParams.from_params(params)._replace(**mech)
    jcp = jc.CoordParams.from_params(_jax_params(params))._replace(**mech)
    state, batch, fv = torch_tick_args(d, "cpu", flows=flows)
    ps, pout = co.schedule_tick(state, batch, float(d["now"]), cp=cp,
                                flows=fv)
    for b in range(B):
        jstate, jbatch, jfv = _jax_lane(d, b, flows)
        js, jout = jc.schedule_tick(jstate, jbatch, jnp.float32(d["now"]),
                                    cp=jcp, flows=jfv)
        _compare(jout, js, pout, ps, b, bw=params.port_bw)


@pytest.mark.parametrize("wc_fill", ["greedy", "maxmin"])
@pytest.mark.parametrize("hosts_per_leaf,oversub", [(4, 4.0), (3, 2.0),
                                                    (5, 1.0)])
def test_leafspine_tick_matches_jax_per_lane(wc_fill, hosts_per_leaf,
                                             oversub):
    """The tick with the leaf-spine link columns (W = 2P + 2Lf) and
    either work-conservation fill, B = 3 lanes, against three JAX ticks:
    queue, order, contention, expiry and admission equal, rates within
    the C1 bar (rtol 1e-6 plus 1e-6 of the port rate)."""
    B, C, P = 3, 48, 10
    d = random_tick_inputs(B, C, P, seed=hosts_per_leaf, params=UNIT,
                           hosts_per_leaf=hosts_per_leaf, oversub=oversub)
    cp = co.CoordParams.from_params(UNIT)
    jcp = jc.CoordParams.from_params(_jax_params(UNIT))
    state, batch, fv = torch_tick_args(d, "cpu")
    ps, pout = co.schedule_tick(state, batch, float(d["now"]), cp=cp,
                                flows=fv, wc_fill=wc_fill)
    assert pout["wc_flow"].any()
    for b in range(B):
        jstate, jbatch, jfv = _jax_lane(d, b, True)
        js, jout = jc.schedule_tick(jstate, jbatch, jnp.float32(d["now"]),
                                    cp=jcp, flows=jfv, wc_fill=wc_fill)
        _compare(jout, js, pout, ps, b, bw=UNIT.port_bw)


def test_leafspine_coflow_fill_matches_jax():
    """fidelity="coflow" on a leaf-spine tick: the coflow-granular fill
    runs its MADD over the link columns too."""
    d = random_tick_inputs(2, 40, 8, seed=3, params=UNIT, hosts_per_leaf=4)
    cp = co.CoordParams.from_params(UNIT)
    jcp = jc.CoordParams.from_params(_jax_params(UNIT))
    state, batch, _ = torch_tick_args(d, "cpu", flows=False)
    ps, pout = co.schedule_tick(state, batch, float(d["now"]), cp=cp)
    for b in range(2):
        jstate, jbatch, _ = _jax_lane(d, b, False)
        js, jout = jc.schedule_tick(jstate, jbatch, jnp.float32(d["now"]),
                                    cp=jcp)
        _compare(jout, js, pout, ps, b, bw=UNIT.port_bw)


def test_one_to_one_links_never_bind_in_the_tick():
    """At 1:1 an uplink's capacity is the sum of its ports', so the link
    columns never bind: the leaf-spine tick equals the big-switch tick
    output by output, bit for bit (greedy fill)."""
    d = random_tick_inputs(3, 48, 8, seed=9, params=UNIT, hosts_per_leaf=4,
                           oversub=1.0)
    cp = co.CoordParams.from_params(UNIT)
    state, batch, fv = torch_tick_args(d, "cpu")
    _, leaf = co.schedule_tick(state, batch, float(d["now"]), cp=cp,
                               flows=fv)
    _, big = co.schedule_tick(state, batch._replace(cnt_x=None, bw_x=None),
                              float(d["now"]), cp=cp,
                              flows=fv._replace(up=None, dn=None))
    for k, v in big.items():
        assert torch.equal(leaf[k], v), k


def test_unknown_wc_fill_raises():
    d = random_tick_inputs(1, 8, 4, seed=0, params=UNIT)
    state, batch, fv = torch_tick_args(d, "cpu")
    with pytest.raises(ValueError, match="wc_fill"):
        co.schedule_tick(state, batch, 1.0,
                         cp=co.CoordParams.from_params(UNIT), flows=fv,
                         wc_fill="random")


def test_table2_random_batch_matches_jax():
    """Table 2's random coordinator batch at (512 coflows, 150 ports),
    generated as benchmarks/table2_coordinator_latency.py does."""
    C, P = 512, 150
    rng = np.random.default_rng(0)
    active = rng.uniform(size=C) < 0.7
    m = rng.uniform(0, 1e8, C).astype(np.float32)
    width = rng.integers(1, 64, C).astype(np.int32)
    cnt_s = ((rng.uniform(size=(C, P)) < 0.05)
             * rng.integers(1, 4, (C, P))).astype(np.float32)
    cnt_r = ((rng.uniform(size=(C, P)) < 0.05)
             * rng.integers(1, 4, (C, P))).astype(np.float32)
    bw = np.full(P, 1e9, np.float32)
    jbatch = jc.CoflowBatch(
        active=jnp.asarray(active), arrival=jnp.arange(C, dtype=jnp.int32),
        m=jnp.asarray(m), width=jnp.asarray(width),
        cnt_s=jnp.asarray(cnt_s), cnt_r=jnp.asarray(cnt_r),
        bw_s=jnp.asarray(bw), bw_r=jnp.asarray(bw))
    js, jout = jc.schedule_tick(jc.init_state(C), jbatch, jnp.float32(1.0),
                                cp=jc.CoordParams.from_params(JParams()))

    def t(x, dtype):
        return torch.as_tensor(np.array(x)[None]).to(dtype)

    pbatch = co.CoflowBatch(
        active=t(active, torch.bool),
        arrival=torch.arange(C)[None], m=t(m, torch.float32),
        width=t(width, torch.int64), cnt_s=t(cnt_s, torch.float32),
        cnt_r=t(cnt_r, torch.float32), bw_s=t(bw, torch.float32),
        bw_r=t(bw, torch.float32))
    ps, pout = co.schedule_tick(co.init_state(1, C), pbatch, 1.0,
                                cp=co.CoordParams.from_params(
                                    SchedulerParams()))
    assert int(pout["admitted"].sum()) > 0
    _compare(jout, js, pout, ps, bw=1e9)
