"""The port's counterpart of tests/test_properties.py: the scheduler
invariants on the port's host plane (every registry policy,
`saath-torch` among them, `device="cpu"`). Hypothesis draws are
derandomized, at the reference's example counts or fewer."""
import numpy as np
from hypothesis import given, settings, strategies as st

from repro_torch.core.coflow import Coflow, Flow, Trace
from repro_torch.core.params import SchedulerParams
from repro_torch.core.policies import REGISTRY, make_policy
from repro_torch.core.policies.base import greedy_flow_alloc
from repro_torch.fabric.simulator import Simulator
from repro_torch.fabric.state import FlowTable

PORTS = 6


@st.composite
def traces(draw, max_coflows=8, max_flows=5):
    n = draw(st.integers(1, max_coflows))
    coflows = []
    fid = 0
    for c in range(n):
        arrival = draw(st.floats(0.0, 5.0, allow_nan=False))
        w = draw(st.integers(1, max_flows))
        flows = []
        for _ in range(w):
            src = draw(st.integers(0, PORTS - 1))
            dst = draw(st.integers(0, PORTS - 1))
            size = draw(st.floats(0.5, 20.0, allow_nan=False))
            flows.append(Flow(fid, src, dst, size))
            fid += 1
        coflows.append(Coflow(c, arrival, flows))
    return Trace(num_ports=PORTS, coflows=coflows)


def _bottleneck_bytes(cf) -> float:
    """Max per-port load (bytes) over a coflow's senders and receivers
    (the reference's `Coflow.bottleneck_bytes`)."""
    s = np.zeros(PORTS)
    r = np.zeros(PORTS)
    for f in cf.flows:
        s[f.src] += f.size
        r[f.dst] += f.size
    return float(max(s.max(), r.max()))


PARAMS = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                         growth=4.0, num_queues=5)


def mid_state(trace, frac=0.3):
    """A half-served state: some bytes sent, some flows done."""
    t = FlowTable.from_trace(trace, PARAMS.port_bw)
    rng = np.random.default_rng(0)
    t.sent = t.size * rng.uniform(0, 1, t.size.shape) * frac
    t.active[:] = True
    return t


@given(traces())
@settings(max_examples=60, deadline=None, derandomize=True)
def test_capacity_never_exceeded(trace):
    t = mid_state(trace)
    for name in REGISTRY:
        pol = make_policy(name, PARAMS, device="cpu")
        pol.reset(t)
        rates = pol.schedule(t, 1.0)
        live = t.flow_live()
        assert (rates[~live] == 0).all(), name
        load_s = np.bincount(t.src, weights=rates, minlength=PORTS)
        load_r = np.bincount(t.dst, weights=rates, minlength=PORTS)
        # 1e-6 relative slack: saath-torch's tick runs in f32
        assert (load_s <= PARAMS.port_bw * (1 + 1e-6)).all(), name
        assert (load_r <= PARAMS.port_bw * (1 + 1e-6)).all(), name


@given(traces())
@settings(max_examples=60, deadline=None, derandomize=True)
def test_all_or_none_equal_rates(trace):
    """With WC off, every coflow's live flows get one equal rate or none
    (all-or-none + MADD equal-rate D2)."""
    t = mid_state(trace)
    pol = make_policy("saath", PARAMS, device="cpu",
                      work_conservation=False)
    pol.reset(t)
    rates = pol.schedule(t, 1.0)
    live = t.flow_live()
    for c in range(t.num_coflows):
        lo, hi = t.flow_lo[c], t.flow_hi[c]
        r = rates[lo:hi][live[lo:hi]]
        if r.size == 0:
            continue
        assert (r == 0).all() or (r > 0).all(), "partial coflow scheduled"
        if (r > 0).all():
            np.testing.assert_allclose(r, r[0], rtol=1e-9)


@given(traces())
@settings(max_examples=60, deadline=None, derandomize=True)
def test_work_conservation_no_idle_pair(trace):
    """After Saath's schedule, every live flow faces at least one
    saturated port (otherwise WC would have given it bandwidth)."""
    t = mid_state(trace)
    pol = make_policy("saath", PARAMS, device="cpu")
    pol.reset(t)
    rates = pol.schedule(t, 1.0)
    live = t.flow_live()
    avail_s = PARAMS.port_bw - np.bincount(t.src, weights=rates,
                                           minlength=PORTS)
    avail_r = PARAMS.port_bw - np.bincount(t.dst, weights=rates,
                                           minlength=PORTS)
    slack = np.minimum(avail_s[t.src], avail_r[t.dst])
    assert (slack[live & (rates <= 0)] <= 1e-9).all()


@given(traces(), st.sampled_from(sorted(REGISTRY)))
@settings(max_examples=40, deadline=None, derandomize=True)
def test_simulation_completes_and_conserves(trace, name):
    table = FlowTable.from_trace(trace, PARAMS.port_bw)
    res = Simulator(PARAMS).run(table,
                                make_policy(name, PARAMS, device="cpu"))
    t = res.table
    assert t.finished.all()
    assert t.done.all()
    np.testing.assert_allclose(t.sent, t.size, rtol=1e-9)
    # CCT lower bound: the coflow's bottleneck-port bytes at 1 byte/s,
    # minus grid quantization slack
    for c, cf in enumerate(sorted(trace.coflows, key=lambda c: c.cid)):
        lb = _bottleneck_bytes(cf) / PARAMS.port_bw
        assert t.cct[c] >= lb - 2 * PARAMS.delta - 1e-9
        # FCTs lie within [arrival, makespan]
        lo, hi = t.flow_lo[c], t.flow_hi[c]
        assert (t.fct[lo:hi] >= t.arrival[c] - 1e-9).all()


@given(traces())
@settings(max_examples=40, deadline=None, derandomize=True)
def test_queue_index_monotone_without_dynamics(trace):
    params = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                             growth=4.0, num_queues=5,
                             dynamics_requeue=False)
    table = FlowTable.from_trace(trace, params.port_bw)
    pol = make_policy("saath", params, device="cpu")

    seen = {}

    orig = pol._assign_queues

    def spy(table, now):
        q = orig(table, now)
        for c in np.nonzero(table.active)[0]:
            if c in seen:
                assert q[c] >= seen[c], "queue moved up without dynamics"
            seen[c] = q[c]
        return q

    pol._assign_queues = spy
    Simulator(params).run(table, pol)


@given(traces())
@settings(max_examples=40, deadline=None, derandomize=True)
def test_greedy_alloc_matches_sequential(trace):
    """Round-based vectorized greedy == the one-at-a-time reference."""
    t = mid_state(trace)
    live = t.flow_live()
    order = np.argsort(t.size, kind="stable")

    fast = greedy_flow_alloc(t, order, live)

    rates = np.zeros(t.size.shape[0])
    avail_s = t.bw_send.copy()
    avail_r = t.bw_recv.copy()
    for f in order:
        if not live[f]:
            continue
        r = min(avail_s[t.src[f]], avail_r[t.dst[f]])
        if r <= 0:
            continue
        rates[f] = r
        avail_s[t.src[f]] -= r
        avail_r[t.dst[f]] -= r
    np.testing.assert_allclose(fast, rates, rtol=1e-12)
