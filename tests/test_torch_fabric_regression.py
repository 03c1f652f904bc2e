"""The port's counterpart of tests/test_fabric_regression.py: the
bitwise big-switch contract of the host plane's allocation stack.

`_LegacySaath` below is the reference's frozen copy of the pre-refactor
`Saath.schedule` and `greedy_flow_alloc` (no link handling), copied
verbatim into this file, with the contention count through the port's
`core.contention` (exact integers). Routing the port's allocation stack
through `topology=None` and `topology=BigSwitch()` must reproduce that
legacy trajectory exactly (`fct`, `cct`, `sent`, `rate`), so a fabric
change that perturbs big-switch arithmetic (a reordered min, an extra
subtract, a changed round limit) trips this file. The host plane's
`bind_table` view equals the reference's `ExtraLinks` field by field.
Hypothesis draws are derandomized, at the reference's example counts.
"""
import numpy as np
from hypothesis import given, settings, strategies as st

from repro_torch.core.coflow import Coflow, Flow, Trace
from repro_torch.core.params import SchedulerParams
from repro_torch.core.policies import make_policy
from repro_torch.core.policies.saath import Saath
from repro_torch.fabric.simulator import Simulator
from repro_torch.fabric.state import FlowTable
from repro_torch.fabric.topology import BigSwitch, LeafSpine, bind_table

PORTS = 6
PARAMS = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                         growth=4.0, num_queues=5)


def _legacy_greedy_flow_alloc(table, flow_order, live, avail_s, avail_r,
                              rates):
    """`base.greedy_flow_alloc` as it was before the fabric models (no
    link handling)."""
    src, dst = table.src, table.dst
    ordered = flow_order[live[flow_order]]
    for _ in range(2 * table.num_ports + 2):
        if ordered.size == 0:
            break
        cand = ordered[(avail_s[src[ordered]] > 0.0)
                       & (avail_r[dst[ordered]] > 0.0)]
        if cand.size == 0:
            break
        _, first_s = np.unique(src[cand], return_index=True)
        _, first_r = np.unique(dst[cand], return_index=True)
        is_first_s = np.zeros(cand.size, bool)
        is_first_r = np.zeros(cand.size, bool)
        is_first_s[first_s] = True
        is_first_r[first_r] = True
        take = cand[is_first_s & is_first_r]
        r = np.minimum(avail_s[src[take]], avail_r[dst[take]])
        rates[take] = r
        avail_s[src[take]] -= r
        avail_r[dst[take]] -= r
        ordered = cand[~(is_first_s & is_first_r)]
    return rates


class _LegacySaath(Saath):
    """`Saath` with the pre-refactor `schedule` body frozen verbatim."""

    def schedule(self, table, now):
        from repro_torch.core.contention import contention
        p = self.params
        live = table.flow_live()
        rates = np.zeros(table.size.shape[0])
        if not live.any():
            return rates

        q_new = self._assign_queues(table, now)
        self._refresh_deadlines(table, q_new, now)

        active = table.active.copy()
        A_s, A_r = table.incidence(live)
        k = contention(A_s, A_r, active, device=self.device)
        expired = active & (now >= self._deadline)
        self.stats_deadline_hits += int(expired.sum())

        cids = np.nonzero(active)[0]
        if self.lcof:
            key = [(0, self._deadline[c], 0, 0, table.arrival[c], c)
                   if expired[c] else
                   (1, q_new[c], k[c], int(~self._running[c]),
                    table.arrival[c], c) for c in cids]
        else:
            key = [(0, self._deadline[c], 0, 0, table.arrival[c], c)
                   if expired[c] else
                   (1, q_new[c], table.arrival[c], 0, 0, c) for c in cids]
        order = cids[sorted(range(len(cids)), key=lambda i: key[i])]

        cnt_s, cnt_r = table.flow_counts(live)
        avail_s = table.bw_send.copy()
        avail_r = table.bw_recv.copy()
        admitted = np.zeros(table.num_coflows, bool)
        missed = []
        for c in order:
            cs, cr = cnt_s[c], cnt_r[c]
            ps, pr = cs > 0, cr > 0
            if not ps.any() and not pr.any():
                continue
            r = np.inf
            if ps.any():
                r = min(r, (avail_s[ps] / cs[ps]).min())
            if pr.any():
                r = min(r, (avail_r[pr] / cr[pr]).min())
            if self.all_or_none and r < p.min_rate:
                missed.append(c)
                continue
            if r <= 0.0:
                missed.append(c)
                continue
            lo, hi = table.flow_lo[c], table.flow_hi[c]
            seg = rates[lo:hi]
            seg[live[lo:hi]] = r
            avail_s -= r * cs
            avail_r -= r * cr
            admitted[c] = True
            self.stats_admitted += 1

        if self.work_conservation and missed:
            wc_order = np.concatenate(
                [np.arange(table.flow_lo[c], table.flow_hi[c])
                 for c in missed])
            before = rates > 0
            _legacy_greedy_flow_alloc(table, wc_order, live, avail_s,
                                      avail_r, rates)
            self.stats_wc_flows += int(((rates > 0) & ~before).sum())

        if p.wc_admitted_round:
            for c in order:
                cs, cr = cnt_s[c], cnt_r[c]
                ps, pr = cs > 0, cr > 0
                if not (ps.any() or pr.any()) or c in missed:
                    continue
                r = np.inf
                if ps.any():
                    r = min(r, (avail_s[ps] / cs[ps]).min())
                if pr.any():
                    r = min(r, (avail_r[pr] / cr[pr]).min())
                if not np.isfinite(r) or r <= 0.0:
                    continue
                sel = live & (table.cid == c)
                rates[sel] += r
                avail_s -= r * cs
                avail_r -= r * cr

        self._running = admitted
        return rates


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


def _run(trace, policy, topology=None):
    table = FlowTable.from_trace(trace, PARAMS.port_bw)
    sim = Simulator(PARAMS, topology=topology)
    return sim.run(table, policy)


def _assert_bitwise(res_a, res_b):
    np.testing.assert_array_equal(res_a.table.fct, res_b.table.fct)
    np.testing.assert_array_equal(res_a.table.cct, res_b.table.cct)
    np.testing.assert_array_equal(res_a.table.sent, res_b.table.sent)
    np.testing.assert_array_equal(res_a.table.rate, res_b.table.rate)


@given(traces())
@settings(max_examples=40, deadline=None, derandomize=True)
def test_bigswitch_bitwise_vs_legacy(trace):
    """topology=None AND topology=BigSwitch() through the port's
    allocation stack == the frozen pre-refactor Saath, bitwise."""
    legacy = _run(trace, _LegacySaath(PARAMS, device="cpu"))
    for topo in (None, BigSwitch()):
        cur = _run(trace, make_policy("saath", PARAMS, device="cpu"),
                   topology=topo)
        _assert_bitwise(legacy, cur)


@given(traces())
@settings(max_examples=20, deadline=None, derandomize=True)
def test_bigswitch_bitwise_no_wc(trace):
    """The non-work-conserving ablation path is guarded too (admission
    loop only — the branch fig10's A/N lane runs)."""
    legacy = _run(trace, _LegacySaath(PARAMS, work_conservation=False,
                                      device="cpu"))
    cur = _run(trace, make_policy("saath", PARAMS, device="cpu",
                                  work_conservation=False),
               topology=BigSwitch())
    _assert_bitwise(legacy, cur)


@given(traces(max_coflows=5))
@settings(max_examples=15, deadline=None, derandomize=True)
def test_greedy_policies_bitwise(trace):
    """Order-driven policies (Aalo) route through the port's
    `greedy_flow_alloc`; with no topology the rates must be bitwise the
    legacy allocation."""
    from repro_torch.core.policies.base import greedy_flow_alloc

    table = FlowTable.from_trace(trace, PARAMS.port_bw)
    rng = np.random.default_rng(1)
    table.sent = table.size * rng.uniform(0, 1, table.size.shape) * 0.3
    table.active[:] = True
    live = table.flow_live()
    order = np.argsort(table.arrival[table.cid], kind="stable")
    new = greedy_flow_alloc(table, order, live)
    old = _legacy_greedy_flow_alloc(
        table, order, live, table.bw_send.copy(), table.bw_recv.copy(),
        np.zeros(table.size.shape[0]))
    np.testing.assert_array_equal(new, old)


def test_api_run_bigswitch_bitwise():
    """`api.run` with topology=BigSwitch() == topology omitted, exactly
    (the Scenario field changes the hash, not the numbers)."""
    from repro_torch.api import Scenario, run

    synth = dict(num_coflows=8, num_ports=8, seed=3, max_width=16)
    base = run(Scenario(policy="saath", engine="numpy", synth=synth,
                        device="cpu"))
    topo = run(Scenario(policy="saath", engine="numpy", synth=synth,
                        topology=BigSwitch(), device="cpu"))
    np.testing.assert_array_equal(base.row_cct(), topo.row_cct())
    assert base.scenario.hash() != topo.scenario.hash()


def test_bind_table_equals_the_reference_extra_links():
    """The host plane's leaf-spine view (capacities, per-flow up and
    down link ids, -1 inside a leaf) equals the reference's; the big
    switch binds to None in both."""
    from repro.core.coflow import Coflow as JCoflow, Flow as JFlow
    from repro.core.coflow import Trace as JTrace
    from repro.fabric.state import FlowTable as JFlowTable
    from repro.fabric.topology import LeafSpine as JLeafSpine
    from repro.fabric.topology import bind_table as jbind_table

    rng = np.random.default_rng(2)
    rows = [[(int(rng.integers(0, 10)), int(rng.integers(0, 10)),
              float(rng.uniform(1, 9))) for _ in range(4)]
            for _ in range(5)]
    pt = Trace(10, [Coflow(c, 0.0, [Flow(0, *f) for f in r])
                    for c, r in enumerate(rows)])
    jt = JTrace(10, [JCoflow(c, 0.0, [JFlow(0, *f) for f in r])
                     for c, r in enumerate(rows)])
    table = FlowTable.from_trace(pt, 2.0)
    jtable = JFlowTable.from_trace(jt, 2.0)
    assert bind_table(None, table) is None
    assert bind_table(BigSwitch(), table) is None
    for h, o in ((3, 2.0), (4, 1.0), (1, 4.0)):
        got = bind_table(LeafSpine(h, o), table)
        want = jbind_table(JLeafSpine(h, o), jtable)
        assert got.num_uplinks == want.num_uplinks
        for name in ("cap", "up", "dn"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
