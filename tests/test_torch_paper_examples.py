"""The port's counterpart of tests/test_paper_examples.py: the paper's
worked examples through the port's host plane (`run(Scenario(engine=
"numpy", device="cpu"))`), with the reference's expected CCTs.

Fig. 17 (Appendix A): SJF is suboptimal — LCoF beats it 8.33 vs 9.33.
Fig. 8: LCoF's own limitation — 2.83 vs optimal 2.66.
Fig. 4: work conservation recovers the ports all-or-none leaves idle.
Fig. 5: per-flow thresholds transition a partially-served coflow faster.
"""
import numpy as np

from repro_torch.api import Scenario, run
from repro_torch.core.coflow import Coflow, Flow, Trace
from repro_torch.core.params import SchedulerParams


def simulate(trace, policy, params, policy_kwargs=None):
    """Worked examples go through the port's front door."""
    return run(Scenario(policy=policy, engine="numpy", trace=trace,
                        params=params, policy_kwargs=policy_kwargs,
                        device="cpu"))

# 1 byte/s ports; sizes in bytes = durations in seconds.
PARAMS = SchedulerParams(port_bw=1.0, delta=1e-3,
                         start_threshold=1e18,  # keep everything in Q0
                         dynamics_requeue=False)

A, B, X, Y = 0, 1, 2, 3


def fig17_trace():
    """C1: A->X size 5 (k=2). C2: A->Y size 6 (k=1). C3: B->X size 7 (k=1).
    All arrive at t=0."""
    return Trace(num_ports=4, coflows=[
        Coflow(0, 0.0, [Flow(0, A, X, 5.0)]),
        Coflow(1, 0.0, [Flow(1, A, Y, 6.0)]),
        Coflow(2, 0.0, [Flow(2, B, X, 7.0)]),
    ])


def test_fig17_sjf_suboptimal():
    # SCF (= SJF on total bytes): C1 first -> CCTs 5, 11, 12 (avg 9.33)
    res = simulate(fig17_trace(), "scf", PARAMS)
    np.testing.assert_allclose(sorted(res.row_cct()), [5, 11, 12], atol=0.05)
    # Saath/LCoF: C2, C3 first (k=1), C1 waits for both ports -> 6, 7, 12
    res = simulate(fig17_trace(), "saath", PARAMS)
    np.testing.assert_allclose(sorted(res.row_cct()), [6, 7, 12], atol=0.05)
    assert np.nanmean(res.row_cct()) < 8.34  # 8.33 vs SJF's 9.33


def test_fig17_aalo_matches_sjf_order():
    # Aalo: all in Q0, FIFO by arrival (C1 first by id) -> 5, 11, 12
    res = simulate(fig17_trace(), "aalo", PARAMS)
    np.testing.assert_allclose(sorted(res.row_cct()), [5, 11, 12], atol=0.05)


def fig8_trace():
    """LCoF limitation: C1 (two flows of 1.0 across A,B; k=2) vs two
    longer single-flow coflows (2.5 each; k=1)."""
    return Trace(num_ports=4, coflows=[
        Coflow(0, 0.0, [Flow(0, A, X, 1.0), Flow(1, B, Y, 1.0)]),
        Coflow(1, 0.0, [Flow(2, A, X, 2.5)]),
        Coflow(2, 0.0, [Flow(3, B, Y, 2.5)]),
    ])


def test_fig8_lcof_limitation():
    # LCoF schedules the two low-contention 2.5s coflows first: 2.5,2.5,3.5
    res = simulate(fig8_trace(), "saath", PARAMS)
    np.testing.assert_allclose(sorted(res.row_cct()), [2.5, 2.5, 3.5],
                               atol=0.05)
    # total-bytes SCF picks C1 (total 2.0) first: 1, 3.5, 3.5 (the optimum)
    res = simulate(fig8_trace(), "scf", PARAMS)
    np.testing.assert_allclose(sorted(res.row_cct()), [1.0, 3.5, 3.5],
                               atol=0.05)


def fig4_trace():
    """All-or-none can idle ports: C1 holds port A; C2 needs A and B; B
    would idle without work conservation."""
    return Trace(num_ports=4, coflows=[
        Coflow(0, 0.0, [Flow(0, A, X, 2.0)]),
        Coflow(1, 0.0, [Flow(1, A, Y, 2.0), Flow(2, B, Y, 2.0)]),
    ])


def test_fig4_work_conservation_helps():
    no_wc = simulate(fig4_trace(), "saath", PARAMS,
                     policy_kwargs={"work_conservation": False})
    wc = simulate(fig4_trace(), "saath", PARAMS)
    # Without WC, C2 waits for port A entirely: starts at 2, ends at 4.
    # (C2's two flows go to the same receiver Y, so they serialize on Y:
    #  2 + 2 = 4 either way; use distinct receivers to see the pure effect.)
    assert np.nanmean(wc.row_cct()) <= np.nanmean(no_wc.row_cct()) + 1e-6


def fig4b_trace():
    """Same as fig4 but C2's flows go to distinct receivers so WC can
    genuinely overlap the B->Z flow while A is held by C1."""
    Z = 3
    return Trace(num_ports=5, coflows=[
        Coflow(0, 0.0, [Flow(0, A, X, 2.0)]),
        Coflow(1, 0.0, [Flow(1, A, Y, 2.0), Flow(2, B, Z, 2.0)]),
    ])


def test_fig4b_work_conservation_strictly_better():
    no_wc = simulate(fig4b_trace(), "saath", PARAMS,
                     policy_kwargs={"work_conservation": False})
    wc = simulate(fig4b_trace(), "saath", PARAMS)
    # no WC: C2 fully blocked until t=2, CCT(C2)=4. With WC its B->Z flow
    # streams during [0,2): CCT(C2)=2+2=... the A->Y flow still waits, so
    # CCT(C2)=4 BUT the B flow finished at 2 — with per-flow progress the
    # remaining all-or-none admission at t=2 only needs A: CCT stays 4 for
    # A->Y; C2's CCT is driven by its last flow = 4 in both. The win shows
    # up in *other* coflows' slots; here assert WC never hurts and the B
    # port was actually used early.
    assert np.nanmean(wc.row_cct()) <= np.nanmean(no_wc.row_cct()) + 1e-6
    tb = wc.table(0)
    b_flow = 2
    assert tb.fct[b_flow] <= 2.1  # WC streamed it immediately


def test_fig1_out_of_sync_collapse():
    """Fig. 1/13 mechanism: under Saath, flows of an equal-length coflow
    finish (nearly) together; under Aalo they can drift far apart."""
    # Two 2-flow coflows sharing one port: Aalo serves C2's port-A flow
    # after C1 but its port-B flow immediately -> out of sync.
    tr = Trace(num_ports=6, coflows=[
        Coflow(0, 0.0, [Flow(0, A, X, 3.0)]),
        Coflow(1, 0.0, [Flow(1, A, Y, 3.0), Flow(2, B, 5, 3.0)]),
    ])
    aalo = simulate(tr, "aalo", PARAMS)
    saath = simulate(tr, "saath", PARAMS,
                     policy_kwargs={"work_conservation": False})
    t = aalo.table(0)
    drift_aalo = abs(t.fct[1] - t.fct[2])
    t = saath.table(0)
    drift_saath = abs(t.fct[1] - t.fct[2])
    assert drift_aalo > 2.5          # B flow done at 3, A flow at 6
    assert drift_saath < 0.1         # all-or-none keeps them in lockstep


def test_fig5_per_flow_threshold_transitions_faster():
    """Fig. 5: a 4-flow coflow with only 2 flows being served crosses the
    per-flow threshold (Q/N) ~2x sooner than the total-bytes threshold."""
    from repro_torch.core import queues

    p = SchedulerParams(start_threshold=4.0, port_bw=1.0)
    width = np.array([4])
    # two of four flows served for t=1: total=2, max-flow=1
    assert queues.aalo_queue(np.array([2.0]), p)[0] == 0     # 2 < 4
    assert queues.saath_queue(np.array([1.0]), width, p)[0] == 1  # 1*4 >= 4
    # all four served for t=1: total=4 crosses too
    assert queues.aalo_queue(np.array([4.0]), p)[0] == 1


def starvation_trace():
    """C0 spans both port pairs, forever contended by streams of short
    single-flow coflows (C0 always has the higher contention)."""
    flows0 = [Flow(0, A, X, 4.0), Flow(1, B, Y, 4.0)]
    coflows = [Coflow(0, 0.0, flows0)]
    fid = 2
    t = 0.0
    for i in range(1, 40):
        t += 0.25
        coflows.append(Coflow(i, t, [Flow(fid, A, X, 0.5)]))
        fid += 1
        coflows.append(Coflow(100 + i, t, [Flow(fid, B, Y, 0.5)]))
        fid += 1
    return Trace(num_ports=4, coflows=coflows)


def test_starvation_deadline_forces_progress():
    """A high-contention coflow under adversarial arrivals is rescued by
    the FIFO-derived deadline (D5); with deadlines effectively disabled it
    waits for the whole short-coflow stream."""
    from repro_torch.core.policies import make_policy
    from repro_torch.fabric.simulator import Simulator
    from repro_torch.fabric.state import FlowTable

    ccts = {}
    for d in (2.0, 1e9):
        params = SchedulerParams(port_bw=1.0, delta=1e-3,
                                 start_threshold=1.0, growth=2.0,
                                 num_queues=6, deadline_factor=d,
                                 dynamics_requeue=False)
        table = FlowTable.from_trace(starvation_trace(), params.port_bw)
        pol = make_policy("saath", params, device="cpu")
        res = Simulator(params).run(table, pol)
        assert res.table.finished.all()
        ccts[d] = float(res.table.cct[0])
        if d == 2.0:
            assert pol.stats_deadline_hits > 0  # the guarantee actually fired
    assert ccts[2.0] <= ccts[1e9] + 1e-6
