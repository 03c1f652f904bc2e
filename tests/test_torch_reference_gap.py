"""ROADMAP C13: two draws on which the JAX package's own planes split.

`tests/test_jax_coordinator.py::test_full_sim_close_to_numpy` (a
hypothesis test of the reference alone) holds the reference's `saath-jax`
replay to its numpy `saath` replay at 1% + 2δ of the avg CCT. Some draws
break that bar. These are two of them, kept here as fixed traces:

* ``issue``: found by hypothesis with a fresh example database; the
  numpy plane takes 51 steps, `saath-jax` 52, and coflows 1 and 2 swap
  their completion order;
* ``saved``: the draw a working tree's `.hypothesis/examples/` kept and
  replayed in every later run there; both planes take 62 steps, and
  coflow 4 finishes at 6.52 s on the numpy plane, 9.51 s on `saath-jax`.

The causes, found by logging both planes' schedules (queues,
deadlines, rates) until they first part:

* ``issue``: at t = 6.5 flow 9 (0.99999 bytes) of coflow 2 finishes, so
  the §4.3 re-queue places the coflow by m̂ · N_c = 0.99999 · 4, widened
  by (1 + CROSS_EPS) against Q_0 = 4. In f64 (the numpy plane) that is
  3.9999999996: queue 0. In f32 (the jitted tick) it rounds to exactly
  4.0: queue 1, with a new starvation deadline. Coflow 2 then ranks
  behind coflow 1 on `saath-jax` only, and the two swap;
* ``saved``: coflow 3's starvation deadline is 6.46 in f64 and
  6.460000038 in the tick's f32; the simulator takes the deadline as an
  event instant and puts the f32 one on the next δ tick, 6.47 (the
  mechanism of ROADMAP C12, here inside the reference's own pair).

On each, the port reproduces each reference plane: its numpy `saath`
equals the reference's numpy `saath` bit for bit (steps, CCTs, FCTs), and
its `saath-torch` takes `saath-jax`'s steps with CCTs within C12's bar
(rtol 1e-2, atol 2δ). The split itself is the reference's; the test
records its size, so that a change on either side shows here first.
"""
import numpy as np
import pytest

from repro.api import Scenario as JScenario, run as jrun
from repro.core.coflow import Coflow as JCoflow, Flow as JFlow, \
    Trace as JTrace
from repro.core.params import SchedulerParams as JParams
from repro_torch.api import Scenario, run
from repro_torch.core.params import SchedulerParams

from tests.test_properties import PARAMS as JPARAMS
from tests.test_torch_policies import _port_trace

PARAMS = SchedulerParams(**{k: getattr(JPARAMS, k)
                            for k in JParams.__dataclass_fields__})


def _trace(num_ports, coflows):
    return JTrace(num_ports=num_ports, coflows=[
        JCoflow(cid=cid, arrival=arrival,
                flows=[JFlow(*f) for f in flows])
        for cid, arrival, flows in coflows])


# (cid, arrival, [(fid, src, dst, size), ...])
DRAWS = {
    "issue": _trace(6, [
        (0, 4.927559615844634, [(0, 0, 0, 6.896063499458637),
                                (1, 0, 0, 9.713579477159696),
                                (2, 0, 0, 1.877521865424336),
                                (3, 0, 0, 1.2824685391964386)]),
        (1, 0.299617510613508, [(4, 0, 2, 0.5),
                                (5, 0, 0, 19.85877230327891)]),
        (2, 0.8339528758614729, [(6, 0, 0, 2.838691690465809),
                                 (7, 0, 0, 18.2062532085972),
                                 (8, 0, 0, 0.5), (9, 5, 0, 0.99999)]),
        (3, 0.0, [(10, 0, 0, 13.404376447337274)]),
        (4, 0.0, [(11, 0, 0, 0.5)]),
        (5, 0.0, [(12, 0, 0, 0.5)]),
        (6, 0.0, [(13, 0, 1, 0.5)])]),
    "saved": _trace(6, [
        (0, 4.969267477818247e-190, [(0, 4, 5, 4.742581875167104),
                                     (1, 1, 3, 9.053344031960368),
                                     (2, 0, 3, 19.68260898299802)]),
        (1, 0.17340305036783968, [(3, 4, 4, 16.981597407108175),
                                  (4, 0, 0, 0.95)]),
        (2, 2.5004180022989737, [(5, 0, 0, 3.8362512805809788),
                                 (6, 1, 3, 8.292981271816286),
                                 (7, 2, 3, 14.952923099829587),
                                 (8, 3, 0, 14.296093373362476),
                                 (9, 5, 0, 3.488761897133401)]),
        (3, 1.6527574641471434, [(10, 0, 4, 1.0), (11, 0, 0, 1.0),
                                 (12, 0, 1, 1.0), (13, 0, 0, 1.0),
                                 (14, 0, 0, 1.0)]),
        (4, 0.0, [(15, 2, 5, 2.0), (16, 2, 0, 2.0), (17, 0, 5, 4.0)]),
        (5, 0.0, [(18, 0, 0, 0.5)]),
        (6, 3.107058139338666, [(19, 1, 2, 1.0), (20, 0, 1, 1.9375),
                                (21, 3, 2, 19.0), (22, 3, 0, 4.625)])]),
}
# what the reference's two planes give on each draw (this image's CPU):
# (numpy steps, saath-jax steps, numpy avg CCT, saath-jax avg CCT)
REFERENCE = {
    "issue": (51, 52, 33.16324068105526, 32.71038353352908),
    "saved": (62, 62, 22.568118023873783, 23.008927539006574),
}


def _planes(name):
    jt = DRAWS[name]
    pt = _port_trace(jt)
    ref = {p: jrun(JScenario(engine="numpy", policy=p, trace=jt,
                             params=JPARAMS))
           for p in ("saath", "saath-jax")}
    port = {p: run(Scenario(engine="numpy", policy=p, trace=pt,
                            params=PARAMS, device="cpu"))
            for p in ("saath", "saath-torch")}
    return ref, port


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_port_numpy_saath_equals_the_reference_bitwise(name):
    ref, port = _planes(name)
    got, want = port["saath"], ref["saath"]
    assert got.steps == want.steps
    np.testing.assert_array_equal(got.cct, want.cct)
    np.testing.assert_array_equal(got.fct, want.fct)
    np.testing.assert_array_equal(got.sent, want.sent)


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_port_saath_torch_tracks_saath_jax(name):
    ref, port = _planes(name)
    got, want = port["saath-torch"], ref["saath-jax"]
    assert got.steps == want.steps
    np.testing.assert_allclose(got.cct, want.cct, rtol=1e-2,
                               atol=2 * PARAMS.delta)


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_reference_planes_split_on_the_draw(name):
    """The gap between the reference's planes, as measured: beyond the
    1% + 2δ bar of `test_full_sim_close_to_numpy`."""
    ref, _ = _planes(name)
    steps_np, steps_jax, avg_np, avg_jax = REFERENCE[name]
    a = float(np.nanmean(ref["saath"].cct))
    b = float(np.nanmean(ref["saath-jax"].cct))
    assert (a, b) == pytest.approx((avg_np, avg_jax), rel=1e-12)
    assert (ref["saath"].steps, ref["saath-jax"].steps) == \
        (steps_np, steps_jax)
    assert abs(b - a) > 1e-2 * a + 2 * PARAMS.delta


def test_issue_draw_requeue_value_lands_on_q0_in_f32_only():
    """The arithmetic of the ``issue`` draw's split: the re-queue value
    of coflow 2 sits under Q_0 in f64 and on it in f32."""
    from repro_torch.core.queues import CROSS_EPS

    m, width, q0 = 0.99999, 4, PARAMS.thresholds()[0]
    assert m * width * (1 + CROSS_EPS) < q0
    f32 = np.float32
    assert f32(m) * f32(width) * (f32(1.0) + f32(CROSS_EPS)) == f32(q0)
