"""The port's counterpart of tests/test_system.py: end-to-end behaviour
of the paper's system on the port's host plane — trace -> schedulers ->
claims, `saath-torch` among them (`device="cpu"`)."""
import numpy as np

from repro_torch.api import Scenario, run
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric.metrics import percentile_speedup
from repro_torch.traces import tiny_trace


def _run(trace, policy, params):
    return run(Scenario(policy=policy, engine="numpy", trace=trace,
                        params=params, device="cpu"))


def test_end_to_end_saath_beats_aalo_tail():
    tr = tiny_trace(60, 24, seed=5)
    p = SchedulerParams()
    aalo = _run(tr, "aalo", p)
    saath = _run(tr, "saath", p)
    assert np.isfinite(saath.row_cct()).all()
    assert np.isfinite(aalo.row_cct()).all()
    s = percentile_speedup(aalo.row_cct(), saath.row_cct())
    # the paper's effect is in the tail; median should not regress much
    assert s["p90"] > 1.0, s
    assert s["p50"] > 0.8, s


def test_online_saath_tracks_offline_varys():
    tr = tiny_trace(60, 24, seed=6)
    p = SchedulerParams()
    varys = _run(tr, "varys-sebf", p)   # clairvoyant
    saath = _run(tr, "saath", p)        # online
    a = float(varys.avg_cct[0])
    b = float(saath.avg_cct[0])
    assert b <= 2.0 * a, (a, b)  # online within 2x of clairvoyant avg


def test_all_policies_agree_on_total_work():
    """Every scheduler moves exactly the trace's bytes (no lost or
    duplicated traffic) regardless of policy."""
    tr = tiny_trace(30, 12, seed=7)
    total = sum(f.size for c in tr.coflows for f in c.flows)
    for pol in ("saath", "saath-torch", "aalo", "uc-tcp", "varys-sebf"):
        res = _run(tr, pol, SchedulerParams())
        assert abs(float(res.sent.sum()) - total) < 1e-6 * total
