"""The port's figure drivers (`benchmarks/torch_fig*.py`) against the JAX
package on the CPU, at a tiny fabric.

Each driver runs at fb_like_trace(30, 16) (its tiny_trace fleets and
sweeps cut alike), the smallest bench fabric on which every gate of the
reference's drivers still holds, and its gates are asserted as written;
only the fig9 fleet's wall-clock gate is set low (`SAATH_FLEET_MIN_
SPEEDUP`), since on the CPU the batched engine runs the kernels' plain
versions: a speed gate is the card's. Every replay a driver makes goes
through a spy on the port's front door, and is then held to the JAX
package's front door on the same scenario:

* host baselines (the numpy engine) bit for bit: steps, CCTs, FCTs;
* `saath-torch` against the reference's `saath-jax`: steps equal, CCTs
  within C12's bar (rtol 1e-2, atol 2δ);
* Saath on the torch engine against the JAX engine: each row's avg CCT
  within 1% (PERF.md §2).

Records go to a scratch BENCH_torch.json. The other drivers are in
`tests/test_torch_figures_lanes.py` and `tests/test_torch_figures_
planes.py`, the suite runner in `tests/test_torch_figures_suite.py`.
"""
import dataclasses

import numpy as np
import pytest

from repro.api import Scenario as JScenario, run as jrun
from repro.core.coflow import Coflow as JCoflow, Flow as JFlow, \
    Trace as JTrace
from repro.core.params import SchedulerParams as JParams
from repro.fabric.topology import LeafSpine as JLeafSpine

TINY = dict(num_coflows=30, num_ports=16, seed=0)
# the reference's result of each port scenario already checked (by its
# hash and engine), so drivers sharing a replay hold it once
_REFERENCE = {}


def _jp(p):
    return JParams(**dataclasses.asdict(p))


def _jtrace(tr):
    return JTrace(tr.num_ports, [
        JCoflow(c.cid, c.arrival,
                [JFlow(f.fid, f.src, f.dst, f.size) for f in c.flows])
        for c in tr.coflows])


def reference_scenario(sc):
    """The JAX package's counterpart of a port `Scenario`: the torch
    engine becomes the JAX engine, `saath-torch` becomes `saath-jax`,
    and params, traces and fabric are rebuilt from the reference's own
    classes with the same numbers (warm timing off: it moves no CCT)."""
    kw = dict(policy={"saath-torch": "saath-jax"}.get(sc.policy,
                                                      sc.policy),
              engine="jax" if sc.engine == "torch" else sc.engine,
              params=_jp(sc.params), fidelity=sc.fidelity,
              mechanisms=sc.mechanisms, policy_kwargs=sc.policy_kwargs,
              max_jump=sc.max_jump, clairvoyance=sc.clairvoyance,
              label=sc.label)
    if sc.sweep is not None:
        kw["sweep"] = tuple(_jp(p) for p in sc.sweep)
    if sc.topology is not None:
        t = sc.topology
        kw["topology"] = JLeafSpine(t.hosts_per_leaf, t.oversub, t.wc_fill)
    if sc.synth is not None:
        kw["synth"] = dict(sc.synth)
    elif sc.trace is not None:
        kw["trace"] = _jtrace(sc.trace)
    else:
        kw["traces"] = tuple(_jtrace(t) for t in sc.traces)
    return JScenario(**kw)


def hold_to_reference(calls):
    """Hold every recorded (port Scenario, Result) to the reference's
    run of the same scenario; returns {engine: replays checked}."""
    seen = {"numpy": 0, "torch": 0}
    for sc, got in calls:
        key = (sc.hash(), sc.engine)
        if key not in _REFERENCE:
            _REFERENCE[key] = jrun(reference_scenario(sc))
        want = _REFERENCE[key]
        what = f"{sc.policy}[{sc.engine}]/{sc.label}"
        assert got.cct.shape == want.cct.shape, what
        if sc.engine == "torch":
            np.testing.assert_allclose(got.avg_cct, want.avg_cct,
                                       rtol=1e-2, err_msg=what)
        elif sc.policy == "saath-torch":
            assert got.steps == want.steps, what
            np.testing.assert_allclose(got.cct, want.cct, rtol=1e-2,
                                       atol=2 * sc.params.delta,
                                       err_msg=what)
        else:
            assert got.steps == want.steps, what
            np.testing.assert_array_equal(got.cct, want.cct, err_msg=what)
            np.testing.assert_array_equal(got.fct, want.fct, err_msg=what)
        seen[sc.engine] += 1
    return seen


@pytest.fixture
def drivers(tmp_path, monkeypatch):
    """The drivers at the tiny fabric, their records in a scratch file,
    and the list every front-door replay of theirs lands in."""
    import benchmarks.torch_common as tc
    from benchmarks import (torch_fig9_speedup, torch_fig14_sensitivity,
                            torch_fig_oversub, torch_fig_sampling,
                            torch_table2_coordinator_latency)

    monkeypatch.setattr(tc, "BENCH_JSON", str(tmp_path / "BENCH.json"))
    monkeypatch.setattr(tc, "QUICK", TINY)
    monkeypatch.setattr(torch_fig9_speedup, "FLEET", 2)
    monkeypatch.setattr(torch_fig14_sensitivity, "TRACE_QUICK", (30, 16))
    monkeypatch.setattr(torch_fig_oversub, "FLEET_QUICK", 2)
    monkeypatch.setattr(torch_table2_coordinator_latency, "FLEET_QUICK",
                        (12, 8, 2))
    monkeypatch.setenv("SAATH_FLEET_MIN_SPEEDUP", "0.01")
    calls = []
    real = tc.api_run

    def spy(sc):
        res = real(sc)
        calls.append((sc, res))
        return res

    for mod in (tc, torch_fig9_speedup, torch_fig14_sensitivity,
                torch_fig_oversub, torch_fig_sampling,
                torch_table2_coordinator_latency):
        monkeypatch.setattr(mod, "api_run", spy)
    return calls


def _bench():
    from benchmarks.torch_common import Bench

    return Bench(device="cpu")


def test_fig9_speedup_and_fleet(drivers):
    """Saath on the torch engine against Aalo, Varys-SEBF, UC-TCP, FIFO
    and `saath-torch`, then the fleet: p50 > 1.1 and p90 > 2.0 over Aalo,
    the fidelity ratio in (0.97, 1.03), the coflow-granular one in (0.5,
    2.0)."""
    from benchmarks import torch_fig9_speedup as drv

    rows = drv.run(_bench(), engine="torch")
    assert [r["vs"] for r in rows] == list(drv.BASELINES) + [
        "fleet-seq-numpy", "fleet-torch-cold", "fleet-torch-fidelity",
        "fleet-torch-warm"]
    aalo = rows[0]
    assert aalo["p50"] > 1.1 and aalo["p90"] > 2.0
    assert hold_to_reference(drivers) == {"numpy": 6, "torch": 3}
    fleet = [sc for sc, _ in drivers if sc.label.startswith("fleet")]
    assert [len(sc.traces) for sc in fleet] == [2, 2, 2]


def test_fig3_offline_policies(drivers):
    from benchmarks import torch_fig3_offline_policies as drv

    rows = drv.run(_bench())
    assert [r["policy"] for r in rows] == ["scf", "srtf", "lwtf"]
    assert hold_to_reference(drivers) == {"numpy": 4, "torch": 0}


def test_fig2_out_of_sync(drivers):
    import json

    import benchmarks.torch_common as tc
    from benchmarks import torch_fig2_out_of_sync as drv

    rows = drv.run(_bench())
    assert rows[0]["metric"] == "width" and len(rows) >= 2
    assert hold_to_reference(drivers) == {"numpy": 1, "torch": 0}
    saved = json.loads(open(tc.BENCH_JSON).read())
    assert [(r["bench"], r["policy"], r["device"]) for r in saved] == [
        ("fig2", "aalo", "cpu")]


def test_fig11_bins(drivers):
    from benchmarks import torch_fig11_bins as drv

    rows = drv.run(_bench())
    assert sum(r["n"] for r in rows) == TINY["num_coflows"]
    assert hold_to_reference(drivers) == {"numpy": 1, "torch": 1}


def test_fig13_fct_deviation(drivers):
    from benchmarks import torch_fig13_fct_deviation as drv

    rows = drv.run(_bench())
    assert {r["policy"] for r in rows} == {"aalo", "saath"}
    assert hold_to_reference(drivers) == {"numpy": 1, "torch": 1}


def test_figures_with_saath_on_the_numpy_engine(drivers):
    """`--engine numpy` puts the Saath side on the host plane: bit for
    bit the reference's numpy Saath, gates as written."""
    from benchmarks import torch_fig10_breakdown, torch_fig13_fct_deviation

    bench = _bench()
    torch_fig13_fct_deviation.run(bench, engine="numpy")
    torch_fig10_breakdown.run(bench, engine="numpy")
    assert hold_to_reference(drivers) == {"numpy": 5, "torch": 0}


def test_cli_bench_options():
    from benchmarks.torch_common import cli_bench

    bench, engine = cli_bench([])
    assert (bench.quick, bench.device, engine) == (True, "cuda", "torch")
    bench, engine = cli_bench(["--full", "--engine", "numpy", "--device",
                               "cpu"])
    assert (bench.quick, bench.device, engine) == (False, "cpu", "numpy")
    with pytest.raises(SystemExit):
        cli_bench(["--engine", "jax"])
