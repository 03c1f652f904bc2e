"""What runs Saath alone on the port, against the JAX package on the CPU:

* `traces.loader` on a file written here in the coflow-benchmark format
  gives the reference loader's `Trace`, and both engines replay it alike;
* `Scenario(trace_path=...)` and its hash, and `warm_timing`;
* `fabric.metrics` (`fct_normalized_std`, `width_size_bins`,
  `bin_speedups`, `RunSummary`) against the reference's on equal tables;
* the port's drivers (`benchmarks/torch_pool_throughput.py`,
  `torch_table2_coordinator_latency.py`, `torch_api_smoke.py`,
  `torch_fleet_ccts.py`) and `examples/serve_lm_torch.py` on the CPU at
  reduced sizes, with the
  pool's speedup gate set for the CPU (a speed gate is the card's);
* the drivers and the example import neither jax nor the JAX package.

A `slow` test regenerates tests/data/torch_port_api_smoke_golden.json.
"""
import dataclasses
import importlib
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro.api import Scenario as JScenario, run as jrun
from repro.core.params import SchedulerParams as JParams
from repro.fabric import metrics as jmetrics
from repro.fabric.state import FlowTable as JFlowTable
from repro.traces import loader as jloader
from repro.traces import synth as jsynth
from repro_torch.api import Scenario, run
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric import metrics
from repro_torch.traces import loader

ROOT = Path(__file__).resolve().parents[1]
UNIT = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                       growth=4.0, num_queues=5)

# a coflow-benchmark file: 16 ports, 6 coflows (ids out of order, a
# single-flow one, a port id past num_ports, fractional MB, a reducer
# list wider than its mappers)
BENCHMARK_TEXT = """16 6
3 0 2 1 5 2 7:10.5 9:3
1 120 1 4 1 2:0.25
7 250 3 0 1 2 2 10:8 11:8
2 400 2 17 3 3 4:1 5:2 6:40
9 410 1 8 1 12:100
4 900 4 0 4 8 12 2 13:16 14:0.0000001
"""


def _write(tmp_path, text=BENCHMARK_TEXT):
    p = tmp_path / "trace.txt"
    p.write_text(text)
    return p


def _flat(tr):
    return (tr.num_ports, [(c.cid, c.arrival, [(f.fid, f.src, f.dst, f.size)
                                               for f in c.flows])
                           for c in tr.coflows])


def test_loader_gives_the_reference_trace(tmp_path):
    p = _write(tmp_path)
    got, want = loader.load_coflow_benchmark(str(p)), \
        jloader.load_coflow_benchmark(str(p))
    assert _flat(got) == _flat(want)
    assert got.num_flows == want.num_flows == 26
    assert min(f.size for c in got.coflows for f in c.flows) == 1.0


def test_loaded_trace_replays_as_the_reference(tmp_path):
    """The loaded file through both engines' front doors (unit-rate
    params: the file's MB flows at 1 byte/s would take ages, so the
    sizes are scaled by the trace's own loader-free copy)."""
    text = "\n".join(
        [BENCHMARK_TEXT.splitlines()[0]] +
        [" ".join(tok if ":" not in tok else
                  f"{tok.split(':')[0]}:{float(tok.split(':')[1]) / 2**20}"
                  for tok in line.split())
         for line in BENCHMARK_TEXT.splitlines()[1:]]) + "\n"
    p = _write(tmp_path, text)
    want = jrun(JScenario(engine="jax", trace_path=str(p),
                          params=JParams(**dataclasses.asdict(UNIT))))
    got = run(Scenario(trace_path=str(p), params=UNIT, device="cpu"))
    assert got.row_cct().shape == (6,)
    np.testing.assert_array_equal(got.cct, want.cct)
    np.testing.assert_array_equal(got.fct, want.fct)


def test_trace_path_is_one_source_and_keys_the_hash(tmp_path):
    p = _write(tmp_path)
    sc = Scenario(trace_path=str(p), device="cpu")
    assert sc.hash() == Scenario(trace_path=str(p), device="cpu").hash()
    other = tmp_path / "other.txt"
    other.write_text(BENCHMARK_TEXT)
    assert sc.hash() != Scenario(trace_path=str(other)).hash()
    # the path keys the hash, not the file's content (as the reference)
    assert sc.hash() != Scenario(
        trace=loader.load_coflow_benchmark(str(p))).hash()
    with pytest.raises(ValueError, match="exactly one trace source"):
        run(Scenario(trace_path=str(p), synth=dict(num_coflows=4),
                     device="cpu"))


def test_warm_timing_keeps_the_ccts():
    tr = jsynth.tiny_trace(10, 8, seed=2)
    from tests.test_torch_engine import _port_trace

    pt = _port_trace(tr)
    cold = run(Scenario(trace=pt, device="cpu"))
    warm = run(Scenario(trace=pt, device="cpu", warm_timing=True))
    np.testing.assert_array_equal(warm.cct, cold.cct)
    assert warm.compile_seconds >= 0.0 and cold.compile_seconds == 0.0
    assert warm.build_seconds == 0.0      # no kernel is built on the CPU
    assert warm.wall_seconds > 0.0
    assert Scenario(trace=pt, warm_timing=True).hash() == \
        Scenario(trace=pt).hash()


# ---- metrics against the reference's ----------------------------------


def _tables(res, jtrace, row=0):
    """The port's table of row `row` and a reference FlowTable filled
    with the same arrays."""
    pt = res.table(row)
    jt = JFlowTable.from_trace(jtrace, res.params_rows[row].port_bw)
    for name in ("sent", "fct", "done", "cct", "finished", "active"):
        getattr(jt, name)[:] = getattr(pt, name)
    return pt, jt


@pytest.fixture(scope="module")
def replays():
    from tests.test_torch_engine import _port_trace

    jtr = jsynth.fb_like_trace(40, 30, seed=4)
    pt = _port_trace(jtr)
    full = run(Scenario(trace=pt, device="cpu"))
    aalo = run(Scenario(trace=pt, device="cpu", mechanisms=dict(
        lcof=False, per_flow_threshold=False)))
    return jtr, full, aalo


def test_fct_normalized_std_and_bins_equal_the_reference(replays):
    jtr, full, _ = replays
    pt, jt = _tables(full, jtr)
    got, want = metrics.fct_normalized_std(pt), jmetrics.fct_normalized_std(jt)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["equal"].size + got["unequal"].size > 0
    np.testing.assert_array_equal(metrics.width_size_bins(pt),
                                  jmetrics.width_size_bins(jt))
    assert set(metrics.width_size_bins(pt)) > {1}


def test_bin_speedups_equal_the_reference(replays):
    jtr, full, aalo = replays
    pb, jb = _tables(aalo, jtr)
    pn, jn = _tables(full, jtr)
    got = metrics.bin_speedups(pb, pn, qs=(10, 50, 90))
    want = jmetrics.bin_speedups(jb, jn, qs=(10, 50, 90))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_run_summary_equals_the_reference(replays):
    """`RunSummary.from_result` on the port's own `Result` against the
    reference's summary of the JAX engine's replay of the same trace."""
    jtr, full, _ = replays
    want_res = jrun(JScenario(engine="jax", trace=jtr))
    np.testing.assert_array_equal(full.cct, want_res.cct)
    got = metrics.RunSummary.from_result("saath", full)
    want = jmetrics.RunSummary.from_result("saath", SimpleNamespace(
        table=want_res.table(0), makespan=float(want_res.makespan[0]),
        steps=want_res.steps, sched_seconds=full.wall_seconds))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.steps == full.steps > 0 and math.isfinite(got.p90_cct)
    empty = metrics.RunSummary.from_result("x", dataclasses.replace(
        full, cct=np.full_like(full.cct, np.nan)))
    assert math.isnan(empty.avg_cct) and math.isnan(empty.p90_cct)
    assert empty.makespan == got.makespan


# ---- the drivers on the CPU -------------------------------------------


@pytest.fixture
def bench_json(tmp_path, monkeypatch):
    """Point the drivers' record file at a scratch path."""
    import benchmarks.torch_common as tc

    path = tmp_path / "BENCH_torch.json"
    monkeypatch.setattr(tc, "BENCH_JSON", str(path))
    return path


def test_bench_runs_once_per_scenario_and_records(bench_json):
    """`Bench.run` caches by scenario and device; `record_as` appends one
    record naming the device, replaced (not duplicated) on a rerun."""
    from benchmarks.torch_common import Bench, record

    bench = Bench(device="cpu")
    sc = bench.scenario(num_coflows=6, num_ports=12)
    assert sc.synth["num_coflows"] == 6 and sc.device == "cpu"
    first = bench.run(scenario=sc, record_as="tiny")
    assert bench.run(scenario=sc) is first
    record("tiny", first)
    saved = json.loads(bench_json.read_text())
    assert len(saved) == 1 and saved[0]["device"] == "cpu"
    assert saved[0]["num_coflows"] == 6 and saved[0]["avg_cct"] > 0


def test_pool_throughput_driver_on_the_cpu(bench_json, monkeypatch):
    """Bitwise pooled = sequential CCTs and one full upload are gated
    inside; the speed gate is set for the CPU, where a pooled slab does
    the rows' work serially (the reference's CI lowers it the same way
    for narrower runs)."""
    from benchmarks import torch_pool_throughput as drv

    monkeypatch.setenv("SAATH_POOL_MIN_SPEEDUP", "0.05")
    rec = drv.main(["--device", "cpu", "--sessions", "4", "--coflows",
                    "4"])
    assert rec["full_uploads"] == 1 and rec["sessions"] == 4
    assert rec["device"] == "cpu" and rec["speedup"] > 0
    saved = json.loads(bench_json.read_text())
    assert [r["bench"] for r in saved] == ["pool_throughput"]


def test_pool_throughput_driver_without_cold_passes(bench_json,
                                                    monkeypatch):
    """`--no-cold` drives the two warm passes only: the gates hold and
    the record has no compile time to report."""
    from benchmarks import torch_pool_throughput as drv

    monkeypatch.setenv("SAATH_POOL_MIN_SPEEDUP", "0.05")
    rec = drv.main(["--device", "cpu", "--sessions", "2", "--coflows",
                    "2", "--no-cold"])
    assert rec["full_uploads"] == 1 and rec["sessions"] == 2
    assert rec["compile_pool"] is None and rec["compile_sequential"] is None
    assert rec["build_seconds"] == 0.0


def test_pool_throughput_workload_is_the_reference_workload():
    from benchmarks import pool_throughput as ref
    from benchmarks import torch_pool_throughput as drv

    for seed in (0, 5):
        a, b = drv._workload(seed, 10), ref._workload(seed, 10)
        assert [(c.cid, c.arrival, [(f.fid, f.src, f.dst, f.size)
                                    for f in c.flows]) for c in a] == \
            [(c.cid, c.arrival, [(f.fid, f.src, f.dst, f.size)
                                 for f in c.flows]) for c in b]
    assert drv.PARAMS == drv.SchedulerParams(**dataclasses.asdict(
        ref.PARAMS)) and drv.PORTS == ref.PORTS


def test_table2_driver_on_the_cpu(bench_json, capsys, monkeypatch):
    from benchmarks import torch_common
    from benchmarks import torch_table2_coordinator_latency as drv

    monkeypatch.setattr(drv, "FLEET_QUICK", (12, 8, 2))
    monkeypatch.setattr(torch_common, "QUICK",
                        dict(num_coflows=30, num_ports=16, seed=0))
    rows = drv.main(["--device", "cpu", "--sizes", "64x16", "96x24",
                     "--reps", "2", "--fleet", "1"])
    assert [r["impl"] for r in rows] == ["numpy-replay", "torch-tick",
                                         "torch-tick",
                                         "torch-batched-engine"]
    assert [r["C"] for r in rows] == [30, 64, 96, 12]
    assert rows[0]["P"] == 16
    assert all(r["avg_ms"] > 0 for r in rows)
    err = capsys.readouterr().err
    assert "(a) numpy-replay: host ms inside the policy" in err


def test_table2_inputs_are_the_reference_draws():
    """Row (b)'s inputs, drawn as the reference draws them."""
    import jax.numpy as jnp

    from benchmarks import torch_table2_coordinator_latency as drv

    rng_p, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    for C, P in ((32, 8), (48, 16)):
        b = drv.tick_inputs(C, P, rng_p, "cpu")
        active = jnp.asarray(rng_j.uniform(size=C) < 0.7)
        m = rng_j.uniform(0, 1e8, C).astype(np.float32)
        width = rng_j.integers(1, 64, C)
        cnt_s = (rng_j.uniform(size=(C, P)) < 0.05) * \
            rng_j.integers(1, 4, (C, P))
        cnt_r = (rng_j.uniform(size=(C, P)) < 0.05) * \
            rng_j.integers(1, 4, (C, P))
        np.testing.assert_array_equal(b.active[0].numpy(), active)
        np.testing.assert_array_equal(b.m[0].numpy(), m)
        np.testing.assert_array_equal(b.width[0].numpy(), width)
        np.testing.assert_array_equal(b.cnt_s[0].numpy(), cnt_s)
        np.testing.assert_array_equal(b.cnt_r[0].numpy(), cnt_r)


def test_api_smoke_driver_on_the_cpu():
    from benchmarks import torch_api_smoke as drv

    out = drv.main(["--device", "cpu"])
    assert out["max_rel_dev"] <= drv.RTOL and out["device"] == "cpu"
    assert abs(out["engine_ratio"] - 1.0) < 1e-2


def test_serve_example_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    assert sorted(out) == ["mamba2-1.3b", "starcoder2-3b"]
    assert all(t.shape == (2, 12) for t in out.values())


def test_fleet_ccts_script_on_the_cpu(tmp_path, capsys):
    """`benchmarks/torch_fleet_ccts.py` at a tiny size: two runs of one
    tree compare equal (0 CCTs differ, exit 0), a changed file exits 1."""
    from benchmarks import torch_fleet_ccts as drv

    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    small = ["--device", "cpu", "--coflows", "6", "--ports", "12",
             "--fleet", "1", "--parity", "4"]
    assert drv.main(small + ["--out", str(a)]) == 0
    assert drv.main(small + ["--out", str(b)]) == 0
    capsys.readouterr()
    assert drv.main(["--compare", str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert out.count(" 0 of ") == 3
    data = dict(np.load(a))
    data["bigswitch_steps"] = data["bigswitch_steps"] + 1
    np.savez(b, **data)
    assert drv.main(["--compare", str(a), str(b)]) == 1


def test_fleet_ccts_pairs_on_the_cpu(capfd):
    """`--parent` runs both trees in turns, each in its own process (here
    this checkout against itself): every wall printed, 0 CCTs differ."""
    from benchmarks import torch_fleet_ccts as drv

    assert drv.main(["--parent", str(ROOT), "--pairs", "1", "--device",
                     "cpu", "--coflows", "6", "--ports", "12", "--fleet",
                     "1", "--replays", "bigswitch"]) == 0
    out = capfd.readouterr().out
    assert "bigswitch walls in run order (p c): " in out
    assert "median parent" in out and "change" in out
    assert out.count(" 0 of ") == 1
    assert "parent against change:" in out


def test_drivers_load_neither_jax_nor_repro():
    """Importing the drivers loads neither jax nor the JAX package, nor
    `benchmarks/common.py`, which imports it (the AST scan of
    `tests/test_torch_api.py` covers their import statements)."""
    import subprocess

    code = ("import sys; sys.path[:0] = ['src', '.']; "
            "import benchmarks.torch_pool_throughput, "
            "benchmarks.torch_table2_coordinator_latency, "
            "benchmarks.torch_api_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.')) "
            "or m == 'benchmarks.common']; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---- the golden torch_api_smoke.py holds the port to ------------------


@pytest.mark.slow
def test_regenerate_api_smoke_golden():
    """Recompute tests/data/torch_port_api_smoke_golden.json: the JAX
    package's replay of the smoke trace (seconds)."""
    from benchmarks import torch_api_smoke as drv

    tr = jsynth.tiny_trace(drv.N, drv.PORTS, seed=drv.SEED, load=drv.LOAD)
    res = jrun(JScenario(engine="jax", trace=tr, params=JParams(),
                         label="api-smoke"))
    import jax

    gold = {
        "what": "the JAX package's replay of benchmarks/api_smoke.py's "
                "trace, the reference benchmarks/torch_api_smoke.py holds "
                "the port to",
        "call": f"repro.api.run(Scenario(engine='jax', trace=tiny_trace("
                f"{drv.N}, {drv.PORTS}, seed={drv.SEED}, load={drv.LOAD}),"
                f" params=SchedulerParams()))",
        "platform": "cpu", "jax": jax.__version__,
        "regenerate": "PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest "
                      "-q -m slow tests/test_torch_drivers.py -k "
                      "api_smoke_golden",
        "avg_cct": float(res.avg_cct[0]),
        "cct": [float(x) for x in res.row_cct()],
        "steps": int(res.steps),
    }
    drv.GOLDEN.write_text(json.dumps(gold, indent=1) + "\n")
    got = json.loads(drv.GOLDEN.read_text())
    assert got["cct"] == gold["cct"] and len(got["cct"]) == drv.N
