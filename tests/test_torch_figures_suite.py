"""The port's suite runner (`benchmarks/torch_run.py`) on the CPU:
`run_all` once at the tiny fabric of `tests/test_torch_figures.py`, with
the Saath side on the numpy engine (every gate as written, every replay
held to the JAX package's), and `main`'s claim-check bookkeeping.
"""
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from tests.test_torch_figures import drivers, \
    hold_to_reference  # noqa: F401  (drivers is a fixture)

ROOT = Path(__file__).resolve().parents[1]


def test_run_all_at_the_tiny_fabric(drivers, monkeypatch):
    from benchmarks import torch_run
    from benchmarks import torch_table2_coordinator_latency as table2

    monkeypatch.setattr(table2, "SIZES", ((64, 16), (96, 24)))
    out = torch_run.run_all(quick=True, engine="numpy", device="cpu")
    assert list(out) == [name for name, _ in torch_run.SUITES]
    assert [r["impl"] for r in out["table2"]] == [
        "numpy-replay", "torch-tick", "torch-tick", "numpy-batched-engine"]
    # the Saath side on numpy: only the fig9 fleet's two batched rows
    # replay on the torch engine (Table 2's row (c) follows --engine)
    seen = hold_to_reference(drivers)
    assert seen["torch"] == 2 and seen["numpy"] > 20


def _suite(name, log, fails=False):
    def run(bench, engine):
        log.append((name, bench.quick, bench.device, engine))
        assert not fails, f"{name} claim"
        return []
    return SimpleNamespace(run=run)


def test_main_collects_claim_check_failures(monkeypatch, capsys):
    """A failed gate is reported and the suite goes on; the runner
    exits 1 at the end. `--only` runs one suite."""
    from benchmarks import torch_run

    log = []
    monkeypatch.setattr(torch_run, "SUITES", [
        ("a", _suite("a", log, fails=True)), ("b", _suite("b", log))])
    with pytest.raises(SystemExit) as ex:
        torch_run.main(["--full", "--engine", "numpy", "--device", "cpu"])
    assert ex.value.code == 1
    assert log == [("a", False, "cpu", "numpy"), ("b", False, "cpu",
                                                  "numpy")]
    err = capsys.readouterr()
    assert "# a CLAIM-CHECK FAILED: a claim" in err.err
    assert "1 claim-check failures" in err.out
    log.clear()
    assert torch_run.main(["--only", "b"]) == []
    assert log == [("b", True, "cuda", "torch")]


def test_figure_drivers_and_the_bridge_load_neither_jax_nor_repro():
    """Importing the suite runner (every figure driver), the two drivers
    it does not run and the runtime bridge loads neither jax nor the JAX
    package, nor `benchmarks/common.py` (the AST scan of
    `tests/test_torch_api.py` covers their import statements)."""
    code = ("import sys; sys.path[:0] = ['src', '.']; "
            "import benchmarks.torch_run, benchmarks.torch_fig_oversub, "
            "benchmarks.torch_fig_sampling, repro_torch.runtime; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.')) "
            "or m == 'benchmarks.common']; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
