"""The port's front door: Result semantics, device handling, the
package boundary (no jax, nothing of `repro`), and the kernels' checks
made in Python before a launch (K5's TMA rule, the build's hash)."""
import ast
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import Result, Scenario, result_from_completions, run
from repro_torch.core.coflow import Coflow, Flow, Trace
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric.engine import EngineResult

ROOT = Path(__file__).resolve().parents[1]
PARAMS = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                         growth=4.0, num_queues=5)


def _trace(n=5, ports=4, seed=0):
    rng = np.random.default_rng(seed)
    coflows, fid = [], 0
    for c in range(n):
        flows = []
        for _ in range(int(rng.integers(1, 4))):
            flows.append(Flow(fid, int(rng.integers(0, ports)),
                              int(rng.integers(0, ports)),
                              float(rng.uniform(1.0, 8.0))))
            fid += 1
        coflows.append(Coflow(c, float(rng.uniform(0.0, 2.0)), flows))
    return Trace(num_ports=ports, coflows=coflows)


# ---- Result owns the NaN/padding semantics (tests/test_api.py:88-139) --

def test_empty_stream_reports_nan_not_zero():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = result_from_completions([])
        assert np.isnan(res.makespan[0])
        assert np.isnan(res.avg_cct[0])


def test_engine_result_all_padding_row_is_nan_without_warning():
    res = EngineResult(
        cct=np.array([[1.0, np.nan], [np.nan, np.nan]]),
        fct=np.full((2, 2), np.nan), sent=np.zeros((2, 2)),
        finished=np.ones((2, 2), bool), ticks=0, events=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        avg = res.avg_cct
    assert avg[0] == 1.0 and np.isnan(avg[1])


def test_result_normalizer_row_semantics():
    r = Result(engine="torch", policy="saath",
               cct=np.array([[2.0, np.nan], [np.nan, np.nan]]),
               fct=np.array([[5.0, np.nan], [np.nan, np.nan]]),
               sent=np.zeros((2, 2)), num_coflows=np.array([2, 1]),
               num_flows=np.array([2, 1]), steps=0, wall_seconds=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert r.avg_cct[0] == 2.0 and np.isnan(r.avg_cct[1])
        assert r.makespan[0] == 5.0 and np.isnan(r.makespan[1])


def test_fleet_result_trims_padding_and_rebuilds_tables():
    fleet = (_trace(3, seed=1), _trace(7, seed=2))
    res = run(Scenario(traces=fleet, params=PARAMS, device="cpu"))
    assert res.cct.shape[0] == 2 and res.steps == res.events * 2
    for b, tr in enumerate(fleet):
        assert res.row_cct(b).shape == (len(tr.coflows),)
        assert np.isfinite(res.row_cct(b)).all()
        assert np.isnan(res.cct[b, len(tr.coflows):]).all()
        t = res.table(b)
        assert t.finished.all() and t.done.all()
        np.testing.assert_allclose(t.sent, t.size, rtol=1e-5)
    assert res.summary(1)["num_coflows"] == 7


# ---- devices ------------------------------------------------------------

def test_run_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(Scenario(trace=_trace(), params=PARAMS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(Scenario(trace=_trace(), params=PARAMS, device="cuda"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run on CPU tensors; only `ops` routes a
    CPU tensor to the plain version."""
    from repro_torch.kernels.contention import contention_cuda

    a = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        contention_cuda(a, a, torch.zeros(1, 4, dtype=torch.bool))


def _bf16_view(kind):
    """bf16 (B, H, S, D) views of CPU memory, for the TMA rule."""
    if kind == "contiguous":
        return torch.zeros(2, 3, 40, 64, dtype=torch.bfloat16)
    if kind == "transposed":          # a (B, S, H, D) tensor's view
        return torch.zeros(2, 40, 3, 64, dtype=torch.bfloat16).transpose(1, 2)
    if kind == "cache slice":         # rows [0, 40) of a 96-row cache
        return torch.zeros(1, 96, 1, 16, dtype=torch.bfloat16)[:, :40] \
            .transpose(1, 2)
    if kind == "one element off":
        flat = torch.zeros(2 * 3 * 40 * 64 + 1, dtype=torch.bfloat16)
        return flat[1:].view(2, 3, 40, 64)
    return torch.zeros(2, 3, 40, 68, dtype=torch.bfloat16)[..., :64]


@pytest.mark.parametrize("kind,strides", [
    ("contiguous", (7680, 2560, 64)),
    ("transposed", (7680, 64, 192)),
    ("cache slice", (16, 16, 16)),    # size-1 batch and head axes pass D
])
def test_bf16_attention_takes_views_tma_can_load(kind, strides):
    """The bf16 K5 wrapper passes a view's (batch, head, row) strides to
    the tensor maps; a size-1 axis is never stepped and passes D."""
    from repro_torch.kernels.flash_attention import _tma_strides

    assert tuple(_tma_strides(_bf16_view(kind), "q")) == strides


@pytest.mark.parametrize("kind,match", [
    ("one element off", "16-byte-aligned base"),
    ("row stride 68", "row stride is 68 elements"),
])
def test_bf16_attention_refuses_views_tma_cannot_load(kind, match):
    """Checked in Python before any launch: the bf16 K5 wrapper raises on
    a base or a stride that TMA cannot take (no fallback)."""
    from repro_torch.kernels.flash_attention import _tma_strides

    with pytest.raises(ValueError, match=match):
        _tma_strides(_bf16_view(kind), "q")


def test_kernel_library_name_hashes_headers(tmp_path, monkeypatch):
    """An edited `.cuh` header under csrc/ renames every library, so a
    stale build is never loaded (as an edited `.cu` source does)."""
    from repro_torch.kernels import build

    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "h.cuh").write_text("// helpers 1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setitem(build.SOURCES, "k", ("k.cu", []))
    first = build.library_path("k")
    (tmp_path / "h.cuh").write_text("// helpers 2\n")
    second = build.library_path("k")
    (tmp_path / "k.cu").write_text("// kernel, edited\n")
    assert len({first, second, build.library_path("k")}) == 3


@pytest.mark.parametrize("kw,err,match", [
    (dict(engine="numpy", fidelity="coflow"), ValueError,
     "inherently flow-fidelity"),
    (dict(policy_kwargs={"lcof": False}), ValueError,
     "numpy-engine only"),
    (dict(engine="jax"), ValueError, "unknown engine"),
    (dict(policy="aalo"), ValueError, "no batched implementation"),
    (dict(fidelity="packet"), ValueError, "unknown fidelity"),
    (dict(mechanisms={"bogus": True}), ValueError, "unknown mechanism"),
    (dict(topology=object()), TypeError, "BigSwitch, LeafSpine"),
    (dict(traces=(_trace(),)), ValueError, "exactly one trace source"),
])
def test_front_door_errors(kw, err, match):
    kw = {"trace": _trace(), "params": PARAMS, "device": "cpu", **kw}
    with pytest.raises(err, match=match):
        run(Scenario(**kw))


def test_scenario_hash_is_stable_and_discriminating():
    a = Scenario(trace=_trace(seed=3), params=PARAMS, device="cpu")
    b = Scenario(trace=_trace(seed=3), params=PARAMS, device="cpu")
    c = Scenario(trace=_trace(seed=4), params=PARAMS, device="cpu")
    assert a.hash() == b.hash() != c.hash()


# ---- the package boundary ------------------------------------------------

def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.api, "
            "repro_torch.fabric.engine, repro_torch.kernels.ops, "
            "repro_torch.fabric.simulator, repro_torch.core.policies, "
            "repro_torch.launch.lm_serve, repro_torch.models.lm; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "benchmarks").glob("torch_*.py"))
    + sorted((ROOT / "examples").glob("*_torch.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "repro", "jaxlib")]
    assert not bad, bad
