"""The port's dispatch auditor (`repro_torch.analysis.audit`) and its op
scan: golden-manifest round trip, drift detection, the hard gates (a
host sync or an f64 cast injected into the real `session_advance` must
fail the audit), and the scan's kernel boundary. The counterparts of
tests/test_analysis_audit.py, with the op scan where the reference
reads a jaxpr and the torch version where it reads a jax version."""
import json

import numpy as np
import pytest
import torch

import repro_torch.analysis.audit as au
from repro_torch.analysis.op_scan import scan, signature
from repro_torch.fabric import engine as eng
from repro_torch.kernels import ops


# ---- toy entrypoints (cheap; exercise the manifest machinery) ------------

def _toy_entry(device="cpu"):
    return scan(lambda x: x * 2.0 + 1.0, torch.ones(3))


def _toy_entry_drifted(device="cpu"):
    return scan(lambda x: torch.sin(x * 2.0 + 1.0), torch.ones(3))


def _toy_entry_reshaped(device="cpu"):
    return scan(lambda x: x * 2.0 + 1.0, torch.ones(4))


def _toy_entry_host_sync(device="cpu"):
    def f(x):
        y = x * 2.0
        float(y.sum())               # a scalar read in the step
        return y
    return scan(f, torch.ones(3))


def test_manifest_round_trip_is_clean():
    reg = {"toy": _toy_entry}
    manifest = au.build_manifest(reg)
    assert manifest["torch_version"] == torch.__version__
    assert manifest["entrypoints"]["toy"]["host_sites"] == []
    assert manifest["entrypoints"]["toy"]["f64_sites"] == []
    assert au.check_manifest(manifest, reg) == []


def test_op_drift_is_flagged_under_same_torch_version():
    manifest = au.build_manifest({"toy": _toy_entry})
    problems = au.check_manifest(manifest, {"toy": _toy_entry_drifted})
    assert any("op-count drift" in p and "sin" in p
               for p in problems), problems


def test_op_drift_diff_is_grouped_by_direction():
    manifest = au.build_manifest({"toy": _toy_entry})
    problems = au.check_manifest(manifest, {"toy": _toy_entry_drifted})
    drift = next(p for p in problems if "op-count drift" in p)
    assert "added:" in drift and "aten.sin.default x1" in drift
    assert "removed:" not in drift
    back = au.check_manifest(au.build_manifest(
        {"toy": _toy_entry_drifted}), {"toy": _toy_entry})
    drift = next(p for p in back if "op-count drift" in p)
    assert "removed:" in drift and "sin" in drift


def test_op_drift_under_another_torch_version_is_a_warning(capsys):
    manifest = au.build_manifest({"toy": _toy_entry})
    manifest["torch_version"] = "0.0.0"
    assert au.check_manifest(manifest, {"toy": _toy_entry_drifted}) == []
    assert "torch version changed" in capsys.readouterr().err


def test_signature_drift_is_flagged():
    manifest = au.build_manifest({"toy": _toy_entry})
    problems = au.check_manifest(manifest, {"toy": _toy_entry_reshaped})
    assert any("input signature drift" in p for p in problems), problems


def test_signature_drift_diff_is_positional():
    manifest = au.build_manifest({"toy": _toy_entry})
    problems = au.check_manifest(manifest, {"toy": _toy_entry_reshaped})
    drift = next(p for p in problems if "input signature drift" in p)
    assert "[0]" in drift and "->" in drift
    assert "float32[3]" in drift and "float32[4]" in drift


def test_sig_diff_marks_arity_changes():
    assert au._sig_diff(["f32[3]"], ["f32[3]", "i32[]"]) == \
        ["  [1] <absent> -> i32[]"]
    assert au._sig_diff(["f32[3]", "i32[]"], ["f32[3]"]) == \
        ["  [1] i32[] -> <absent>"]


def test_gate_failure_prints_the_update_hint(tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.setattr(au, "ENTRYPOINTS", {"toy": _toy_entry})
    path = tmp_path / "manifest.json"
    assert au.main(["--update", "--manifest", str(path)]) == 0
    monkeypatch.setattr(au, "ENTRYPOINTS", {"toy": _toy_entry_drifted})
    capsys.readouterr()
    assert au.main(["--manifest", str(path)]) == 1
    captured = capsys.readouterr()
    assert "--update" in captured.err            # the one-line hint
    assert "added:" in captured.out              # the structured diff


def test_missing_and_stale_entries_are_flagged():
    manifest = au.build_manifest({"toy": _toy_entry})
    problems = au.check_manifest(manifest, {"other": _toy_entry})
    assert any(p.startswith("other: not in the manifest")
               for p in problems), problems
    assert any("toy" in p and "no longer audited" in p
               for p in problems), problems


def test_update_refuses_to_bless_host_syncs(tmp_path, monkeypatch):
    """`--update` must never launder a hard-invariant violation into
    the golden manifest."""
    monkeypatch.setattr(au, "ENTRYPOINTS", {"toy": _toy_entry_host_sync})
    path = tmp_path / "manifest.json"
    assert au.main(["--update", "--manifest", str(path)]) == 1
    assert not path.exists()


def test_cli_round_trip_update_then_gate(tmp_path, monkeypatch):
    monkeypatch.setattr(au, "ENTRYPOINTS", {"toy": _toy_entry})
    path = tmp_path / "manifest.json"
    assert au.main(["--manifest", str(path)]) == 1   # no manifest yet
    assert au.main(["--update", "--manifest", str(path)]) == 0
    written = json.loads(path.read_text())
    assert "toy" in written["entrypoints"]
    assert au.main(["--manifest", str(path)]) == 0


# ---- the real device step ------------------------------------------------

def _committed():
    path = au.default_manifest_path()
    assert path.exists(), (
        f"no committed manifest at {path}; run `python -m "
        f"repro_torch.analysis.audit --update`")
    return json.loads(path.read_text())


def test_committed_manifest_matches_live_entrypoints():
    """`python -m repro_torch.analysis.audit` run as a test: the op
    histograms are held exactly only under the torch version that
    blessed the manifest."""
    manifest = _committed()
    if manifest["torch_version"] != torch.__version__:
        pytest.skip(f"the manifest was blessed under torch "
                    f"{manifest['torch_version']}; this is torch "
                    f"{torch.__version__}, whose eager dispatch may differ")
    problems = au.check_manifest(manifest)
    assert problems == [], "\n".join(problems)


def test_hard_invariants_hold_on_every_entrypoint():
    """No f64 site and no host sync in the step, on any torch version;
    the signatures, the crossings and the kernel calls match the
    manifest's."""
    manifest = _committed()
    fresh = au.build_manifest()
    assert set(fresh["entrypoints"]) == set(au.ENTRYPOINTS)
    for name, cur in fresh["entrypoints"].items():
        assert au.hard_problems(name, cur) == [], name
        old = manifest["entrypoints"][name]
        assert cur["signature"] == old["signature"], name
        assert cur["crossings"] == old["crossings"], name
        assert au._kernels(cur["ops"]) == au._kernels(old["ops"]), name


def test_step_entrypoints_launch_the_slice_kernels():
    m = _committed()["entrypoints"]
    for name in au.SESSION_ENTRIES + ("simulate_sweep",
                                      "session_plan_tick"):
        k = au._kernels(m[name]["ops"])
        assert k["kernel:contention"] == k["kernel:tick_walk"] >= 1, name
        assert k["kernel:prefix_sum"] >= k["kernel:contention"], name
    assert "kernel:maxmin" in m["session_advance_leafspine"]["ops"]
    assert "kernel:maxmin" not in m["session_advance"]["ops"]
    for name in au.SESSION_ENTRIES:
        assert m[name]["flag_reads"] == \
            m[name]["crossings"][au.FLAG] >= 1, name
    assert not au._kernels(m["scatter_rows"]["ops"])


def _session_advance_inputs():
    tb, _, ep_rows, state = au.canonical_slab()
    return (state, tb, ep_rows)


def _poisoned_session_advance(poison):
    def entry(device="cpu"):
        def run(state, tb, ep):
            out = eng.session_advance(
                state, tb, ep, n_end=np.full((au.B,), au.N_END, np.float32),
                chunk=au.CHUNK, features=au.FEATURES)
            poison(out[0])
            return out
        return scan(run, *_session_advance_inputs())
    return entry


def test_host_sync_injected_into_session_advance_fails_gate():
    """A scalar read left in the step (a debug print of a tensor) must
    fail the audit."""
    manifest = _committed()
    entry = _poisoned_session_advance(lambda st: print(st.cct.sum().item()))
    problems = au.check_manifest(manifest, {"session_advance": entry})
    assert any("session_advance" in p and "host sync" in p
               for p in problems), problems


def test_f64_cast_injected_into_session_advance_fails_gate():
    manifest = _committed()
    entry = _poisoned_session_advance(lambda st: st.sent.double())
    problems = au.check_manifest(manifest, {"session_advance": entry})
    assert any("session_advance" in p and "float64" in p
               for p in problems), problems


def test_uncounted_flag_read_fails_gate():
    rec = au._record("session_advance", au.ENTRYPOINTS["session_advance"]())
    rec["crossings"] = {}
    assert any("counted flag reads" in p
               for p in au.hard_problems("session_advance", rec))


def test_card_check_compares_kernel_calls_only():
    """Off the CPU the op histogram is not compared, the kernel calls
    are (the card dispatches other aten ops for the same step)."""
    manifest = au.build_manifest({"toy": _toy_entry})
    manifest["entrypoints"]["toy"]["ops"]["aten.sin.default"] = 1
    assert au.check_manifest(manifest, {"toy": _toy_entry},
                             device="meta") == []
    manifest["entrypoints"]["toy"]["ops"]["kernel:contention"] = 1
    problems = au.check_manifest(manifest, {"toy": _toy_entry},
                                 device="meta")
    assert any("kernel-call drift" in p for p in problems), problems


# ---- the op scan ---------------------------------------------------------

def test_scan_records_kernels_at_the_ops_boundary():
    """A kernel call is one `kernel:<name>` entry, and the scan is
    suspended inside it: the plain walk's data-dependent ops (a Python
    loop on the CPU) are not counted."""
    s = scan(au.ENTRYPOINTS["simulate_sweep"])
    assert s.ops["kernel:tick_walk"] == au.CHUNK
    x = torch.rand(3, 40)
    s = scan(ops.prefix_sum, x)
    assert dict(s.ops) == {"kernel:prefix_sum": 1}
    assert s.signature == ["float32[3, 40]"]
    assert not ops.observers


def test_scan_sees_f64_outputs_and_casts():
    s = scan(lambda x: (x.double(), torch.zeros(2, dtype=torch.float64)),
             torch.ones(2))
    assert "aten._to_copy.default -> float64" in s.f64_sites
    assert any("f64 output" in f for f in s.f64_sites)


@pytest.mark.parametrize("what", ["item", "bool", "nonzero", "mask_index"])
def test_scan_sees_host_syncs(what):
    fn = {"item": lambda x: x.sum().item(), "bool": lambda x: bool(x[0]),
          "nonzero": lambda x: x.nonzero(),
          "mask_index": lambda x: x[x > 0]}[what]
    assert scan(fn, torch.ones(3)).host_sites


def test_scan_sees_copies_to_another_device():
    s = scan(lambda a: torch.from_numpy(a).to("meta"),
             np.ones(3, np.float32))
    assert s.host_sites == ["aten._to_copy.default (h2d copy)"]


def test_tolist_and_numpy_dispatch_no_copy():
    """The blind spot the lint rule covers: `.tolist()` dispatches
    nothing, `.numpy()` only a detach."""
    x = torch.ones(3)
    assert scan(lambda t: t.tolist(), x).ops == {}
    assert set(scan(lambda t: t.numpy(), x).ops) <= {"aten.detach.default"}


def test_signature_walks_trees_in_order():
    st = au.canonical_slab()[3]
    sig = signature((st, {"b": np.zeros(2, np.int32), "a": None}))
    # the 14 session-state leaves (coord's 3 first), then the dict's one
    assert len(sig) == 15
    assert sig[0] == "int64[2, 4]" and sig[-1] == "int32[2]"
