"""The port's lint layer (`repro_torch.analysis.lint`): per-rule fixtures
(positive and negative), suppression semantics, the contract rules, and
the self-run gate asserting `src/repro_torch` stays clean. The
counterparts of tests/test_analysis_lint.py, with the device step where
the reference has a traced scope."""
import re
import textwrap
from pathlib import Path

import pytest

import repro_torch
from repro_torch.analysis.contracts import (api_simulator_imports,
                                            slab_leaf_coverage)
from repro_torch.analysis.lint import _suppressions, lint_paths, lint_text

ENGINE_PATH = "src/repro_torch/fabric/engine.py"    # step seeds + dtype on
COORD_PATH = "src/repro_torch/core/coordinator.py"  # tick_core seed
NEUTRAL_PATH = "src/repro_torch/api/fixture.py"     # hot-module gates off
SRC = Path(list(repro_torch.__path__)[0])


def rules_of(src, path=ENGINE_PATH):
    return {f.rule for f in lint_text(textwrap.dedent(src), path)}


# ---- host-sync-in-step ---------------------------------------------------

@pytest.mark.parametrize("pull", ["x.item()", "x.cpu()", "x.tolist()",
                                  "x.numpy()", "float(x)", "int(x.sum())",
                                  "bool(x.any())", "np.asarray(x)"])
def test_host_sync_in_step_positive(pull):
    assert "host-sync-in-step" in rules_of(f"""
        import numpy as np
        import torch

        def _tick(x: torch.Tensor):
            return {pull}
    """)


@pytest.mark.parametrize("call", ["torch.tensor([1.0], device=d)",
                                  "torch.as_tensor(v, dtype=torch.float32,"
                                  " device=d)"])
def test_upload_in_step_positive(call):
    # a list upload the dispatch mode cannot see on the card
    assert "host-sync-in-step" in rules_of(f"""
        import torch

        def tick_core(x: torch.Tensor, v, d):
            return x + {call}
    """, COORD_PATH)


def test_host_sync_negative_host_function():
    assert "host-sync-in-step" not in rules_of("""
        import numpy as np
        import torch

        def results(x: torch.Tensor):
            return np.asarray(x.cpu()), float(x.sum())
    """)


def test_host_sync_negative_host_scalars_in_step():
    # a float literal and np on host metadata are not device reads
    assert "host-sync-in-step" not in rules_of("""
        import numpy as np
        import torch

        def session_plan_tick(state: torch.Tensor, row_mask=None):
            inf = float("inf")
            B = state.shape[0]
            mask = np.ones(B, bool) if row_mask is None else \\
                np.asarray(row_mask, bool)
            return state + inf, mask
    """)


def test_step_scope_propagates_through_call_graph():
    # the helper is no seed, but the step reaches it
    assert "host-sync-in-step" in rules_of("""
        import torch

        def helper(x: torch.Tensor):
            return x.sum().item()

        def _run_chunk(x, chunk):
            return helper(x)
    """)


def test_step_scope_taints_torch_results():
    assert "host-sync-in-step" in rules_of("""
        import torch

        def _session_chunk(n):
            y = torch.zeros(n)
            return int(y.sum())
    """)


def test_step_seeds_are_per_module():
    src = """
        import torch

        def tick_core(x: torch.Tensor):
            return x.item()
    """
    assert "host-sync-in-step" in rules_of(src, COORD_PATH)
    assert "host-sync-in-step" not in rules_of(src, NEUTRAL_PATH)


# ---- branch-on-tensor ----------------------------------------------------

def test_branch_on_tensor_positive():
    assert "branch-on-tensor" in rules_of("""
        import torch

        def _tick(state: torch.Tensor):
            y = torch.sum(state)
            if y > 0:
                return y
            return -y
    """)


def test_while_on_tensor_positive():
    assert "branch-on-tensor" in rules_of("""
        import torch

        def _tick(state: torch.Tensor):
            while (state > 0).any():
                state = state - 1
            return state
    """)


def test_branch_negative_static_switches_and_identity():
    # branching on a structure switch, on `is None`, on membership in a
    # dict of tensors and on shapes is the sanctioned pattern
    assert "branch-on-tensor" not in rules_of("""
        import torch

        def _tick(state: torch.Tensor, n_end=None, *, with_dynamics: bool):
            session = n_end is not None
            rows = dict(a=state)
            if with_dynamics and session:
                state = state + 1
            if "a" in rows and state.shape[-1] > 0:
                return state
            return -state
    """)


# ---- implicit-dtype ------------------------------------------------------

@pytest.mark.parametrize("call", ["torch.tensor(x)", "torch.as_tensor(x)",
                                  "torch.from_numpy(x)"])
def test_implicit_dtype_positive_in_hot_module(call):
    assert "implicit-dtype" in rules_of(f"""
        import torch

        def f(x):
            return {call}
    """)


@pytest.mark.parametrize("call", [
    "torch.tensor(x, dtype=torch.float32)",
    "torch.as_tensor(x, dtype=torch.float32, device=d)",
    "torch.from_numpy(x).to(device=d, dtype=torch.float32)"])
def test_implicit_dtype_negative_with_explicit_dtype(call):
    assert "implicit-dtype" not in rules_of(f"""
        import torch

        def f(x, d):
            return {call}
    """)


def test_implicit_dtype_negative_outside_hot_modules():
    assert "implicit-dtype" not in rules_of("""
        import torch

        def f(x):
            return torch.as_tensor(x)
    """, NEUTRAL_PATH)


@pytest.mark.parametrize("expr", ["x.to(torch.float64)", "x.double()",
                                  "x.astype(np.float64)"])
def test_implicit_dtype_f64_in_step_function(expr):
    assert "implicit-dtype" in rules_of(f"""
        import numpy as np
        import torch

        def _tick(x: torch.Tensor):
            return {expr}
    """)


def test_implicit_dtype_f64_ok_in_host_result_path():
    assert "implicit-dtype" not in rules_of("""
        import numpy as np

        def results(state):
            return state.double(), np.asarray(state, np.float64)
    """)


# ---- host-pull-unaccounted -----------------------------------------------

@pytest.mark.parametrize("pull", ["np.asarray(self._state)",
                                  "self._state.tick.cpu()",
                                  "int(self._ctl[0].max())",
                                  "self._tb.size.tolist()"])
def test_host_pull_unaccounted_positive_pool_method(pull):
    assert "host-pull-unaccounted" in rules_of(f"""
        import numpy as np

        class P:
            def __init__(self):
                self.io = {{}}
                self._state = None

            def bad(self):
                return {pull}
    """, NEUTRAL_PATH)


def test_host_pull_accounted_negative():
    assert "host-pull-unaccounted" not in rules_of("""
        import numpy as np

        class P:
            def __init__(self):
                self.io = {}
                self._state = None

            def good(self):
                out = self._state.tick.cpu().numpy()
                self.io["download_bytes"] += out.nbytes
                return out
    """, NEUTRAL_PATH)


def test_host_pull_shape_reads_and_host_copies_are_not_pulls():
    assert "host-pull-unaccounted" not in rules_of("""
        import numpy as np

        class P:
            def __init__(self):
                self.io = {}
                self._state = None

            def meta(self):
                return int(np.prod(self._state.shape))

            def mirrors(self):
                tick_h, fin_h = self._download_ctl(self._state.tick)
                return int(tick_h[0]), bool(fin_h.all())
    """, NEUTRAL_PATH)


def test_host_pull_engine_host_function_positive():
    assert "host-pull-unaccounted" in rules_of("""
        def session_probe(state, tb, ep, ne):
            state = _session_chunk(state, tb, ep, ne, 4)
            return bool(_lanes_open(state, ne)), state.tick.max().item()
    """)


def test_host_pull_engine_rule_is_scoped_to_the_engine():
    assert "host-pull-unaccounted" not in rules_of("""
        def session_probe(state):
            return state.tick.max().item()
    """, NEUTRAL_PATH)


# ---- hygiene rules -------------------------------------------------------

def test_unused_import_positive_and_negative():
    assert "unused-import" in rules_of("import os\nx = 1\n")
    assert "unused-import" not in rules_of(
        "import os\nx = os.getcwd()\n")


def test_unused_variable_positive_and_negative():
    assert "unused-variable" in rules_of("""
        def f():
            y = 1
            return 2
    """)
    assert "unused-variable" not in rules_of("""
        def f():
            y = 1
            return y
    """)


# ---- suppressions --------------------------------------------------------

STEP = "import torch\n\ndef _tick(x: torch.Tensor):\n"


def test_suppression_with_reason_silences_matching_rule():
    src = (STEP + "    return x.item()  "
           "# saath: lint-ok(host-sync-in-step): fixture\n")
    assert "host-sync-in-step" not in {f.rule for f in
                                       lint_text(src, ENGINE_PATH)}


def test_suppression_requires_reason():
    # assembled so that the scanner does not read THIS file's line as a
    # reason-less suppression of its own
    marker = "# saath: " + "lint-ok(host-sync-in-step)"
    src = STEP + f"    return x.item()  {marker}\n"
    rules = {f.rule for f in lint_text(src, ENGINE_PATH)}
    assert "bad-suppression" in rules
    assert "host-sync-in-step" in rules   # unsuppressed without a reason


def test_suppression_wrong_rule_does_not_silence():
    src = (STEP + "    return x.item()  "
           "# saath: lint-ok(branch-on-tensor): wrong rule\n")
    assert "host-sync-in-step" in {f.rule for f in
                                   lint_text(src, ENGINE_PATH)}


def test_def_line_suppression_covers_function_body():
    src = ("import torch\n\n"
           "def _tick(x: torch.Tensor):  "
           "# saath: lint-ok(host-sync-in-step): whole body\n"
           "    y = x.cpu()\n"
           "    return y.item()\n")
    assert "host-sync-in-step" not in {f.rule for f in
                                       lint_text(src, ENGINE_PATH)}


def test_decorator_line_suppression_covers_function_body():
    src = ("import functools\nimport torch\n\n"
           "@functools.lru_cache  "
           "# saath: lint-ok(host-sync-in-step): fixture\n"
           "def _tick(x: torch.Tensor):\n"
           "    return x.item()\n")
    assert "host-sync-in-step" not in {f.rule for f in
                                       lint_text(src, ENGINE_PATH)}


def test_multiline_signature_suppression_covers_function_body():
    src = ("import torch\n\n"
           "def _tick(\n"
           "    x: torch.Tensor,  "
           "# saath: lint-ok(host-sync-in-step): fixture\n"
           "):\n"
           "    return x.item()\n")
    assert "host-sync-in-step" not in {f.rule for f in
                                       lint_text(src, ENGINE_PATH)}


def test_body_line_suppression_stays_line_local():
    src = ("import torch\n\n"
           "def _tick(x: torch.Tensor):\n"
           "    y = x.cpu()  "
           "# saath: lint-ok(host-sync-in-step): this line\n"
           "    return x.item()\n")
    findings = [f for f in lint_text(src, ENGINE_PATH)
                if f.rule == "host-sync-in-step"]
    assert [f for f in findings if f.line == 5]     # .item() survives
    assert not [f for f in findings if f.line == 4]


def test_nested_def_header_suppression_covers_inner_span_only():
    src = ("import torch\n\n"
           "def _tick(x: torch.Tensor):\n"
           "    def inner(y: torch.Tensor):  "
           "# saath: lint-ok(host-sync-in-step): inner only\n"
           "        return y.item()\n"
           "    z = inner(x)\n"
           "    return x.cpu(), z\n")
    findings = [f for f in lint_text(src, ENGINE_PATH)
                if f.rule == "host-sync-in-step"]
    assert [f for f in findings if f.line == 7]     # the outer's .cpu()
    assert not [f for f in findings if f.line == 5]


# ---- contract rules ------------------------------------------------------

def _fake_tree(tmp_path, pool_body):
    for d in ("traces", "fabric", "core", "api"):
        (tmp_path / "repro_torch" / d).mkdir(parents=True, exist_ok=True)
    (tmp_path / "repro_torch/traces/batch.py").write_text(
        textwrap.dedent("""
        class TraceBatch(NamedTuple):
            cid: int
            newcol: int

        def empty_batch():
            return dict(cid=0, newcol=0)

        def blank_row(tb):
            tb.cid = 0
            tb.newcol = 0

        def pack_row(tb):
            tb.cid = 1
    """))
    (tmp_path / "repro_torch/fabric/engine.py").write_text(
        "class EngineState(NamedTuple):\n    sent: int\n    tick: int\n"
        "    t0: int\n")
    (tmp_path / "repro_torch/core/coordinator.py").write_text(
        "class CoordState(NamedTuple):\n    queue: int\n")
    (tmp_path / "repro_torch/api/pool.py").write_text(
        textwrap.dedent(pool_body))
    return tmp_path


def test_slab_leaf_coverage_catches_forgotten_field(tmp_path):
    root = _fake_tree(tmp_path, """
        class SessionPool:
            def _blank_state_row(self):
                return self._eng.EngineState(sent=0, tick=0, t0=0), \\
                    co.CoordState(0)

            def _sync_row(self, st):
                return st.sent, st.tick, st.queue
    """)
    findings = slab_leaf_coverage(root)
    # pack_row forgot TraceBatch.newcol; everything else is covered
    # (CoordState is built positionally complete through its module, and
    # _sync_row may skip t0)
    assert [f for f in findings
            if "newcol" in f.msg and "pack_row" in f.msg]
    assert not [f for f in findings if "queue" in f.msg]
    assert not [f for f in findings if "t0" in f.msg]


def test_slab_leaf_coverage_catches_unsynced_engine_leaf(tmp_path):
    root = _fake_tree(tmp_path, """
        class SessionPool:
            def _blank_state_row(self):
                return EngineState(sent=0, tick=0, t0=0), CoordState(0)

            def _sync_row(self, st):
                return st.sent, st.queue
    """)
    findings = slab_leaf_coverage(root)
    assert [f for f in findings
            if "`tick`" in f.msg and "_sync_row" in f.msg]


def test_api_simulator_import_rule(tmp_path):
    api = tmp_path / "repro_torch" / "api"
    api.mkdir(parents=True)
    (api / "bad.py").write_text(
        "from repro_torch.fabric.simulator import Simulator\n")
    (api / "bad_module.py").write_text(
        "import repro_torch.fabric.simulator\n")
    (api / "good.py").write_text(
        "def f():\n    from repro_torch.fabric.simulator import Simulator\n"
        "    return Simulator\n")
    findings = api_simulator_imports(tmp_path)
    assert [f for f in findings if f.path.endswith("bad.py")]
    assert [f for f in findings if f.path.endswith("bad_module.py")]
    assert not [f for f in findings if f.path.endswith("good.py")]


def test_contract_rules_hold_on_the_port():
    root = SRC.resolve().parent
    assert slab_leaf_coverage(root) == []
    assert api_simulator_imports(root) == []


# The port's slab schema against the reference's: the fields each side
# has and the other lacks (none today). A field added on one side only
# fails here until it is ported or listed.
SCHEMA = {
    "TraceBatch": ("repro.traces.batch", "repro_torch.traces.batch"),
    "EngineState": ("repro.fabric.jax_engine", "repro_torch.fabric.engine"),
    "CoordState": ("repro.core.jax_coordinator",
                   "repro_torch.core.coordinator"),
}
SCHEMA_DIFFERENCES = {name: {"reference_only": (), "port_only": ()}
                      for name in SCHEMA}


@pytest.mark.parametrize("name", sorted(SCHEMA))
def test_slab_schema_equals_the_reference(name):
    import importlib

    ref_mod, port_mod = SCHEMA[name]
    ref = getattr(importlib.import_module(ref_mod), name)._fields
    port = getattr(importlib.import_module(port_mod), name)._fields
    diff = SCHEMA_DIFFERENCES[name]
    assert [f for f in ref if f not in diff["reference_only"]] == \
        [f for f in port if f not in diff["port_only"]]
    assert set(diff["reference_only"]) <= set(ref)
    assert set(diff["port_only"]) <= set(port)


# ---- the self-run gate ---------------------------------------------------

SUPPRESSION_BUDGET = 8


def test_port_src_is_lint_clean_within_suppression_budget():
    """`src/repro_torch` stays clean under the full rule set (contract
    rules included), with at most SUPPRESSION_BUDGET suppression
    comments, each with its reason: a new finding is fixed or gets a
    reasoned `# saath: lint-ok(rule): why` and a slot of the budget."""
    findings, n_suppressed = lint_paths([str(SRC)])
    assert not findings, "\n".join(str(f) for f in findings)
    comments = 0
    for path in sorted(SRC.rglob("*.py")):
        _, bad, count = _suppressions(path.read_text(), str(path))
        assert not bad, bad
        comments += count
    assert 0 < comments <= SUPPRESSION_BUDGET, comments
    assert n_suppressed >= comments


def test_the_real_host_syncs_are_suppressed_with_reasons():
    """The engine's real host reads (the replay's loop condition and its
    results, the session loop's flag read) carry reasoned suppressions:
    strip them and the rule finds each."""
    path = SRC / "fabric" / "engine.py"
    src = path.read_text()
    stripped = re.sub(r"  # saath: lint-ok\([a-z-]+\): .*", "", src)
    funcs = {f.msg.split("`")[1] for f in lint_text(stripped, str(path))
             if f.rule == "host-pull-unaccounted"}
    assert {"_drive", "_results", "_read_flag"} <= funcs
