"""Repo-contract rules: slab schemas vs. the machinery that moves them
(the port of `repro.analysis.contracts`).

These rules are cross-file — they check that the pack/blank/sync
machinery keeps up with the slab NamedTuple schemas — so they run once
per lint invocation against the live `repro_torch` package sources
rather than per scanned file:

* ``slab-leaf-coverage`` — every `TraceBatch` field must be written by
  `pack_row`, `blank_row`, and `empty_batch` (traces/batch.py), and
  every `EngineState` (fabric/engine.py) / `CoordState`
  (core/coordinator.py) leaf must be handled by the pool's
  `_blank_state_row` and `_sync_row` (api/pool.py). Catches
  the "added a field, forgot the scatter" class statically: a new
  slab column that the blank/pack/sync paths silently zero or drop.
  `_SYNC_ALLOW` lists the documented exceptions (`t0` is pinned to 0
  for sessions — epochs are re-based host-side — so `_sync_row`
  intentionally never reads it).
* ``api-simulator-import`` — no MODULE-level import of the event-driven
  `Simulator` (`fabric/simulator.py`) inside `repro_torch.api`: the
  front door must stay importable (and its torch plane usable) without
  dragging in the host event loop; the numpy branch imports it lazily.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.analysis.rules import Finding

__all__ = ["check_contracts", "slab_leaf_coverage",
           "api_simulator_imports"]

# documented per-function exceptions: {function: {field, ...}}
_SYNC_ALLOW = {"_sync_row": {"t0"}}


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _class_fields(tree: ast.Module, cls_name: str) -> List[str]:
    """Annotated field names of a NamedTuple/dataclass class."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return [stmt.target.id for stmt in node.body
                    if isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)]
    return []


def _func_node(tree: ast.Module, name: str) -> Optional[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _func_source(tree: ast.Module, src: str,
                 name: str) -> Optional[str]:
    node = _func_node(tree, name)
    return None if node is None else ast.get_source_segment(src, node)


def _positional_ctors(func: Optional[ast.AST]) -> Dict[str, int]:
    """Class constructors (`Name(...)` or `module.Name(...)`) called
    with ONLY positional args inside `func`, mapped to their arg count.
    A complete positional
    construction covers every field of that class: a newly added field
    turns it into a TypeError at the call site, so nothing can be
    silently dropped."""
    out: Dict[str, int] = {}
    if func is None:
        return out
    for node in ast.walk(func):
        name = node.func.id if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Name) else node.func.attr \
            if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) else ""
        if name[:1].isupper() and not node.keywords:
            out[name] = max(out.get(name, 0), len(node.args))
    return out


def _coverage(fields: List[str], cls_name: str, schema_path: str,
              tree: ast.Module, src: str, path: Path,
              func_names: List[str]) -> List[Finding]:
    findings = []
    for fn in func_names:
        seg = _func_source(tree, src, fn)
        if seg is None:
            findings.append(Finding(
                "slab-leaf-coverage", str(path), 1,
                f"expected slab machinery `{fn}` not found"))
            continue
        allow = _SYNC_ALLOW.get(fn, set())
        for field in fields:
            if field in allow:
                continue
            if not re.search(rf"\b{re.escape(field)}\b", seg):
                findings.append(Finding(
                    "slab-leaf-coverage", str(path), 1,
                    f"{cls_name}.{field} ({schema_path}) is not "
                    f"handled by `{fn}`"))
    return findings


def slab_leaf_coverage(src_root: Path) -> List[Finding]:
    """TraceBatch fields vs traces/batch.py machinery; EngineState +
    CoordState leaves vs the pool's blank/sync row paths."""
    findings: List[Finding] = []
    batch_py = src_root / "repro_torch" / "traces" / "batch.py"
    engine_py = src_root / "repro_torch" / "fabric" / "engine.py"
    coord_py = src_root / "repro_torch" / "core" / "coordinator.py"
    pool_py = src_root / "repro_torch" / "api" / "pool.py"

    b_src = batch_py.read_text()
    b_tree = ast.parse(b_src, filename=str(batch_py))
    tb_fields = _class_fields(b_tree, "TraceBatch")
    if not tb_fields:
        return [Finding("slab-leaf-coverage", str(batch_py), 1,
                        "TraceBatch schema not found")]
    findings += _coverage(tb_fields, "TraceBatch", "traces/batch.py",
                          b_tree, b_src, batch_py,
                          ["pack_row", "blank_row", "empty_batch"])

    schemas = [
        ("EngineState", _class_fields(_parse(engine_py), "EngineState"),
         "fabric/engine.py"),
        ("CoordState", _class_fields(_parse(coord_py), "CoordState"),
         "core/coordinator.py"),
    ]
    if not all(fields for _, fields, _ in schemas):
        return findings + [Finding(
            "slab-leaf-coverage", str(engine_py), 1,
            "EngineState/CoordState schema not found")]
    p_src = pool_py.read_text()
    p_tree = ast.parse(p_src, filename=str(pool_py))
    for fn in ("_blank_state_row", "_sync_row"):
        node = _func_node(p_tree, fn)
        seg = _func_source(p_tree, p_src, fn)
        if seg is None:
            findings.append(Finding(
                "slab-leaf-coverage", str(pool_py), 1,
                f"expected slab machinery `{fn}` not found"))
            continue
        allow = _SYNC_ALLOW.get(fn, set())
        ctors = _positional_ctors(node)
        for cls_name, fields, origin in schemas:
            if ctors.get(cls_name, -1) == len(fields):
                continue  # complete positional construction
            for field in fields:
                if field in allow:
                    continue
                if not re.search(rf"\b{re.escape(field)}\b", seg):
                    findings.append(Finding(
                        "slab-leaf-coverage", str(pool_py), 1,
                        f"{cls_name} leaf `{field}` ({origin}) is not "
                        f"handled by `SessionPool.{fn}`"))
    return findings


def api_simulator_imports(src_root: Path) -> List[Finding]:
    """Module-level Simulator imports under repro_torch/api are
    forbidden — the lazy function-scoped import of the numpy branch is
    the sanctioned pattern."""
    findings = []
    for path in sorted((src_root / "repro_torch" / "api").glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:  # module level only
            names = []
            if isinstance(node, ast.ImportFrom):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            if isinstance(node, ast.ImportFrom) and node.module:
                names.append(node.module)
            if any(n == "Simulator" or n.endswith(".simulator")
                   for n in names):
                findings.append(Finding(
                    "api-simulator-import", str(path), node.lineno,
                    "module-level import of the event-driven Simulator "
                    "in repro_torch.api (import it inside the numpy "
                    "branch)"))
    return findings


def check_contracts(src_root: Path) -> List[Finding]:
    return slab_leaf_coverage(src_root) + api_simulator_imports(src_root)
