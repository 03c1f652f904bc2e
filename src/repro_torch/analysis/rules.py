"""stdlib-`ast` lint rules for the port's eager device step and repo
hygiene: the counterpart of `repro.analysis.rules`.

The reference's rules guard a traced scope; the port has none (no
`torch.compile`, no CUDA graph), so its "traced scope" is the device
step: the functions reached from the seeds in `STEP_SEEDS` (the engine's
`_tick`, `_run_chunk`, `_session_chunk` and `session_plan_tick`, the
coordinator's `tick_core`), closed over the module's call graph and
lexical nesting. Code there runs once an event step and must never make
the host wait on the device.

The rule catalogue:

* ``host-sync-in-step``    — `.item()`, `.cpu()`, `.tolist()`,
  `.numpy()`, `float()` / `int()` / `bool()` of a tensor, or an `np.*`
  call on a tensor inside a device-step function: a host read that
  stalls the stream every step (the counterpart of `cast-in-trace` and
  `traced-np-call`); and `torch.tensor(..., device=...)` /
  `torch.as_tensor(..., device=...)` there, an upload of host data that
  no dispatch mode sees on the card.
* ``branch-on-tensor``     — a Python `if` / `while` whose condition
  mentions a tensor inside a device-step function: a hidden scalar read
  (the counterpart of `branch-on-tracer`).
* ``implicit-dtype``       — `torch.tensor` / `torch.as_tensor` without
  `dtype=`, `torch.from_numpy` not followed by a `.to(..., dtype)`, in
  `fabric/engine.py` and `core/coordinator.py`; a `float64` literal or
  a `.double()` inside a device-step function there: the input's dtype
  leaks into the f32 slab.
* ``host-pull-unaccounted``— a device value crossing to the host
  (`np.asarray` / `np.array`, `float` / `int` / `bool`, `.item()`,
  `.cpu()`, `.tolist()`, `.numpy()`) in a method of an io-counted class
  (`SessionPool`) that never touches `self.io`, over its device
  attributes (`_state`, `_tb`, `_ctl`, `_ep_stack`); or in a host
  function of `fabric/engine.py` (the replay and session loops), on the
  values the step returns: every host read must be counted or
  explicitly suppressed.
* ``unused-import``        — module-level import never referenced.
* ``unused-variable``      — function-local name assigned and never
  read.

A tensor is recognized by taint: parameters annotated with a tensor or
a slab type (`torch.Tensor`, `EngineState`, `TraceBatch`, ...), names
assigned from a `torch.*` call or from a tainted expression. Metadata
(`.shape`, `.dtype`, `.device`, `.dim()`, `.numel()`, `is None`
comparisons, `len()`, `isinstance()`) is not a tensor value.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

__all__ = ["Finding", "STEP_SEEDS", "lint_module", "step_functions"]


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


# the device step's seeds, by module path (suffix match)
STEP_SEEDS: Dict[str, Set[str]] = {
    "fabric/engine.py": {"_tick", "_run_chunk", "_session_chunk",
                         "session_plan_tick"},
    "core/coordinator.py": {"tick_core"},
}
# annotation names that make a parameter a tensor (or a tree of them)
TENSOR_TYPES = {"Tensor", "EngineState", "TraceBatch", "EngineParams",
                "CoordState", "CoflowBatch", "FlowView", "DynCoordParams"}
# attribute reads and method calls that yield host metadata, not
# device values: they break the taint walk
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "_fields"}
_META_METHODS = {"dim", "size", "numel", "element_size", "get_device",
                 "data_ptr", "is_contiguous", "stride"}
_META_CALLS = {"isinstance", "len", "hasattr", "type", "id", "callable"}
# method calls that pull a value to the host
_PULL_METHODS = {"item", "cpu", "tolist", "numpy"}
_CASTS = {"float", "int", "bool"}
# the pool's download helpers return host copies: their results are not
# device values (the pull inside them is the counted one)
_HOST_CALLS = {"_download", "_download_ctl", "_copy_to_host"}
_NP_ROOTS = {"np", "numpy"}
# device attrs of the io-counted pool class
_POOL_DEVICE_ATTRS = {"_state", "_tb", "_ctl", "_ep_stack"}
_POOL_DEVICE_CALLS = {"gather_rows", "session_advance", "session_plan_tick"}
# the engine's step functions return device values to its host loops
_ENGINE_DEVICE_CALLS = {"_run_chunk", "_session_chunk", "_lanes_open",
                        "_tick", "_init_state"}
_DTYPE_SCOPED = re.compile(r"(/|^)fabric/engine\.py$"
                           r"|(/|^)core/coordinator\.py$")


def _leaf_name(node) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _root_name(node) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _posix(path: str) -> str:
    return path.replace("\\", "/")


# ---- device-step scope -----------------------------------------------------

class _Funcs(ast.NodeVisitor):
    """Collect every function with its enclosing function."""

    def __init__(self):
        self.by_name: Dict[str, List[ast.AST]] = {}
        self.parents: Dict[ast.AST, Optional[ast.AST]] = {}
        self._stack: List[ast.AST] = []

    def _visit_def(self, node):
        self.by_name.setdefault(node.name, []).append(node)
        self.parents[node] = self._stack[-1] if self._stack else None
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def


def step_functions(tree: ast.AST, path: str) -> Set[ast.AST]:
    """The function nodes of this module that run inside the device
    step: the module's seeds (`STEP_SEEDS`), lexically nested defs, and
    the closure over the intra-module call graph."""
    posix = _posix(path)
    seeds: Set[str] = set()
    for suffix, names in STEP_SEEDS.items():
        if posix.endswith(suffix):
            seeds |= names
    funcs = _Funcs()
    funcs.visit(tree)
    step: Set[ast.AST] = set()
    for name in seeds:
        step.update(funcs.by_name.get(name, []))
    changed = bool(step)
    while changed:
        changed = False
        for nodes in funcs.by_name.values():
            for node in nodes:
                if node not in step and funcs.parents[node] in step:
                    step.add(node)
                    changed = True
        for node in list(step):
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                callee = None
                if isinstance(call.func, ast.Name):
                    callee = call.func.id
                elif isinstance(call.func, ast.Attribute) and \
                        _root_name(call.func) in ("self", "cls"):
                    callee = call.func.attr
                for cand in funcs.by_name.get(callee, []):
                    if cand not in step:
                        step.add(cand)
                        changed = True
    return step


def _own_nodes(func: ast.AST):
    """Walk `func`'s body without descending into nested defs."""
    todo = list(ast.iter_child_nodes(func))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.Lambda)):
            todo.extend(ast.iter_child_nodes(node))


# ---- taint -------------------------------------------------------------------

def _mentions(node, tainted: Set[str], device_calls: Set[str]) -> bool:
    """Does this expression reference a tensor: a tainted name or
    `self.` attribute, or a device-returning call? Metadata does not
    count."""
    if isinstance(node, ast.Attribute):
        if node.attr in _META_ATTRS:
            return False
        if _root_name(node) == "self" and f"self.{node.attr}" in tainted:
            return True
    if isinstance(node, ast.Name) and node.id in tainted:
        return True
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
            for op in node.ops):
        return False   # identity and container membership: host facts
    if isinstance(node, ast.Call):
        leaf = _leaf_name(node.func)
        if isinstance(node.func, ast.Name) and leaf in _META_CALLS:
            return False
        if isinstance(node.func, ast.Attribute) and \
                leaf in _META_METHODS | _HOST_CALLS:
            return False
        if leaf in device_calls:
            return True
    if isinstance(node, (ast.Lambda, ast.FunctionDef)):
        return False
    return any(_mentions(c, tainted, device_calls)
               for c in ast.iter_child_nodes(node))


def _from_torch(node) -> bool:
    """A call rooted at `torch` (a device op's result)."""
    return any(isinstance(c, ast.Call) and _root_name(c.func) == "torch"
               and _leaf_name(c.func) not in _META_CALLS
               for c in ast.walk(node))


def _annotated_tensor(arg: ast.arg) -> bool:
    if arg.annotation is None:
        return False
    names = {_leaf_name(n) for n in ast.walk(arg.annotation)}
    if isinstance(arg.annotation, ast.Constant) and \
            isinstance(arg.annotation.value, str):
        names |= set(re.findall(r"\w+", arg.annotation.value))
    return bool(names & TENSOR_TYPES)


def _params(func) -> List[ast.arg]:
    a = func.args
    return list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)


def _assign_targets(node) -> List[str]:
    out = []
    tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
    for tgt in tgts:
        if isinstance(tgt, ast.Name):
            out.append(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            out.extend(e.id for e in tgt.elts if isinstance(e, ast.Name))
    return out


def _propagate(func, tainted: Set[str], device_calls: Set[str],
               torch_taints: bool) -> Set[str]:
    """Close `tainted` over the assignments inside `func` (its own body;
    nested defs are walked as their own functions)."""
    for _ in range(6):
        grew = False
        for node in _own_nodes(func):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = node.value
                if value is None:
                    continue
                if not (_mentions(value, tainted, device_calls)
                        or (torch_taints and _from_torch(value))):
                    continue
                names = _assign_targets(node) if not isinstance(
                    node, ast.AugAssign) else (
                    [node.target.id] if isinstance(node.target, ast.Name)
                    else [])
            elif isinstance(node, ast.For):
                if not _mentions(node.iter, tainted, device_calls):
                    continue
                names = [e.id for e in ast.walk(node.target)
                         if isinstance(e, ast.Name)]
            else:
                continue
            for name in names:
                if name not in tainted:
                    tainted.add(name)
                    grew = True
        if not grew:
            break
    return tainted


def _pull_sites(func, tainted: Set[str], device_calls: Set[str],
                every_method_pull: bool = False) -> List[ast.Call]:
    """Calls inside `func` that pull a tensor to the host."""
    sites = []
    for node in _own_nodes(func):
        if not isinstance(node, ast.Call):
            continue
        leaf, root = _leaf_name(node.func), _root_name(node.func)
        hit = False
        if isinstance(node.func, ast.Attribute) and leaf in _PULL_METHODS \
                and root not in _NP_ROOTS:
            hit = every_method_pull or _mentions(node.func.value, tainted,
                                                 device_calls)
        elif isinstance(node.func, ast.Name) and leaf in _CASTS:
            hit = any(_mentions(a, tainted, device_calls)
                      for a in node.args)
        elif root in _NP_ROOTS:
            hit = any(_mentions(a, tainted, device_calls)
                      for a in list(node.args)
                      + [k.value for k in node.keywords])
        if hit:
            sites.append(node)
    return sites


def _step_taint(func) -> Set[str]:
    tainted = {a.arg for a in _params(func) if _annotated_tensor(a)}
    return _propagate(func, tainted, set(), torch_taints=True)


# ---- per-module rules ----------------------------------------------------

def _describe(call: ast.Call) -> str:
    leaf, root = _leaf_name(call.func), _root_name(call.func)
    if isinstance(call.func, ast.Attribute) and leaf in _PULL_METHODS:
        return f"`.{leaf}()`"
    if isinstance(call.func, ast.Name):
        return f"`{leaf}()` of a tensor"
    return f"`{root}.{leaf}` on a tensor"


def _check_step_bodies(tree, path, findings) -> None:
    for func in step_functions(tree, path):
        tainted = _step_taint(func)
        for site in _pull_sites(func, tainted, set(),
                                every_method_pull=True):
            findings.append(Finding(
                "host-sync-in-step", path, site.lineno,
                f"{_describe(site)} reads a device value inside "
                f"device-step function `{func.name}`"))
        for node in _own_nodes(func):
            if isinstance(node, ast.Call) and \
                    _root_name(node.func) == "torch" and \
                    _leaf_name(node.func) in ("tensor", "as_tensor") and \
                    any(kw.arg == "device" for kw in node.keywords):
                findings.append(Finding(
                    "host-sync-in-step", path, node.lineno,
                    f"`torch.{_leaf_name(node.func)}(..., device=...)` "
                    f"uploads host data inside device-step function "
                    f"`{func.name}`"))
        for node in _own_nodes(func):
            if isinstance(node, (ast.If, ast.While)) and \
                    _mentions(node.test, tainted, set()):
                kw = "if" if isinstance(node, ast.If) else "while"
                findings.append(Finding(
                    "branch-on-tensor", path, node.lineno,
                    f"Python `{kw}` on a tensor inside device-step "
                    f"function `{func.name}`"))


def _has_dtype(call: ast.Call, pos: int) -> bool:
    return len(call.args) > pos or any(kw.arg == "dtype"
                                       for kw in call.keywords)


def _check_implicit_dtype(tree, path, findings) -> None:
    if not _DTYPE_SCOPED.search(_posix(path)):
        return
    for func in step_functions(tree, path):
        for node in _own_nodes(func):
            if isinstance(node, ast.Attribute) and \
                    node.attr == "float64" and \
                    _root_name(node) in ("np", "numpy", "torch"):
                findings.append(Finding(
                    "implicit-dtype", path, node.lineno,
                    "float64 literal inside a device-step function of an "
                    "f32 hot module"))
            elif isinstance(node, ast.Call) and \
                    _leaf_name(node.func) == "double" and \
                    isinstance(node.func, ast.Attribute):
                findings.append(Finding(
                    "implicit-dtype", path, node.lineno,
                    "`.double()` inside a device-step function of an f32 "
                    "hot module"))
    # a from_numpy whose result is cast by `.to(dtype=...)` is explicit
    cast = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "to" and \
                isinstance(node.func.value, ast.Call) and \
                any(kw.arg == "dtype" for kw in node.keywords):
            cast.add(id(node.func.value))
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _root_name(node.func) == "torch"
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)):
            continue
        leaf = node.func.attr
        if leaf in ("tensor", "as_tensor") and not _has_dtype(node, 1):
            findings.append(Finding(
                "implicit-dtype", path, node.lineno,
                f"`torch.{leaf}` without an explicit dtype lets the "
                f"input's dtype leak into the f32 slab"))
        elif leaf == "from_numpy" and id(node) not in cast:
            findings.append(Finding(
                "implicit-dtype", path, node.lineno,
                "`torch.from_numpy` keeps the numpy dtype: cast it with "
                "`.to(..., dtype=...)`"))


def _check_host_pulls(tree, path, findings) -> None:
    # (a) methods of io-counted classes (SessionPool): a device pull in a
    # method that never references `self.io` is unaccounted
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        if not any(isinstance(n, ast.Attribute) and n.attr == "io"
                   and _root_name(n) == "self" for n in ast.walk(cls)):
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if meth.name == "__init__" or any(
                    isinstance(n, ast.Attribute) and n.attr == "io"
                    and _root_name(n) == "self" for n in ast.walk(meth)):
                continue
            tainted = {f"self.{a}" for a in _POOL_DEVICE_ATTRS}
            tainted = _propagate(meth, tainted, _POOL_DEVICE_CALLS, False)
            seen: Set[int] = set()
            for site in _pull_sites(meth, tainted, _POOL_DEVICE_CALLS):
                if site.lineno not in seen:
                    seen.add(site.lineno)
                    findings.append(Finding(
                        "host-pull-unaccounted", path, site.lineno,
                        f"device pull in `{cls.name}.{meth.name}` "
                        f"without `self.io` accounting"))
    # (b) the engine's host functions (the replay and session loops):
    # pulls of what the step returns are the host syncs of those loops
    if not _posix(path).endswith("fabric/engine.py"):
        return
    step = step_functions(tree, path)
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or func in step:
            continue
        tainted = {a.arg for a in _params(func)
                   if a.arg == "state" or _annotated_tensor(a)}
        tainted = _propagate(func, tainted, _ENGINE_DEVICE_CALLS, False)
        seen = set()
        for site in _pull_sites(func, tainted, _ENGINE_DEVICE_CALLS):
            if site.lineno not in seen:
                seen.add(site.lineno)
                findings.append(Finding(
                    "host-pull-unaccounted", path, site.lineno,
                    f"host sync on a device value in engine host "
                    f"function `{func.name}`"))


def _check_unused_imports(tree, src, path, findings) -> None:
    import_stmts = [n for n in tree.body
                    if isinstance(n, (ast.Import, ast.ImportFrom))]
    if not import_stmts:
        return
    lines = src.splitlines()
    import_lines = set()
    for node in import_stmts:
        end = getattr(node, "end_lineno", node.lineno)
        import_lines.update(range(node.lineno, end + 1))
    rest = "\n".join(line for i, line in enumerate(lines, 1)
                     if i not in import_lines)
    for node in import_stmts:
        if isinstance(node, ast.ImportFrom) and \
                node.module == "__future__":
            continue
        for alias in node.names:
            if alias.name == "*":
                continue
            bound = alias.asname or alias.name.split(".")[0]
            if not re.search(rf"\b{re.escape(bound)}\b", rest):
                findings.append(Finding(
                    "unused-import", path, node.lineno,
                    f"`{bound}` imported but never used"))


def _check_unused_variables(tree, path, findings) -> None:
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        declared: Set[str] = set()
        for node in ast.walk(func):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                declared.update(node.names)
        loads = {n.id for n in ast.walk(func)
                 if isinstance(n, ast.Name)
                 and isinstance(n.ctx, (ast.Load, ast.Del))}
        for node in _own_nodes(func):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if name.startswith("_") or name in declared or \
                    name in loads:
                continue
            findings.append(Finding(
                "unused-variable", path, node.lineno,
                f"`{name}` assigned in `{func.name}` but never read"))


def lint_module(path: str, src: str) -> List[Finding]:
    """All module-local findings for one source file (unsuppressed:
    `repro_torch.analysis.lint` applies the `# saath: lint-ok`
    filter)."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as exc:
        return [Finding("syntax-error", path, exc.lineno or 1,
                        str(exc.msg))]
    findings: List[Finding] = []
    _check_step_bodies(tree, path, findings)
    _check_implicit_dtype(tree, path, findings)
    _check_host_pulls(tree, path, findings)
    _check_unused_imports(tree, src, path, findings)
    _check_unused_variables(tree, path, findings)
    findings.sort(key=lambda f: (f.line, f.rule))
    return findings
