"""Slab coherence checker: effect extraction + typestate rules (the port
of `repro.analysis.coherence`).

The port's serving plane keeps the reference's host<->device coherence
protocol (DESIGN S9) in the same three files of `repro_torch` --
`api/pool.py` (the device-resident slab), `api/session.py` (the row
view), `launch/serve.py` (the tenant front door).  This module makes it
machine-checked, in three layers:

1. **Protocol declaration** (`PROTOCOL`): the tracked state variables
   of `SessionPool` / `SaathSession` / `CoflowServer` and what each
   one means.  The extractor only reasons about these names.

2. **Effect extraction** (`extract_effects`): a stdlib-AST walk over
   the three files that infers, per method, its read / write /
   invalidate / entry-write / call / transfer effect sets.  The
   result is pinned as a committed golden manifest
   (`analysis/torch_coherence_manifest.json`, same drift model as the
   dispatch auditor's `torch_dispatch_manifest.json`): effect drift is
   surfaced as a structured diff and blessed with `--update`.

3. **Typestate rules** (`check_protocol`): a path-sensitive must-facts
   walk enforcing the protocol:

   - `coh-dirty-on-write`    every coflow-membership / entry mutation
                             sets its dirty flag on all exit paths
   - `coh-sync-before-mirror` every ctl-mirror access is dominated by
                             `_sync_ctl()` (directly or via a callee
                             that provides it on every exit)
   - `coh-stale-folded-cache` every slab rewrite also touches its
                             folded dispatch cache (`CACHE_OF`: empty
                             until the port's sharded slab lands)
   - `coh-ctl-consume-once`  the deferred async ctl handle is armed in
                             one place, consumed exactly once
   - `coh-unaccounted-transfer` no public pool method reaches a
                             host<->device transfer outside an
                             `@_io_accounted` frame
   - `coh-fresh-index`       `_new_done` flips keep the `_fresh`
                             completion index in step, per block
   - `coh-harvest-before-read` server reads of `_pending` follow a
                             `_harvest()` in the same method

Known-good deviations are waived in `WAIVERS` with a reason; waivers
are part of the manifest so edits to them are reviewed like any other
drift.  `--selftest` runs the seeded-mutation harness: five single-site
coherence bugs are injected into in-memory copies of the sources and
the checker must flag each one with the expected rule (the reference's
sixth, a stale folded cache, needs the sharded slab's caches).

The port moves data through `engine.host_to_device`, `traces.batch.
to_device`, `SessionPool._download` and the engine's slab calls, so
those are its transfer leaves, beside numpy pulls and a tensor's
`.cpu()` / `.numpy()` / `.tolist()` / `.item()`.

Usage:
    python -m repro_torch.analysis.coherence             # gate vs manifest
    python -m repro_torch.analysis.coherence --update    # re-pin manifest
    python -m repro_torch.analysis.coherence --selftest  # mutation harness
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.rules import Finding

# ---- rule ids ------------------------------------------------------------

R_DIRTY = "coh-dirty-on-write"
R_SYNC = "coh-sync-before-mirror"
R_CACHE = "coh-stale-folded-cache"
R_HANDLE = "coh-ctl-consume-once"
R_IO = "coh-unaccounted-transfer"
R_FRESH = "coh-fresh-index"
R_HARVEST = "coh-harvest-before-read"

RULES = {
    R_DIRTY: "membership/entry mutations set their dirty flag on "
             "every exit path",
    R_SYNC: "ctl-mirror accesses are dominated by _sync_ctl()",
    R_CACHE: "slab/epoch-stack rewrites invalidate the folded "
             "dispatch caches",
    R_HANDLE: "the deferred ctl handle is armed once, consumed "
              "exactly once",
    R_IO: "public pool surface never reaches a transfer outside "
          "@_io_accounted",
    R_FRESH: "_new_done flips update the _fresh completion index in "
             "the same block",
    R_HARVEST: "server _pending reads follow _harvest() in the same "
               "method",
}

# ---- the protocol declaration -------------------------------------------

PROTOCOL: Dict[str, Dict[str, str]] = {
    "SessionPool": {
        "_tb": "device TraceBatch slab (row-major, padded)",
        "_state": "device EngineState/CoordState slab",
        "_ep_stack": "stacked per-row EngineParams; None means stale",
        "_ticks": "lazy host mirror of per-row device tick counters",
        "_fin": "lazy host mirror of the per-row completion bitmap",
        "_ctl": "deferred async ctl handle: (tick, finished) device "
                "tensors parked by _dispatch_async, consumed once by "
                "_sync_ctl",
        "_pend_rows": "rows with an in-flight async horizon "
                      "(row -> (session, n_end))",
        "_fresh": "sessions whose completion bitmap changed since "
                  "last gather (poll fast path)",
        "_blank_rows": "rows needing a blank-row scatter before next "
                       "dispatch",
        "_sessions": "row -> live SaathSession (None = free)",
        "_free": "sorted free-row list",
        "_scratch": "reusable host staging row",
        "io": "host<->device byte / dispatch accounting",
    },
    "SaathSession": {
        "_live": "handle -> live coflow entry (the membership set)",
        "_slots": "submission-ordered entry list, row-pack order",
        "_table": "numpy-backend staged FlowTable",
        "_policy": "numpy-backend coordinator instance",
        "_tb_dirty": "membership changed since last pack: row "
                     "re-pack required",
        "_state_dirty": "entry dynamic state diverged from the "
                        "packed row: state re-scatter required",
        "_host_stale": "device row advanced past the host entries",
        "_new_done": "completion bitmap changed on device; gather "
                     "before poll",
        "_host_done": "a harvested completion is waiting host-side",
        "_pend": "capped schedule interval carried across advances",
        "_pending": "numpy backend's capped interval (or None)",
        "_tick": "session tick in absolute (epoch-based) units",
        "_epoch": "row re-base epoch (f32 resolution guard)",
        "_clock": "wall-clock seconds fed to advance()",
        "_row": "pool row index (None after release)",
        "_pool": "owning SessionPool (None after release)",
        "_seq": "monotonic handle counter",
    },
    "CoflowServer": {
        "pool": "the shared SessionPool slab",
        "_tenants": "tenant -> SaathSession row view",
        "_pending": "tenant -> harvested-but-unpolled completions",
        "_deferred": "tenant -> quota-deferred submissions",
        "_agg": "tenant -> incremental TenantAggregates",
        "_quota": "tenant -> TenantQuota (None = unthrottled)",
        "_live_bytes": "tenant -> admitted-but-unfinished bytes",
    },
}

ENTRY_FIELDS = frozenset({
    "sent", "done", "fct", "rate", "pend_sent", "finished", "cct",
    "queue", "deadline", "running",
})
ENTRY_RECEIVERS = frozenset({"e", "entry"})

# ctl-mirror state: reads/writes require a dominating _sync_ctl()
SYNC_VARS = frozenset({"_ticks", "_fin", "_fresh", "_new_done"})
# membership vars whose mutation requires _tb_dirty on every exit
MEMBERSHIP_VARS = frozenset({"_live", "_slots"})
# slab source -> folded dispatch cache it must invalidate: the port has
# no folded per-shard caches until its sharded slab (ROADMAP queue A
# item 8), so no pair yet
CACHE_OF: Dict[str, str] = {}

_MUTATORS = frozenset({
    "add", "append", "clear", "discard", "extend", "insert", "pop",
    "popitem", "remove", "setdefault", "update",
})
_TRANSFER_LEAVES = frozenset({
    "scatter_rows", "gather_rows", "session_advance",
    "session_plan_tick", "host_to_device", "to_device", "_download",
})
# tensor methods that pull a value to the host
_PULL_METHODS = frozenset({"cpu", "numpy", "tolist", "item"})

FILES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("api/pool.py", ("SessionPool",)),
    ("api/session.py", ("SaathSession",)),
    ("launch/serve.py", ("CoflowServer",)),
)

# (qualified method, rule) -> reason.  Waivers ship in the manifest so
# edits to this table show up as reviewed drift.  Each is justified by
# the port's code (api/pool.py, api/session.py, launch/serve.py).
WAIVERS: Dict[Tuple[str, str], str] = {
    ("SessionPool._dispatch_async", R_SYNC):
        "the async fast path reads the stale tick mirror as the horizon "
        "of the rows it does not target -- a stale mirror can only "
        "under-ask, and a lane at its horizon is an exact no-op",
    ("SessionPool.release", R_SYNC):
        "the session identity check in _sync_ctl disarms the parked ctl "
        "of a released (maybe recycled) row; release only drops the "
        "session from _fresh",
    ("SaathSession.poll", R_DIRTY):
        "lazy slot reclaim: finished coflows stay packed as masked "
        "no-op rows until the next submit re-packs",
    ("SaathSession.close", R_DIRTY):
        "releases the row itself; clearing _live on a dead session "
        "needs no re-pack",
    ("CoflowServer.stats", R_HARVEST):
        "a monitoring snapshot (retained counts) may lag one harvest by "
        "design",
}

# methods allowed to write entry fields / membership without dirtying:
# they sync FROM the authoritative copy, so flagging would be wrong
LEGAL_SYNC_WRITERS = frozenset({
    "SessionPool._sync_row",
    "SaathSession._rebuild_table",
    "SaathSession._sync_from_table",
})

# internal pool methods that session/server code calls directly --
# they are public surface for rule purposes
CROSS_CLASS_ENTRIES = (
    "SessionPool._adopt",
    "SessionPool._advance",
    "SessionPool._materialize",
    "SessionPool._plan_tick",
)

MANIFEST_VERSION = 1


def default_manifest_path() -> Path:
    return Path(__file__).resolve().parents[3] / "analysis" \
        / "torch_coherence_manifest.json"


# ---- event extraction ----------------------------------------------------
# An event is (kind, name, hint, lineno):
#   kind: "r" read | "w" write | "ew" entry-field write |
#         "call" self-method call | "pcall" pool-method call |
#         "xfer" host<->device transfer
#   hint: for writes, the stored value's shape: "None" | "True" |
#         "False" | "elem" (container element) | "expr"


def _leaf(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _hint_of(value: ast.AST) -> str:
    if isinstance(value, ast.Constant):
        if value.value is None:
            return "None"
        if value.value is True:
            return "True"
        if value.value is False:
            return "False"
    return "expr"


def _is_np_pull(func: ast.AST) -> bool:
    return (isinstance(func, ast.Attribute)
            and func.attr in ("array", "asarray")
            and isinstance(func.value, ast.Name)
            and func.value.id in ("np", "numpy"))


def _expr_events(node, vars_, out) -> None:
    if node is None:
        return
    if isinstance(node, ast.Call):
        f = node.func
        leaf = _leaf(f)
        if leaf in _TRANSFER_LEAVES:
            out.append(("xfer", leaf, None, node.lineno))
        elif isinstance(f, ast.Attribute) and leaf in _PULL_METHODS \
                and not node.args:
            out.append(("xfer", "." + leaf + "()", None, node.lineno))
        elif _is_np_pull(f):
            out.append(("xfer", "np." + f.attr, None, node.lineno))
        elif leaf == "tree_map" and node.args \
                and _is_np_pull(node.args[0]):
            out.append(("xfer", "tree_map(np.asarray)", None,
                        node.lineno))
        if isinstance(f, ast.Attribute):
            recv = f.value
            if isinstance(recv, ast.Name) and recv.id == "self":
                for a in node.args:
                    _expr_events(a, vars_, out)
                for kw in node.keywords:
                    _expr_events(kw.value, vars_, out)
                out.append(("call", f.attr, None, node.lineno))
                return
            if isinstance(recv, ast.Attribute) \
                    and recv.attr in ("_pool", "pool") \
                    and isinstance(recv.value, ast.Name) \
                    and recv.value.id == "self":
                for a in node.args:
                    _expr_events(a, vars_, out)
                for kw in node.keywords:
                    _expr_events(kw.value, vars_, out)
                out.append(("pcall", f.attr, None, node.lineno))
                return
            if f.attr in _MUTATORS:
                base = recv
                if isinstance(base, ast.Subscript):
                    _expr_events(base.slice, vars_, out)
                    base = base.value
                if isinstance(base, ast.Attribute) \
                        and base.attr in vars_:
                    for a in node.args:
                        _expr_events(a, vars_, out)
                    for kw in node.keywords:
                        _expr_events(kw.value, vars_, out)
                    _expr_events(base.value, vars_, out)
                    out.append(("w", base.attr, "elem", node.lineno))
                    return
        for c in ast.iter_child_nodes(node):
            _expr_events(c, vars_, out)
        return
    if isinstance(node, ast.Attribute):
        _expr_events(node.value, vars_, out)
        if node.attr in vars_ and isinstance(node.ctx, ast.Load):
            out.append(("r", node.attr, None, node.lineno))
        return
    for c in ast.iter_child_nodes(node):
        _expr_events(c, vars_, out)


def _target_events(tgt, vars_, hint, out) -> None:
    if isinstance(tgt, ast.Attribute):
        _expr_events(tgt.value, vars_, out)
        if tgt.attr in vars_:
            out.append(("w", tgt.attr, hint, tgt.lineno))
        elif tgt.attr in ENTRY_FIELDS \
                and isinstance(tgt.value, ast.Name) \
                and tgt.value.id in ENTRY_RECEIVERS:
            out.append(("ew", tgt.attr, hint, tgt.lineno))
    elif isinstance(tgt, ast.Subscript):
        _expr_events(tgt.slice, vars_, out)
        base = tgt.value
        if isinstance(base, ast.Attribute):
            _expr_events(base.value, vars_, out)
            if base.attr in vars_:
                out.append(("w", base.attr, "elem", tgt.lineno))
            elif base.attr in ENTRY_FIELDS \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id in ENTRY_RECEIVERS:
                out.append(("ew", base.attr, "elem", tgt.lineno))
        else:
            _expr_events(base, vars_, out)
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for el in tgt.elts:
            _target_events(el, vars_, hint, out)
    elif isinstance(tgt, ast.Starred):
        _target_events(tgt.value, vars_, hint, out)
    # bare Name targets carry no tracked effect


def _aug_read(tgt, vars_, out) -> None:
    base = tgt
    if isinstance(base, ast.Subscript):
        base = base.value
    if isinstance(base, ast.Attribute) and base.attr in vars_:
        out.append(("r", base.attr, None, tgt.lineno))


def _stmt_header_events(stmt, vars_, out) -> None:
    """Events of a statement's own expressions (compound statements
    contribute only their header; bodies are walked separately)."""
    if isinstance(stmt, ast.Assign):
        _expr_events(stmt.value, vars_, out)
        tgts = stmt.targets
        if (len(tgts) == 1 and isinstance(tgts[0], (ast.Tuple, ast.List))
                and isinstance(stmt.value, ast.Tuple)
                and len(stmt.value.elts) == len(tgts[0].elts)):
            for el, v in zip(tgts[0].elts, stmt.value.elts):
                _target_events(el, vars_, _hint_of(v), out)
        else:
            hint = _hint_of(stmt.value)
            for tgt in tgts:
                _target_events(tgt, vars_, hint, out)
    elif isinstance(stmt, ast.AugAssign):
        _expr_events(stmt.value, vars_, out)
        _aug_read(stmt.target, vars_, out)
        _target_events(stmt.target, vars_, "expr", out)
    elif isinstance(stmt, ast.AnnAssign):
        if stmt.value is not None:
            _expr_events(stmt.value, vars_, out)
            _target_events(stmt.target, vars_, _hint_of(stmt.value),
                           out)
    elif isinstance(stmt, ast.Delete):
        for tgt in stmt.targets:
            _target_events(tgt, vars_, "elem", out)
    elif isinstance(stmt, ast.Expr):
        _expr_events(stmt.value, vars_, out)
    elif isinstance(stmt, ast.Assert):
        _expr_events(stmt.test, vars_, out)
        if stmt.msg is not None:
            _expr_events(stmt.msg, vars_, out)
    elif isinstance(stmt, ast.Return):
        if stmt.value is not None:
            _expr_events(stmt.value, vars_, out)
    elif isinstance(stmt, ast.Raise):
        if stmt.exc is not None:
            _expr_events(stmt.exc, vars_, out)
        if stmt.cause is not None:
            _expr_events(stmt.cause, vars_, out)
    elif isinstance(stmt, (ast.If, ast.While)):
        _expr_events(stmt.test, vars_, out)
    elif isinstance(stmt, ast.For):
        _expr_events(stmt.iter, vars_, out)
        _target_events(stmt.target, vars_, "expr", out)
    elif isinstance(stmt, ast.With):
        for item in stmt.items:
            _expr_events(item.context_expr, vars_, out)
            if item.optional_vars is not None:
                _target_events(item.optional_vars, vars_, "expr", out)
    # Pass/Break/Continue/Global/Import/Try headers: no expressions


def _iter_stmts(body):
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if sub:
                yield from _iter_stmts(sub)
        for h in getattr(stmt, "handlers", ()):
            yield from _iter_stmts(h.body)


class _Method:
    """One extracted method: flat effect events + summary bits."""

    def __init__(self, cls: str, name: str, path: str,
                 node: ast.FunctionDef, vars_) -> None:
        self.cls = cls
        self.name = name
        self.qual = f"{cls}.{name}"
        self.path = path
        self.node = node
        self.vars = vars_
        self.accounted = any(_leaf(d) == "_io_accounted"
                             for d in node.decorator_list)
        self.events: List[tuple] = []
        for stmt in _iter_stmts(node.body):
            _stmt_header_events(stmt, vars_, self.events)

    def writes_of(self, name: str):
        return [e for e in self.events if e[0] == "w" and e[1] == name]

    @property
    def xfers(self):
        return [e for e in self.events if e[0] == "xfer"]

    def summary(self) -> dict:
        reads, writes, inval, ew = set(), set(), set(), set()
        calls = set()
        for kind, name, hint, _line in self.events:
            if kind == "r":
                reads.add(name)
            elif kind == "w":
                (inval if hint == "None" else writes).add(name)
            elif kind == "ew":
                ew.add(name)
            elif kind == "call":
                calls.add("self." + name)
            elif kind == "pcall":
                calls.add("pool." + name)
        return {
            "reads": sorted(reads),
            "writes": sorted(writes),
            "invalidates": sorted(inval),
            "entry_writes": sorted(ew),
            "calls": sorted(calls),
            "transfers": bool(self.xfers),
            "accounted": self.accounted,
        }


def _load_sources(sources: Optional[Dict[str, str]] = None
                  ) -> Dict[str, str]:
    if sources is not None:
        return sources
    root = Path(__file__).resolve().parents[1]
    return {rel: (root / rel).read_text() for rel, _cls in FILES}


def extract_methods(sources: Optional[Dict[str, str]] = None
                    ) -> Dict[str, _Method]:
    src = _load_sources(sources)
    tracked_pool = (frozenset(PROTOCOL["SessionPool"])
                    | frozenset(PROTOCOL["SaathSession"]))
    methods: Dict[str, _Method] = {}
    for rel, classes in FILES:
        vars_ = (frozenset(PROTOCOL["CoflowServer"])
                 if rel == "launch/serve.py" else tracked_pool)
        tree = ast.parse(src[rel], filename=rel)
        for node in tree.body:
            if not isinstance(node, ast.ClassDef) \
                    or node.name not in classes:
                continue
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    m = _Method(node.name, item.name, rel, item, vars_)
                    methods[m.qual] = m
    return methods


# ---- the typestate walk --------------------------------------------------


class _State:
    __slots__ = ("facts", "may", "term")

    def __init__(self, facts=(), may=()):
        self.facts = set(facts)
        self.may = set(may)
        self.term = False

    def copy(self) -> "_State":
        s = _State(self.facts, self.may)
        s.term = self.term
        return s


def _join(st: "_State", a: "_State", b: "_State") -> None:
    st.may |= a.may | b.may
    if a.term and b.term:
        st.term = True
    elif a.term:
        st.facts = set(b.facts)
    elif b.term:
        st.facts = set(a.facts)
    else:
        st.facts = a.facts & b.facts


def _is_none_guard(test: ast.AST) -> bool:
    """`if self.X is None:` -- a degenerate-state early-out whose bare
    return does not count against provides_sync."""
    return (isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Is)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
            and isinstance(test.left, ast.Attribute))


class _Checker:
    """Fixpoint driver: repeats the per-method walk until the
    provides_sync / requires_sync / may_arm summaries stabilize, then
    one reporting pass emits findings."""

    def __init__(self, methods: Dict[str, _Method]) -> None:
        self.methods = methods
        self.provides: set = set()
        self.requires: Dict[str, tuple] = {}   # qual -> (line, why)
        self.may_arm = self._arm_closure()
        self.findings: List[Finding] = []

    # -- summary-level: which methods can (re-)arm the ctl handle
    def _arm_closure(self) -> set:
        armers = {q for q, m in self.methods.items()
                  if any(h not in ("None",)
                         for _k, n, h, _l in m.events
                         if _k == "w" and n == "_ctl")}
        changed = True
        while changed:
            changed = False
            for q, m in self.methods.items():
                if q in armers:
                    continue
                for kind, name, _h, _l in m.events:
                    callee = self._resolve(m, kind, name)
                    if callee in armers:
                        armers.add(q)
                        changed = True
                        break
        return armers

    def _resolve(self, m: _Method, kind: str, name: str
                 ) -> Optional[str]:
        if kind == "call":
            q = f"{m.cls}.{name}"
        elif kind == "pcall":
            q = f"SessionPool.{name}"
        else:
            return None
        return q if q in self.methods else None

    # -- the per-method path walk
    def run(self) -> List[Finding]:
        for _pass in range(10):
            before = (frozenset(self.provides),
                      frozenset(self.requires))
            self.requires = {}
            for m in self.methods.values():
                self._walk(m, report=False)
            if (frozenset(self.provides),
                    frozenset(self.requires)) == before:
                break
        self.findings = []
        for m in self.methods.values():
            self._walk(m, report=True)
        self._summary_rules()
        self._report_sync_entries()
        seen, out = set(), []
        for f in sorted(self.findings,
                        key=lambda f: (f.path, f.line, f.rule)):
            key = (f.rule, f.path, f.line, f.msg)
            if key not in seen:
                seen.add(key)
                out.append(f)
        return out

    def _waived(self, m: _Method, rule: str) -> bool:
        return (m.qual, rule) in WAIVERS

    def _walk(self, m: _Method, report: bool) -> None:
        self._m = m
        self._report = report
        self._exits: List[bool] = []
        self._guard = 0
        self._r1_hit: set = set()
        self._r7_hit = False
        st = _State()
        self._block(m.node.body, st)
        if not st.term:
            self._exit(st, m.node.body[-1].lineno if m.node.body
                       else m.node.lineno)
        provides = (m.qual == "SessionPool._sync_ctl"
                    or (bool(self._exits) and all(self._exits)))
        if provides:
            self.provides.add(m.qual)
        else:
            self.provides.discard(m.qual)

    def _block(self, body, st: "_State") -> None:
        due = None
        for stmt in body:
            if st.term:
                break
            due = self._stmt(stmt, st, due)
        if due is not None and self._report \
                and self._m.name != "__init__" \
                and not self._waived(self._m, R_FRESH):
            self.findings.append(Finding(
                R_FRESH, self._m.path, due,
                f"{self._m.qual}: _new_done updated without a "
                f"matching _fresh update in the same block"))

    def _stmt(self, stmt, st: "_State", due):
        ev: List[tuple] = []
        _stmt_header_events(stmt, self._m.vars, ev)
        due = self._events(ev, st, due)
        t = type(stmt)
        if t is ast.Return:
            self._exit(st, stmt.lineno)
            st.term = True
        elif t in (ast.Raise, ast.Break, ast.Continue):
            st.term = True
        elif t is ast.If:
            guarded = _is_none_guard(stmt.test)
            a = st.copy()
            if guarded:
                self._guard += 1
            self._block(stmt.body, a)
            if guarded:
                self._guard -= 1
            b = st.copy()
            self._block(stmt.orelse, b)
            _join(st, a, b)
        elif t in (ast.For, ast.While):
            body = st.copy()
            self._block(stmt.body, body)
            st.may |= body.may
            if stmt.orelse:
                self._block(stmt.orelse, st)
        elif t is ast.With:
            self._block(stmt.body, st)
        elif t is ast.Try:
            body = st.copy()
            self._block(stmt.body, body)
            st.may |= body.may
            for h in stmt.handlers:
                hs = st.copy()
                self._block(h.body, hs)
                st.may |= hs.may
            if stmt.orelse:
                self._block(stmt.orelse, st)
            if stmt.finalbody:
                self._block(stmt.finalbody, st)
        return due

    def _events(self, ev, st: "_State", due):
        m = self._m
        for kind, name, hint, line in ev:
            if kind in ("r", "w") and name in SYNC_VARS:
                self._need_sync(st, line, f"touches `{name}`")
            if kind == "w":
                if name in MEMBERSHIP_VARS:
                    st.may.add("w:mem")
                elif name in ("_tb_dirty", "_state_dirty"):
                    if hint == "True":
                        st.facts.add("f:" + name)
                elif name == "_new_done":
                    due = line
                elif name == "_fresh":
                    due = None
                elif name == "_ctl" and hint != "None":
                    st.facts.discard("synced")
            elif kind == "r":
                if (name == "_pending" and m.cls == "CoflowServer"
                        and "harvested" not in st.facts
                        and m.name not in ("_harvest", "__init__")
                        and not self._waived(m, R_HARVEST)
                        and self._report and not self._r7_hit):
                    self._r7_hit = True
                    self.findings.append(Finding(
                        R_HARVEST, m.path, line,
                        f"{m.qual}: reads _pending without a "
                        f"preceding _harvest() in this method"))
            elif kind == "ew":
                if m.qual not in LEGAL_SYNC_WRITERS:
                    st.may.add("w:entry")
            elif kind in ("call", "pcall"):
                callee = self._resolve(m, kind, name)
                if callee == "SessionPool._sync_ctl":
                    st.facts.add("synced")
                    continue
                if m.cls == "CoflowServer" and kind == "call" \
                        and name == "_harvest":
                    st.facts.add("harvested")
                if callee is None:
                    continue
                if callee in self.may_arm:
                    st.facts.discard("synced")
                if callee in self.provides:
                    st.facts.add("synced")
                elif callee in self.requires \
                        and "synced" not in st.facts:
                    cl, why = self.requires[callee]
                    self._need_sync(
                        st, line, f"calls {callee} which {why} "
                        f"({self.methods[callee].path}:{cl})")
        return due

    def _need_sync(self, st: "_State", line: int, why: str) -> None:
        m = self._m
        if "synced" in st.facts or m.name == "__init__" \
                or m.qual == "SessionPool._sync_ctl" \
                or m.qual in LEGAL_SYNC_WRITERS \
                or self._waived(m, R_SYNC):
            return
        if m.qual not in self.requires:
            self.requires[m.qual] = (line, why)

    def _exit(self, st: "_State", line: int) -> None:
        if self._guard == 0:
            self._exits.append("synced" in st.facts)
        if not self._report:
            return
        m = self._m
        if m.name == "__init__" or m.qual in LEGAL_SYNC_WRITERS \
                or self._waived(m, R_DIRTY):
            return
        for tag, flag in (("w:mem", "_tb_dirty"),
                          ("w:entry", "_state_dirty")):
            if tag in st.may and "f:" + flag not in st.facts \
                    and (tag, line) not in self._r1_hit:
                self._r1_hit.add((tag, line))
                self.findings.append(Finding(
                    R_DIRTY, m.path, line,
                    f"{m.qual}: exits after a "
                    f"{'membership' if tag == 'w:mem' else 'entry'} "
                    f"mutation without setting {flag}"))

    # -- method-summary rules (path-insensitive)
    def _summary_rules(self) -> None:
        self._rule_cache()
        self._rule_handle()
        self._rule_io()

    def _rule_cache(self) -> None:
        for m in self.methods.values():
            if m.cls != "SessionPool" or m.name == "__init__":
                continue
            for src_var, cache in CACHE_OF.items():
                real = [e for e in m.writes_of(src_var)
                        if e[2] != "None"]
                if real and not m.writes_of(cache) \
                        and not self._waived(m, R_CACHE):
                    self.findings.append(Finding(
                        R_CACHE, m.path, real[0][3],
                        f"{m.qual}: rewrites {src_var} without "
                        f"invalidating or refreshing {cache}"))

    def _rule_handle(self) -> None:
        allowed = {"SessionPool.__init__",
                   "SessionPool._dispatch_async",
                   "SessionPool._sync_ctl"}
        for m in self.methods.values():
            touches = [e for e in m.events
                       if e[0] in ("r", "w") and e[1] == "_ctl"]
            if touches and m.qual not in allowed:
                self.findings.append(Finding(
                    R_HANDLE, m.path, touches[0][3],
                    f"{m.qual}: touches the deferred ctl handle; "
                    f"only _dispatch_async may arm it and only "
                    f"_sync_ctl may consume it"))
        consumer = self.methods.get("SessionPool._sync_ctl")
        if consumer is not None:
            reads = [e for e in consumer.events
                     if e[0] == "r" and e[1] == "_ctl"]
            resets = [e for e in consumer.writes_of("_ctl")
                      if e[2] == "None"]
            if reads and not resets:
                self.findings.append(Finding(
                    R_HANDLE, consumer.path, reads[0][3],
                    "SessionPool._sync_ctl: consumes the ctl handle "
                    "without resetting it to None -- a second sync "
                    "would double-consume the download"))

    def _rule_io(self) -> None:
        pool = {q: m for q, m in self.methods.items()
                if m.cls == "SessionPool"}
        entries = [q for q, m in pool.items()
                   if not m.name.startswith("_")]
        entries += [q for q in CROSS_CLASS_ENTRIES if q in pool]
        reported = set()
        for entry in entries:
            hit = self._find_unaccounted(pool, entry, set())
            if hit is not None and hit not in reported:
                reported.add(hit)
                q, line, desc = hit[0], hit[1], hit[2]
                self.findings.append(Finding(
                    R_IO, pool[q].path, line,
                    f"{q}: reachable from public surface "
                    f"({entry.split('.')[1]}) and performs `{desc}` "
                    f"outside an @_io_accounted frame"))

    def _find_unaccounted(self, pool, qual, seen):
        m = pool.get(qual)
        if m is None or m.accounted or qual in seen:
            return None
        seen.add(qual)
        if m.xfers:
            _k, desc, _h, line = m.xfers[0]
            return (qual, line, desc)
        for kind, name, _h, _l in m.events:
            if kind != "call":
                continue
            hit = self._find_unaccounted(
                pool, f"SessionPool.{name}", seen)
            if hit is not None:
                return hit
        return None

    def _report_sync_entries(self) -> None:
        entries = {q for q, m in self.methods.items()
                   if not m.name.startswith("_")}
        entries.update(CROSS_CLASS_ENTRIES)
        for q in sorted(entries & set(self.requires)):
            line, why = self.requires[q]
            m = self.methods[q]
            self.findings.append(Finding(
                R_SYNC, m.path, line,
                f"{q}: {why} with no dominating _sync_ctl()"))


# ---- public API ----------------------------------------------------------


def check_protocol(sources: Optional[Dict[str, str]] = None
                   ) -> List[Finding]:
    """Run every coherence rule; return surviving findings."""
    return _Checker(extract_methods(sources)).run()


def build_manifest(sources: Optional[Dict[str, str]] = None) -> dict:
    methods = extract_methods(sources)
    checker = _Checker(methods)
    checker.run()
    entries = {}
    for qual in sorted(methods):
        m = methods[qual]
        s = m.summary()
        s["file"] = m.path
        s["provides_sync"] = qual in checker.provides
        entries[qual] = s
    return {
        "protocol_version": MANIFEST_VERSION,
        "protocol": PROTOCOL,
        "rules": RULES,
        "waivers": {f"{q}::{r}": why
                    for (q, r), why in sorted(WAIVERS.items())},
        "methods": entries,
    }


def check_manifest(manifest: dict,
                   sources: Optional[Dict[str, str]] = None
                   ) -> List[str]:
    """Structured drift report between the committed manifest and a
    fresh extraction.  Empty list == no drift."""
    cur = build_manifest(sources)
    problems: List[str] = []
    if manifest.get("protocol_version") != MANIFEST_VERSION:
        problems.append(
            f"manifest protocol_version "
            f"{manifest.get('protocol_version')} != "
            f"{MANIFEST_VERSION}")
        return problems
    for section in ("protocol", "waivers"):
        if manifest.get(section) != cur[section]:
            problems.append(
                f"{section} declaration drifted from the committed "
                f"manifest -- re-pin with --update after review")
    old_m = manifest.get("methods", {})
    new_m = cur["methods"]
    for q in sorted(set(old_m) - set(new_m)):
        problems.append(f"{q}: in the manifest but no longer "
                        f"extracted (removed or renamed)")
    for q in sorted(set(new_m) - set(old_m)):
        problems.append(f"{q}: new method, not in the manifest")
    for q in sorted(set(new_m) & set(old_m)):
        diff = _method_diff(old_m[q], new_m[q])
        if diff:
            problems.append(f"{q}: effect drift\n" + "\n".join(diff))
    return problems


def _method_diff(old: dict, new: dict) -> List[str]:
    out = []
    for field in ("reads", "writes", "invalidates", "entry_writes",
                  "calls"):
        o, n = set(old.get(field, ())), set(new.get(field, ()))
        for name in sorted(n - o):
            out.append(f"  + {field[:-1]}: {name}")
        for name in sorted(o - n):
            out.append(f"  - {field[:-1]}: {name}")
    for field in ("transfers", "accounted", "provides_sync", "file"):
        o, n = old.get(field), new.get(field)
        if o != n:
            out.append(f"  {field}: {o} -> {n}")
    return out


# ---- seeded-mutation selftest -------------------------------------------

# the reference's sixth, `stale-folded-cache`, comes back with the
# sharded slab's folded caches (ROADMAP queue A item 8)
SEEDED_MUTATIONS: Tuple[Tuple[str, str, str, str, str], ...] = (
    ("dropped-dirty-flag-set", "api/session.py",
     "        self._tb_dirty = True\n        return handles",
     "        return handles",
     R_DIRTY),
    ("skipped-sync-ctl", "api/pool.py",
     "        self._sync_ctl()\n"
     "        if completions_only and not self._fresh:",
     "        if completions_only and not self._fresh:",
     R_SYNC),
    ("double-consumed-ctl-handle", "api/pool.py",
     "        tick_dev, fin_dev = self._ctl\n"
     "        self._ctl = None",
     "        tick_dev, fin_dev = self._ctl",
     R_HANDLE),
    ("unaccounted-transfer", "api/pool.py",
     "    @_io_accounted\n    def host_view",
     "    def host_view",
     R_IO),
    ("unflagged-fresh-set-update", "api/pool.py",
     "                s._new_done = True\n"
     "                self._fresh.add(s)",
     "                s._new_done = True",
     R_FRESH),
)


def run_selftest(out=sys.stdout) -> int:
    """Inject each seeded coherence bug into an in-memory copy of the
    sources and assert the checker flags it with the expected rule."""
    clean = _load_sources()
    base = check_protocol(clean)
    if base:
        print("selftest: checker is not clean on the pristine "
              "sources:", file=out)
        for f in base:
            print(f"  {f}", file=out)
        return 1
    failures = 0
    for name, rel, old, new, rule in SEEDED_MUTATIONS:
        src = dict(clean)
        if src[rel].count(old) != 1:
            print(f"selftest: FAIL {name}: mutation anchor occurs "
                  f"{src[rel].count(old)}x in {rel} (want 1) -- "
                  f"update SEEDED_MUTATIONS", file=out)
            failures += 1
            continue
        src[rel] = src[rel].replace(old, new)
        found = {f.rule for f in check_protocol(src)}
        if rule in found:
            print(f"selftest: ok   {name} -> [{rule}]", file=out)
        else:
            print(f"selftest: FAIL {name}: expected [{rule}], "
                  f"checker reported {sorted(found) or 'nothing'}",
                  file=out)
            failures += 1
    n = len(SEEDED_MUTATIONS)
    print(f"selftest: {n - failures}/{n} seeded coherence bugs "
          f"caught", file=out)
    return 1 if failures else 0


# ---- CLI -----------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.coherence",
        description="slab coherence checker of the port (DESIGN S9)")
    ap.add_argument("--update", action="store_true",
                    help="re-extract effects and rewrite the golden "
                         "manifest")
    ap.add_argument("--manifest", type=Path,
                    default=default_manifest_path())
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded-mutation harness")
    args = ap.parse_args(argv)

    if args.selftest:
        return run_selftest()

    findings = check_protocol()
    for f in findings:
        print(f"coherence: {f}")
    if findings:
        print(f"coherence: {len(findings)} protocol violation(s) -- "
              f"fix the site or add a reasoned WAIVERS entry",
              file=sys.stderr)
        # rule findings are a hard gate: --update must not bless them
        return 1

    if args.update:
        manifest = build_manifest()
        args.manifest.parent.mkdir(parents=True, exist_ok=True)
        args.manifest.write_text(json.dumps(manifest, indent=1,
                                            sort_keys=True) + "\n")
        print(f"coherence: wrote {args.manifest} "
              f"({len(manifest['methods'])} methods)")
        return 0

    if not args.manifest.exists():
        print(f"coherence: no manifest at {args.manifest} -- run "
              f"`python -m repro_torch.analysis.coherence --update` "
              f"to pin one", file=sys.stderr)
        return 1
    problems = check_manifest(json.loads(args.manifest.read_text()))
    for p in problems:
        print(f"coherence: {p}")
    if problems:
        print(f"coherence: {len(problems)} effect drift(s) vs "
              f"{args.manifest.name} -- review the diff above, then "
              f"bless with `python -m repro_torch.analysis.coherence "
              f"--update`", file=sys.stderr)
        return 1
    print(f"coherence: ok -- {len(json.loads(args.manifest.read_text())['methods'])} "
          f"methods match the pinned protocol")
    return 0


if __name__ == "__main__":
    sys.exit(main())
