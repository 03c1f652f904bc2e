"""Lint driver: discovery, suppression filtering, reporting (the port
of `repro.analysis.lint`).

Usage::

    python -m repro_torch.analysis.lint [paths...]   # default: src/repro_torch

Exit status 1 if any finding survives suppression. Suppressions are
in-source comments::

    done = bool(flag)  # saath: lint-ok(host-pull-unaccounted): the loop's counted flag read

The rule name is mandatory and must match the finding's rule; the
reason (after the colon) is mandatory too — a bare `lint-ok` is itself
reported (`bad-suppression`). A suppression on a `def` line covers the
whole function body. Cross-file contract rules
(`repro_torch.analysis.contracts`) run once per invocation against the
live `repro_torch` package sources regardless of the paths given.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.analysis import contracts
from repro_torch.analysis.rules import Finding, lint_module

__all__ = ["lint_paths", "lint_text", "main"]

_SUPPRESS = re.compile(
    r"#\s*saath:\s*lint-ok\(([a-z0-9-]+)\)(?::\s*(\S.*))?")


def _suppressions(src: str, path: str
                  ) -> Tuple[Dict[int, str], List[Finding], int]:
    """Map line -> suppressed rule. A suppression anywhere on a def's
    HEADER — a decorator line, the `def` line, or a continuation line
    of a multi-line signature — covers the def's whole span; one on a
    body line stays line-local. Returns (line map, bad-suppression
    findings, count of suppression comments)."""
    import ast

    lines = src.splitlines()
    # (header_lo, header_hi, end): header runs from the first
    # decorator through the last signature line (the line before the
    # body starts — or the def line itself for one-liners)
    spans: List[Tuple[int, int, int]] = []
    try:
        tree = ast.parse(src, filename=path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                header_lo = min([node.lineno]
                                + [d.lineno for d in node.decorator_list])
                header_hi = max(node.lineno,
                                node.body[0].lineno - 1)
                spans.append((header_lo, header_hi,
                              getattr(node, "end_lineno", node.lineno)))
    except SyntaxError:
        pass
    by_line: Dict[int, str] = {}
    bad: List[Finding] = []
    count = 0
    for i, line in enumerate(lines, 1):
        m = _SUPPRESS.search(line)
        if not m:
            continue
        count += 1
        rule, reason = m.group(1), m.group(2)
        if not reason:
            bad.append(Finding(
                "bad-suppression", path, i,
                f"lint-ok({rule}) without a reason — write "
                f"`# saath: lint-ok({rule}): <why>`"))
            continue
        targets = [i]
        # innermost def whose header contains this line wins
        best = None
        for lo, hi, end in spans:
            if lo <= i <= hi and (best is None or lo > best[0]):
                best = (lo, end)
        if best is not None:
            targets = list(range(best[0], best[1] + 1))
        for ln in targets:
            by_line[ln] = rule
    return by_line, bad, count


def lint_text(src: str, path: str = "<string>") -> List[Finding]:
    """Lint one source blob (module-local rules only) with suppression
    filtering applied — the unit the fixture tests drive."""
    findings = lint_module(path, src)
    by_line, bad, _ = _suppressions(src, path)
    kept = [f for f in findings if by_line.get(f.line) != f.rule]
    return kept + bad


def _discover(paths: List[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(
                f for f in path.rglob("*.py")
                if "__pycache__" not in f.parts))
        elif path.suffix == ".py":
            files.append(path)
    return files


def lint_paths(paths: List[str], with_contracts: bool = True
               ) -> Tuple[List[Finding], int]:
    """Lint every .py under `paths`. Returns (findings, suppressions
    used across the sweep)."""
    findings: List[Finding] = []
    n_suppressed = 0
    for f in _discover(paths):
        src = f.read_text()
        module_findings = lint_module(str(f), src)
        by_line, bad, _ = _suppressions(src, str(f))
        survived = [x for x in module_findings
                    if by_line.get(x.line) != x.rule]
        n_suppressed += len(module_findings) - len(survived)
        findings.extend(survived)
        findings.extend(bad)
    if with_contracts:
        import repro_torch
        src_root = Path(list(repro_torch.__path__)[0]).resolve().parent
        findings.extend(contracts.check_contracts(src_root))
    findings.sort(key=lambda x: (x.path, x.line, x.rule))
    return findings, n_suppressed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="device-step safety + repo-contract lint of the port")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the cross-file contract rules")
    args = ap.parse_args(argv)
    findings, n_suppressed = lint_paths(
        list(args.paths), with_contracts=not args.no_contracts)
    for f in findings:
        print(f)
    if n_suppressed:
        print(f"({n_suppressed} finding(s) suppressed via "
              f"`saath: lint-ok`)", file=sys.stderr)
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("lint clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
