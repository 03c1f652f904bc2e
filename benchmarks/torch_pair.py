"""Parent against change on one card: the runner that the kernel pair
drivers (`torch_k7_pair.py`, `torch_k8_pair.py`) share.

A driver defines `one_tree(args)`, which builds and times its kernel in
the tree `args.src` and prints one JSON record whose "ms" maps each
(shape, dtype) key to a device time (with `--yardsticks` also the plain
version's and a library's), and hands it to `main`. With `--parent
PARENT`, `pairs` runs PARENT's and this checkout's `repro_torch` in
separate processes of the driver, in the order parent, change, change,
parent, ... (`--pairs` pairs; the change's first process with
`--yardsticks`), prints every record in run order, then each key's
means and their ratio. Both sides run this checkout's driver and
`chip_smoke` helpers; only the `repro_torch` package differs.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def pairs(script, args, note=None) -> int:
    """Parent and change in turns (p c c p ...), each a process of
    `script`; every record in run order, then the means and ratios.
    `note(key, change_ms, change's first record)` adds to a key's
    line."""
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "change": args.src}
    order = []
    for i in range(args.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    runs = {"parent": [], "change": []}
    for n, side in enumerate(order):
        cmd = [sys.executable, str(Path(script).resolve()), "--src",
               trees[side]] + (["--yardsticks"] if n == 1 else [])
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{side}: {json.dumps(rec)}", flush=True)
        runs[side].append(rec)
    for key in runs["change"][0]["ms"]:
        p = statistics.mean(r["ms"][key] for r in runs["parent"])
        c = statistics.mean(r["ms"][key] for r in runs["change"])
        extra = note(key, c, runs["change"][0]) if note else ""
        print(f"{key}: parent {p:.4f} ms, change {c:.4f} ms, "
              f"parent / change {p / c:.2f}{extra}", flush=True)
    return 0


def main(doc, script, one_tree, yardsticks, note=None) -> int:
    """The drivers' command line: `pairs` with `--parent`, else
    `one_tree` on `--src`. `yardsticks` is `--yardsticks`' help."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--yardsticks", action="store_true", help=yardsticks)
    args = ap.parse_args()
    return pairs(script, args, note) if args.parent else one_tree(args)
