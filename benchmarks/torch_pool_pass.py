"""Parent against change on one card: the pooled pass of
`benchmarks/torch_pool_throughput.py` (16 sessions on one `SessionPool`
slab, every coflow submitted up front, advances of `--step` until the
fleet drains), timed by two trees of the port in turns. It shows what a
change to the pool's host path costs when nothing is armed.

    python3 benchmarks/torch_pool_pass.py --parent PARENT --pairs 4

runs PARENT's and this checkout's passes in separate processes in the
order parent, change, change, parent, parent, change, ... (`--pairs`
pairs). Each process builds its tree's kernels, drives one cold pass
and `--passes` warm ones, and prints their walls (host clock around the
drive). Then each side's median of its warm passes and their ratio.
Both sides run this checkout's `torch_pool_throughput` workload and
drive; only the `repro_torch` package differs. One tree alone:

    python3 benchmarks/torch_pool_pass.py --src src --passes 5
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_tree(args) -> int:
    """The cold pass and `--passes` warm passes of one tree's pool."""
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from benchmarks import torch_pool_throughput as tp
    from repro_torch.kernels import build

    if args.device == "cuda":
        build.build_all()
    traces = tp._workloads(args.sessions, args.coflows, args.seed)
    t0 = time.perf_counter()
    tp.run_pool(traces, args.step, args.device)
    cold = time.perf_counter() - t0
    walls = [tp.run_pool(traces, args.step, args.device)[2]
             for _ in range(args.passes)]
    print(json.dumps({"src": args.src, "cold": cold, "walls": walls}),
          flush=True)
    return 0


def pairs(args) -> int:
    """Parent and change in turns (p c c p ...), each in its own
    process; every warm wall in run order, then the medians."""
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "change": args.src}
    order = []
    for i in range(args.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    child = [sys.executable, str(Path(__file__).resolve()),
             "--device", args.device, "--sessions", str(args.sessions),
             "--coflows", str(args.coflows), "--step", str(args.step),
             "--seed", str(args.seed), "--passes", str(args.passes)]
    walls = {"parent": [], "change": []}
    for side in order:
        out = subprocess.run(child + ["--src", trees[side]], check=True,
                             capture_output=True, text=True).stdout
        rec = json.loads(out.strip().splitlines()[-1])
        walls[side] += rec["walls"]
        print(f"{side}: cold {rec['cold']:.3f} s, warm "
              f"{' / '.join(f'{w:.4f}' for w in rec['walls'])} s",
              flush=True)
    med = {s: statistics.median(w) for s, w in walls.items()}
    print(f"pool pass ({args.sessions} sessions x {args.coflows} coflows, "
          f"{len(walls['parent'])} warm passes a side, run order "
          f"{' '.join(s[0] for s in order)}): median parent "
          f"{med['parent']:.4f} s, change {med['change']:.4f} s, change / "
          f"parent {med['change'] / med['parent']:.4f}; min parent "
          f"{min(walls['parent']):.4f} s, change "
          f"{min(walls['change']):.4f} s")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: compare")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--passes", type=int, default=3,
                    help="warm pooled passes a process")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--coflows", type=int, default=10)
    ap.add_argument("--step", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.parent:
        return pairs(args)
    return one_tree(args)


if __name__ == "__main__":
    sys.exit(main())
