"""The port's benchmark suite: one driver per paper table/figure (the
counterpart of `benchmarks/run.py`).

    python -m benchmarks.torch_run [--full] [--only fig9] \\
        [--engine numpy|torch] [--device cuda|cpu]

--full replays the 526x150 FB-scale fabric; the default quick fabric
(240x100) preserves every qualitative claim. Every driver runs through
`repro_torch.api.run`, so --engine is plain Scenario data threaded to
the Saath side uniformly (the host baselines replay on numpy whatever
it says). Each driver's claim checks are asserts: a failed one is
collected, the suite goes on, and the runner exits 1 at the end if any
failed. Records accumulate in the ignored BENCH_torch.json
(`benchmarks.torch_common.record`). The reference runner's cached
roofline table has no counterpart: the port has no roofline pass.
"""
from __future__ import annotations

import argparse
import sys
import time

from benchmarks import (torch_fig2_out_of_sync, torch_fig3_offline_policies,
                        torch_fig9_speedup, torch_fig10_breakdown,
                        torch_fig11_bins, torch_fig13_fct_deviation,
                        torch_fig14_sensitivity,
                        torch_table2_coordinator_latency)
from benchmarks.torch_common import Bench

SUITES = [
    ("fig2", torch_fig2_out_of_sync),
    ("fig3", torch_fig3_offline_policies),
    ("fig9", torch_fig9_speedup),
    ("fig10", torch_fig10_breakdown),
    ("fig11", torch_fig11_bins),
    ("fig13", torch_fig13_fct_deviation),
    ("fig14", torch_fig14_sensitivity),
    ("table2", torch_table2_coordinator_latency),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="FB-scale fabric (526 coflows x 150 ports)")
    ap.add_argument("--only", default=None)
    ap.add_argument("--engine", choices=("numpy", "torch"), default="torch",
                    help="replay engine for the Saath-side Scenarios")
    ap.add_argument("--device", default="cuda",
                    help="torch device the port runs on (default cuda; "
                    "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    bench = Bench(quick=not args.full, device=args.device)
    t0 = time.time()
    failures = []
    for name, mod in SUITES:
        if args.only and name != args.only:
            continue
        t1 = time.time()
        try:
            mod.run(bench, engine=args.engine)
        except AssertionError as e:
            failures.append((name, str(e)))
            print(f"# {name} CLAIM-CHECK FAILED: {e}", file=sys.stderr)
        print(f"# {name} done in {time.time() - t1:.1f}s", file=sys.stderr)
    print(f"# total {time.time() - t0:.1f}s; "
          f"{len(failures)} claim-check failures")
    if failures:
        sys.exit(1)
    return failures


def run_all(quick=True, engine="torch", device="cuda"):
    bench = Bench(quick=quick, device=device)
    return {name: mod.run(bench, engine=engine) for name, mod in SUITES}


if __name__ == "__main__":
    main()
