"""Parent against change on one card: the clairvoyant fleet replays of
`chip_smoke.py` (phases 4, 7 and the offline side of 17, at its sizes)
run by two trees of the port in turns, their walls printed and their
per-coflow CCTs compared. A change whose float work now rounds otherwise
shows as CCTs that moved; a host-path change shows in the walls.

    python3 benchmarks/torch_fleet_ccts.py --parent PARENT --pairs 5

runs PARENT's and this checkout's replays in separate processes in the
order parent, change, change, parent, parent, change, ... (`--pairs`
pairs), prints every run's wall (`Result.wall_seconds`: host clock
around the replay; each run builds its tree's kernels first, on their
own), each side's median, and how many CCTs differ between the sides.
It exits 1 when the event steps or ticks differ. One run of one tree:

    python3 benchmarks/torch_fleet_ccts.py --src src --out a.npz
    python3 benchmarks/torch_fleet_ccts.py --compare a.npz b.npz
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import COFLOWS, FLEET, PARITY_COFLOWS, PORTS  # noqa: E402

REPLAYS = ("bigswitch", "leafspine", "leafspine_parity")


def replays(names, coflows: int, ports: int, fleet: int, parity: int):
    """(name, Scenario kwargs) of the named replays."""
    from repro_torch.fabric.topology import LeafSpine
    from repro_torch.traces.synth import fb_like_trace

    traces = tuple(fb_like_trace(coflows, ports, seed=s)
                   for s in range(fleet))
    leaf = LeafSpine(hosts_per_leaf=4, oversub=4.0, wc_fill="maxmin")
    small = tuple(fb_like_trace(parity, ports, seed=s) for s in range(4))
    kw = {"bigswitch": dict(traces=traces),
          "leafspine": dict(traces=traces, topology=leaf),
          "leafspine_parity": dict(traces=small, topology=leaf)}
    return [(n, kw[n]) for n in names]


def run_all(args) -> int:
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.api import Scenario, run
    from repro_torch.kernels import build

    if args.device == "cuda":
        t0 = time.perf_counter()
        build.build_all()
        print(f"built the kernels of {args.src} in "
              f"{time.perf_counter() - t0:.2f} s")
    out = {}
    for name, kw in replays(args.replays, args.coflows, args.ports,
                            args.fleet, args.parity):
        res = run(Scenario(engine="torch", device=args.device, **kw))
        out[f"{name}_cct"] = res.cct
        out[f"{name}_steps"] = np.array([res.events, res.ticks])
        out[f"{name}_wall"] = np.array(res.wall_seconds)
        print(f"{args.src} {name}: events {res.events}, ticks {res.ticks}, "
              f"wall {res.wall_seconds:.3f} s, avg CCT lanes 0-1 "
              f"{res.avg_cct[0]:.6f} {res.avg_cct[min(1, res.batch - 1)]:.6f}",
              flush=True)
    np.savez(args.out, **out)
    return 0


def compare(a_path, b_path) -> int:
    a, b = np.load(a_path), np.load(b_path)
    status = 0
    for key in sorted(k for k in a.files if k.endswith("_cct")):
        name = key[:-4]
        sa, sb = a[f"{name}_steps"], b[f"{name}_steps"]
        ca, cb = a[key], b[key]
        same = (ca == cb) | (np.isnan(ca) & np.isnan(cb))
        real = np.isfinite(ca) | np.isfinite(cb)
        print(f"{name}: events/ticks {sa.tolist()} vs {sb.tolist()}; "
              f"{int((~same & real).sum())} of {int(real.sum())} CCTs "
              f"differ (max |Δ| "
              f"{float(np.nanmax(np.abs(ca - cb), initial=0.0)):.3e} s)")
        if not np.array_equal(sa, sb):
            status = 1
    return status


def pairs(args) -> int:
    """Parent and change in turns (p c c p ...), each in its own
    process; the walls per replay and side, then parent against change
    (and each side against its own first run)."""
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "change": args.src}
    order = []
    for i in range(args.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    child = [sys.executable, str(Path(__file__).resolve()),
             "--device", args.device, "--coflows", str(args.coflows),
             "--ports", str(args.ports), "--fleet", str(args.fleet),
             "--parity", str(args.parity), "--replays", *args.replays]
    files = {"parent": [], "change": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, side in enumerate(order):
            out = Path(tmp) / f"{i}_{side}.npz"
            subprocess.run(child + ["--src", trees[side], "--out", str(out)],
                           check=True)
            files[side].append(out)
        for name in args.replays:
            walls = {s: [float(np.load(f)[f"{name}_wall"]) for f in fs]
                     for s, fs in files.items()}
            seq = [walls[s][order[:i].count(s)]
                   for i, s in enumerate(order)]
            print(f"{name} walls in run order "
                  f"({' '.join(s[0] for s in order)}): "
                  f"{' / '.join(f'{w:.3f}' for w in seq)} s; median parent "
                  f"{statistics.median(walls['parent']):.3f} s, change "
                  f"{statistics.median(walls['change']):.3f} s")
        status = 0
        for side in files:
            for f in files[side][1:]:
                print(f"{side} against its first run:")
                status |= compare(files[side][0], f)
        print("parent against change:")
        status |= compare(files["parent"][0], files["change"][0])
    return status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default="fleet_ccts.npz")
    ap.add_argument("--compare", nargs=2, metavar="NPZ")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent tree: run both in turns")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--replays", nargs="+", choices=REPLAYS,
                    default=list(REPLAYS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--coflows", type=int, default=COFLOWS)
    ap.add_argument("--ports", type=int, default=PORTS)
    ap.add_argument("--fleet", type=int, default=FLEET)
    ap.add_argument("--parity", type=int, default=PARITY_COFLOWS,
                    help="coflows of each leaf-spine parity trace")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if args.parent:
        return pairs(args)
    return run_all(args)


if __name__ == "__main__":
    sys.exit(main())
