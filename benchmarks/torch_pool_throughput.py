"""Pool throughput on the port: N concurrent `SaathSession`s on one
`SessionPool` slab against N standalone sessions driven in sequence (the
counterpart of `benchmarks/pool_throughput.py`, on the same workload and
defaults).

Every session replays the same-shape (different-seed) online workload:
all coflows submitted up front, then fixed `--step` advances until the
session drains. The sequential baseline drives N standalone sessions one
after another (each its own one-row slab, N session loops per advance);
the pool drives one `SessionPool` whose `advance` moves all N rows with
one batched session loop. Three gates, as in the reference:

* per-session CCTs (and FCTs) of the pool equal the sequential ones bit
  for bit: batching changes the launch count, never the arithmetic;
* the whole pooled drive performs exactly one full slab upload (the
  initial build; every later advance moves dirty-row scatters or
  nothing);
* the pooled fleet is at least ``SAATH_POOL_MIN_SPEEDUP`` (default 4.0,
  calibrated for the default 16 sessions) times faster end to end.

A cold pass of each drive comes first (on the card it pays the kernels'
first-use builds, printed apart; `--no-cold` skips it where an earlier
drive in the same process has built and loaded them); the walls are the
best of two warm passes. Records go to BENCH_torch.json
(`benchmarks.torch_common`).
The reference's `--shards` (a sharded slab) waits for the port's
sharded pool, and the port's pool has no blocking-dispatch switch.

    PYTHONPATH=src python -m benchmarks.torch_pool_throughput   # card
    SAATH_POOL_MIN_SPEEDUP=1.0 PYTHONPATH=src python -m \\
        benchmarks.torch_pool_throughput --device cpu --sessions 4
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from benchmarks.torch_common import cli_parser, device_name, record
from repro_torch.api import SaathSession, SessionPool, \
    result_from_completions
from repro_torch.core.coflow import Coflow, Flow
from repro_torch.core.params import SchedulerParams
from repro_torch.kernels import build

# a serving-style fabric: narrow coflows on a small slab, many advances
# (the reference's workload, unchanged)
PARAMS = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                         growth=4.0, num_queues=5)
PORTS = 12


def _workload(seed: int, n_coflows: int):
    rng = np.random.default_rng(seed)
    cfs, fid = [], 0
    for c in range(n_coflows):
        w = int(rng.integers(1, 4))
        flows = [Flow(fid + i, int(rng.integers(0, PORTS)),
                      int(rng.integers(0, PORTS)),
                      float(rng.uniform(1.0, 12.0))) for i in range(w)]
        fid += w
        cfs.append(Coflow(c, float(rng.uniform(0.0, 5.0)), flows))
    return cfs


def _workloads(n_sessions: int, n_coflows: int, seed: int):
    """One arrival stream per session: same shape, different seeds."""
    return [_workload(seed + i, n_coflows) for i in range(n_sessions)]


def _drive(sessions, advance_all, step: float, max_steps: int = 4000):
    """Advance until every session drains; returns per-session
    {handle: (cct, fct-tuple)} dicts plus session 0's raw completions."""
    out = [dict() for _ in sessions]
    raw0 = []
    for _ in range(max_steps):
        advance_all(step)
        live = 0
        for i, s in enumerate(sessions):
            done = s.poll()
            if i == 0:
                raw0 += done
            out[i].update({d.handle: (d.cct, tuple(d.fct))
                           for d in done})
            live += s.num_live
        if not live:
            return out, raw0
    raise RuntimeError(f"workload failed to drain in {max_steps} steps")


def run_sequential(traces, step: float, device):
    sessions = [SaathSession(PARAMS, num_ports=PORTS, device=device)
                for _ in traces]
    for s, tr in zip(sessions, traces):
        s.submit(sorted(tr, key=lambda c: (c.arrival, c.cid)))
    t0 = time.perf_counter()

    def advance_all(dt):
        for s in sessions:
            s.advance(dt)

    ccts, raw0 = _drive(sessions, advance_all, step)
    return ccts, raw0, time.perf_counter() - t0


def run_pool(traces, step: float, device):
    pool = SessionPool(PARAMS, num_ports=PORTS, max_sessions=len(traces),
                       device=device)
    sessions = [pool.session() for _ in traces]
    for s, tr in zip(sessions, traces):
        s.submit(sorted(tr, key=lambda c: (c.arrival, c.cid)))
    t0 = time.perf_counter()
    ccts, raw0 = _drive(sessions, pool.advance, step)
    return ccts, raw0, time.perf_counter() - t0, dict(pool.io)


def main(argv=None) -> dict:
    ap = cli_parser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--coflows", type=int, default=10,
                    help="coflows per session")
    ap.add_argument("--step", type=float, default=0.25,
                    help="virtual seconds per advance")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-cold", action="store_true",
                    help="skip the cold passes (the kernels already built "
                         "and loaded in this process)")
    args = ap.parse_args(argv)
    dev = args.device

    traces = _workloads(args.sessions, args.coflows, args.seed)
    built = build.build_seconds
    cold_seq = cold_pool = float("nan")
    if not args.no_cold:
        _, _, cold_seq = run_sequential(traces, args.step, dev)
        _, _, cold_pool, _ = run_pool(traces, args.step, dev)
    built = build.build_seconds - built
    seq_cct, _, wall_seq = run_sequential(traces, args.step, dev)
    pool_cct, comps, wall_pool, io = run_pool(traces, args.step, dev)
    c2, _, w2 = run_sequential(traces, args.step, dev)
    wall_seq = min(wall_seq, w2)
    p2, _, w2, _ = run_pool(traces, args.step, dev)
    wall_pool = min(wall_pool, w2)

    assert pool_cct == seq_cct == c2 == p2, \
        "pooled sessions diverged from standalone sessions"
    assert io["full_uploads"] == 1, \
        f"expected one full slab upload, saw {io['full_uploads']}"
    n_cct = sum(len(d) for d in pool_cct)
    speedup = wall_seq / wall_pool
    where = device_name(dev)
    print(f"# torch_pool_throughput on {where}: {args.sessions} sessions "
          f"x {args.coflows} coflows ({n_cct} CCTs, bitwise-equal pool vs "
          f"sequential)", file=sys.stderr)
    print(f"#   sequential {wall_seq:.3f}s (cold {cold_seq:.2f}s) | "
          f"pool {wall_pool:.3f}s (cold {cold_pool:.2f}s; kernel builds "
          f"{built:.2f}s of the cold passes) | speedup {speedup:.2f}x "
          f"(gate {os.environ.get('SAATH_POOL_MIN_SPEEDUP', '4.0')}) | "
          f"{args.sessions / wall_pool:.1f} sessions/sec", file=sys.stderr)
    print(f"#   device-resident slab: {io['full_uploads']} full upload"
          f" | {io['row_uploads']} row scatters "
          f"({io['upload_bytes'] / 1e6:.2f} MB up) | "
          f"{io['row_downloads']} row gathers "
          f"({io['download_bytes'] / 1e6:.2f} MB down) | "
          f"{io['dispatches']} dispatches | {io['loop_reads']} flag reads",
          file=sys.stderr)

    res = result_from_completions(comps, wall_seconds=wall_pool)
    rec = record(
        "pool_throughput", res, device=where,
        sessions=args.sessions, coflows_per_session=args.coflows,
        wall_pool=wall_pool, wall_sequential=wall_seq,
        compile_pool=max(cold_pool - wall_pool, 0.0),
        compile_sequential=max(cold_seq - wall_seq, 0.0),
        build_seconds=built, sessions_per_sec=args.sessions / wall_pool,
        speedup=speedup, ctl_bytes=io["ctl_bytes"],
        full_uploads=io["full_uploads"], row_uploads=io["row_uploads"],
        upload_mb=io["upload_bytes"] / 1e6,
        download_mb=io["download_bytes"] / 1e6,
        loop_reads=io["loop_reads"])

    min_speedup = float(os.environ.get("SAATH_POOL_MIN_SPEEDUP", "4.0"))
    assert speedup >= min_speedup, (
        f"pooled fleet speedup {speedup:.2f}x < required "
        f"{min_speedup}x (SAATH_POOL_MIN_SPEEDUP)")
    return rec


if __name__ == "__main__":
    main()
