"""Online coflow service on the port: a Poisson open-loop tenant mix
through one long-running `SaathSession` — and, with ``--tenants N``, N
such mixes through one `SessionPool` slab (the counterpart of
`examples/online_service.py`).

Three traffic sources share a pod's fabric, arrivals NOT known up
front:

* a training job: every step, a burst of gradient buckets (ici:data)
  and MoE all-to-all waves (ici:model), staggered by backward-pass
  readiness;
* checkpoint shard uploads over (dcn, host), Poisson;
* serving KV-cache migrations over dcn, Poisson.

Each session keeps its padded slab row alive across the whole run —
submissions land in recycled rows, `advance` re-enters the session loop
up to each wall-clock horizon, `poll` retires completions — i.e. the
coordinator runs as a *service*, not a trace replay. With N > 1 tenants
the pool advances every tenant's coordinator with one batched step
chain per horizon. ``--backend numpy`` runs the host reference session
(one tenant).

    python examples/online_service_torch.py [--seconds 0.2]
        [--backend torch|numpy] [--seed 0] [--tenants 1] [--device cuda]
    PYTHONPATH=src python examples/online_service_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import SaathSession, SessionPool  # noqa: E402
from repro_torch.runtime.coflow_bridge import (  # noqa: E402
    RESOURCES, CollectiveCoflow, bridge_params, collective_to_coflow)

NUM_CHIPS = 16
STEP = 0.02          # training step period (s)
MB = 1 << 20


def _workload(seconds: float, seed: int):
    """(time, name, CollectiveCoflow) arrivals over the horizon."""
    rng = np.random.default_rng(seed)
    events = []
    # training steps: 4 gradient buckets + 2 MoE a2a per step
    t = 0.0
    while t < seconds:
        for b in range(4):
            events.append((t + 1e-3 * b, CollectiveCoflow(
                f"grad/{b}", int(32 * MB), ("ici:data",), b)))
        for l in range(2):
            events.append((t + 5e-4 + 2e-3 * l, CollectiveCoflow(
                f"moe/{l}", int(64 * MB), ("ici:model",), 10 + l)))
        t += STEP
    # background tenants: Poisson
    t = float(rng.exponential(1 / 50))
    while t < seconds:
        events.append((t, CollectiveCoflow(
            "ckpt", int(256 * MB), ("dcn", "host"), 50)))
        t += float(rng.exponential(1 / 50))
    t = float(rng.exponential(1 / 100))
    while t < seconds:
        events.append((t, CollectiveCoflow(
            "kv", int(64 * MB), ("dcn",), 60)))
        t += float(rng.exponential(1 / 100))
    events.sort(key=lambda e: e[0])
    return events


def main(seconds: float = 0.2, seed: int = 0, backend: str = "torch",
         tenants: int = 1, device=None) -> dict:
    params = bridge_params()
    P = len(RESOURCES) * NUM_CHIPS
    if tenants > 1 and backend != "torch":
        raise ValueError("multi-tenant pooling is the torch slab's "
                         "feature; --tenants needs --backend torch")
    if tenants > 1:
        pool = SessionPool(params, num_ports=P, max_sessions=tenants,
                           device=device)
        sessions = [pool.session() for _ in range(tenants)]
        advance_all = pool.advance
    else:
        sessions = [SaathSession(params, num_ports=P, backend=backend,
                                 device=device)]
        advance_all = lambda dt: sessions[0].advance(dt)  # noqa: E731

    # merge every tenant's open-loop arrivals onto one fleet timeline
    merged = sorted(
        (at, ti, c)
        for ti in range(tenants)
        for at, c in _workload(seconds, seed + ti))

    t0 = time.perf_counter()
    kinds = {}
    done = []
    now = 0.0
    for at, ti, c in merged:
        if at > now:
            advance_all(at - now)
            now = at
        h = sessions[ti].submit(
            [collective_to_coflow(c, num_chips=NUM_CHIPS, arrival=at)])[0]
        kinds[(ti, h)] = c.name.split("/")[0]
        for s_i, s in enumerate(sessions):
            done += [(s_i, d) for d in s.poll()]
    spent = 0.0
    while any(s.num_live for s in sessions) and spent < 60.0:
        advance_all(5 * STEP)
        spent += 5 * STEP
        for s_i, s in enumerate(sessions):
            done += [(s_i, d) for d in s.poll()]
    wall = time.perf_counter() - t0

    by_kind = {}
    for s_i, d in done:
        by_kind.setdefault(kinds[(s_i, d.handle)], []).append(d.cct * 1e3)
    print(f"== online service ({backend}, {tenants} tenant(s)): "
          f"{len(merged)} collectives over {seconds * 1e3:.0f}ms "
          f"virtual, wall {wall:.2f}s ==")
    for kind, ccts in sorted(by_kind.items()):
        a = np.asarray(ccts)
        print(f"  {kind:6s} n={a.size:4d} avg={a.mean():7.3f}ms "
              f"p90={np.percentile(a, 90):7.3f}ms")
    if backend == "torch":
        print(f"  slab: {len(sessions)} row(s) x {sessions[0]._C_cap} "
              f"coflow x {sessions[0]._F_cap} flow slots (grown once, "
              f"recycled across {len(merged)} submissions)")
    all_cct = np.asarray([d.cct for _, d in done])
    unfinished = sum(s.num_live for s in sessions)
    return {"completed": len(done), "unfinished": unfinished,
            "avg_cct": float(all_cct.mean()) if all_cct.size else
            float("nan"), "wall_seconds": wall}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=0.2,
                    help="virtual horizon of the open-loop arrivals")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=("torch", "numpy"),
                    default="torch")
    ap.add_argument("--tenants", type=int, default=1,
                    help="sessions sharing one SessionPool slab")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(seconds=args.seconds, seed=args.seed, backend=args.backend,
         tenants=args.tenants, device=args.device)
