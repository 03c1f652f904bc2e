"""Quickstart on the port: the paper in five minutes on one GPU (the
counterpart of `examples/quickstart.py`).

1. Replay an FB-like trace under Aalo and Saath; print the speedup.
2. Show the three design ideas (all-or-none, per-flow thresholds,
   LCoF) switching on one by one.
3. Plan a multi-tenant collective schedule with the same coordinator.

Saath replays on the batched torch engine, Aalo on the event-driven
host plane (numpy), the collective plan on a `SaathSession` slab.

    python examples/quickstart_torch.py                  # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import Scenario, run  # noqa: E402
from repro_torch.core.params import SchedulerParams  # noqa: E402
from repro_torch.fabric.metrics import percentile_speedup  # noqa: E402
from repro_torch.runtime.buckets import Bucket  # noqa: E402
from repro_torch.runtime.coflow_bridge import (  # noqa: E402
    CollectiveCoflow, grad_bucket_coflows, plan_waves)
from repro_torch.traces import fb_like_trace  # noqa: E402


def main(argv=None, *, num_coflows: int = 200, num_ports: int = 80):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device
    trace = fb_like_trace(num_coflows=num_coflows, num_ports=num_ports,
                          seed=1)
    params = SchedulerParams()

    print("== 1. Saath vs Aalo on an FB-like trace ==")
    aalo = run(Scenario(policy="aalo", engine="numpy", trace=trace,
                        params=params, device=dev))
    saath = run(Scenario(policy="saath", trace=trace, params=params,
                         device=dev))
    s = percentile_speedup(aalo.row_cct(), saath.row_cct())
    print(f"CCT speedup vs Aalo: p50={s['p50']:.2f}x p90={s['p90']:.2f}x "
          f"(overall {s['overall']:.2f}x)\n")
    out = {"speedup": s, "ideas": {}}

    print("== 2. design ideas one by one ==")
    for name, kw in [("A/N only", dict(lcof=False,
                                       per_flow_threshold=False)),
                     ("A/N + P/F", dict(lcof=False,
                                        per_flow_threshold=True)),
                     ("full SAATH", {})]:
        r = run(Scenario(policy="saath", trace=trace, params=params,
                         mechanisms=kw, device=dev))
        s = percentile_speedup(aalo.row_cct(), r.row_cct())
        out["ideas"][name] = s
        print(f"{name:12s} p50={s['p50']:.2f}x p90={s['p90']:.2f}x")

    print("\n== 3. the same scheduler planning collectives ==")
    buckets = [Bucket(0, ("layer2",), (0,), 64 << 20),
               Bucket(1, ("layer1",), (1,), 64 << 20),
               Bucket(2, ("layer0",), (2,), 96 << 20)]
    coflows = grad_bucket_coflows(buckets)
    coflows += [
        CollectiveCoflow("moe/a2a", 32 << 20, ("ici:model",), 50),
        CollectiveCoflow("ckpt/upload", 1 << 30, ("dcn", "host"), 60),
        CollectiveCoflow("kv/migrate", 256 << 20, ("dcn",), 70),
    ]
    waves = plan_waves(coflows, num_chips=16, device=dev)
    for i, w in enumerate(waves):
        print(f"wave {i}: {w}")
    print("\n(grad buckets serialize on ici:data; the MoE a2a, checkpoint "
          "upload and KV migration ride disjoint resources in wave 0 — "
          "all-or-none + LCoF in action)")
    out["waves"] = waves
    return out


if __name__ == "__main__":
    main()
