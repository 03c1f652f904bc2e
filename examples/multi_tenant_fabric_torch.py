"""Multi-tenant fabric scheduling on the port: the paper's scheduler
arbitrating a pod's concurrent collective traffic (the counterpart of
`examples/multi_tenant_fabric.py`).

Tenants: (a) a training job's per-step gradient buckets (reverse-layer
arrival order), (b) a MoE job's all-to-all waves, (c) a checkpoint
upload over DCN, (d) a serving fleet's KV-cache migration, (e) an
elastic-rescale parameter resharding burst.

The Saath coordinator orders them with all-or-none + LCoF and
starvation deadlines (the wave plan on a `SaathSession` slab, the
steady state on the batched torch engine); compare against naive FIFO
issue (a host policy on the numpy engine).

    python examples/multi_tenant_fabric_torch.py         # on the card
    PYTHONPATH=src python examples/multi_tenant_fabric_torch.py \\
        --device cpu
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import Scenario, run  # noqa: E402
from repro_torch.core.coflow import Coflow, Flow, Trace  # noqa: E402
from repro_torch.core.params import SchedulerParams  # noqa: E402
from repro_torch.fabric.metrics import percentile_speedup  # noqa: E402
from repro_torch.runtime.coflow_bridge import (  # noqa: E402
    CollectiveCoflow, plan_waves)


def bridge_workload():
    """One training step's collective traffic as the bridge sees it:
    gradient buckets (deepest layer ready first), a MoE all-to-all per
    MoE layer, a checkpoint upload, a KV-cache migration and a
    parameter reshard."""
    coflows = [CollectiveCoflow(f"grad/{b}", (48 - 4 * b) << 20,
                                ("ici:data",), b) for b in range(6)]
    coflows += [CollectiveCoflow(f"moe_a2a/{l}", 160 << 20, ("ici:model",),
                                 10 + l) for l in (0, 1, 2)]
    coflows += [
        CollectiveCoflow("ckpt/upload", 4 << 30, ("dcn", "host"), 20),
        CollectiveCoflow("kv/migrate", 512 << 20, ("dcn",), 21),
        CollectiveCoflow("reshard/params", 1 << 30,
                         ("ici:data", "ici:model"), 22),
    ]
    return coflows


def steady_state(steps: int = 40) -> Trace:
    """Each chip's links as a port; tenants contend for overlapping chip
    sets; the steady state replicated over `steps` training steps with
    Poisson jitter."""
    rng = np.random.default_rng(0)
    P = 64
    cfs = []
    fid = 0
    t = 0.0
    for step in range(steps):
        t += float(rng.exponential(0.05))
        for b in range(4):
            chips = range(0, 32)
            flows = [Flow(fid + i, c, c, float((32 - 6 * b) << 19))
                     for i, c in enumerate(chips)]
            fid += len(flows)
            cfs.append(Coflow(len(cfs), t + 0.001 * b, flows))
        if step % 4 == 0:  # periodic checkpoint upload on other chips
            flows = [Flow(fid + i, 32 + i, 32 + i, float(1 << 26))
                     for i in range(16)]
            fid += 16
            cfs.append(Coflow(len(cfs), t, flows))
    return Trace(num_ports=P, coflows=cfs)


def main(argv=None, *, steps: int = 40):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device

    # ---- wave planning view -------------------------------------------
    coflows = bridge_workload()
    waves = plan_waves(coflows, num_chips=16, device=dev)
    print("== Saath wave plan (all-or-none + LCoF) ==")
    for i, w in enumerate(waves):
        print(f"wave {i}: {w}")

    # ---- full fabric simulation: Saath vs FIFO issue ------------------
    trace = steady_state(steps)
    params = SchedulerParams(port_bw=50e9 / 8, delta=1e-3,
                             start_threshold=8 << 20)
    fifo = run(Scenario(policy="fifo", engine="numpy", trace=trace,
                        params=params, device=dev))
    saath = run(Scenario(policy="saath", trace=trace, params=params,
                         device=dev))
    s = percentile_speedup(fifo.row_cct(), saath.row_cct())
    print("\n== steady-state fabric: Saath vs FIFO issue order ==")
    print(f"collective-coflow completion speedup: p50={s['p50']:.2f}x "
          f"p90={s['p90']:.2f}x overall={s['overall']:.2f}x")
    return {"waves": waves, "speedup": s}


if __name__ == "__main__":
    main()
