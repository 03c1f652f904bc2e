"""Parent against change on one card: kernel K8 (the SSD scan's backward,
`repro_torch.kernels.ssd_scan_bwd`) at Mamba2-1.3B's train shape and
Jamba's microbatch shape (`chip_smoke.SSD_BWD_TRAIN`, `SSD_BWD_JAMBA`),
f32 and bf16, timed by two trees of the port in turns.

    python3 benchmarks/torch_k8_pair.py --parent PARENT --pairs 2

runs PARENT's and this checkout's K8 in separate processes in the order
parent, change, change, parent, ... (`--pairs` pairs). Each process
builds its tree's K8 and prints its device ms at each (shape, dtype)
(`chip_smoke.cuda_ms`, 5 calls after warm-up, inputs from
`chip_smoke.ssd_inputs`), with the corrected bound
(`chip_smoke.ssd_bwd_bound_ms`) and the share of it; the change's first
process also the plain version's ms and each of K8's launches' device
ms a call (`torch.profiler`, one profiled call a shape). Then each
side's mean and their ratio, with the change's share of the bound
(`torch_pair.pairs`). One tree alone:

    python3 benchmarks/torch_k8_pair.py --src src --yardsticks
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks.torch_pair import main  # noqa: E402


def launch_split(call):
    """{K8 launch: device ms} of one profiled `call` (after a warm-up
    call), by `chip_smoke.K8_KERNELS`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k in c.K8_KERNELS:
                if k in e.key:
                    name = k.rstrip("<(")
                    out[name] = out.get(name, 0.0) + \
                        e.self_device_time_total / 1e3
    return out


def one_tree(args) -> int:
    """K8's ms at each shape and dtype in one tree (and the
    yardsticks')."""
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as c
    from repro_torch.kernels import build, ops

    build.build_all(["ssd_scan_bwd"])
    dev = torch.device("cuda")
    out = {"src": args.src, "card": c.smi(), "ms": {}, "bound_ms": {}}
    for shape, what in ((c.SSD_BWD_TRAIN, "train"),
                        (c.SSD_BWD_JAMBA, "jamba")):
        B, L, H, G, Dh, N, lc = shape
        for dtype in (torch.bfloat16, torch.float32):
            xs = c.ssd_inputs(shape, dtype, L + H, dev)
            dy = torch.as_tensor(np.random.default_rng(L + H + 1).normal(
                size=(B, L, H, Dh)), dtype=dtype, device=dev)
            key = f"{what} {str(dtype)[6:]}"

            def call():
                return ops.ssd_scan_bwd(*xs, dy, lc=lc)

            ms = c.cuda_ms(call, 5)
            bnd = c.ssd_bwd_bound_ms(shape, xs[0].element_size())[0]
            out["ms"][key] = ms
            out["bound_ms"][key] = bnd
            if args.yardsticks:
                out.setdefault("plain_ms", {})[key] = c.cuda_ms(
                    lambda: ops.ssd_scan_bwd(*xs, dy, lc=lc, force="ref"), 2)
                out.setdefault("split_ms", {})[key] = launch_split(call)
            del xs, dy
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def bound_share(key, ms, rec) -> str:
    """The bound beside a key's mean (the change's)."""
    bnd = rec["bound_ms"][key]
    return f"; bound {bnd:.4f} ms, change at {bnd / ms:.1%} of it"


if __name__ == "__main__":
    sys.exit(main(__doc__, __file__, one_tree,
                  "also time the plain version and split K8 by launch",
                  bound_share))
