"""Parent against change on one card: kernel K7 (the attention's
backward, `repro_torch.kernels.flash_attention_bwd`) at StarCoder2-3B's
train shape and DeepSeek-V2's MLA shape (`chip_smoke.K7_TRAIN`,
`K7_MLA`), f32 and bf16, timed by two trees of the port in turns.

    python3 benchmarks/torch_k7_pair.py --parent PARENT --pairs 2

runs PARENT's and this checkout's K7 in separate processes in the order
parent, change, change, parent, ... (`--pairs` pairs). Each process
builds its tree's K7 and prints its device ms at each (shape, dtype)
(`chip_smoke.cuda_ms`, 3 calls after warm-up, inputs from
`chip_smoke.k7_inputs`), the change's first process also the plain
version's and SDPA's backward (`chip_smoke.sdpa_bwd_any`), both the
same code in either tree. Then each side's mean and their ratio. Both
sides run this checkout's `chip_smoke` helpers; only the `repro_torch`
package differs. One tree alone:

    python3 benchmarks/torch_k7_pair.py --src src --yardsticks
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_tree(args) -> int:
    """K7's ms at each shape and dtype in one tree (and the
    yardsticks')."""
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as c
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["flash_attention_bwd"])
    dev = torch.device("cuda")
    out = {"src": args.src, "card": c.smi(), "ms": {}}
    for shape, what in ((c.K7_TRAIN, "train"), (c.K7_MLA, "mla")):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, o, do = c.k7_inputs(shape, dtype, shape[5] + shape[6],
                                         dev)
            key = f"{what} {str(dtype)[6:]}"
            out["ms"][key] = c.cuda_ms(
                lambda: ops.flash_attention_bwd(q, k, v, o, do), 3)
            if args.yardsticks:
                out.setdefault("plain_ms", {})[key] = c.cuda_ms(
                    lambda: ops.flash_attention_bwd(q, k, v, o, do,
                                                    force="ref"), 2)
                out.setdefault("sdpa_ms", {})[key] = \
                    c.sdpa_bwd_any(q, k, v, do)[0]
            del q, k, v, o, do
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def pairs(args) -> int:
    """Parent and change in turns (p c c p ...), each in its own
    process; every time in run order, then the means and ratios."""
    trees = {"parent": str(Path(args.parent).resolve() / "src"),
             "change": args.src}
    order = []
    for i in range(args.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    runs = {"parent": [], "change": []}
    for n, side in enumerate(order):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--src",
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
        print(f"{key}: parent {p:.4f} ms, change {c:.4f} ms, "
              f"parent / change {p / c:.2f}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--yardsticks", action="store_true",
                    help="also time the plain version and SDPA")
    args = ap.parse_args()
    return pairs(args) if args.parent else one_tree(args)


if __name__ == "__main__":
    sys.exit(main())
