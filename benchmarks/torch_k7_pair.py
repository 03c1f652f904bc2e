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
same code in either tree. Then each side's mean and their ratio
(`torch_pair.pairs`). One tree alone:

    python3 benchmarks/torch_k7_pair.py --src src --yardsticks
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks.torch_pair import main  # noqa: E402


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


if __name__ == "__main__":
    sys.exit(main(__doc__, __file__, one_tree,
                  "also time the plain version and SDPA"))
