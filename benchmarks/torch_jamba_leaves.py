"""Where Jamba's bf16 gradients part from the plain path's, on one card:
the gradient norm of every master leaf of Jamba-v0.1-52B at its
published widths, one period (8 layers) and the main train path's 2
routed experts (`chip_smoke.SSM_PAIR_CUTS`), one microbatch of 1 x 1024
tokens, through `lm.forward_train_loss`:

- with every kernel (K4 and K8 for the Mamba mixers, K5 and K7 for the
  attention layer);
- with every plain version (`force="ref"`), twice (the plain path is
  deterministic: 0 apart);
- with the attention's kernels only (the SSD scan pinned to its plain
  version through `models.mamba.scan`),

each held against the plain path: the loss and the six leaves with the
largest relative gap of their norms, in bf16 (the config's dtype) and in
f32. It reads whether a gap comes from one kernel or from the bf16
rounding of either path compounding over the layers.

    python3 benchmarks/torch_jamba_leaves.py
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as c
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import build
    from repro_torch.models import lm, mamba

    if not torch.cuda.is_available():
        c.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    scan = mamba.scan

    def norms(cfg, masters, b, force, ssd_force):
        if ssd_force:
            mamba.scan = lambda *a, **k: scan(*a, **{**k, "force": ssd_force})
        try:
            loss = lm.forward_train_loss(lm.skeleton(cfg), masters, b,
                                         force=force)
            grads = torch.autograd.grad(loss, list(masters.values()))
        finally:
            mamba.scan = scan
        return float(loss.detach()), {
            n: float(torch.linalg.vector_norm(g.double()))
            for n, g in zip(masters, grads)}

    arch = "jamba-v0.1-52b"
    print(f"card: {c.smi()}", flush=True)
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config(arch),
                                  **c.SSM_PAIR_CUTS[arch], dtype=dtype)
        masters = lm.init_masters(cfg, seed=0, device="cuda")
        b = c.ssm_batch(SyntheticLMData(cfg.vocab_size, 1024, 1,
                                        device="cuda"), 0)
        runs = {"kernels": norms(cfg, masters, b, None, None),
                "plain": norms(cfg, masters, b, "ref", None),
                "attention kernels only": norms(cfg, masters, b, None,
                                                "ref"),
                "plain again": norms(cfg, masters, b, "ref", None)}
        ref_loss, ref = runs["plain"]
        for what, (loss, got) in runs.items():
            gaps = sorted(((abs(got[n] - ref[n]) / ref[n], n, ref[n])
                           for n in ref if ref[n]), reverse=True)[:6]
            print(f"{dtype} {what}: loss {loss:.7f} (plain {ref_loss:.7f});"
                  f" largest relative gaps of the leaf norms: "
                  + ", ".join(f"{n} {g:.2e} (norm {v:.3e})"
                              for g, n, v in gaps), flush=True)
        del masters
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
