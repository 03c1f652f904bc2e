"""Batched serving example on the port: prefill + greedy decode on two
families, a KV-cache transformer and an O(1)-state Mamba2, through
`repro_torch.launch.lm_serve.ServeSession` (the counterpart of
`examples/serve_lm.py`), at the smoke configs' size.

    python examples/serve_lm_torch.py                 # on the CUDA card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.lm_serve import ServeSession  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = {}
    for arch in ("starcoder2-3b", "mamba2-1.3b"):
        sess = ServeSession(arch, smoke=True, batch=2, max_len=64,
                            device=args.device)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, sess.cfg.vocab_size, (2, 8)).astype(
            np.int32)
        toks = sess.generate(prompts, 12)
        print(f"{arch} on {sess.device}: generated {toks.shape}; sample: "
              f"{toks[0][:8]}")
        out[arch] = toks
    return out


if __name__ == "__main__":
    main()
