"""End-to-end training on the port (the counterpart of
`examples/train_lm.py`): a member of the StarCoder2 family for a few
hundred steps through `repro_torch.launch.train.train`, with
checkpoints and the Saath plan of the gradient-bucket coflows. On the
card the attention runs K5 forward and K7 backward; on the CPU their
plain versions.

    python examples/train_lm_torch.py                       # on the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --cpu-budget

The default builds a reduced StarCoder2 (4 layers, d_model 512, ~45M
parameters, sequences of 256); `--cpu-budget` a ~6M-parameter one for a
CPU core. Loss should drop well below the ~5.55 unigram entropy of the
synthetic mixture. Archs with a Mamba mixer raise NotImplementedError
(ROADMAP queue A item 11e-ii).
"""
import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--cpu-budget", action="store_true",
                    help="~6M params / short sequences (one CPU core)")
    args = ap.parse_args(argv)

    # a small member of the chosen family (--cpu-budget: smaller still so
    # a CPU core makes progress; same code path either way)
    import repro_torch.launch.train as T
    if args.cpu_budget:
        dims = dict(num_layers=2, d_model=256, vocab_size=8192, d_ff=1024,
                    heads=4, seq=128, batch=8)
    else:
        dims = dict(num_layers=4, d_model=512, vocab_size=32768, d_ff=2048,
                    heads=8, seq=256, batch=16)
    small = dataclasses.replace(
        get_config(args.arch), num_layers=dims["num_layers"],
        d_model=dims["d_model"], num_heads=dims["heads"], num_kv_heads=2,
        head_dim=dims["d_model"] // dims["heads"], d_ff=dims["d_ff"],
        vocab_size=dims["vocab_size"])

    orig = T.get_smoke_config
    T.get_smoke_config = lambda a: small
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = train(args.arch, steps=args.steps, smoke=True,
                        batch=dims["batch"], seq=dims["seq"],
                        ckpt_dir=args.ckpt or tmp, ckpt_every=100,
                        device=args.device)
    finally:
        T.get_smoke_config = orig
    print(f"first losses: {[round(x, 3) for x in out['losses'][:3]]}")
    print(f"last  losses: {[round(x, 3) for x in out['losses'][-3:]]}")
    print(f"saath plan for grad coflows: {out['plan']}")
    return out


if __name__ == "__main__":
    main()
