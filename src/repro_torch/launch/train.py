"""Training driver of the port: data pipeline -> train step ->
checkpoints, on one device.

The counterpart of `repro.launch.train`, with its fault tolerance:
  * periodic + async checkpoints, atomic commit (`checkpoint.ckpt`);
  * resume from the latest step on restart: the data pipeline is
    stateless in `step` and the train state is saved whole, so a killed
    and restarted run replays the uninterrupted loss trajectory;
  * SIGTERM/SIGINT (preemption) triggers a final save before exit;
  * straggler watchdog: step times over k x the running median are
    logged and returned;
  * elastic restart: checkpoints restore onto any device
    (`restore(..., device=)`; the sharded restore waits for ROADMAP
    queue A item 8).

The masters are f32 (`lm.init_masters`, drawn on the device), the
compute dtype the config's; on the card the attention runs K5 forward
and K7 backward, the Mamba mixer's SSD scan K4 forward and K8 backward.
An encoder-decoder arch (SeamlessM4T) draws 32 source frames a row
(`src_embeds`), as `repro.launch.train` does. With `coflow_plan` the
step's gradient buckets (8 MiB, `runtime.buckets.bucketize`) are
planned once into Saath waves for 8 chips on the same device
(`runtime.coflow_bridge.plan_waves`).

Usage (CPU smoke scale; the card is the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --steps 50 --device cpu --ckpt-dir /tmp/ckpt
  python -m repro_torch.launch.train --arch starcoder2-3b --full \\
      --batch 4 --seq 2048 --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import time
from typing import Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.fabric.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.models import lm
from repro_torch.optim import make_optimizer


class StragglerWatchdog:
    """Flags steps slower than `factor` x the running median (§4.3)."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.times = []
        self.window = window
        self.events = []

    def observe(self, step: int, dt: float):
        med = float(np.median(self.times[-self.window:])) \
            if self.times else dt
        self.times.append(dt)
        if len(self.times) > 8 and dt > self.factor * med:
            self.events.append({"step": step, "dt": dt, "median": med})
            return True
        return False


def train(arch: str, *, steps: int = 50, smoke: bool = True,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          batch: int = 8, seq: int = 64, seed: int = 0, log_every: int = 10,
          coflow_plan: bool = True, device=None,
          config_cuts: Optional[dict] = None):
    """Train `arch` (its smoke config, or the published one with
    `smoke=False`; `config_cuts` replaces fields of it, e.g. the depth)
    for `steps` steps of `batch` x `seq` tokens on `device` (default
    CUDA). Returns {"losses", "grad_norms", "step_seconds",
    "straggler_events", "plan", "plan_launches", "final_step"};
    `plan_launches` are the kernel launches of the coflow plan."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if config_cuts:
        cfg = dataclasses.replace(cfg, **config_cuts)
    dev = resolve_device(device)
    params = lm.init_masters(cfg, seed=seed, device=dev)
    opt = make_optimizer(cfg, total_steps=steps,
                         groups=lm.reference_groups(cfg, list(params)))
    opt_state = opt.init(params)
    step_fn = ST.make_train_step(cfg, opt)

    data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=seed,
                           src_len=32 if cfg.enc_dec else 0,
                           d_model=cfg.d_model, device=dev)

    # the Saath plan for this step's collective coflows (gradient
    # buckets) — static per step shape
    plan, plan_launches = None, None
    if coflow_plan:
        from repro_torch.runtime.buckets import bucketize
        from repro_torch.runtime.coflow_bridge import (grad_bucket_coflows,
                                                       plan_waves)
        before = ops.launch_counts()
        bks = bucketize(params, bucket_bytes=8 * 1024 * 1024)
        plan = plan_waves(grad_bucket_coflows(bks), num_chips=8, device=dev)
        plan_launches = {k: v - before[k]
                         for k, v in ops.launch_counts().items()}

    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, every=ckpt_every, keep=3)
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore(ckpt_dir, last,
                            {"params": params, "opt": opt_state},
                            device=dev)
            params = type(params)((n, t.requires_grad_(True))
                                  for n, t in state["params"].items())
            opt_state = state["opt"]
            start = last
            print(f"[train] resumed from step {start}")

    stop = {"now": False}

    def _sig(_s, _f):
        stop["now"] = True

    old = []
    for s in (signal.SIGTERM, signal.SIGINT):
        old.append(signal.signal(s, _sig))

    dog = StragglerWatchdog()
    losses, gnorms, seconds = [], [], []
    try:
        for step in range(start, steps):
            t0 = time.perf_counter()
            b = data.batch(step)
            b = {"tokens": b["tokens"][:, :-1],
                 "labels": b["tokens"][:, 1:],
                 **({"src_embeds": b["src_embeds"]}
                    if "src_embeds" in b else {})}
            params, opt_state, m = step_fn(params, opt_state, step, b)
            loss = float(m["loss"])
            gnorm = float(m["grad_norm"])
            losses.append(loss)
            gnorms.append(gnorm)
            dt = time.perf_counter() - t0
            seconds.append(dt)
            dog.observe(step, dt)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={gnorm:.3f} dt={dt * 1e3:.0f}ms")
            if mgr:
                mgr.maybe_save(step + 1,
                               {"params": params, "opt": opt_state},
                               metadata={"arch": arch, "loss": loss})
            if stop["now"]:
                print("[train] preemption signal — saving and exiting")
                if mgr:
                    mgr.maybe_save(step + 1,
                                   {"params": params, "opt": opt_state},
                                   metadata={"arch": arch, "loss": loss,
                                             "preempted": True},
                                   force=True)
                break
    finally:
        if mgr:
            mgr.wait()
        for s, h in zip((signal.SIGTERM, signal.SIGINT), old):
            signal.signal(s, h)

    return {"losses": losses, "grad_norms": gnorms, "step_seconds": seconds,
            "straggler_events": dog.events, "plan": plan,
            "plan_launches": plan_launches,
            "final_step": start + len(losses)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain versions")
    args = ap.parse_args()
    out = train(args.arch, steps=args.steps, smoke=args.smoke,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                batch=args.batch, seq=args.seq, device=args.device)
    print(json.dumps({"final_loss": out["losses"][-1],
                      "steps": out["final_step"],
                      "stragglers": len(out["straggler_events"])}))


if __name__ == "__main__":
    main()
