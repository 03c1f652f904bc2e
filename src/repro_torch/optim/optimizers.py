"""Optimizers of the port (AdamW, Adafactor), the cosine schedule and
global-norm clipping.

The counterpart of `repro.optim.optimizers`. Parameters, gradients and
state are ordered dicts of tensors keyed by leaf name (the port's f32
masters, `models.lm.init_masters`); the state is kept in `state_dtype`
(bf16 for the configs that set `opt_state_dtype`, as the reference
does). The arithmetic is f32 in the reference's order: the step's
scalars (t = step + 1, the bias corrections, the learning rate,
Adafactor's beta) are formed as f32 values first, then each leaf's
update as the reference writes it; `grad_norm` is the norm before
clipping.

`Optimizer.update(grads, state, params, step)` returns (params, state,
{"grad_norm"}) like the reference's, but writes the new parameters, the
new state and the clipped gradients into the given tensors in place (a
full-width StarCoder2-3B holds 13.6 GB of f32 masters and twice that of
moments; a functional copy of them would not fit beside them on the
card).

Adafactor factors the second moment of every leaf the reference holds
with ndim >= 2. The reference holds each layer leaf stacked over its
layer group (a leading axis), so a per-layer norm weight (d,) is part
of a (groups, d) leaf there, factored across the stack. `groups` maps a
key to the port leaves the reference stacks into one leaf, in stack
order (`models.lm.reference_groups`): their state has the stacked
leaf's shape and the update factors them as that stack. A leaf in no
group is factored as it stands.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Callable, Mapping, Optional, Sequence

import torch

_F32 = torch.float32


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """lr(step) -> 0-d f32 tensor: linear warm-up over `warmup` steps,
    then cosine decay to `min_frac` of `base_lr` at `total`."""
    def lr(step):
        step = torch.as_tensor(step, dtype=_F32)
        warm = base_lr * (step + 1.0) / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """Scales the leaves of `grads` where they are by min(1, max_norm /
    max(norm, 1e-9)) and returns (grads, norm): the norm over every leaf
    in f32, summed leaf by leaf in the dict's order."""
    g2 = sum((g.to(_F32) * g.to(_F32)).sum() for g in grads.values())
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.to(_F32) * scale)
    return grads, norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # (params) -> state
    update: Callable   # (grads, state, params, step) -> (params, state, info)


def _scalar(x: torch.Tensor) -> float:
    """An f32 value as a Python float (exact), for use as an operand."""
    return float(x.to(_F32))


def adamw(lr_fn: Callable, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
          state_dtype=_F32, clip=1.0) -> Optimizer:
    """AdamW with decoupled weight decay on every leaf, after clipping
    the gradients to a global norm of `clip`."""
    def init(params):
        return {"m": OrderedDict((n, torch.zeros_like(p, dtype=state_dtype))
                                 for n, p in params.items()),
                "v": OrderedDict((n, torch.zeros_like(p, dtype=state_dtype))
                                 for n, p in params.items())}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, clip)
        t = torch.tensor(float(step), dtype=_F32) + 1.0
        lr = _scalar(lr_fn(step))
        bc1 = _scalar(1 - b1 ** t)
        bc2 = _scalar(1 - b2 ** t)
        for n, p in params.items():
            gf = grads[n].to(_F32)
            m, v = state["m"][n], state["v"][n]
            m_new = b1 * m.to(_F32) + (1 - b1) * gf
            v_new = b2 * v.to(_F32) + (1 - b2) * gf * gf
            step_ = lr * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                          + wd * p.to(_F32))
            p.copy_(p.to(_F32) - step_)
            m.copy_(m_new)
            v.copy_(v_new)
        return params, state, {"grad_norm": gnorm}

    return Optimizer(init, update)


def _units(params, groups):
    """[(state key, leaf names, stacked)] in the order of `params`: each
    group once, at its first leaf, then every leaf in no group alone."""
    owner = {n: key for key, names in (groups or {}).items() for n in names}
    units, seen = [], set()
    for n in params:
        key = owner.get(n)
        if key is None:
            units.append((n, [n], False))
        elif key not in seen:
            seen.add(key)
            units.append((key, list(groups[key]), True))
    return units


def adafactor(lr_fn: Callable, eps=1e-30, clip=1.0, state_dtype=_F32,
              groups: Optional[Mapping[str, Sequence[str]]] = None
              ) -> Optimizer:
    """Adafactor with factored second moments for leaves of ndim >= 2
    (memory O(n + m), not O(n m)), after clipping to a global norm of
    `clip`; `groups` as in the module note."""
    def init(params):
        f = OrderedDict()
        for key, names, stacked in _units(params, groups):
            p = params[names[0]]
            shape = ((len(names),) if stacked else ()) + tuple(p.shape)
            zeros = lambda s: torch.zeros(s, dtype=state_dtype,  # noqa: E731
                                          device=p.device)
            if len(shape) >= 2:
                f[key] = {"vr": zeros(shape[:-1]),
                          "vc": zeros(shape[:-2] + shape[-1:])}
            else:
                f[key] = {"v": zeros(shape)}
        return {"f": f}

    def upd(g, s, p, beta, omb, lr):
        """The reference's `upd` on one (possibly stacked) leaf: writes
        the state `s` in place, returns the new parameter values."""
        gf = g.to(_F32)
        g2 = gf * gf + eps
        if p.dim() >= 2:
            vr = beta * s["vr"].to(_F32) + omb * g2.mean(-1)
            vc = beta * s["vc"].to(_F32) + omb * g2.mean(-2)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                              min=eps))
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = beta * s["v"].to(_F32) + omb * g2
            denom = torch.sqrt(v)
            s["v"].copy_(v)
        stp = lr * gf / torch.clamp(denom, min=1e-12)
        return p.to(_F32) - stp

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, clip)
        t = torch.tensor(float(step), dtype=_F32) + 1.0
        beta_t = 1.0 - t ** -0.8
        beta, omb = _scalar(beta_t), _scalar(1 - beta_t)
        lr = _scalar(lr_fn(step))
        for key, names, stacked in _units(params, groups):
            s = state["f"][key]
            if stacked and params[names[0]].dim() >= 2:
                # factored over each layer's own last two axes: one
                # member of the stack at a time, into views of its state
                for i, n in enumerate(names):
                    params[n].copy_(upd(grads[n], {k: t_[i] for k, t_ in
                                                   s.items()},
                                        params[n], beta, omb, lr))
            elif stacked:
                new = upd(torch.stack([grads[n] for n in names]), s,
                          torch.stack([params[n] for n in names]), beta,
                          omb, lr)
                for i, n in enumerate(names):
                    params[n].copy_(new[i])
            else:
                params[key].copy_(upd(grads[key], s, params[key], beta, omb,
                                      lr))
        return params, state, {"grad_norm": gnorm}

    return Optimizer(init, update)


def make_optimizer(cfg, total_steps: int = 10000, base_lr: float = 3e-4,
                   groups: Optional[Mapping[str, Sequence[str]]] = None
                   ) -> Optimizer:
    """The config's optimizer under the reference's cosine schedule
    (warm-up min(500, total_steps // 10)); `groups` goes to Adafactor."""
    lr = cosine_schedule(base_lr, warmup=min(500, total_steps // 10),
                         total=total_steps)
    sdt = torch.bfloat16 if cfg.opt_state_dtype == "bfloat16" else _F32
    if cfg.optimizer == "adafactor":
        return adafactor(lr, state_dtype=sdt, groups=groups)
    return adamw(lr, state_dtype=sdt)


__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "cosine_schedule", "make_optimizer"]
