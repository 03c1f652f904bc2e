"""The port's optimizers (`repro_torch.optim`) against the JAX package's
(`repro.optim`) on the CPU, on the same seeded numpy trees, at rtol 1e-6
(f32 arithmetic in the same order; the sums of the global norm and
Adafactor's means may add in another order): the cosine schedule, the
global-norm clip, AdamW and Adafactor over three steps with f32 and
bf16 state (parameters, state and grad_norm), and Adafactor's factoring
of per-layer 1-D leaves as the reference's stacked (layers, d) leaves.
Each comparison also allows 1e-6 of the leaf's largest magnitude: the
JAX package's CPU backend contracts a x + b y into fused multiply-adds
and the port does not (ROADMAP C1), which shows where the two terms of
a moment update nearly cancel.
"""
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.optim import optimizers as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.optim import optimizers as opt

RTOL = 1e-6
SHAPES = {"a_bias": (7,), "b_dense": (6, 5), "c_stack": (3, 4, 5),
          "d_embed": (11, 4), "e_norm": (4,)}
STATE = {"f32": (torch.float32, jnp.float32),
         "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.standard_normal(s)).astype(np.float32)
            for n, s in sorted(SHAPES.items())}


def _port(tree):
    return OrderedDict((n, torch.tensor(a)) for n, a in sorted(tree.items()))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what):
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 5),
                                          (500, 10000)])
def test_cosine_schedule(warmup, total):
    ref = jopt.cosine_schedule(3e-4, warmup, total)
    port = opt.cosine_schedule(3e-4, warmup, total)
    for step in (0, 1, 2, 4, 5, 9, 10, 499, 500, 5000, 10000, 12000):
        _close(port(step), ref(step), f"lr at {step}")


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 100.0])
def test_clip_by_global_norm(max_norm):
    g = _tree(1)
    want, wnorm = jopt.clip_by_global_norm(
        {n: jnp.asarray(a) for n, a in g.items()}, max_norm)
    grads = _port(g)
    got, norm = opt.clip_by_global_norm(grads, max_norm)
    assert got is grads                 # scaled where they are
    _close(norm, wnorm, "norm")
    for n in g:
        _close(got[n], want[n], n)


def _run(make_ref, make_port, steps=3):
    """Three updates of both optimizers from the same params and grads;
    returns (ref params, ref state, ref norms, port ...)."""
    p0 = _tree(0)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    pp = _port(p0)
    ro, po = make_ref(), make_port()
    js, ps = ro.init(jp), po.init(pp)
    jn, pn = [], []
    for step in range(steps):
        g = _tree(10 + step, scale=0.3 + step)
        jp, js, ji = ro.update({n: jnp.asarray(a) for n, a in g.items()},
                               js, jp, step)
        pp, ps, pi = po.update(_port(g), ps, pp, step)
        jn.append(ji["grad_norm"])
        pn.append(pi["grad_norm"])
    return jp, js, jn, pp, ps, pn


@pytest.mark.parametrize("state", sorted(STATE))
def test_adamw_matches_reference(state):
    tdt, jdt = STATE[state]
    jp, js, jn, pp, ps, pn = _run(
        lambda: jopt.adamw(jopt.cosine_schedule(1e-2, 1, 3),
                           state_dtype=jdt),
        lambda: opt.adamw(opt.cosine_schedule(1e-2, 1, 3), state_dtype=tdt))
    for a, b in zip(pn, jn):
        _close(a, b, "grad_norm")
    for n in SHAPES:
        _close(pp[n], jp[n], f"param {n}")
        for k in ("m", "v"):
            assert ps[k][n].dtype == tdt
            _close(ps[k][n], js[k][n], f"{k} of {n}")


@pytest.mark.parametrize("state", sorted(STATE))
def test_adafactor_matches_reference(state):
    tdt, jdt = STATE[state]
    jp, js, jn, pp, ps, pn = _run(
        lambda: jopt.adafactor(jopt.cosine_schedule(1e-2, 1, 3),
                               state_dtype=jdt),
        lambda: opt.adafactor(opt.cosine_schedule(1e-2, 1, 3),
                              state_dtype=tdt))
    for a, b in zip(pn, jn):
        _close(a, b, "grad_norm")
    for n, shape in SHAPES.items():
        _close(pp[n], jp[n], f"param {n}")
        keys = ("vr", "vc") if len(shape) >= 2 else ("v",)
        assert sorted(ps["f"][n]) == sorted(keys)
        for k in keys:
            assert ps["f"][n][k].dtype == tdt
            _close(ps["f"][n][k], js["f"][n][k], f"{k} of {n}")


@pytest.mark.parametrize("state", sorted(STATE))
def test_adafactor_factors_per_layer_leaves_as_the_stack(state):
    """The reference holds a layer's norm weight (d,) inside a (layers,
    d) leaf and factors it across the stack (vr over d per layer, vc
    over the layers), a layer's matrix (a, b) inside (layers, a, b) per
    layer. The port's per-layer leaves, grouped as the reference stacks
    them, take the same updates and state; ungrouped, the 1-D ones do
    not."""
    tdt, jdt = STATE[state]
    L, rng = 3, np.random.default_rng(5)
    ref_shapes = {"embed": (9, 4), "ln": (L, 4), "w": (L, 4, 5),
                  "top": (4,)}
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in ref_shapes.items()}
    grads = [{n: (0.5 * rng.standard_normal(s)).astype(np.float32)
              for n, s in ref_shapes.items()} for _ in range(3)]

    def per_layer(tree):
        out = OrderedDict()
        for n in sorted(tree):
            if n in ("ln", "w"):
                for l in range(L):
                    out[f"{n}.{l}"] = torch.tensor(tree[n][l])
            else:
                out[n] = torch.tensor(tree[n])
        return out

    groups = {g: [f"{g}.{l}" for l in range(L)] for g in ("ln", "w")}
    ro = jopt.adafactor(jopt.cosine_schedule(1e-2, 1, 3), state_dtype=jdt)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    js = ro.init(jp)
    runs = {}
    for name, grp in (("grouped", groups), ("alone", None)):
        po = opt.adafactor(opt.cosine_schedule(1e-2, 1, 3),
                           state_dtype=tdt, groups=grp)
        pp = per_layer(p0)
        ps = po.init(pp)
        for step, g in enumerate(grads):
            pp, ps, _ = po.update(per_layer(g), ps, pp, step)
        runs[name] = (pp, ps)
    for step, g in enumerate(grads):
        jp, js, _ = ro.update({n: jnp.asarray(a) for n, a in g.items()},
                              js, jp, step)
    pp, ps = runs["grouped"]
    for n in ("embed", "top"):
        _close(pp[n], jp[n], n)
    for l in range(L):
        _close(pp[f"ln.{l}"], jp["ln"][l], f"ln layer {l}")
        _close(pp[f"w.{l}"], jp["w"][l], f"w layer {l}")
    for g in ("ln", "w"):
        for k in ("vr", "vc"):
            assert tuple(ps["f"][g][k].shape) == js["f"][g][k].shape
            _close(ps["f"][g][k], js["f"][g][k], f"{k} of {g}")
    alone = runs["alone"][0]
    gap = max(float(np.abs(_f32(alone[f"ln.{l}"]) - _f32(jp["ln"][l])).max())
              for l in range(L))
    assert gap > 1e-4, gap


def test_make_optimizer_follows_the_config():
    import dataclasses

    for arch in ("starcoder2-3b", "qwen3-moe-235b-a22b"):
        cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
        p = OrderedDict(w=torch.zeros(3, 2))
        st = opt.make_optimizer(cfg, total_steps=10).init(p)
        want = jopt.make_optimizer(jcfg, total_steps=10).init(
            {"w": jnp.zeros((3, 2))})
        assert str(st["m"]["w"].dtype)[6:] == str(want["m"]["w"].dtype)
        fact = opt.make_optimizer(dataclasses.replace(cfg,
                                                      optimizer="adafactor"),
                                  total_steps=10).init(p)
        assert sorted(fact["f"]["w"]) == ["vc", "vr"]
