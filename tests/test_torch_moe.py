"""The port's MoE FFN (`models.moe`) against the JAX package's
`repro.models.moe`, on the CPU, at the three MoE SMOKE configs
(Qwen3-MoE: 8 experts top-2; DeepSeek-V2: 8 top-2 and a shared expert;
Jamba: 4 top-2), f32, on one layer of weights drawn by the JAX package:

* `moe_apply` at the default capacity factor 1.25 (a router column
  biased so that one expert overflows: drops occur) and at 64 (none),
  at a prefill's token count and a decode's (T = B, where cap = 4),
  with and without the shared experts, to atol 1e-5 (f32 products of
  width <= 128 summed in another order);
* the kept-pair mask and the slots equal to the reference's `_pack`,
  and the capacity equal to its formula;
* the top-k tie rule: among equal probabilities the lower expert comes
  first, as `jax.lax.top_k` orders them, and the weights equal the
  reference's.

Inputs are made with numpy from a seed and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models.common import Parallelism
from repro_torch.configs import get_smoke_config
from repro_torch.models import common, moe

ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v2-236b", "jamba-v0.1-52b"]
PAR = Parallelism(None)
ATOL = 1e-5


def smoke_moe(arch, seed=3, shared=None, bias=0.0):
    """(port config, JAX config, JAX weights of one layer, port weights)
    of `arch`'s SMOKE MoE in f32. `shared` overrides the shared-expert
    count; bias / d_model is added to the router column of expert 1, so
    that on `tokens` (mean 1) its logit rises by about `bias`, most
    tokens choose it and it overflows its capacity."""
    kw = {"dtype": "float32"}
    if shared is not None:
        kw["num_shared_experts"] = shared
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    jcfg = dataclasses.replace(jget_smoke(arch), **kw)
    pf = jcommon.ParamFactory(jax.random.key(seed))
    w = jax.tree.map(lambda t: t[0], jmoe.moe_init(pf, jcfg, "moe", 1))
    w["router"] = w["router"].at[:, 1].add(bias / jcfg.d_model)
    tw = {k: torch.tensor(np.asarray(v)) for k, v in w.items()}
    return cfg, jcfg, w, tw


def tokens(seed, shape):
    """Seeded normal tokens with mean 1 (see `smoke_moe`'s bias)."""
    return np.random.default_rng(seed).normal(1.0, 1.0, shape).astype(
        np.float32)


def jax_pack(jcfg, w, x, capacity_factor):
    """The reference's routing and `_pack` on x (T, d): (slot, keep,
    cap), as numpy."""
    E, k = jcfg.num_experts, jcfg.num_experts_per_tok
    logits = jnp.einsum("td,de->te", x, w["router"]).astype(jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    T = x.shape[0]
    cap = int(max(4, np.ceil(T * k * capacity_factor / E)))
    slot, keep = jmoe._pack(top_e.reshape(-1), None,
                            jnp.repeat(jnp.arange(T), k), E, cap)
    return np.asarray(slot), np.asarray(keep), cap


@pytest.mark.parametrize("B,S", [(2, 24), (3, 1)])
@pytest.mark.parametrize("capacity_factor", [None, 64.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, capacity_factor, B, S):
    """The default capacity factor drops pairs at the prefill's size
    (asserted); at 64 nothing is dropped; S = 1 is a decode step's
    token count."""
    cfg, jcfg, w, tw = smoke_moe(arch, bias=4.0)
    x = tokens(B * S, (B, S, cfg.d_model))
    want = jmoe.moe_apply(jcfg, w, jnp.asarray(x), par=PAR,
                          capacity_factor=capacity_factor)
    got = moe.moe_apply(cfg, tw, torch.from_numpy(x),
                        capacity_factor=capacity_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    _, keep, cap = jax_pack(jcfg, w, jnp.asarray(x.reshape(B * S, -1)),
                            capacity_factor or cfg.moe_capacity_factor)
    if capacity_factor is None:
        assert cap == 4 if S == 1 else not keep.all()


@pytest.mark.parametrize("shared", [0, 2])
def test_moe_apply_with_and_without_shared_experts(shared):
    """DeepSeek-V2's layer with its shared experts taken out and with
    two: the routed part and the shared GLU both as the reference's."""
    cfg, jcfg, w, tw = smoke_moe("deepseek-v2-236b", seed=8, shared=shared)
    assert ("shared_gate" in w) == bool(shared)
    x = tokens(1, (2, 20, cfg.d_model))
    want = jmoe.moe_apply(jcfg, w, jnp.asarray(x), par=PAR)
    got = moe.MoEFFN(cfg, tw)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("capacity_factor", [1.25, 1.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_kept_pairs_and_slots_equal_the_reference_pack(arch,
                                                       capacity_factor):
    """Routing, capacity and the pack on the same tokens: the port's
    slots and kept-pair mask are the reference's, drops included."""
    cfg, jcfg, w, tw = smoke_moe(arch, bias=4.0)
    x = tokens(5, (40, cfg.d_model))
    slot, keep, cap = jax_pack(jcfg, w, jnp.asarray(x), capacity_factor)
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    assert moe.capacity(40, k, E, capacity_factor) == cap
    _, top_e = moe.route(torch.from_numpy(x), tw["router"], k)
    got_slot, got_keep = moe.pack(top_e.reshape(-1), E, cap)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    np.testing.assert_array_equal(got_slot.numpy(), slot)
    assert not keep.all()


def test_pack_ranks_pairs_in_token_then_choice_order():
    """Pairs fill an expert's slots in (token, choice) order; the
    (cap + 1)-th pair of an expert and later ones are dropped."""
    e = torch.tensor([2, 0, 2, 1, 2, 2, 0, 2])
    slot, keep = moe.pack(e, 3, 3)
    assert keep.tolist() == [True, True, True, True, True, False, True,
                             False]
    assert slot.tolist() == [6, 0, 7, 3, 8, 8, 1, 8]
    jslot, jkeep = jmoe._pack(jnp.asarray(e.numpy()), None, None, 3, 3)
    assert np.asarray(jslot).tolist() == slot.tolist()
    assert np.asarray(jkeep).tolist() == keep.tolist()


@pytest.mark.parametrize("logits", [
    np.zeros((2, 8)),
    np.array([[0.0, 1.0, 1.0, 0.5, 1.0, 0.0, 0.0, 1.0],
              [2.0, 0.0, 0.0, 2.0, 0.0, 0.0, 0.0, 0.0]]),
    np.array([[3.0, 3.0, 3.0, 3.0, 1.0, 1.0, 3.0, 3.0]])])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_top_k_ties_take_the_lower_expert_first(logits, k):
    """Equal probabilities (an identity router over equal logits): the
    experts and weights `jax.lax.top_k` gives, lower index first."""
    x = torch.tensor(logits, dtype=torch.float32)
    w, e = moe.route(x, torch.eye(8), k)
    jw, je = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits, jnp.float32),
                                          axis=-1), k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    jw = jw / jnp.maximum(jw.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7,
                               rtol=0)


def test_moe_init_draws_the_reference_shapes():
    for arch in ARCHS:
        cfg, jcfg, w, _ = smoke_moe(arch)
        got = moe.moe_init(common.ParamInit(0, "cpu", torch.float32), cfg)
        assert sorted(got) == sorted(w)
        for name, t in got.items():
            assert tuple(t.shape) == w[name].shape, (arch, name)
