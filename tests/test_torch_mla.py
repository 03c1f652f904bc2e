"""The port's MLA attention, the attention kernel's plain version at
unequal widths and the gated FFN against the JAX package's, on the CPU.

* `ref.flash_attention_ref` with a q.k width D and a value width Dv
  (MLA's prefill: 192 and 128) against the reference's `jnp_flash`
  (which the JAX MLA prefill calls), f32 and bf16, causal and not, with
  GQA groups, a chunk at a q_offset and a ragged S against T > S, at
  atol 1e-5 in f32 (the reference's bar between two attention paths,
  `tests/test_kernels.py:109`: `jnp_flash` scales q before the product,
  the plain version the f32 scores, so their 192-term sums round
  apart; 2e-6, the kernel's bar against the plain version, is held on
  the card) and 2e-2 in bf16;
* `flash_attention._like`, the output layout of K5 at a value width
  other than q's;
* `MLAAttention` against `mla_apply` on DeepSeek-V2's SMOKE weights in
  f32 (kv_norm made non-zero): a prefill that fills the latent cache,
  then three absorbed decode steps, outputs and caches to atol 1e-5;
* `glu_ffn` against the reference's, SwiGLU and GeGLU, f32 (atol 1e-5)
  and bf16 (one bf16 step of the output, atol 2e-2).

Inputs are made with numpy from a seed and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.common import Parallelism
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention, ops, ref
from repro_torch.models import attention, common

ARCH = "deepseek-v2-236b"
BARS = {"float32": (jnp.float32, torch.float32, 1e-5),
        "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# (B, H, Hkv, S, T, D, Dv, q_offset): MLA's widths at the smoke and the
# published head counts, GQA groups, a chunk at an offset against a
# longer T, a ragged S, and an equal-width case
UNEQUAL = [(1, 2, 2, 16, 16, 192, 128, 0), (2, 4, 4, 40, 40, 24, 16, 0),
           (1, 8, 2, 33, 33, 192, 128, 0), (2, 4, 2, 23, 40, 192, 128, 17),
           (1, 2, 1, 30, 70, 48, 32, 40), (1, 4, 2, 64, 64, 64, 64, 0)]


def close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("B,H,Hkv,S,T,D,Dv,q_offset", UNEQUAL)
def test_flash_attention_ref_unequal_widths_match_jnp_flash(
        B, H, Hkv, S, T, D, Dv, q_offset, dtype, causal):
    """o (B, H, S, Dv): the reference's `jnp_flash` takes (B, S, H, .)
    tensors, so both sides see the same numbers in their own layouts.
    `jnp_flash` scales q by D^-1/2 in q's dtype, the plain version the
    f32 scores: in bf16 that is one more rounding, inside the bar."""
    rng = np.random.default_rng(S + D + Dv)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv))]
    jdt, tdt, bar = BARS[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert got.shape == (B, H, S, Dv) and got.dtype == tdt
    jq, jk, jv = (jnp.asarray(a.transpose(0, 2, 1, 3), jdt) for a in arrs)
    want = jattn.jnp_flash(jq, jk, jv, causal=causal, q_offset=q_offset,
                           block=32)
    close(got, np.asarray(want, np.float32).transpose(0, 2, 1, 3), bar)


@pytest.mark.parametrize("transposed", [False, True])
def test_kernel_output_is_laid_out_like_q(transposed):
    """K5's output at a value width other than q's keeps q's axis order:
    a (B, S, H, D) tensor passed as its transpose gives an o whose
    transpose back is contiguous."""
    q = torch.zeros(2, 5, 3, 192)
    if transposed:
        q = q.transpose(1, 2)
    else:
        q = q.permute(0, 2, 1, 3).contiguous()
    o = flash_attention._like(q, 128)
    assert o.shape == (2, 3, 5, 128) and o.stride(3) == 1
    if transposed:
        assert o.transpose(1, 2).is_contiguous()
    else:
        assert o.is_contiguous()


def smoke_mla():
    """DeepSeek-V2's SMOKE MLA weights of one layer from the JAX
    package, kv_norm made non-zero so that the norm is exercised: (port
    config, JAX config, JAX weights, port module), f32."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    pf = jcommon.ParamFactory(jax.random.key(5))
    w = jax.tree.map(lambda t: t[0], jattn.mla_init(pf, jcfg, "attn", 1))
    w = dict(w, kv_norm=w["kv_norm"] + 0.25)
    module = attention.MLAAttention(cfg, {
        k: torch.tensor(np.asarray(v)) for k, v in w.items()})
    return cfg, jcfg, w, module


def test_mla_weights_have_the_reference_shapes():
    cfg, jcfg, _, _ = smoke_mla()
    pf = jcommon.ParamFactory(jax.random.key(0))
    want = jax.eval_shape(lambda: jattn.mla_init(pf, jcfg, "attn", 1))
    got = attention.mla_init(common.ParamInit(0, "cpu", torch.float32), cfg)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape[1:], k


def test_mla_module_matches_mla_apply():
    """Prefill of S tokens filling a latent cache of max_len rows, then
    three absorbed decode steps at kv_len = S, S + 1, S + 2: outputs,
    ckv and krope to atol 1e-5."""
    cfg, jcfg, w, module = smoke_mla()
    B, S, n, max_len = 2, 19, 3, 26
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S + n, cfg.d_model)).astype(np.float32)
    shapes = {"ckv": (B, max_len, cfg.kv_lora_rank),
              "krope": (B, max_len, cfg.rope_head_dim)}
    jcache = {k: jnp.zeros(s) for k, s in shapes.items()}
    cache = {k: torch.zeros(s) for k, s in shapes.items()}
    jo, jcache = jattn.mla_apply(jcfg, w, jnp.asarray(x[:, :S]),
                                 positions=jnp.arange(S)[None],
                                 cache=jcache)
    with torch.inference_mode():
        o, cache = module(torch.from_numpy(x[:, :S]),
                          torch.arange(S)[None], cache)
        close(o, jo, 1e-5)
        for k in shapes:
            close(cache[k], jcache[k], 1e-5)
        for i in range(n):
            pos = S + i
            jo, jcache = jattn.mla_apply(
                jcfg, w, jnp.asarray(x[:, pos:pos + 1]),
                positions=jnp.full((B, 1), pos, jnp.int32), cache=jcache,
                kv_len=jnp.int32(pos))
            o, cache = module(torch.from_numpy(x[:, pos:pos + 1]),
                              torch.full((B, 1), pos), cache, kv_len=pos)
            close(o, jo, 1e-5)
            for k in shapes:
                close(cache[k], jcache[k], 1e-5)


def test_mla_prefill_runs_the_attention_entry_point_at_mla_widths(
        monkeypatch):
    """The prefill's attention goes through `ops.flash_attention` with
    q and k (dn + dr) wide and v dn wide, causal; without a cache it
    attends its own k and v (the cached prefill's output); a decode step
    needs one token and a cache."""
    cfg, _, _, module = smoke_mla()
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 9, cfg.d_model)).astype(np.float32))
    pos = torch.arange(9)[None]
    cache = {"ckv": torch.zeros(1, 12, cfg.kv_lora_rank),
             "krope": torch.zeros(1, 12, cfg.rope_head_dim)}
    cached, _ = module(x, pos, cache)
    bare, none = module(x, pos)
    assert none is None
    torch.testing.assert_close(bare, cached, atol=0, rtol=0)
    dqk = cfg.head_dim + cfg.rope_head_dim
    assert seen == [(dqk, dqk, cfg.head_dim, True)] * 2
    with pytest.raises(ValueError, match="one token"):
        module(x, pos, cache, kv_len=3)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", sorted(BARS))
def test_glu_ffn_matches_jax(act, dtype):
    rng = np.random.default_rng(6)
    arrs = [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((2, 7, 32), 1.0), ((32, 48), 32 ** -0.5), ((32, 48), 32 ** -0.5),
        ((48, 32), 48 ** -0.5))]
    jdt, tdt, _ = BARS[dtype]
    want = jcommon.glu_ffn(*(jnp.asarray(a, jdt) for a in arrs), act,
                           Parallelism(None))
    got = common.glu_ffn(*(torch.from_numpy(a).to(tdt) for a in arrs), act)
    assert got.dtype == tdt
    close(got, want, BARS[dtype][2])
