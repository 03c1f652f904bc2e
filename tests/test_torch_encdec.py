"""The parts this port slice adds below the models, against the JAX
package's, on the CPU, f32 unless said:

* `lm.embed_tokens` and the train path's embedding (`forward_train_loss`,
  seen at its first layer's input) in bf16 under `scale_embed` equal the
  reference's `embed_tokens` bit for bit: sqrt(d_model) rounded to bf16
  first (55.5 for Gemma's d_model 3072), at Gemma's SMOKE width and at
  d_model 3072;
* cross attention alone (`GQAAttention.cross_kv` and `.cross`, q-normed
  or not, a prefill of S rows and a decode step) against `gqa_apply(
  cross_kv=...)`; the encoder alone (`lm.encode`) against the
  reference's `encode`, SeamlessM4T's SMOKE config with weights that are
  not zero;
* `ops.flash_attention(causal=False)` with S != T on the plain path (no
  launch) against `jnp_flash(causal=False)` and the Pallas kernel in
  interpret mode, at K5's widths (Gemma's (256, 256) among them);
* K5 is built for (256, 256) and K7 is not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.common import Parallelism
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import flash_attention_bwd as k7
from repro_torch.kernels import ops
from repro_torch.models import attention, lm

PAR = Parallelism(None)
SEAM, GEMMA = "seamless-m4t-medium", "gemma-7b"


def close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def noisy_params(cfg, seed):
    """`numpy_params` with every zero leaf (the norms) replaced by small
    normals, so that the norms' weights take part."""
    params, meta = lm.numpy_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        if not a.any() else a, params)
    return params, meta


# ---- the embedding scale ----------------------------------------------

@pytest.mark.parametrize("d_model", [None, 3072])
def test_embed_tokens_bf16_bitwise(d_model):
    kw = {} if d_model is None else {"d_model": d_model}
    cfg = dataclasses.replace(get_smoke_config(GEMMA), **kw)
    jcfg = dataclasses.replace(jget_smoke(GEMMA), **kw)
    assert cfg.scale_embed and cfg.dtype == "bfloat16"
    params, meta = lm.numpy_params(cfg, seed=2)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 33))
    want = np.asarray(jlm.embed_tokens(
        jcfg, {"embed": jnp.asarray(params["embed"])},
        jnp.asarray(tokens), PAR).astype(jnp.float32))
    model = lm.from_reference(params, meta, cfg)
    with torch.inference_mode():
        got = lm.embed_tokens(model, torch.as_tensor(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the train path: the masters cast to bf16 in the loss, the first
    # layer's input
    seen = []
    skel = lm.skeleton(cfg)
    skel.layers[0].register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach()))
    masters = lm.masters_from_reference(params, cfg)
    tok = torch.as_tensor(tokens)
    lm.forward_train_loss(skel, masters, {"tokens": tok, "labels": tok})
    assert seen[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(seen[0].float().numpy(), want)
    if d_model == 3072:   # sqrt(3072) = 55.43 is 55.5 in bf16
        assert float(torch.tensor(3072 ** 0.5, dtype=torch.bfloat16)) \
            == 55.5


# ---- cross attention and the encoder -----------------------------------

@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("S", [7, 1])
def test_cross_attention_matches_gqa_apply(qk_norm, S):
    """k and v projected from an encoder output (no RoPE, no k-norm),
    then q (q-normed under qk_norm, no RoPE) attends all of their rows:
    a prefill of S rows through `ops.flash_attention` (non-causal, S !=
    T) and a decode step (S = 1) through `decode_attend`, against
    `gqa_apply(cross_kv=...)` (atol 1e-5)."""
    cfg = dataclasses.replace(get_smoke_config(SEAM), dtype="float32",
                              qk_norm=qk_norm)
    jcfg = dataclasses.replace(jget_smoke(SEAM), dtype="float32",
                               qk_norm=qk_norm)
    params, _ = noisy_params(cfg, seed=4)
    w = {k: v[0] for k, v in params["decoder"]["offsets"][0]["cross"].items()}
    module = attention.GQAAttention(cfg, {k: torch.tensor(v)
                                          for k, v in w.items()})
    rng = np.random.default_rng(5)
    enc = rng.normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jk = jnp.einsum("bsd,dhk->bshk", jnp.asarray(enc), jw["wk"])
    jv = jnp.einsum("bsd,dhk->bshk", jnp.asarray(enc), jw["wv"])
    want, _ = jattn.gqa_apply(jcfg, jw, jnp.asarray(x),
                              positions=jnp.arange(S)[None] + 3,
                              cache=None, causal=False, cross_kv=(jk, jv))
    before = ops.launch_counts()["flash_attention"]
    with torch.inference_mode():
        k, v = module.cross_kv(torch.from_numpy(enc))
        close(k, jk, 1e-5)
        close(v, jv, 1e-5)
        got = module.cross(torch.from_numpy(x), k, v, decode=S == 1)
    assert ops.launch_counts()["flash_attention"] == before
    close(got, want, 1e-5)


def test_encoder_matches_encode():
    """SeamlessM4T's SMOKE encoder (2 non-causal attention layers with
    RoPE over positions 0..S_src-1, then ln_enc) on frames of the
    compute dtype, against the reference's `encode` (atol 1e-5)."""
    cfg = dataclasses.replace(get_smoke_config(SEAM), dtype="float32")
    jcfg = dataclasses.replace(jget_smoke(SEAM), dtype="float32")
    params, meta = noisy_params(cfg, seed=6)
    src = np.random.default_rng(7).normal(
        size=(2, 21, cfg.d_model)).astype(np.float32)
    want = jlm.encode(jcfg, jax.tree.map(jnp.asarray, params), meta,
                      jnp.asarray(src), PAR)
    model = lm.from_reference(params, meta, cfg)
    with torch.inference_mode():
        got = lm.encode(model, torch.from_numpy(src))
    close(got, want, 1e-5)
    # a causal encoder would differ: the mask matters here
    with torch.inference_mode():
        x = model.encoder[0](torch.from_numpy(src),
                             positions=torch.arange(21)[None])[0]
        y = model.encoder[0](torch.from_numpy(src),
                             positions=torch.arange(21)[None],
                             causal=False)[0]
    assert not torch.allclose(x, y, atol=1e-3)


# ---- K5's non-causal branch with S != T, and the widths ---------------

@pytest.mark.parametrize("B,H,Hkv,S,T,D", [
    (2, 4, 4, 16, 40, 16), (1, 6, 2, 5, 33, 32), (2, 14, 2, 9, 70, 64),
    (1, 2, 2, 8, 24, 256)])
def test_flash_attention_non_causal_s_ne_t(B, H, Hkv, S, T, D):
    """Cross attention's shape: S query rows against T != S keys,
    non-causal, on CPU tensors (the plain version, no launch) against
    `jnp_flash(causal=False)` ((B, S, H, D) layout) and the Pallas kernel
    in interpret mode, at 2e-6."""
    rng = np.random.default_rng(S + T + D)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    assert ops.launch_counts()["flash_attention"] == before
    assert got.shape == (B, H, S, D)
    want = jattn.jnp_flash(*(jnp.asarray(a.transpose(0, 2, 1, 3))
                             for a in (q, k, v)), causal=False, q_offset=0)
    close(got, np.asarray(want).transpose(0, 2, 1, 3), 2e-6)
    close(got, jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False, bq=8,
                                    bk=8, force="interpret"), 2e-6)


def test_k5_and_k7_width_lists():
    """K5 is built for Gemma's (256, 256); K7 keeps its own list without
    it (its refusal: `tests/test_torch_train.py`), while the plain
    backward, the CPU's path, takes the pair."""
    assert (256, 256) in k5.WIDTHS
    assert (256, 256) not in k7.WIDTHS
    assert set(k7.WIDTHS) == set(k5.WIDTHS) - {(256, 256)}
    q = torch.zeros(1, 2, 4, 256)
    dq, dk, dv = ops.flash_attention_bwd(q, q[:, :1], q[:, :1], q, q)
    assert dq.shape == q.shape and dv.shape == (1, 1, 4, 256)
