"""The serve paths of the port's other dense models and its
encoder-decoder model (Gemma-7B, DeepSeek-7B, DeepSeek-Coder-33B,
Chameleon-34B, SeamlessM4T-medium) against the JAX package's, on the
CPU, at the SMOKE configs (the helpers and the f32 parity are in
`tests/test_torch_lm_dense.py`):

* in the config's bf16 every step's logits within 0.1 (ROADMAP C5) plus
  two to four bf16 steps of the value (rtol 2^-6, the bar of
  `tests/test_torch_lm_moe.py`'s bf16 layers), teacher-forced: Gemma's
  tied unit-normal embedding gives logits of magnitude ~sqrt(d_model),
  where one bf16 step is past 0.1 (ROADMAP C15);
* prefill then decode equals prefill of the longer prompt inside the
  port (the contract of `tests/test_arch_smoke.py:73`), f32;
* `ServeSession(..., device="cpu")` generates the JAX `ServeSession`'s
  tokens from the same weights (and frames), f32; the bf16 SMOKE
  session's defaults, and an encoder-decoder session without its
  frames refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import lm_serve as jserve
from repro.models import lm as jlm
from repro_torch.launch import lm_serve
from repro_torch.models import lm
from tests.test_torch_lm_dense import (ARCHS, BF16_RTOL, BF16_TOL, PAR,
                                       SRC_LEN, TOL, configs, smoke_pair,
                                       src_embeds)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_bar(arch):
    """Teacher-forced: the same tokens go to both, so the histories
    agree; every step's logits within 0.1 plus two to four bf16 steps of the
    value."""
    cfg, jcfg, params, meta, model = smoke_pair(arch, "bfloat16", seed=3)
    B, S, n = 2, 24, 4
    full = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + n)).astype(np.int32)
    src = src_embeds(cfg, B)
    prefill = jax.jit(lambda p, b, c: jlm.forward_prefill(
        jcfg, p, meta, b, c, PAR))
    decode = jax.jit(lambda p, t, c, k: jlm.forward_decode(
        jcfg, p, meta, t, c, k, PAR))
    jc = jlm.init_cache(jcfg, meta, B, S + n, PAR,
                        src_len=SRC_LEN if cfg.enc_dec else 0)
    batch = {"tokens": jnp.asarray(full[:, :S])}
    if cfg.enc_dec:
        batch["src_embeds"] = jnp.asarray(src)
    jl, jc = prefill(params, batch, jc)
    with torch.inference_mode():
        pc = lm.init_cache(cfg, B, S + n,
                           src_len=SRC_LEN if cfg.enc_dec else 0)
        pl, pc = lm.forward_prefill(
            model, torch.as_tensor(full[:, :S]).long(), pc,
            src_embeds=None if src is None else torch.as_tensor(src))
        assert pl.dtype == torch.bfloat16
        for i in range(n + 1):
            np.testing.assert_allclose(pl.float().numpy(),
                                       np.asarray(jl, np.float32),
                                       atol=BF16_TOL, rtol=BF16_RTOL)
            if i == n:
                break
            tok = full[:, S + i:S + i + 1]
            jl, jc = decode(params, jnp.asarray(tok), jc, jnp.int32(S + i))
            pl, pc = lm.forward_decode(model, torch.as_tensor(tok).long(),
                                       pc, S + i)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Prefill of S tokens, then decode of tokens S.. one by one, gives
    the last-token logits of prefilling the longer prompt (the same
    frames for an encoder-decoder; the reference's 2e-3 bar,
    `tests/test_arch_smoke.py:73`)."""
    cfg, _ = configs(arch)
    model = lm.init_model(cfg, seed=1)
    B, S, n = 2, 16, 3
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S + n)))
    src = src_embeds(cfg, B)
    src = None if src is None else torch.as_tensor(src)
    src_len = SRC_LEN if cfg.enc_dec else 0

    def prefill(tokens):
        return lm.forward_prefill(
            model, tokens, lm.init_cache(cfg, B, S + n, src_len=src_len),
            src_embeds=src)

    with torch.inference_mode():
        lg, cache = prefill(toks[:, :S])
        for k in range(n):
            lg, cache = lm.forward_decode(model, toks[:, S + k:S + k + 1],
                                          cache, S + k)
            want, _ = prefill(toks[:, :S + k + 1])
            np.testing.assert_allclose(lg.numpy(), want.numpy(), atol=TOL,
                                       rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_matches_jax_serve_session(monkeypatch, arch):
    """Both packages' `ServeSession`s in f32 on the same prompts (and
    frames), the port's holding the JAX session's weights: the same
    tokens."""
    cfg, jcfg = configs(arch)
    monkeypatch.setattr(jserve, "get_smoke_config", lambda arch: jcfg)
    jsess = jserve.ServeSession(arch, batch=2)
    sess = lm_serve.ServeSession(arch, batch=2, model=lm.from_reference(
        jsess.params, jsess.meta, cfg))
    assert sess.src_len == jsess.src_len == (16 if cfg.enc_dec else 0)
    prompts = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    src = src_embeds(cfg, 2, frames=16)
    want = jsess.generate(prompts, 8, src_embeds=src)
    got = sess.generate(prompts, 8, src_embeds=src)
    assert got.shape == (2, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_defaults(arch):
    """The SMOKE config in bf16 from `init_model` on the CPU: in-range
    tokens, the same on a second session of the same seed; an
    encoder-decoder session refuses a batch without its frames."""
    sess = lm_serve.ServeSession(arch, device="cpu")
    assert sess.cfg.dtype == "bfloat16" and sess.cfg.name == arch
    prompts = np.random.default_rng(0).integers(0, 256, (4, 10))
    src = src_embeds(sess.cfg, 4, frames=16)
    toks = sess.generate(prompts, 5, src_embeds=src)
    assert toks.shape == (4, 5)
    assert ((toks >= 0) & (toks < sess.cfg.vocab_size)).all()
    np.testing.assert_array_equal(
        toks, lm_serve.ServeSession(arch, device="cpu").generate(
            prompts, 5, src_embeds=src))
    if sess.cfg.enc_dec:
        with pytest.raises(ValueError, match="src_embeds"):
            sess.generate(prompts, 2)
        with pytest.raises(ValueError, match="src_embeds"):
            sess.generate(prompts, 2, src_embeds=src[:, :9])
