"""The port's Mamba-2 language model and serve session against the JAX
package's, on the CPU.

* `from_reference` loads the JAX `SMOKE` Mamba2 parameters leaf for
  leaf, and `numpy_params` builds the JAX tree's structure and shapes;
* in f32 the port's prefill and decode logits agree with the JAX
  package's to atol 1e-4 (the JAX package's own prefill bar is 2e-3) and
  greedy tokens are equal; in the config's bf16 the logits agree to
  atol 0.1 (bf16 keeps 8 significant bits: one rounding step of a logit
  of magnitude 2-4 is 1/64, and the two packages round the matmuls'
  and norms' outputs at different places), tokens unchecked;
* prefill then decode equals prefill of the longer prompt inside the
  port (the contract of `tests/test_arch_smoke.py:72`);
* `ServeSession(..., device="cpu")` generates the JAX `ServeSession`'s
  tokens from the same converted weights;
* architectures the port does not run raise `NotImplementedError`;
* the port on the CPU reproduces `tests/data/torch_port_mamba2_golden.
  json`, the full-width reference `chip_smoke.py` holds the card to; a
  `slow` test regenerates it with the JAX package.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import lm_serve as jserve
from repro.models import lm as jlm
from repro.models.common import Parallelism
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import lm_serve
from repro_torch.models import lm

ARCH = "mamba2-1.3b"
PAR = Parallelism(None)
GOLDEN = Path(__file__).parent / "data" / "torch_port_mamba2_golden.json"
F32_TOL = 1e-4
BF16_TOL = 0.1


def configs(dtype, *, full=False, layers=None):
    """(port config, JAX config) of the Mamba2 arch in `dtype`."""
    port = get_config(ARCH) if full else get_smoke_config(ARCH)
    ref = jget_config(ARCH) if full else jget_smoke(ARCH)
    kw = {"dtype": dtype}
    if layers is not None:
        kw["num_layers"] = layers
    return dataclasses.replace(port, **kw), dataclasses.replace(ref, **kw)


def jax_greedy(jcfg, params, meta, prompts, n):
    """The JAX package's prefill + greedy decode: (logits (B, V) per
    step as f32 numpy, tokens (B, n), the prefilled cache)."""
    B, S = prompts.shape
    prefill = jax.jit(lambda p, b, c: jlm.forward_prefill(
        jcfg, p, meta, b, c, PAR))
    decode = jax.jit(lambda p, t, c, k: jlm.forward_decode(
        jcfg, p, meta, t, c, k, PAR))
    cache = jlm.init_cache(jcfg, meta, B, S + n, PAR)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)},
                            cache)
    filled = cache
    out_l, out_t = [], []
    for i in range(n):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out_l.append(np.asarray(logits[:, -1], np.float32))
        out_t.append(np.asarray(tok[:, 0]))
        if i + 1 < n:
            logits, cache = decode(params, tok, cache, jnp.int32(S + i))
    return out_l, np.stack(out_t, 1), filled


def port_greedy(model, prompts, n, *, force=None):
    """The port's prefill + greedy decode, same outputs as `jax_greedy`
    (the cache as the port's list of per-layer dicts)."""
    B = prompts.shape[0]
    tokens = torch.as_tensor(prompts, dtype=torch.int64)
    with torch.inference_mode():
        cache = lm.init_cache(model.cfg, B)
        logits, cache = lm.forward_prefill(model, tokens, cache,
                                           force=force)
        filled = cache
        out_l, out_t = [], []
        for i in range(n):
            tok = logits[:, -1].argmax(-1)
            out_l.append(logits[:, -1].float().numpy())
            out_t.append(tok.numpy())
            if i + 1 < n:
                logits, cache = lm.forward_decode(model, tok[:, None],
                                                  cache)
    return out_l, np.stack(out_t, 1), filled


def smoke_pair(dtype, seed=1):
    cfg, jcfg = configs(dtype)
    params, _, meta = jlm.init_model(jcfg, jax.random.key(seed))
    return cfg, jcfg, params, meta, lm.from_reference(params, meta, cfg)


def test_from_reference_loads_jax_smoke_params():
    cfg, _, params, meta, model = smoke_pair("float32")
    off = params["decoder"]["offsets"][0]
    np.testing.assert_array_equal(model.embed.numpy(), params["embed"])
    np.testing.assert_array_equal(model.head.numpy(), params["head"])
    np.testing.assert_array_equal(model.ln_f.numpy(), params["ln_f"])
    assert len(model.layers) == cfg.num_layers == meta["decoder"]["groups"]
    for l, layer in enumerate(model.layers):
        np.testing.assert_array_equal(layer.ln1.numpy(), off["ln1"][l])
        for k, v in off["mamba"].items():
            np.testing.assert_array_equal(
                getattr(layer.mamba, k).numpy(), np.asarray(v[l]))
    cfg16, _ = configs("bfloat16")
    assert lm.from_reference(params, meta, cfg16).embed.dtype \
        == torch.bfloat16


@pytest.mark.parametrize("full", [False, True])
def test_numpy_params_match_jax_tree(full):
    """Leaf for leaf the JAX `init_model`'s tree (structure, shapes,
    dtypes) and side table; the full width at 2 layers."""
    cfg, jcfg = configs("float32", full=full, layers=2 if full else None)
    box = {}

    def init(key):
        p, _, box["meta"] = jlm.init_model(jcfg, key)
        return p

    want = jax.eval_shape(init, jax.random.key(0))
    got, meta = lm.numpy_params(cfg, seed=0)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert meta == box["meta"]


@pytest.mark.parametrize("S,n", [(16, 6), (37, 4)])
def test_f32_logits_and_tokens_match_jax(S, n):
    cfg, jcfg, params, meta, model = smoke_pair("float32")
    prompts = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jt, jcache = jax_greedy(jcfg, params, meta, prompts, n)
    pl, pt, pcache = port_greedy(model, prompts, n)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)
    np.testing.assert_array_equal(pt, jt)
    for l, c in enumerate(pcache):
        for k in ("conv", "ssd"):
            np.testing.assert_allclose(
                c[k].float().numpy(),
                np.asarray(jcache["scan"][0][k][l], np.float32),
                atol=F32_TOL, rtol=0)


def test_bf16_logits_within_bar():
    cfg, jcfg, params, meta, model = smoke_pair("bfloat16")
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    # teacher-forced: the same tokens go to both, so histories agree
    n = 4
    B, S = prompts.shape
    full = np.concatenate([prompts, np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)], 1)
    jc = jlm.init_cache(jcfg, meta, B, S + n, PAR)
    jl, jc = jlm.forward_prefill(jcfg, params, meta,
                                 {"tokens": jnp.asarray(prompts)}, jc, PAR)
    with torch.inference_mode():
        pc = lm.init_cache(cfg, B)
        pl, pc = lm.forward_prefill(model, torch.as_tensor(prompts).long(),
                                    pc)
        assert pl.dtype == torch.bfloat16
        for i in range(n + 1):
            np.testing.assert_allclose(pl.float().numpy(),
                                       np.asarray(jl, np.float32),
                                       atol=BF16_TOL, rtol=0)
            if i == n:
                break
            tok = full[:, S + i:S + i + 1]
            jl, jc = jlm.forward_decode(jcfg, params, meta,
                                        jnp.asarray(tok), jc,
                                        jnp.int32(S + i), PAR)
            pl, pc = lm.forward_decode(model, torch.as_tensor(tok).long(),
                                       pc)


def test_prefill_decode_consistency():
    """Prefill of S tokens, then decode of tokens S.. one by one, gives
    the last-token logits of prefilling the longer prompt (the
    reference's 2e-3 bar, `tests/test_arch_smoke.py:72`)."""
    cfg, _ = configs("float32")
    model = lm.init_model(cfg, seed=1)
    B, S, n = 2, 16, 3
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S + n)))
    with torch.inference_mode():
        lg, cache = lm.forward_prefill(model, toks[:, :S],
                                       lm.init_cache(cfg, B))
        for k in range(n):
            lg, cache = lm.forward_decode(model, toks[:, S + k:S + k + 1],
                                          cache)
            want, _ = lm.forward_prefill(model, toks[:, :S + k + 1],
                                         lm.init_cache(cfg, B))
            np.testing.assert_allclose(lg.numpy(), want.numpy(), atol=2e-3)


def test_serve_session_matches_jax_serve_session(monkeypatch):
    """Both packages' `ServeSession`s in f32 on the same prompts, the
    port's holding the JAX session's weights: the same tokens."""
    _, jcfg = configs("float32")
    monkeypatch.setattr(jserve, "get_smoke_config", lambda arch: jcfg)
    jsess = jserve.ServeSession(ARCH, batch=2)
    sess = lm_serve.ServeSession(ARCH, batch=2, model=lm.from_reference(
        jsess.params, jsess.meta, configs("float32")[0]))
    prompts = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want = jsess.generate(prompts, 8)
    got = sess.generate(prompts, 8)
    assert got.shape == (2, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_serve_session_serves_a_given_model():
    """`ServeSession(model=...)` streams the model functions' greedy
    logits and tokens from a prompt tensor, on the model's device, and
    refuses a model of another arch."""
    cfg, _ = configs("float32")
    model = lm.from_reference(*lm.numpy_params(cfg, seed=3), cfg)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 17))
    want_l, want_t, _ = port_greedy(model, prompts, 6)
    sess = lm_serve.ServeSession(ARCH, batch=3, max_len=23, model=model)
    assert sess.device == torch.device("cpu") and sess.cfg is cfg
    out = list(sess.stream(torch.as_tensor(prompts), 6))
    np.testing.assert_array_equal(
        torch.stack([t for t, _ in out], 1).numpy(), want_t)
    for (_, got), want in zip(out, want_l):
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="starcoder2-3b"):
        lm_serve.ServeSession("starcoder2-3b", model=model)


def test_serve_session_defaults_and_limits():
    sess = lm_serve.ServeSession(ARCH, device="cpu")
    assert sess.cfg.dtype == "bfloat16" and sess.batch == 4
    assert sess.model.embed.dtype == torch.bfloat16
    prompts = np.zeros((4, 10), np.int64)
    toks = sess.generate(prompts, 5)
    assert toks.shape == (4, 5)
    assert ((toks >= 0) & (toks < sess.cfg.vocab_size)).all()
    np.testing.assert_array_equal(
        toks, lm_serve.ServeSession(ARCH, device="cpu").generate(prompts, 5))
    with pytest.raises(ValueError, match="batch"):
        sess.generate(np.zeros((3, 10), np.int64), 2)
    with pytest.raises(ValueError, match="max_len"):
        sess.generate(np.zeros((4, 120), np.int64), 9)


@pytest.mark.parametrize("make", [
    lambda: lm_serve.ServeSession("starcoder2-3b", device="cpu"),
    lambda: get_smoke_config("jamba-v0.1-52b"),
    lambda: lm.init_model(dataclasses.replace(
        get_smoke_config(ARCH), attn_period=2, num_heads=2, num_kv_heads=2,
        head_dim=8)),
    lambda: lm.numpy_params(dataclasses.replace(
        get_smoke_config(ARCH), d_ff=32)),
])
def test_unported_architectures_raise(make):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item"):
        make()


def golden_model(gold, device="cpu"):
    cfg, _ = configs("float32", full=True, layers=gold["num_layers"])
    params, meta = lm.numpy_params(cfg, seed=gold["weights_seed"])
    return cfg, params, meta, lm.from_reference(params, meta, cfg,
                                                device=device)


def test_port_reproduces_mamba2_golden_on_cpu():
    """Full width, 2 layers, f32: the port on the CPU against the JAX
    package's numbers in the golden (logits at the JAX prefill bar 2e-3,
    tokens equal, per-layer SSD state norms to rtol 1e-4)."""
    gold = json.loads(GOLDEN.read_text())
    _, _, _, model = golden_model(gold)
    prompts = np.asarray(gold["prompts"], np.int64)
    pl, pt, cache = port_greedy(model, prompts, len(gold["tokens"][0]))
    idx = np.asarray(gold["top8_index"])
    np.testing.assert_allclose(np.take_along_axis(pl[0], idx, 1),
                               gold["top8_value"], atol=2e-3, rtol=0)
    np.testing.assert_allclose(
        np.linalg.norm(pl[0].astype(np.float64), axis=1),
        gold["logits_norm"], rtol=1e-4)
    np.testing.assert_array_equal(pt, gold["tokens"])
    # norms summed in f64: an f32 sum over 1 M entries alone drifts ~5e-5
    np.testing.assert_allclose(
        [float(c["ssd"].double().norm()) for c in cache],
        gold["ssd_state_norm"], rtol=1e-4)


@pytest.mark.slow
def test_regenerate_mamba2_golden():
    """Recompute the full-width reference with the JAX package on the
    CPU: Mamba2-1.3B at its published width, depth cut to 2 layers, f32,
    weights from `numpy_params(cfg, seed=0)`; 2 prompts of 300 tokens,
    8 greedy tokens."""
    n_layers, seed, n_tok = 2, 0, 8
    cfg, jcfg = configs("float32", full=True, layers=n_layers)
    params, meta = lm.numpy_params(cfg, seed=seed)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32)
    logits, tokens, cache = jax_greedy(
        jcfg, jax.tree.map(jnp.asarray, params), meta, prompts, n_tok)
    first = logits[0]
    top = np.argsort(-first, axis=1, kind="stable")[:, :8]
    top2 = [np.sort(lg, axis=1)[:, -2:] for lg in logits]
    gaps = [t[:, 1] - t[:, 0] for t in top2]
    ssd = np.asarray(cache["scan"][0]["ssd"])
    gold = {
        "what": "the JAX package's prefill and greedy decode of Mamba2-1.3B "
                "at full width, depth cut, f32: the reference for "
                "chip_smoke.py's full-width whole-path parity check",
        "call": "repro.models.lm.forward_prefill / forward_decode (CPU) on "
                "repro_torch.models.lm.numpy_params(cfg, seed=0), cfg = "
                "mamba2-1.3b CONFIG with num_layers=2, dtype='float32'",
        "platform": "cpu",
        "jax": jax.__version__,
        "regenerate": "PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q "
                      "-m slow tests/test_torch_lm.py -k mamba2_golden",
        "num_layers": n_layers,
        "weights_seed": seed,
        "prompts": prompts.tolist(),
        "top8_index": top.tolist(),
        "top8_value": np.take_along_axis(first, top, 1).tolist(),
        "logits_norm": np.linalg.norm(first.astype(np.float64),
                                      axis=1).tolist(),
        "tokens": tokens.tolist(),
        "top2_gap": np.stack(gaps, 1).tolist(),
        "ssd_state_norm": [float(np.linalg.norm(ssd[l].astype(np.float64)))
                           for l in range(n_layers)],
    }
    GOLDEN.write_text(json.dumps(gold) + "\n")
