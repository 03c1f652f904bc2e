"""The port's language models (Mamba2-1.3B, StarCoder2-3B) and serve
session against the JAX package's, on the CPU. Every check that is not
about one mixer runs for both architectures (`ARCHS`).

* `from_reference` loads the JAX `SMOKE` parameters leaf for leaf, and
  `numpy_params` builds the JAX tree's structure and shapes;
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
* the constructors that raised before the other dense and
  encoder-decoder models were ported build what they name;
* the port on the CPU reproduces `tests/data/torch_port_mamba2_golden.
  json` and `torch_port_starcoder2_golden.json`, the full-width
  references `chip_smoke.py` holds the card to; `slow` tests regenerate
  them with the JAX package;
* StarCoder2-3B at full width (head_dim 128), 2 layers, in bf16 within
  the bf16 bar of the JAX package's logits (`slow`, ROADMAP C6).
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
ATTN_ARCH = "starcoder2-3b"
ARCHS = [ARCH, ATTN_ARCH]
PAR = Parallelism(None)
DATA = Path(__file__).parent / "data"
GOLDEN = DATA / "torch_port_mamba2_golden.json"
ATTN_GOLDEN = DATA / "torch_port_starcoder2_golden.json"
F32_TOL = 1e-4
BF16_TOL = 0.1


def configs(dtype, *, full=False, layers=None, arch=ARCH):
    """(port config, JAX config) of `arch` in `dtype`."""
    port = get_config(arch) if full else get_smoke_config(arch)
    ref = jget_config(arch) if full else jget_smoke(arch)
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
    (the prefilled cache as the port's list of per-layer dicts, copied
    before decode writes into the attention caches)."""
    B, S = prompts.shape
    tokens = torch.as_tensor(prompts, dtype=torch.int64)
    with torch.inference_mode():
        cache = lm.init_cache(model.cfg, B, S + n)
        logits, cache = lm.forward_prefill(model, tokens, cache,
                                           force=force)
        filled = [{k: t.clone() for k, t in c.items()} for c in cache]
        out_l, out_t = [], []
        for i in range(n):
            tok = logits[:, -1].argmax(-1)
            out_l.append(logits[:, -1].float().numpy())
            out_t.append(tok.numpy())
            if i + 1 < n:
                logits, cache = lm.forward_decode(model, tok[:, None],
                                                  cache, S + i)
    return out_l, np.stack(out_t, 1), filled


def cache_keys(arch):
    return ("k", "v") if arch == ATTN_ARCH else ("conv", "ssd")


def layer_leaves(layer):
    """{reference tree path: the port layer's tensor} of one layer."""
    out = {"ln1": layer.ln1}
    mixer = "attn" if layer.is_attn else "mamba"
    for k, v in getattr(layer, mixer).named_parameters():
        out[f"{mixer}.{k}"] = v
    if layer.has_ffn:
        out["ln2"] = layer.ln2
        for k, v in layer.ffn.named_parameters():
            out[f"ffn.{k}"] = v
    return out


def smoke_pair(dtype, seed=1, arch=ARCH):
    cfg, jcfg = configs(dtype, arch=arch)
    params, _, meta = jlm.init_model(jcfg, jax.random.key(seed))
    return cfg, jcfg, params, meta, lm.from_reference(params, meta, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_loads_jax_smoke_params(arch):
    cfg, _, params, meta, model = smoke_pair("float32", arch=arch)
    off = params["decoder"]["offsets"][0]
    np.testing.assert_array_equal(model.embed.numpy(), params["embed"])
    np.testing.assert_array_equal(model.head.numpy(), params["head"])
    np.testing.assert_array_equal(model.ln_f.numpy(), params["ln_f"])
    assert len(model.layers) == cfg.num_layers == meta["decoder"]["groups"]
    want = {jax.tree_util.keystr(path, simple=True, separator="."): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(off)}
    for l, layer in enumerate(model.layers):
        got = layer_leaves(layer)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k][l]))
    cfg16, _ = configs("bfloat16", arch=arch)
    assert lm.from_reference(params, meta, cfg16).embed.dtype \
        == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_numpy_params_match_jax_tree(full, arch):
    """Leaf for leaf the JAX `init_model`'s tree (structure, shapes,
    dtypes) and side table; the full width at 2 layers."""
    cfg, jcfg = configs("float32", full=full, layers=2 if full else None,
                        arch=arch)
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,n", [(16, 6), (37, 4)])
def test_f32_logits_and_tokens_match_jax(S, n, arch):
    cfg, jcfg, params, meta, model = smoke_pair("float32", arch=arch)
    prompts = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jt, jcache = jax_greedy(jcfg, params, meta, prompts, n)
    pl, pt, pcache = port_greedy(model, prompts, n)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)
    np.testing.assert_array_equal(pt, jt)
    for l, c in enumerate(pcache):
        for k in cache_keys(arch):
            np.testing.assert_allclose(
                c[k].float().numpy(),
                np.asarray(jcache["scan"][0][k][l], np.float32),
                atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_bar(arch):
    cfg, jcfg, params, meta, model = smoke_pair("bfloat16", arch=arch)
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
        pc = lm.init_cache(cfg, B, S + n)
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
                                       pc, S + i)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Prefill of S tokens, then decode of tokens S.. one by one, gives
    the last-token logits of prefilling the longer prompt (the
    reference's 2e-3 bar, `tests/test_arch_smoke.py:72`)."""
    cfg, _ = configs("float32", arch=arch)
    model = lm.init_model(cfg, seed=1)
    B, S, n = 2, 16, 3
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S + n)))
    with torch.inference_mode():
        lg, cache = lm.forward_prefill(model, toks[:, :S],
                                       lm.init_cache(cfg, B, S + n))
        for k in range(n):
            lg, cache = lm.forward_decode(model, toks[:, S + k:S + k + 1],
                                          cache, S + k)
            want, _ = lm.forward_prefill(model, toks[:, :S + k + 1],
                                         lm.init_cache(cfg, B, S + n))
            np.testing.assert_allclose(lg.numpy(), want.numpy(), atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_matches_jax_serve_session(monkeypatch, arch):
    """Both packages' `ServeSession`s in f32 on the same prompts, the
    port's holding the JAX session's weights: the same tokens."""
    cfg, jcfg = configs("float32", arch=arch)
    monkeypatch.setattr(jserve, "get_smoke_config", lambda arch: jcfg)
    jsess = jserve.ServeSession(arch, batch=2)
    sess = lm_serve.ServeSession(arch, batch=2, model=lm.from_reference(
        jsess.params, jsess.meta, cfg))
    prompts = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want = jsess.generate(prompts, 8)
    got = sess.generate(prompts, 8)
    assert got.shape == (2, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_serves_a_given_model(arch):
    """`ServeSession(model=...)` streams the model functions' greedy
    logits and tokens from a prompt tensor, on the model's device, and
    refuses a model of another arch."""
    cfg, _ = configs("float32", arch=arch)
    model = lm.from_reference(*lm.numpy_params(cfg, seed=3), cfg)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 17))
    want_l, want_t, _ = port_greedy(model, prompts, 6)
    sess = lm_serve.ServeSession(arch, batch=3, max_len=23, model=model)
    assert sess.device == torch.device("cpu") and sess.cfg is cfg
    out = list(sess.stream(torch.as_tensor(prompts), 6))
    np.testing.assert_array_equal(
        torch.stack([t for t, _ in out], 1).numpy(), want_t)
    for (_, got), want in zip(out, want_l):
        np.testing.assert_array_equal(got.numpy(), want)
    other = ATTN_ARCH if arch == ARCH else ARCH
    with pytest.raises(ValueError, match=other):
        lm_serve.ServeSession(other, model=model)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_defaults_and_limits(arch):
    sess = lm_serve.ServeSession(arch, device="cpu")
    assert sess.cfg.dtype == "bfloat16" and sess.batch == 4
    assert sess.model.embed.dtype == torch.bfloat16
    prompts = np.zeros((4, 10), np.int64)
    toks = sess.generate(prompts, 5)
    assert toks.shape == (4, 5)
    assert ((toks >= 0) & (toks < sess.cfg.vocab_size)).all()
    np.testing.assert_array_equal(
        toks, lm_serve.ServeSession(arch, device="cpu").generate(prompts, 5))
    with pytest.raises(ValueError, match="batch"):
        sess.generate(np.zeros((3, 10), np.int64), 2)
    with pytest.raises(ValueError, match="max_len"):
        sess.generate(np.zeros((4, 120), np.int64), 9)


def _enc_dec(arch):
    """`arch`'s SMOKE config made an encoder-decoder of 2 + 2 layers."""
    return dataclasses.replace(get_smoke_config(arch), enc_dec=True,
                               enc_layers=2)


def _has_encoder_and_cross(model):
    return (len(model.encoder) == 2 and all(
        layer.has_cross for layer in model.layers))


@pytest.mark.parametrize("make,check", [
    (lambda: lm_serve.ServeSession("gemma-7b", device="cpu"),
     lambda s: s.cfg.name == "gemma-7b" and s.model.head is None
     and s.cfg.head_dim == 32 and len(s.model.layers) == 2),
    (lambda: get_smoke_config("seamless-m4t-medium"),
     lambda c: c.enc_dec and c.enc_layers == 2 and c.num_layers == 2),
    (lambda: lm.init_model(_enc_dec(ARCH)), _has_encoder_and_cross),
    (lambda: get_config("deepseek-7b"),
     lambda c: (c.num_layers, c.num_heads, c.num_kv_heads) == (30, 32, 32)),
    (lambda: get_config("gemma-7b"),
     lambda c: c.head_dim == 256 and c.tie_embeddings and c.scale_embed),
    (lambda: lm.from_reference(*lm.numpy_params(_enc_dec(ATTN_ARCH)),
                               _enc_dec(ATTN_ARCH)), _has_encoder_and_cross),
    (lambda: lm.numpy_params(_enc_dec(ATTN_ARCH)),
     lambda pm: {"encoder", "decoder", "ln_enc"} <= set(pm[0])
     and "cross" in pm[0]["decoder"]["offsets"][0]
     and pm[1]["decoder"]["sigs"] == [("attn", "dense", True)] * 2
     and pm[1]["encoder"]["sigs"] == [("attn", "dense", False)] * 2),
])
def test_unported_architectures_raise(make, check):
    """The constructors that raised before the catalog's other dense and
    encoder-decoder models were ported (ROADMAP queue A item 11f) now
    build what they name."""
    assert check(make())


def golden_model(gold, device="cpu", arch=ARCH):
    cfg, _ = configs("float32", full=True, layers=gold["num_layers"],
                     arch=arch)
    params, meta = lm.numpy_params(cfg, seed=gold["weights_seed"])
    return cfg, params, meta, lm.from_reference(params, meta, cfg,
                                                device=device)


NAMES = {ARCH: "Mamba2-1.3B", ATTN_ARCH: "StarCoder2-3B"}
# norms summed in f64: an f32 sum over 1 M entries alone drifts ~5e-5
CACHE_NORMS = {ARCH: {"ssd_state_norm": "ssd"},
               ATTN_ARCH: {"k_cache_norm": "k", "v_cache_norm": "v"}}


def check_golden(arch, path):
    """Full width, 2 layers, f32: the port on the CPU against the JAX
    package's numbers in the golden at `path` (logits at the JAX prefill
    bar 2e-3, tokens equal, per-layer cache norms to rtol 1e-4)."""
    gold = json.loads(path.read_text())
    model = golden_model(gold, arch=arch)[3]
    prompts = np.asarray(gold["prompts"], np.int64)
    pl, pt, cache = port_greedy(model, prompts, len(gold["tokens"][0]))
    idx = np.asarray(gold["top8_index"])
    np.testing.assert_allclose(np.take_along_axis(pl[0], idx, 1),
                               gold["top8_value"], atol=2e-3, rtol=0)
    np.testing.assert_allclose(
        np.linalg.norm(pl[0].astype(np.float64), axis=1),
        gold["logits_norm"], rtol=1e-4)
    np.testing.assert_array_equal(pt, gold["tokens"])
    for field, key in CACHE_NORMS[arch].items():
        np.testing.assert_allclose(
            [float(c[key].double().norm()) for c in cache], gold[field],
            rtol=1e-4)


@pytest.mark.slow
def test_starcoder2_full_width_bf16_within_bar():
    """ROADMAP C6: where attention scales. `jnp_flash` multiplies q by
    D^-1/2 in q's dtype, the port scales the f32 scores; at the SMOKE
    head_dim 16 the scale is exact, so this runs StarCoder2-3B at full
    width (head_dim 128), 2 layers, bf16, weights `numpy_params(cfg,
    seed=0)`, 2 prompts of 40 tokens and 4 greedy tokens: logits within
    C5's bf16 bar (measured 0.03125, one bf16 step) and tokens equal."""
    cfg, jcfg = configs("bfloat16", full=True, layers=2, arch=ATTN_ARCH)
    params, meta = lm.numpy_params(cfg, seed=0)
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jt, _ = jax_greedy(jcfg, jax.tree.map(jnp.asarray, params), meta,
                           prompts, 4)
    pl, pt, _ = port_greedy(lm.from_reference(params, meta, cfg), prompts,
                            4)
    for got, want in zip(pl, jl):
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)
    np.testing.assert_array_equal(pt, jt)


def test_port_reproduces_mamba2_golden_on_cpu():
    check_golden(ARCH, GOLDEN)


def test_port_reproduces_starcoder2_golden_on_cpu():
    check_golden(ATTN_ARCH, ATTN_GOLDEN)


def regenerate_golden(arch, path, test_name):
    """Recompute a full-width reference with the JAX package on the CPU:
    `arch` at its published width, depth cut to 2 layers, f32, weights
    from `numpy_params(cfg, seed=0)`; 2 prompts of 300 tokens, 8 greedy
    tokens."""
    n_layers, seed, n_tok = 2, 0, 8
    cfg, jcfg = configs("float32", full=True, layers=n_layers, arch=arch)
    params, meta = lm.numpy_params(cfg, seed=seed)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32)
    logits, tokens, cache = jax_greedy(
        jcfg, jax.tree.map(jnp.asarray, params), meta, prompts, n_tok)
    first = logits[0]
    top = np.argsort(-first, axis=1, kind="stable")[:, :8]
    top2 = [np.sort(lg, axis=1)[:, -2:] for lg in logits]
    gaps = [t[:, 1] - t[:, 0] for t in top2]
    gold = {
        "what": f"the JAX package's prefill and greedy decode of "
                f"{NAMES[arch]} at full width, depth cut, f32: the reference "
                f"for chip_smoke.py's full-width whole-path parity check",
        "call": f"repro.models.lm.forward_prefill / forward_decode (CPU) on "
                f"repro_torch.models.lm.numpy_params(cfg, seed=0), cfg = "
                f"{cfg.name} CONFIG with num_layers=2, dtype='float32'",
        "platform": "cpu",
        "jax": jax.__version__,
        "regenerate": f"PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q "
                      f"-m slow tests/test_torch_lm.py -k {test_name}",
        "num_layers": n_layers,
        "weights_seed": seed,
        "prompts": prompts.tolist(),
        "top8_index": top.tolist(),
        "top8_value": np.take_along_axis(first, top, 1).tolist(),
        "logits_norm": np.linalg.norm(first.astype(np.float64),
                                      axis=1).tolist(),
        "tokens": tokens.tolist(),
        "top2_gap": np.stack(gaps, 1).tolist(),
    }
    for field, key in CACHE_NORMS[arch].items():
        c = np.asarray(cache["scan"][0][key])
        gold[field] = [float(np.linalg.norm(c[l].astype(np.float64)))
                       for l in range(n_layers)]
    path.write_text(json.dumps(gold) + "\n")


@pytest.mark.slow
def test_regenerate_mamba2_golden():
    regenerate_golden(ARCH, GOLDEN, "mamba2_golden")


@pytest.mark.slow
def test_regenerate_starcoder2_golden():
    regenerate_golden(ATTN_ARCH, ATTN_GOLDEN, "starcoder2_golden")
