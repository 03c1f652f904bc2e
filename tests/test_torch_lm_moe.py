"""The port's MoE, MLA and hybrid language models (Qwen3-MoE-235B-A22B,
DeepSeek-V2-236B, Jamba-v0.1-52B) and their serve sessions against the
JAX package's, on the CPU, at the SMOKE configs (Qwen3: 2 layers of
GQA + MoE; DeepSeek-V2: a dense MLA layer, then 2 MLA + MoE; Jamba: 8
layers, attention at 3, MoE on the odd layers), f32 unless said:

* `numpy_params` builds the JAX `init_model`'s tree (paths, shapes,
  dtypes) and side table, the leading dense layers under "prefix" and a
  period above 1 included; `from_reference` puts every leaf of a JAX
  tree in the port's layer it belongs to;
* prefill logits, greedy tokens and the prefilled caches (k/v,
  ckv/krope, conv/ssd) equal the JAX package's to atol 2e-3 (the JAX
  package's prefill bar, `tests/test_arch_smoke.py`) at the default
  capacity factor, where the routers drop pairs; a Mamba/attention
  stack without FFNs besides;
* in the config's bf16 each layer, fed the same input, agrees with the
  reference's `_apply_layer` to atol 0.1 (ROADMAP C5) plus two bf16
  steps of the value (rtol 2^-6), and the 2- and 3-layer Qwen3 and
  DeepSeek-V2 stacks' logits to atol 0.1, teacher-forced (Jamba's 8
  layers compound the packages' bf16 rounding differences past 0.1 on
  the logits, though each layer alone stays within the bar);
* prefill then decode equals prefill of the longer prompt inside the
  port at a capacity factor of 64 (the contract of
  `tests/test_arch_smoke.py:73`, which sets the same factor so that no
  pair is dropped in either);
* `ServeSession(..., device="cpu")` generates the JAX `ServeSession`'s
  tokens from the same weights;
* the goldens `chip_smoke.py` holds the card to
  (`tests/data/torch_port_{qwen3_moe,deepseek_v2,jamba}_golden.json`:
  published widths, depth and experts cut, f32): `slow` tests
  regenerate them with the JAX package and hold the port on the CPU to
  them (Jamba's f32 weights are ~19 GB: run these alone, not under
  xdist).
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

QWEN, DSV2, JAMBA = ("qwen3-moe-235b-a22b", "deepseek-v2-236b",
                     "jamba-v0.1-52b")
ARCHS = [QWEN, DSV2, JAMBA]
PAR = Parallelism(None)
DATA = Path(__file__).parent / "data"
TOL = 2e-3
BF16_TOL = 0.1
# a Mamba2 SMOKE stack with attention on every other layer, no FFNs
HYBRID = dict(attn_period=2, attn_offset=1, num_heads=2, num_kv_heads=2,
              head_dim=8)
CACHE_KEYS = {"attn": ("k", "v"), "mla": ("ckv", "krope"),
              "mamba": ("conv", "ssd")}


def configs(arch, dtype="float32", *, full=False, **kw):
    """(port config, JAX config) of `arch` in `dtype`, fields replaced by
    `kw` on both."""
    port = get_config(arch) if full else get_smoke_config(arch)
    ref = jget_config(arch) if full else jget_smoke(arch)
    return (dataclasses.replace(port, dtype=dtype, **kw),
            dataclasses.replace(ref, dtype=dtype, **kw))


def smoke_pair(arch, dtype="float32", seed=1, **kw):
    cfg, jcfg = configs(arch, dtype, **kw)
    params, _, meta = jlm.init_model(jcfg, jax.random.key(seed))
    return cfg, jcfg, params, meta, lm.from_reference(params, meta, cfg)


def jax_layer_caches(cache, meta):
    """The JAX package's cache tree as one dict per layer, in layer
    order (prefix layers, then group g of offset o at pre_n + g period +
    o)."""
    md = meta["decoder"]
    pre, p = md["pre_n"], md["period"]
    out = [dict(c) for c in cache["prefix"]]
    for l in range(pre, len(md["sigs"])):
        o, g = (l - pre) % p, (l - pre) // p
        out.append({k: v[g] for k, v in cache["scan"][o].items()})
    return out


def jax_greedy(jcfg, params, meta, prompts, n):
    """The JAX package's prefill + greedy decode: (logits (B, V) per
    step as f32 numpy, tokens (B, n), the prefilled cache per layer)."""
    B, S = prompts.shape
    prefill = jax.jit(lambda p, b, c: jlm.forward_prefill(
        jcfg, p, meta, b, c, PAR))
    decode = jax.jit(lambda p, t, c, k: jlm.forward_decode(
        jcfg, p, meta, t, c, k, PAR))
    cache = jlm.init_cache(jcfg, meta, B, S + n, PAR)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)},
                            cache)
    filled = jax_layer_caches(cache, meta)
    out_l, out_t = [], []
    for i in range(n):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out_l.append(np.asarray(logits[:, -1], np.float32))
        out_t.append(np.asarray(tok[:, 0]))
        if i + 1 < n:
            logits, cache = decode(params, tok, cache, jnp.int32(S + i))
    return out_l, np.stack(out_t, 1), filled


def port_greedy(model, prompts, n):
    """The port's prefill + greedy decode, the outputs of `jax_greedy`
    (the prefilled cache copied before decode writes into it)."""
    B, S = prompts.shape
    tokens = torch.as_tensor(prompts, dtype=torch.int64)
    with torch.inference_mode():
        cache = lm.init_cache(model.cfg, B, S + n)
        logits, cache = lm.forward_prefill(model, tokens, cache)
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


def layer_leaves(layer):
    """{reference tree path: the port layer's tensor} of one layer."""
    out = {"ln1": layer.ln1}
    mixer = "attn" if layer.is_attn else "mamba"
    parts = [(mixer, getattr(layer, mixer))]
    if layer.ffn_kind != "none":
        out["ln2"] = layer.ln2
        parts.append(("ffn", layer.ffn) if layer.has_ffn
                     else ("moe", layer.moe))
    for name, module in parts:
        for k, v in module.named_parameters():
            out[f"{name}.{k}"] = v
    return out


def tree_paths(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="."): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# (arch, layers): the SMOKE depth, and deeper stacks with 2 groups a
# period (Jamba: 16 layers; DeepSeek-V2: the dense layer + 4)
DEPTHS = [(QWEN, None), (DSV2, None), (JAMBA, None), (DSV2, 5),
          (JAMBA, 16)]


@pytest.mark.parametrize("arch,layers", DEPTHS)
def test_numpy_params_match_jax_tree(arch, layers):
    """Leaf for leaf the JAX `init_model`'s tree (structure, shapes,
    dtypes) and side table (plan, period, groups, leading layers)."""
    kw = {} if layers is None else {"num_layers": layers}
    cfg, jcfg = configs(arch, **kw)
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
    assert meta["decoder"]["period"] == lm.period(cfg) == (
        8 if arch == JAMBA else 1)
    assert meta["decoder"]["pre_n"] == (1 if arch == DSV2 else 0)


@pytest.mark.parametrize("arch,layers", DEPTHS)
def test_from_reference_places_every_leaf(arch, layers):
    """Layer l of the port holds prefix layer l (l < pre_n), else group
    (l - pre_n) // period of offset (l - pre_n) % period, leaf for
    leaf; the layer plan is the reference's."""
    kw = {} if layers is None else {"num_layers": layers}
    cfg, _, params, meta, model = smoke_pair(arch, **kw)
    md = meta["decoder"]
    assert len(model.layers) == cfg.num_layers
    dec = params["decoder"]
    for l, layer in enumerate(model.layers):
        if l < md["pre_n"]:
            tree, g = dec["prefix"][l], 0
        else:
            o, g = ((l - md["pre_n"]) % md["period"],
                    (l - md["pre_n"]) // md["period"])
            tree = dec["offsets"][o]
        want = tree_paths(tree)
        got = layer_leaves(layer)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k][g]))
        assert (layer.mixer, layer.ffn_kind, False) == md["sigs"][l]


def test_layer_plans_and_caches():
    """The plans the three configs give, and `init_cache`'s layout for
    each kind of mixer (GQA k/v, MLA ckv/krope, Mamba conv/ssd)."""
    plans = {a: [s[:2] for s in lm.layer_plan(get_smoke_config(a), n, False)]
             for a, n in ((QWEN, 2), (DSV2, 3), (JAMBA, 8))}
    assert plans[QWEN] == [("attn", "moe")] * 2
    assert plans[DSV2] == [("mla", "dense"), ("mla", "moe"), ("mla", "moe")]
    assert plans[JAMBA] == [
        ("attn" if l == 3 else "mamba", "moe" if l % 2 else "dense")
        for l in range(8)]
    for arch, plan in plans.items():
        cfg = get_smoke_config(arch)
        caches = lm.init_cache(cfg, 3, 20)
        for (mixer, _), c in zip(plan, caches):
            assert tuple(c) == CACHE_KEYS[mixer]
            if mixer == "mla":
                assert c["ckv"].shape == (3, 20, cfg.kv_lora_rank)
                assert c["krope"].shape == (3, 20, cfg.rope_head_dim)
                assert c["ckv"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch,kw", [(QWEN, {}), (DSV2, {}), (JAMBA, {}),
                                     ("mamba2-1.3b", HYBRID)])
@pytest.mark.parametrize("S,n", [(16, 6), (37, 4)])
def test_f32_logits_tokens_and_caches_match_jax(arch, kw, S, n):
    cfg, jcfg, params, meta, model = smoke_pair(arch, **kw)
    prompts = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jt, jcache = jax_greedy(jcfg, params, meta, prompts, n)
    pl, pt, pcache = port_greedy(model, prompts, n)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    np.testing.assert_array_equal(pt, jt)
    assert len(pcache) == len(jcache) == cfg.num_layers
    for c, jc in zip(pcache, jcache):
        assert sorted(c) == sorted(jc)
        for k in c:
            np.testing.assert_allclose(c[k].float().numpy(),
                                       np.asarray(jc[k], np.float32),
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layers_within_bar(arch):
    """Prefill in bf16, layer by layer: each of the port's layers and the
    reference's `_apply_layer` (weights cast by `cast_params`) take the
    port's input to that layer; outputs to atol 0.1 + rtol 2^-6."""
    cfg, jcfg, params, meta, model = smoke_pair(arch, "bfloat16", seed=3)
    B, S = 2, 24
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    md = meta["decoder"]
    dec = jlm.cast_params(jcfg, params)["decoder"]
    with torch.inference_mode():
        x = lm.embed_tokens(model, torch.as_tensor(toks))
        for l, layer in enumerate(model.layers):
            if l < md["pre_n"]:
                w = jax.tree.map(lambda t: t[0], dec["prefix"][l])
            else:
                o, g = ((l - md["pre_n"]) % md["period"],
                        (l - md["pre_n"]) // md["period"])
                w = jax.tree.map(lambda t: t[g], dec["offsets"][o])
            want, _ = jlm._apply_layer(
                jcfg, md["sigs"][l], w,
                jnp.asarray(x.float().numpy(), jnp.bfloat16),
                positions=jnp.arange(S)[None], cache=None, kv_len=None,
                par=PAR)
            x, _ = layer(x, positions=torch.arange(S)[None])
            assert x.dtype == torch.bfloat16
            np.testing.assert_allclose(x.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=BF16_TOL, rtol=2 ** -6)


@pytest.mark.parametrize("arch", [QWEN, DSV2])
def test_bf16_logits_within_bar(arch):
    """Teacher-forced: the same tokens go to both, so the histories
    agree; every step's logits within 0.1."""
    cfg, jcfg, params, meta, model = smoke_pair(arch, "bfloat16", seed=3)
    B, S, n = 2, 24, 4
    full = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + n)).astype(np.int32)
    jc = jlm.init_cache(jcfg, meta, B, S + n, PAR)
    jl, jc = jlm.forward_prefill(jcfg, params, meta,
                                 {"tokens": jnp.asarray(full[:, :S])}, jc,
                                 PAR)
    with torch.inference_mode():
        pc = lm.init_cache(cfg, B, S + n)
        pl, pc = lm.forward_prefill(model, torch.as_tensor(full[:, :S]).long(),
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
    the last-token logits of prefilling the longer prompt, at a
    capacity factor of 64 (no pair dropped in either; the reference's
    2e-3 bar, `tests/test_arch_smoke.py:73`)."""
    cfg, _ = configs(arch, moe_capacity_factor=64.0)
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
            np.testing.assert_allclose(lg.numpy(), want.numpy(), atol=TOL,
                                       rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_matches_jax_serve_session(monkeypatch, arch):
    """Both packages' `ServeSession`s in f32 on the same prompts, the
    port's holding the JAX session's weights: the same tokens."""
    cfg, jcfg = configs(arch)
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
def test_serve_session_defaults(arch):
    """The SMOKE config in bf16 from `init_model` on the CPU: in-range
    tokens, the same on a second session of the same seed."""
    sess = lm_serve.ServeSession(arch, device="cpu")
    assert sess.cfg.dtype == "bfloat16" and sess.cfg.name == arch
    prompts = np.random.default_rng(0).integers(0, 256, (4, 10))
    toks = sess.generate(prompts, 5)
    assert toks.shape == (4, 5)
    assert ((toks >= 0) & (toks < sess.cfg.vocab_size)).all()
    np.testing.assert_array_equal(
        toks, lm_serve.ServeSession(arch, device="cpu").generate(prompts, 5))


# ---- the full-width goldens -------------------------------------------

# per arch: golden file, name, the cuts of the published config (depth to
# one period plus the leading dense layers, routed experts so that the
# JAX package's f32 run fits the CPU's memory) and the cache norms kept
GOLDENS = {
    QWEN: ("torch_port_qwen3_moe_golden.json", "Qwen3-MoE-235B-A22B",
           {"num_layers": 2, "num_experts": 16},
           {"k_cache_norm": "k", "v_cache_norm": "v"}),
    DSV2: ("torch_port_deepseek_v2_golden.json", "DeepSeek-V2-236B",
           {"num_layers": 2, "num_experts": 16},
           {"ckv_cache_norm": "ckv", "krope_cache_norm": "krope"}),
    JAMBA: ("torch_port_jamba_golden.json", "Jamba-v0.1-52B",
            {"num_layers": 8, "num_experts": 4},
            {"k_cache_norm": "k", "v_cache_norm": "v",
             "ssd_state_norm": "ssd"}),
}


def cache_norms(caches, norms):
    """{golden field: the f64 norms of `key` over the layers that have
    it, in layer order} of per-layer cache dicts (numpy or torch)."""
    out = {}
    for field, key in norms.items():
        out[field] = [float(np.linalg.norm(np.asarray(
            c[key].double() if torch.is_tensor(c[key]) else c[key],
            np.float64))) for c in caches if key in c]
    return out


@pytest.mark.slow
@pytest.mark.parametrize("arch", ARCHS)
def test_port_reproduces_golden_on_cpu(arch):
    """Published widths, depth and experts cut as the golden says, f32:
    the port on the CPU against the JAX package's numbers (top-8 logits
    at 2e-3, tokens equal, per-layer cache norms to rtol 1e-4)."""
    name, _, _, norms = GOLDENS[arch]
    gold = json.loads((DATA / name).read_text())
    cfg, _ = configs(arch, full=True, **gold["config_cuts"])
    params, meta = lm.numpy_params(cfg, seed=gold["weights_seed"])
    model = lm.from_reference(params, meta, cfg)
    del params
    prompts = np.asarray(gold["prompts"], np.int64)
    pl, pt, cache = port_greedy(model, prompts, len(gold["tokens"][0]))
    idx = np.asarray(gold["top8_index"])
    np.testing.assert_allclose(np.take_along_axis(pl[0], idx, 1),
                               gold["top8_value"], atol=TOL, rtol=0)
    np.testing.assert_array_equal(pt, gold["tokens"])
    for field, got in cache_norms(cache, norms).items():
        np.testing.assert_allclose(got, gold[field], rtol=1e-4)


def regenerate_golden(arch, test_name):
    """Recompute a full-width reference with the JAX package on the CPU:
    `arch` at its published widths, cut as `GOLDENS` says, f32, weights
    from `numpy_params(cfg, seed=0)` (handed to jax leaf by leaf, so
    that the numpy copy is freed as it goes); 2 prompts of 300 tokens, 8
    greedy tokens."""
    name, title, cuts, norms = GOLDENS[arch]
    seed, n_tok = 0, 8
    cfg, jcfg = configs(arch, full=True, **cuts)
    params, meta = lm.numpy_params(cfg, seed=seed)

    def to_jax(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                to_jax(v)
            elif isinstance(v, list):
                for sub in v:
                    to_jax(sub)
            else:
                tree[k] = jnp.asarray(v)

    to_jax(params)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32)
    logits, tokens, cache = jax_greedy(jcfg, params, meta, prompts, n_tok)
    first = logits[0]
    top = np.argsort(-first, axis=1, kind="stable")[:, :8]
    top2 = [np.sort(lg, axis=1)[:, -2:] for lg in logits]
    gold = {
        "what": f"the JAX package's prefill and greedy decode of {title} "
                f"at its published widths, depth and routed experts cut, "
                f"f32: the reference for chip_smoke.py's full-width "
                f"whole-path parity check",
        "call": f"repro.models.lm.forward_prefill / forward_decode (CPU) on "
                f"repro_torch.models.lm.numpy_params(cfg, seed=0), cfg = "
                f"{cfg.name} CONFIG with {cuts}, dtype='float32'",
        "platform": "cpu",
        "jax": jax.__version__,
        "regenerate": f"PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q "
                      f"-m slow tests/test_torch_lm_moe.py -k {test_name}",
        "config_cuts": cuts,
        "num_layers": cuts["num_layers"],
        "num_experts": cuts["num_experts"],
        "num_experts_per_tok": cfg.num_experts_per_tok,
        "moe_capacity_factor": cfg.moe_capacity_factor,
        "weights_seed": seed,
        "prompts": prompts.tolist(),
        "top8_index": top.tolist(),
        "top8_value": np.take_along_axis(first, top, 1).tolist(),
        "logits_norm": np.linalg.norm(first.astype(np.float64),
                                      axis=1).tolist(),
        "tokens": tokens.tolist(),
        "top2_gap": np.stack([t[:, 1] - t[:, 0] for t in top2], 1).tolist(),
        **cache_norms(cache, norms),
    }
    (DATA / name).write_text(json.dumps(gold) + "\n")


@pytest.mark.slow
def test_regenerate_qwen3_moe_golden():
    regenerate_golden(QWEN, "qwen3_moe_golden")


@pytest.mark.slow
def test_regenerate_deepseek_v2_golden():
    regenerate_golden(DSV2, "deepseek_v2_golden")


@pytest.mark.slow
def test_regenerate_jamba_golden():
    regenerate_golden(JAMBA, "jamba_golden")
