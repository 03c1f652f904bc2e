"""The port's other dense models and its encoder-decoder model (Gemma-7B,
DeepSeek-7B, DeepSeek-Coder-33B, Chameleon-34B, SeamlessM4T-medium) and
their serve sessions against the JAX package's, on the CPU, at the SMOKE
configs, f32 unless said:

* `numpy_params` builds the JAX `init_model`'s tree (paths, shapes,
  dtypes) and side table, SeamlessM4T's "encoder" and "ln_enc" and its
  decoder layers' "ln_cross" and "cross" included; `from_reference`
  puts every leaf of a JAX tree in the port's layer it belongs to;
* prefill and decode logits within 2e-3 (the JAX package's prefill bar,
  `tests/test_arch_smoke.py`), greedy tokens equal and the prefilled
  caches (k/v; SeamlessM4T's cross_k/cross_v) within 2e-3; SeamlessM4T
  with `src_embeds`;
* (`tests/test_torch_serve_dense.py`: the bf16 logits, prefill against
  decode, the serve sessions);
* the published configs field for field (`test_full_config_exact`) and
  their parameter counts in the reference's ranges;
* the goldens `chip_smoke.py` holds the card to
  (`tests/data/torch_port_<arch>_golden.json`: published widths, 2
  layers (SeamlessM4T 2 + 2), f32): `slow` tests regenerate them with
  the JAX package and hold the port on the CPU to them (up to ~8 GB of
  f32 weights each: run them alone, not under xdist).
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
from repro.models import lm as jlm
from repro.models.common import Parallelism
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import lm

GEMMA, DS7, CODER, CHAM, SEAM = ("gemma-7b", "deepseek-7b",
                                 "deepseek-coder-33b", "chameleon-34b",
                                 "seamless-m4t-medium")
ARCHS = [GEMMA, DS7, CODER, CHAM, SEAM]
PAR = Parallelism(None)
DATA = Path(__file__).parent / "data"
TOL = 2e-3
BF16_TOL = 0.1
BF16_RTOL = 2 ** -6   # two to four bf16 steps of the value
SRC_LEN = 12    # encoder frames a request in the SMOKE checks


def configs(arch, dtype="float32", *, full=False, **kw):
    """(port config, JAX config) of `arch` in `dtype`, fields replaced by
    `kw` on both."""
    port = get_config(arch) if full else get_smoke_config(arch)
    ref = jget_config(arch) if full else jget_smoke(arch)
    return (dataclasses.replace(port, dtype=dtype, **kw),
            dataclasses.replace(ref, dtype=dtype, **kw))


def smoke_pair(arch, dtype="float32", seed=1):
    """(port config, JAX config, the JAX package's parameter tree, its
    side table, the port's model of the same weights): the tree of
    `numpy_params` (its layout is `jlm.init_model`'s,
    `test_numpy_params_match_jax_tree`), without compiling the
    reference's initialiser."""
    cfg, jcfg = configs(arch, dtype)
    params, meta = lm.numpy_params(cfg, seed=seed)
    return (cfg, jcfg, jax.tree.map(jnp.asarray, params), meta,
            lm.from_reference(params, meta, cfg))


def src_embeds(cfg, B, seed=5, frames=SRC_LEN):
    """Seeded f32 frame embeddings (B, frames, d_model) for an
    encoder-decoder config, else None."""
    if not cfg.enc_dec:
        return None
    return np.random.default_rng(seed).normal(
        size=(B, frames, cfg.d_model)).astype(np.float32)


def jax_layer_caches(cache, meta):
    """The JAX package's decoder cache tree as one dict per layer."""
    md = meta["decoder"]
    pre, p = md["pre_n"], md["period"]
    out = [dict(c) for c in cache["prefix"]]
    for l in range(pre, len(md["sigs"])):
        o, g = (l - pre) % p, (l - pre) // p
        out.append({k: v[g] for k, v in cache["scan"][o].items()})
    return out


def jax_greedy(jcfg, params, meta, prompts, n, src=None):
    """The JAX package's prefill + greedy decode: (logits (B, V) per
    step as f32 numpy, tokens (B, n), the prefilled cache per layer)."""
    B, S = prompts.shape
    prefill = jax.jit(lambda p, b, c: jlm.forward_prefill(
        jcfg, p, meta, b, c, PAR))
    decode = jax.jit(lambda p, t, c, k: jlm.forward_decode(
        jcfg, p, meta, t, c, k, PAR))
    cache = jlm.init_cache(jcfg, meta, B, S + n, PAR,
                           src_len=0 if src is None else src.shape[1])
    batch = {"tokens": jnp.asarray(prompts)}
    if src is not None:
        batch["src_embeds"] = jnp.asarray(src)
    logits, cache = prefill(params, batch, cache)
    filled = jax_layer_caches(cache, meta)
    out_l, out_t = [], []
    for i in range(n):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out_l.append(np.asarray(logits[:, -1], np.float32))
        out_t.append(np.asarray(tok[:, 0]))
        if i + 1 < n:
            logits, cache = decode(params, tok, cache, jnp.int32(S + i))
    return out_l, np.stack(out_t, 1), filled


def port_greedy(model, prompts, n, src=None):
    """The port's prefill + greedy decode, the outputs of `jax_greedy`
    (the prefilled cache copied before decode writes into it)."""
    B, S = prompts.shape
    tokens = torch.as_tensor(prompts, dtype=torch.int64)
    with torch.inference_mode():
        cache = lm.init_cache(model.cfg, B, S + n,
                              src_len=0 if src is None else src.shape[1])
        logits, cache = lm.forward_prefill(
            model, tokens, cache,
            src_embeds=None if src is None else torch.as_tensor(src))
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


def tree_paths(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="."): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def layer_leaves(layer):
    """{reference tree path: the port layer's tensor} of one layer."""
    out = {"ln1": layer.ln1}
    parts = [("attn", layer.attn)]
    if layer.has_cross:
        out["ln_cross"] = layer.ln_cross
        parts.append(("cross", layer.cross))
    out["ln2"] = layer.ln2
    parts.append(("ffn", layer.ffn))
    for name, module in parts:
        for k, v in module.named_parameters():
            out[f"{name}.{k}"] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_numpy_params_match_jax_tree(arch):
    """Leaf for leaf the JAX `init_model`'s tree (structure, shapes,
    dtypes) and side table, an encoder's stack (period 1) included."""
    cfg, jcfg = configs(arch)
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
    assert ("encoder" in meta) == (arch == SEAM) == ("ln_enc" in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_places_every_leaf(arch):
    """Decoder layer l holds group l of the decoder's offset 0, an
    encoder layer l group l of the encoder's, leaf for leaf; the plans
    are the reference's (cross attention on SeamlessM4T's decoder only);
    a tied config has no head."""
    cfg, _, params, meta, model = smoke_pair(arch)
    stacks = [("decoder", model.layers)]
    if cfg.enc_dec:
        stacks.append(("encoder", model.encoder))
        np.testing.assert_array_equal(model.ln_enc.numpy(),
                                      params["ln_enc"])
    assert (model.head is None) == cfg.tie_embeddings == (arch == GEMMA)
    for name, layers in stacks:
        md = meta[name]
        assert len(layers) == len(md["sigs"]) == md["groups"]
        want = tree_paths(params[name]["offsets"][0])
        for l, layer in enumerate(layers):
            got = layer_leaves(layer)
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                np.testing.assert_array_equal(v.numpy(),
                                              np.asarray(want[k][l]))
            assert (layer.mixer, layer.ffn_kind, layer.has_cross) \
                == md["sigs"][l] == ("attn", "dense", name == "decoder"
                                     and cfg.enc_dec)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,n", [(16, 6), (37, 4)])
def test_f32_logits_tokens_and_caches_match_jax(arch, S, n):
    cfg, jcfg, params, meta, model = smoke_pair(arch)
    prompts = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    src = src_embeds(cfg, 2, seed=S)
    jl, jt, jcache = jax_greedy(jcfg, params, meta, prompts, n, src)
    pl, pt, pcache = port_greedy(model, prompts, n, src)
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


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_full_config_exact(arch):
    """The port's published configs field for field the reference's,
    and the assignment numbers of `tests/test_arch_smoke.py`."""
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jget_smoke(arch))
    expected = {
        "starcoder2-3b": (30, 3072, 24, 2, 12288, 49152),
        "gemma-7b": (28, 3072, 16, 16, 24576, 256000),
        "deepseek-coder-33b": (62, 7168, 56, 8, 19200, 32256),
        "deepseek-7b": (30, 4096, 32, 32, 11008, 102400),
        "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 0, 151936),
        "deepseek-v2-236b": (60, 5120, 128, 128, 12288, 102400),
        "chameleon-34b": (48, 8192, 64, 8, 22016, 65536),
        "mamba2-1.3b": (48, 2048, 0, 0, 0, 50280),
        "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
        "seamless-m4t-medium": (12, 1024, 16, 16, 4096, 256206),
    }[arch]
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == expected


def test_param_counts_plausible():
    """The port's analytic parameter counts equal the reference's and
    lie in its advertised ranges (`tests/test_arch_smoke.py`)."""
    expect = {"starcoder2-3b": (2.5e9, 4e9),
              "gemma-7b": (7.5e9, 9.5e9),
              "deepseek-coder-33b": (3.0e10, 3.6e10),
              "deepseek-7b": (6.0e9, 7.5e9),
              "qwen3-moe-235b-a22b": (2.2e11, 2.5e11),
              "deepseek-v2-236b": (2.1e11, 2.5e11),
              "chameleon-34b": (3.1e10, 3.7e10),
              "mamba2-1.3b": (1.1e9, 1.6e9),
              "jamba-v0.1-52b": (4.6e10, 5.6e10),
              "seamless-m4t-medium": (0.8e9, 1.6e9)}
    assert sorted(expect) == sorted(ARCH_IDS)
    for arch, (lo, hi) in expect.items():
        n = get_config(arch).param_count()
        assert n == jget_config(arch).param_count()
        assert lo <= n <= hi, (arch, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_holds_param_count(arch):
    """The port's model of each SMOKE config holds `param_count()`
    weights beside its norms (and a tied config no head)."""
    cfg = get_smoke_config(arch)
    model = lm.init_model(cfg)
    n = sum(p.numel() for name, p in model.named_parameters()
            if not name.split(".")[-1].startswith(("ln", "qnorm",
                                                   "knorm")))
    assert n == cfg.param_count()


def test_layer_plans_and_caches():
    """SeamlessM4T's plans (an encoder of non-cross layers, a decoder
    whose layers cross-attend) and `init_cache`'s cross rows; the dense
    decoder-only configs have none."""
    cfg = get_smoke_config(SEAM)
    assert lm.layer_plan(cfg, 2, False) == [("attn", "dense", False)] * 2
    assert lm.layer_plan(cfg, 2, True) == [("attn", "dense", True)] * 2
    caches = lm.init_cache(cfg, 3, 20, src_len=7)
    for c in caches:
        assert sorted(c) == ["cross_k", "cross_v", "k", "v"]
        assert c["cross_k"].shape == (3, 7, cfg.num_kv_heads, cfg.head_dim)
        assert c["cross_v"].dtype == torch.bfloat16
    for arch in (GEMMA, DS7, CODER, CHAM):
        for c in lm.init_cache(get_smoke_config(arch), 3, 20, src_len=7):
            assert sorted(c) == ["k", "v"]


# ---- the full-width goldens -------------------------------------------

# per arch: golden file, name and the depth cut of the published config
# (SeamlessM4T: 2 encoder and 2 decoder layers); the cache norms kept
GOLDENS = {
    GEMMA: ("torch_port_gemma_7b_golden.json", "Gemma-7B",
            {"num_layers": 2}),
    DS7: ("torch_port_deepseek_7b_golden.json", "DeepSeek-7B",
          {"num_layers": 2}),
    CODER: ("torch_port_deepseek_coder_33b_golden.json",
            "DeepSeek-Coder-33B", {"num_layers": 2}),
    CHAM: ("torch_port_chameleon_34b_golden.json", "Chameleon-34B",
           {"num_layers": 2}),
    SEAM: ("torch_port_seamless_m4t_medium_golden.json",
           "SeamlessM4T-medium", {"num_layers": 2, "enc_layers": 2}),
}
NORMS = {"k_cache_norm": "k", "v_cache_norm": "v"}
CROSS_NORMS = {"cross_k_cache_norm": "cross_k",
               "cross_v_cache_norm": "cross_v"}
GOLDEN_FRAMES = 300   # SeamlessM4T's frames a prompt in its golden


def golden_norms(arch):
    return {**NORMS, **(CROSS_NORMS if arch == SEAM else {})}


def cache_norms(caches, norms):
    """{golden field: the f64 norms of `key` over the layers, in layer
    order} of per-layer cache dicts (numpy or torch)."""
    return {field: [float(np.linalg.norm(np.asarray(
        c[key].double() if torch.is_tensor(c[key]) else c[key],
        np.float64))) for c in caches] for field, key in norms.items()}


def golden_src(gold):
    """A golden's frame embeddings (None without): f32 normals from
    `default_rng(src_seed)` of its `src_shape`."""
    if "src_seed" not in gold:
        return None
    return np.random.default_rng(gold["src_seed"]).standard_normal(
        gold["src_shape"], dtype=np.float32)


@pytest.mark.slow
@pytest.mark.parametrize("arch", ARCHS)
def test_port_reproduces_golden_on_cpu(arch):
    """Published widths, depth cut as the golden says, f32: the port on
    the CPU against the JAX package's numbers (top-8 logits at 2e-3,
    tokens equal, per-layer cache norms to rtol 1e-4)."""
    name, _, _ = GOLDENS[arch]
    gold = json.loads((DATA / name).read_text())
    cfg, _ = configs(arch, full=True, **gold["config_cuts"])
    params, meta = lm.numpy_params(cfg, seed=gold["weights_seed"])
    model = lm.from_reference(params, meta, cfg)
    del params
    prompts = np.asarray(gold["prompts"], np.int64)
    pl, pt, cache = port_greedy(model, prompts, len(gold["tokens"][0]),
                                golden_src(gold))
    idx = np.asarray(gold["top8_index"])
    np.testing.assert_allclose(np.take_along_axis(pl[0], idx, 1),
                               gold["top8_value"], atol=TOL, rtol=0)
    np.testing.assert_array_equal(pt, gold["tokens"])
    for field, got in cache_norms(cache, golden_norms(arch)).items():
        np.testing.assert_allclose(got, gold[field], rtol=1e-4)


def regenerate_golden(arch, test_name):
    """Recompute a full-width reference with the JAX package on the CPU:
    `arch` at its published widths, depth cut as `GOLDENS` says, f32,
    weights from `numpy_params(cfg, seed=0)` (handed to jax leaf by
    leaf, so that the numpy copy is freed as it goes); 2 prompts of 300
    tokens (SeamlessM4T: 2 x 16 decoder tokens against 300 frames from
    `default_rng(1)`), 8 greedy tokens."""
    name, title, cuts = GOLDENS[arch]
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
    P = 16 if cfg.enc_dec else 300
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, P)).astype(np.int32)
    extra = {}
    if cfg.enc_dec:
        extra = {"src_seed": 1, "src_shape": [2, GOLDEN_FRAMES, cfg.d_model]}
    logits, tokens, cache = jax_greedy(jcfg, params, meta, prompts, n_tok,
                                       golden_src(extra))
    first = logits[0]
    top = np.argsort(-first, axis=1, kind="stable")[:, :8]
    top2 = [np.sort(lg, axis=1)[:, -2:] for lg in logits]
    gold = {
        "what": f"the JAX package's prefill and greedy decode of {title} "
                f"at its published widths, depth cut, f32: the reference "
                f"for chip_smoke.py's full-width whole-path parity check",
        "call": f"repro.models.lm.forward_prefill / forward_decode (CPU) on "
                f"repro_torch.models.lm.numpy_params(cfg, seed=0), cfg = "
                f"{cfg.name} CONFIG with {cuts}, dtype='float32'",
        "platform": "cpu",
        "jax": jax.__version__,
        "regenerate": f"PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q "
                      f"-m slow tests/test_torch_lm_dense.py -k {test_name}",
        "config_cuts": cuts,
        "num_layers": cuts["num_layers"],
        "weights_seed": seed,
        **extra,
        "prompts": prompts.tolist(),
        "top8_index": top.tolist(),
        "top8_value": np.take_along_axis(first, top, 1).tolist(),
        "logits_norm": np.linalg.norm(first.astype(np.float64),
                                      axis=1).tolist(),
        "tokens": tokens.tolist(),
        "top2_gap": np.stack([t[:, 1] - t[:, 0] for t in top2], 1).tolist(),
        **cache_norms(cache, golden_norms(arch)),
    }
    (DATA / name).write_text(json.dumps(gold) + "\n")


@pytest.mark.slow
@pytest.mark.parametrize("arch", ARCHS)
def test_regenerate_golden(arch):
    regenerate_golden(arch, f"'regenerate_golden and {arch}'")
