"""The port's attention path against the JAX package's, on the CPU.

* `ref.attention_ref` and `ref.flash_attention_ref` (the plain version
  of the attention kernel K5, which `ops.flash_attention` runs for CPU
  tensors) against the JAX `ref.attention_ref` and the Pallas kernel in
  interpret mode (`bq = bk = 16`) on the sweep of
  `tests/test_kernels.py:80-84`, f32 and bf16, causal and not, at the
  reference's bars (atol 2e-6 f32, 2e-2 bf16);
* the `q_offset` (chunked prefill) case, and a ragged S with T > S;
* a test-local emulation of the arithmetic of K5's bf16 instance (f32
  scores from bf16 inputs over key tiles of 128, exp2 with the folded
  scale, P rounded to bf16 before P V) against the Pallas kernel and
  `flash_attention_ref` at the bf16 bar: the bar admits the design;
* `rope`, the activations and `mlp_ffn` against the JAX functions;
* the GQA attention module against `gqa_apply` on the StarCoder2 SMOKE
  weights in f32: a prefill that fills the cache, then a decode step at
  `kv_len`, outputs and caches to atol 1e-5.

Inputs are made with numpy from a seed and handed to both packages
(bf16 inputs are rounded from the same f32 arrays on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.common import Parallelism
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, common

SWEEP = [(1, 1, 1, 16, 16, 32), (2, 4, 2, 64, 64, 64),
         (1, 8, 1, 32, 32, 128), (1, 2, 2, 40, 40, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def qkv(B, H, Hkv, S, T, D, dtype, seed):
    """(jax, torch) triples of the same seeded q, k, v in `dtype`."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D))]
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,Hkv,S,T,D", SWEEP)
def test_attention_ref_matches_jax(B, H, Hkv, S, T, D, dtype, causal):
    (jq, jk, jv), (q, k, v) = qkv(B, H, Hkv, S, T, D, dtype, seed=S + D)
    got = ref.attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (B, H, S, D)
    close(got, jref.attention_ref(jq, jk, jv, causal=causal),
          DTYPES[dtype][2])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,Hkv,S,T,D", SWEEP)
def test_flash_attention_ref_matches_pallas(B, H, Hkv, S, T, D, dtype,
                                            causal):
    """`ops.flash_attention` on CPU tensors (the plain version, no
    launch) against the Pallas kernel in interpret mode and, since
    S == T here, the JAX `attention_ref`."""
    (jq, jk, jv), (q, k, v) = qkv(B, H, Hkv, S, T, D, dtype, seed=S + D)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.launch_counts()["flash_attention"] == before
    assert got.dtype == q.dtype and got.shape == (B, H, S, D)
    atol = DTYPES[dtype][2]
    close(got, jops.flash_attention(jq, jk, jv, causal=causal, bq=16,
                                    bk=16, force="interpret"), atol)
    close(got, jref.attention_ref(jq, jk, jv, causal=causal), atol)


def test_flash_attention_q_offset_matches_pallas():
    """Chunked prefill (`tests/test_kernels.py:98-109`): the second half
    of the queries at q_offset 32 against the full keys equals the
    Pallas kernel with the same offset and the full causal result's
    second half."""
    (jq, jk, jv), (q, k, v) = qkv(1, 2, 2, 64, 64, 32, "float32", seed=9)
    half = ops.flash_attention(q[:, :, 32:], k, v, causal=True,
                               q_offset=32)
    close(half, jops.flash_attention(jq[:, :, 32:], jk, jv, causal=True,
                                     bq=16, bk=16, q_offset=32,
                                     force="interpret"), 2e-6)
    full = ops.flash_attention(q, k, v, causal=True)
    close(half, full[:, :, 32:].numpy(), 1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_ragged_rows(dtype):
    """S = 23 (no multiple of 16) against T = 40 keys with GQA: at
    q_offset = T - S the top-left contract of the Pallas kernel and the
    bottom-right mask of `attention_ref` agree, and the plain version
    matches both."""
    (jq, jk, jv), (q, k, v) = qkv(2, 4, 2, 23, 40, 32, dtype, seed=23)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=17)
    atol = DTYPES[dtype][2]
    close(got, jops.flash_attention(jq, jk, jv, causal=True, bq=16, bk=16,
                                    q_offset=17, force="interpret"), atol)
    close(got, jref.attention_ref(jq, jk, jv, causal=True), atol)
    close(ref.attention_ref(q, k, v, causal=True),
          jref.attention_ref(jq, jk, jv, causal=True), atol)


def test_flash_attention_small_blocks_equal_one_block():
    """The online softmax over key blocks of 8 gives the one-block
    result (the running max and sum rescale exactly up to rounding)."""
    _, (q, k, v) = qkv(1, 4, 1, 30, 30, 16, "float32", seed=3)
    one = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(
        ref.flash_attention_ref(q, k, v, causal=True, block=8), one,
        atol=1e-6, rtol=0)


def hopper_bf16_emulation(q, k, v, *, causal, q_offset, bk=128):
    """The arithmetic of K5's bf16 instance (`csrc/flash_attention.cu`,
    `hopper::flash_fwd_sm90`), in plain torch: scores q k^T in f32 from
    the bf16 inputs, key tiles of `bk`, the running max in raw score
    units, p = exp2(s c - m c) with c = D^-1/2 log2 e folded into one
    multiply-add, l summed from the f32 p, and P rounded to bf16 before
    P V (f32 sums); o = acc / max(l, 1e-30) in bf16."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    f32 = torch.float32
    c = torch.tensor(D ** -0.5 * np.log2(np.e), dtype=f32)
    qg = q.reshape(B, Hkv, H // Hkv, S, D).to(f32)
    q_pos = q_offset + torch.arange(S)
    m = torch.full((B, Hkv, H // Hkv, S), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, H // Hkv, S, D)
    for j in range(0, T, bk):
        kb, vb = k[:, :, j:j + bk].to(f32), v[:, :, j:j + bk].to(f32)
        s = torch.einsum("bhgsd,bhtd->bhgst", qg, kb)
        if causal:
            k_pos = j + torch.arange(kb.shape[2])
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2((m - mu) * c)
        p = torch.exp2(s * c - (mu * c)[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgst,bhtd->bhgsd", p.to(torch.bfloat16).to(f32), vb)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, S, D).to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "B,H,Hkv,S,T,D,q_offset",
    [shape + (0,) for shape in SWEEP]
    + [(2, 4, 2, 23, 40, 32, 17), (1, 4, 2, 512, 512, 128, 0)])
def test_bf16_kernel_rounding_within_the_bar(B, H, Hkv, S, T, D, q_offset,
                                             causal):
    """The bf16 design's rounding (P in bf16 where the Pallas contract
    keeps it f32; ROADMAP C8) against the Pallas kernel in interpret
    mode and `flash_attention_ref`, at the bf16 bar of 2e-2."""
    (jq, jk, jv), (q, k, v) = qkv(B, H, Hkv, S, T, D, "bfloat16",
                                  seed=S + D)
    got = hopper_bf16_emulation(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, D)
    blk = 128 if S >= 128 else 16
    close(got, jops.flash_attention(jq, jk, jv, causal=causal, bq=blk,
                                    bk=blk, q_offset=q_offset,
                                    force="interpret"), 2e-2)
    close(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset).float(), 2e-2)


def test_ops_flash_attention_rejects_bad_arguments():
    _, (q, k, v) = qkv(1, 2, 1, 8, 8, 16, "float32", seed=1)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="force"):
        ops.flash_attention(q, k, v, force="interpret")


# ---- RoPE, activations, the plain MLP -----------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pos_shape", [(1, 37), (3, 1)])
def test_rope_matches_jax(dtype, pos_shape):
    """Prefill positions (1, S) and decode positions (B, 1), up to 2000
    (the serve path's prompt length)."""
    rng = np.random.default_rng(len(pos_shape) + pos_shape[0])
    S = pos_shape[1]
    x = rng.normal(size=(3, S, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 2000, pos_shape)
    jdt, tdt, _ = DTYPES[dtype]
    want = jcommon.rope(jnp.asarray(x, jdt), jnp.asarray(pos), 1e5)
    got = common.rope(torch.from_numpy(x).to(tdt), torch.as_tensor(pos),
                      1e5)
    assert got.dtype == tdt
    close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
def test_activations_match_jax(act):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    close(common.activation(act)(torch.from_numpy(x)),
          jcommon.activation(act)(jnp.asarray(x)), 1e-6)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-3, 3, 61)
    assert not torch.allclose(common.activation("gelu")(x),
                              torch.nn.functional.gelu(x), atol=1e-5)
    with pytest.raises(ValueError, match="activation"):
        common.activation("swiglu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_ffn_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    wi = (rng.normal(size=(64, 128)) / 8).astype(np.float32)
    wo = (rng.normal(size=(128, 64)) / 11.3).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    want = jcommon.mlp_ffn(*(jnp.asarray(a, jdt) for a in (x, wi, wo)),
                           "gelu", Parallelism(None))
    got = common.mlp_ffn(*(torch.from_numpy(a).to(tdt) for a in (x, wi, wo)),
                         "gelu")
    close(got, want, DTYPES[dtype][2])


# ---- the GQA module against gqa_apply -----------------------------------

def smoke_attention(qk_norm=False, seed=0):
    """(port config, JAX config, JAX layer-0 weights, port module) of the
    StarCoder2 SMOKE attention in f32."""
    cfg = dataclasses.replace(get_smoke_config("starcoder2-3b"),
                              dtype="float32", qk_norm=qk_norm)
    jcfg = dataclasses.replace(jget_smoke("starcoder2-3b"),
                               dtype="float32", qk_norm=qk_norm)
    pf = jcommon.ParamFactory(jax.random.key(seed), jnp.float32)
    w = jax.tree.map(lambda t: t[0], jattn.gqa_init(pf, jcfg, "attn", 1))
    if qk_norm:   # non-zero norm weights, so the norms are exercised
        w = dict(w, qnorm=w["qnorm"] + 0.3, knorm=w["knorm"] - 0.2)
    module = attention.GQAAttention(cfg, {
        k: torch.tensor(np.asarray(v)) for k, v in w.items()})
    return cfg, jcfg, w, module


@pytest.mark.parametrize("qk_norm", [False, True])
def test_gqa_module_matches_gqa_apply(qk_norm):
    """Prefill of S tokens filling a cache of max_len rows, then one
    decode step at kv_len = S: the outputs and both caches to atol
    1e-5."""
    cfg, jcfg, w, module = smoke_attention(qk_norm)
    B, S, max_len = 2, 19, 24
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S + 1, cfg.d_model)).astype(np.float32)
    shape = (B, max_len, cfg.num_kv_heads, cfg.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    jo, jcache = jattn.gqa_apply(jcfg, w, jnp.asarray(x[:, :S]),
                                 positions=jnp.arange(S)[None],
                                 cache=jcache)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    with torch.inference_mode():
        o, cache = module(torch.from_numpy(x[:, :S]),
                          torch.arange(S)[None], cache)
        close(o, jo, 1e-5)
        for k in ("k", "v"):
            close(cache[k], jcache[k], 1e-5)
        jo, jcache = jattn.gqa_apply(
            jcfg, w, jnp.asarray(x[:, S:]),
            positions=jnp.full((B, 1), S, jnp.int32), cache=jcache,
            kv_len=jnp.int32(S))
        o, cache = module(torch.from_numpy(x[:, S:]),
                          torch.full((B, 1), S), cache, kv_len=S)
    close(o, jo, 1e-5)
    for k in ("k", "v"):
        close(cache[k], jcache[k], 1e-5)


def test_gqa_module_without_cache_and_decode_checks():
    """A prefill without a cache attends its own k and v (the cached
    prefill's output); a decode step needs one token and a cache."""
    cfg, _, _, module = smoke_attention()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 9, cfg.d_model)).astype(np.float32))
    pos = torch.arange(9)[None]
    shape = (1, 12, cfg.num_kv_heads, cfg.head_dim)
    cached, _ = module(x, pos, {"k": torch.zeros(shape),
                                "v": torch.zeros(shape)})
    bare, none = module(x, pos)
    assert none is None
    torch.testing.assert_close(bare, cached, atol=0, rtol=0)
    with pytest.raises(ValueError, match="one token"):
        module(x, pos, {"k": torch.zeros(shape), "v": torch.zeros(shape)},
               kv_len=3)


def test_decode_attend_matches_jax():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 1, 6, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 30, 3, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 30, 3, 16)).astype(np.float32)
    want = jattn.decode_attend(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), kv_len=21)
    got = attention.decode_attend(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), 21)
    close(got, want, 1e-6)
