"""The arithmetic of K7's design (the attention's backward,
`csrc/flash_attention_bwd.cu`), emulated on the CPU and held to the
plain version and the JAX package.

The kernel cannot run here, so this file keeps a plain emulation of its
decomposition, on no path of the package:

* stats: per query row the base-2 log-sum-exp lse2 = m D^-1/2 log2 e +
  log2 l (online over key tiles up to the query tile's causal limit)
  and delta = rowsum(do o), padded to a multiple of 128 rows with
  lse2 = +inf and delta = 0;
* dk, dv: key tiles against query tiles from the first one the keys can
  see (causal tile skipping), P^T = exp2(S^T D^-1/2 log2 e - lse2) and
  dS^T = P^T (dP^T - delta); the G query heads of a KV head split into
  `splits` groups whose f32 partials are summed in the kernel's order
  (split 0, then 1, ...), then scaled and cast;
* dq: query tiles against key tiles up to their causal limit, dQ += dS K;
* bf16: P^T and dS^T rounded to bf16 before the products that take them
  (the wgmma A operands), sums in f32, outputs rounded to bf16.

Held against `ref.flash_attention_bwd_ref` and `jax.vjp` of the JAX
package's `jnp_flash` on the same seeded numpy inputs: the cases of
`tests/test_torch_flash_bwd.py` plus G = 12 and (D, Dv) = (192, 128), at
the kernel's tiles and at small tiles that make the skipping and the
split visible at these sizes; f32 at atol 1e-5 + rtol 1e-4, bf16 within
2e-2 of each gradient's largest magnitude (`K7_BAR`). The CUDA kernel is
held to the same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import jnp_flash
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)

from tests.test_torch_flash_bwd import ATOL, CASES, RTOL, _inputs

# csrc/flash_attention_bwd.cu: rows of the padded stats, SMs of the card,
# the bf16 bar (of each gradient's largest magnitude)
ROW_PAD, SM_COUNT, K7_BAR = 128, 132, 2e-2
LOG2E = 1.4426950408889634
# the cases above, G = 12 (StarCoder2-3B's 24 query heads on 2) and MLA's
# widths, at small S: (B, H, Hkv, S, T, D, Dv, q_offset)
DESIGN_CASES = CASES + [(1, 12, 1, 40, 40, 16, 16, 0),
                        (1, 2, 1, 24, 30, 192, 128, 6)]


def geometry(D, bf16):
    """The kernel's tiles: {launch: (rows of the block's own tile, rows of
    the streamed tile)}: bf16 stats 128 query rows x 128 keys, dk/dv 128
    keys x 64 query rows (32 at D = 192), dq 128 x 64; f32 stats 64 x 64,
    dk/dv and dq 64 x 64 (32 x 32 at D = 192)."""
    if bf16:
        return {"stats": (128, 128), "dkdv": (128, 32 if D > 128 else 64),
                "dq": (128, 64)}
    t = 32 if D > 128 else 64
    return {"stats": (64, 64), "dkdv": (t, t), "dq": (t, t)}


SMALL = {"stats": (16, 8), "dkdv": (16, 8), "dq": (16, 8)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the emulation's products are tiny, and a
    pool per worker beside the suite's other workers oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def splits_for(B, Hkv, G, T, kt):
    """The kernel's head split: the largest divisor of G up to 4 while
    the dk/dv grid has fewer than 4 x 132 blocks, else 1."""
    if B * Hkv * -(-T // kt) >= 4 * SM_COUNT:
        return 1
    return next((s for s in (4, 3, 2) if G % s == 0), 1)


def _rows(t, r0, n, ext):
    """Rows [r0, r0 + n) of axis 2 of t, zeros past `ext` (TMA's fill)."""
    out = t.new_zeros(t.shape[:2] + (n,) + t.shape[3:])
    m = max(0, min(n, ext - r0))
    out[:, :, :m] = t[:, :, r0:r0 + m]
    return out


def _kend(q0, n, S, T, causal, q_offset):
    """Keys a query tile [q0, q0 + n) loops over: up to the causal limit
    of its last row."""
    return min(T, q_offset + min(q0 + n, S)) if causal else T


def emulate(q, k, v, o, do, *, causal=True, q_offset=0, bf16=False,
            geo=None, splits=None):
    """K7's design on (B, H, S, D) tensors: (dq, dk, dv, stats) with
    stats = (lse2, delta), each (B, H, Sp)."""
    B, H, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    geo = geo or geometry(D, bf16)
    f32 = torch.float32
    q, k, v, o, do = (t.to(f32) for t in (q, k, v, o, do))
    scale = D ** -0.5
    sl2 = scale * LOG2E
    Sp = -(-S // ROW_PAD) * ROW_PAD
    rnd = (lambda t: t.to(torch.bfloat16).to(f32)) if bf16 else \
        (lambda t: t)
    kh, vh = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)

    # 1. stats
    R, C = geo["stats"]
    lse = torch.full((B, H, Sp), float("inf"))
    delta = torch.zeros(B, H, Sp)
    for q0 in range(0, S, R):
        qt = _rows(q, q0, R, S)
        qpos = q_offset + q0 + torch.arange(R)
        m = torch.full((B, H, R), float("-inf"))
        l = torch.zeros(B, H, R)
        for k0 in range(0, _kend(q0, R, S, T, causal, q_offset), C):
            s = qt @ _rows(kh, k0, C, T).transpose(-1, -2)
            key = k0 + torch.arange(C)
            hide = (key[None, :] >= T) | (causal & (key[None, :] >
                                                    qpos[:, None]))
            s = s.masked_fill(hide, float("-inf"))
            mx = torch.maximum(m, s.amax(-1))
            mu = torch.where(mx == float("-inf"), 0.0, mx)
            l = l * torch.exp2((m - mu) * sl2) + \
                torch.exp2((s - mu[..., None]) * sl2).sum(-1)
            m = mx
        ok = (q0 + torch.arange(R) < S) & (l > 0)
        lse[:, :, q0:q0 + R] = torch.where(ok, m * sl2 + torch.log2(l),
                                           float("inf"))
    delta[:, :, :S] = (do * o).sum(-1)

    # 2. dk, dv: (key tile, split) blocks, f32 partials summed in order
    KT, BQ = geo["dkdv"]
    n_split = splits or splits_for(B, Hkv, G, T, KT)
    assert G % n_split == 0
    Gs = G // n_split
    qg, dog = q.view(B, Hkv, G, S, D), do.view(B, Hkv, G, S, Dv)
    lse_g, delta_g = lse.view(B, Hkv, G, Sp), delta.view(B, Hkv, G, Sp)
    part = torch.zeros(n_split, B, Hkv, T, D + Dv)
    for k0 in range(0, T, KT):
        kt, vt = _rows(k, k0, KT, T), _rows(v, k0, KT, T)
        key = k0 + torch.arange(KT)
        qs0 = max(0, k0 - q_offset) // BQ if causal else 0
        for sp in range(n_split):
            dk = torch.zeros(B, Hkv, KT, D)
            dv = torch.zeros(B, Hkv, KT, Dv)
            for g in range(sp * Gs, (sp + 1) * Gs):
                for q0 in range(qs0 * BQ, S, BQ):
                    qt = _rows(qg[:, :, g], q0, BQ, S)
                    dot = _rows(dog[:, :, g], q0, BQ, S)
                    ls = lse_g[:, :, g, q0:q0 + BQ][..., None, :]
                    de = delta_g[:, :, g, q0:q0 + BQ][..., None, :]
                    pt = torch.exp2(kt @ qt.transpose(-1, -2) * sl2 - ls)
                    if causal:
                        qpos = q_offset + q0 + torch.arange(BQ)
                        pt = pt.masked_fill(key[:, None] > qpos[None, :],
                                            0.0)
                    dst = pt * (vt @ dot.transpose(-1, -2) - de)
                    dv = dv + rnd(pt) @ dot
                    dk = dk + rnd(dst) @ qt
            n = min(KT, T - k0)
            part[sp, :, :, k0:k0 + n] = torch.cat([dk, dv], -1)[:, :, :n]
    total = part[0].clone()
    for sp in range(1, n_split):
        total += part[sp]
    dk, dv = total[..., :D] * scale, total[..., D:]

    # 3. dq
    R, C = geo["dq"]
    dq = torch.zeros(B, H, S, D)
    for q0 in range(0, S, R):
        qt, dot = _rows(q, q0, R, S), _rows(do, q0, R, S)
        ls, de = lse[:, :, q0:q0 + R, None], delta[:, :, q0:q0 + R, None]
        qpos = q_offset + q0 + torch.arange(R)
        acc = torch.zeros(B, H, R, D)
        for k0 in range(0, _kend(q0, R, S, T, causal, q_offset), C):
            kt, vt = _rows(kh, k0, C, T), _rows(vh, k0, C, T)
            key = k0 + torch.arange(C)
            hide = (key[None, :] >= T) | (causal & (key[None, :] >
                                                    qpos[:, None]))
            p = torch.exp2(qt @ kt.transpose(-1, -2) * sl2 - ls)
            p = p.masked_fill(hide, 0.0)
            ds = p * (dot @ vt.transpose(-1, -2) - de)
            acc = acc + rnd(ds) @ kt
        n = min(R, S - q0)
        dq[:, :, q0:q0 + n] = (acc * scale)[:, :, :n]
    out = torch.bfloat16 if bf16 else f32
    return dq.to(out), dk.to(out), dv.to(out), (lse, delta)


def _torch_inputs(case, seed, causal, bf16):
    """q, k, v and do of `case` (rounded to bf16 when `bf16`) and the
    forward's o."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v, do = (torch.tensor(a).to(dtype) for a in _inputs(case, seed))
    o = flash_attention_ref(q, k, v, causal=causal, q_offset=case[-1])
    return q, k, v, o, do


@functools.lru_cache(maxsize=None)
def _jax_grads(case, seed, causal, bf16):
    """jax.vjp of jnp_flash at the values of `_torch_inputs`, as (B, H,
    S, D) arrays (once per inputs: the kernel's and the small tiles'
    emulations share them)."""
    q, k, v, _, do = _torch_inputs(case, seed, causal, bf16)
    tr = (0, 2, 1, 3)
    _, vjp = jax.vjp(lambda a, b, c: jnp_flash(a, b, c, causal=causal,
                                               q_offset=case[-1], block=16),
                     *(jnp.asarray(x.float().numpy().transpose(tr))
                       for x in (q, k, v)))
    return [np.asarray(g).transpose(tr)
            for g in vjp(jnp.asarray(do.float().numpy().transpose(tr)))]


def _within_bar(got, want):
    want = torch.tensor(np.asarray(want, dtype=np.float32))
    bar = K7_BAR * float(want.abs().max())
    torch.testing.assert_close(got.float(), want, atol=bar, rtol=0)


@pytest.mark.parametrize("small", [False, True], ids=["kernel", "small"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", DESIGN_CASES, ids=str)
def test_f32_design_matches_plain_and_jax(case, causal, small):
    q, k, v, o, do = _torch_inputs(case, 11, causal, bf16=False)
    qo = case[-1]
    got = emulate(q, k, v, o, do, causal=causal, q_offset=qo,
                  geo=SMALL if small else None)[:3]
    want = flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                   q_offset=qo)
    jw = _jax_grads(case, 11, causal, False)
    for g, w, j in zip(got, want, jw):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", DESIGN_CASES, ids=str)
def test_bf16_design_within_the_bar(case, causal):
    """P^T and dS^T rounded to bf16 before their products (ROADMAP C14):
    each gradient within 2e-2 of its largest magnitude of the plain
    version's on the same bf16 inputs and of jax.vjp's at their
    values."""
    q, k, v, o, do = _torch_inputs(case, 12, causal, bf16=True)
    qo = case[-1]
    got = emulate(q, k, v, o, do, causal=causal, q_offset=qo, bf16=True)[:3]
    want = flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                   q_offset=qo)
    jw = _jax_grads(case, 12, causal, True)
    for g, w, j in zip(got, want, jw):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _within_bar(g, w.float())
        _within_bar(g, j)


@pytest.mark.parametrize("bf16", [False, True])
def test_bf16_rounding_of_p_and_ds_is_what_moves_the_gradients(bf16):
    """At small tiles with G = 6 split 3 ways: the f32 design equals the
    plain version to float rounding, the bf16 one differs from its f32
    twin on the same inputs only by P^T / dS^T and the outputs' rounding
    (well inside the bar, and not zero)."""
    case = (1, 12, 2, 70, 90, 32, 32, 20)
    q, k, v, o, do = _torch_inputs(case, 13, True, bf16=True)
    f = emulate(q.float(), k.float(), v.float(), o.float(), do.float(),
                q_offset=20, geo=SMALL, splits=3)[:3]
    b = emulate(q, k, v, o, do, q_offset=20, bf16=True, geo=SMALL,
                splits=3)[:3]
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                   o.float(), do.float(), q_offset=20)
    for gf, gb, w in zip(f, b, want):
        np.testing.assert_allclose(gf.numpy(), w.numpy(), atol=ATOL,
                                   rtol=RTOL)
        gap = float((gb.float() - gf).abs().max())
        assert 0 < gap < 0.25 * K7_BAR * float(w.abs().max())


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 6, 12])
def test_head_split_partials_summed_in_order(splits):
    """Every divisor of G = 12 as the split: the same gradients to float
    rounding, and a split's result is the in-order sum of its partials
    (so it is the same bits from call to call)."""
    case = (2, 12, 1, 45, 45, 16, 16, 0)
    q, k, v, o, do = _torch_inputs(case, 14, True, bf16=False)
    one = emulate(q, k, v, o, do, geo=SMALL, splits=1)[:3]
    got = emulate(q, k, v, o, do, geo=SMALL, splits=splits)[:3]
    again = emulate(q, k, v, o, do, geo=SMALL, splits=splits)[:3]
    for a, b, c in zip(one, got, again):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL,
                                   rtol=RTOL)
        assert torch.equal(b, c)


def test_split_rule_and_workspace_at_the_train_and_mla_shapes():
    """StarCoder2-3B's train shape (4, 24 on 2, T 2048) splits its 12
    heads 4 ways in both instances (128 and 256 dk/dv blocks without);
    the partials take 4 x 2 x 4 x 2048 x 256 floats, 67 MB. MLA's (4,
    128 on 128, T 1000) has G = 1 and a full grid: no split."""
    assert splits_for(4, 2, 12, 2048, 128) == 4
    assert splits_for(4, 2, 12, 2048, 64) == 4
    assert splits_for(4, 128, 1, 1000, 128) == 1
    assert splits_for(4, 128, 1, 1000, 32) == 1
    assert 4 * 2 * 4 * 2048 * (128 + 128) * 4 == 67_108_864


@pytest.mark.parametrize("causal", [True, False])
def test_stats_padded_rows_and_lse(causal):
    """lse2 is log2 of the row's sum of exp2 of its scaled scores (the
    plain softmax's log-sum-exp in base 2); rows past S to 128 carry
    lse2 = +inf and delta = 0, so their p is 0."""
    case = (1, 4, 2, 33, 41, 16, 16, 5)
    q, k, v, o, do = _torch_inputs(case, 15, causal, bf16=False)
    _, _, _, (lse, delta) = emulate(q, k, v, o, do, causal=causal,
                                    q_offset=5, geo=SMALL)
    assert lse.shape == (1, 4, 128)
    assert torch.isinf(lse[..., 33:]).all() and not delta[..., 33:].any()
    s = torch.einsum("bhsd,bhtd->bhst", q,
                     k.repeat_interleave(2, 1)) * 16 ** -0.5
    if causal:
        hide = torch.arange(41)[None, :] > 5 + torch.arange(33)[:, None]
        s = s.masked_fill(hide, float("-inf"))
    want = torch.logsumexp(s, -1) * LOG2E
    torch.testing.assert_close(lse[..., :33], want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(delta[..., :33], (do * o).sum(-1))
    assert torch.exp2(torch.tensor(0.0) - lse[..., 33:]).eq(0).all()


@pytest.mark.parametrize("q_offset", [0, 7, 64])
@pytest.mark.parametrize("KT,BQ", [(128, 64), (128, 32), (64, 64),
                                   (32, 32)])
def test_causal_tile_skipping_covers_every_visible_pair(KT, BQ, q_offset):
    """The dk/dv blocks start at query tile max(0, k0 - q_offset) // BQ:
    every (key, query) pair that causal masking keeps lies in a visited
    tile, and the first visited tile of each key tile holds one."""
    S, T = 300, 300 + q_offset
    for k0 in range(0, T, KT):
        first = max(0, k0 - q_offset) // BQ * BQ
        keys = np.arange(k0, min(T, k0 + KT))
        seen = np.nonzero(((q_offset + np.arange(S))[:, None]
                           >= keys[None, :]).any(1))[0]
        if seen.size:       # a suffix of the rows: all in visited tiles
            assert first <= seen[0] < first + BQ
