"""The arithmetic of K6's CUDA design (tiles of 4096 floats, one grid
barrier, each tile scanning its row's high totals), emulated on the CPU
and held bit for bit to the plain version and to the JAX package's
`jnp.cumsum`.

The kernel (`csrc/prefix_sum.cu`) cannot run here, so this file keeps a
plain emulation of its two phases, on no path of the package:

* A: each (row, chunk of 4096) tile sums its blocks of 16 sequentially
  (every chain from +0.0, as XLA starts it) into 256 level-1 totals
  (zeros past the row's end), those into 16
  level-2 totals and those into one level-3 total;
* B: each tile scans its row's level-3 totals in XLA's order (blocks of
  16, recursively), the level-2 blocks of its chunk and the one before
  (in-block prefix + the scanned level-3 total before), its own 16
  level-1 blocks the same way, and forms each element as (scanned
  level-1 total before its block) + (its in-block prefix); the total
  before the chunk is (scanned level-2 total before the previous
  chunk's last level-1 block) + (that block's total). Block 0 of a row
  keeps its prefix.

numpy's float32 adds round to nearest with no contraction, as the
kernel's `__fadd_rn` does. Held with `==` on the int32 views (signed
zeros included) on seeded rows. The CUDA kernel is held to the same
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import prefix_sum_ref

from tests.test_torch_cuda import prefix_rows

BLK = 16
THREADS = 256                 # csrc/prefix_sum.cu: a tile's blocks of 16
TILE = BLK * THREADS          # 4096 floats a tile
LENGTHS = [1, 16, 4095, 4096, 4097, 8193, 30016, 65537, 200_000]


def _pad16(a, nb):
    """(R, m) -> (R, nb, 16), zeros past m."""
    out = np.zeros((a.shape[0], nb * BLK), np.float32)
    out[:, :a.shape[1]] = a
    return out.reshape(a.shape[0], nb, BLK)


def _seq_sum(v):
    """Sequential sum over the last axis (16) from the identity +0.0."""
    s = np.zeros(v.shape[:-1], np.float32)
    for i in range(BLK):
        s = s + v[..., i]
    return s


def _block_scan(v, before, add):
    """Each element of v (..., 16): its in-block prefix, plus `before`
    (...) where `add` (...)."""
    out = np.empty_like(v)
    s = np.float32(0) + v[..., 0]
    out[..., 0] = np.where(add, before + s, s)
    for i in range(1, BLK):
        s = s + v[..., i]
        out[..., i] = np.where(add, before + s, s)
    return out


def _scan_high(t):
    """The kernel's `scan_high`: XLA's scan of a row's level-3 totals
    (R, n), the levels above built from them and scanned down."""
    n = t.shape[1]
    nb = -(-n // BLK)
    blocks = _pad16(t, nb)
    if nb == 1:
        return _block_scan(blocks, np.float32(0), False)[:, 0, :n]
    up = _scan_high(_seq_sum(blocks))
    b = np.arange(nb)
    before = np.where(b > 0, up[:, np.maximum(b - 1, 0)], np.float32(0))
    return _block_scan(blocks, before, b > 0).reshape(t.shape[0], -1)[:, :n]


def emulate(x):
    """K6's design: (R, F) float32 -> (R, F + 1) float32."""
    x = np.asarray(x, np.float32)
    R, F = x.shape
    out = np.zeros((R, F + 1), np.float32)
    if F == 0:
        return out
    n1 = -(-F // BLK)
    n2 = -(-n1 // BLK) if n1 > BLK else 0     # 0: the row has no level
    n3 = -(-n2 // BLK) if n2 > BLK else 0
    nchunk = -(-F // TILE)

    # ---- A: every tile's level-1..3 totals -------------------------------
    blocks = _pad16(x, nchunk * THREADS).reshape(R, nchunk, THREADS, BLK)
    t1 = _seq_sum(blocks)                                 # (R, nchunk, 256)
    t1 = np.where(np.arange(nchunk * THREADS).reshape(nchunk, THREADS)
                  < n1, t1, np.float32(0))
    t2 = _seq_sum(t1.reshape(R, nchunk, BLK, BLK))        # (R, nchunk, 16)
    t2 = np.where(np.arange(nchunk * BLK).reshape(nchunk, BLK) < n2, t2,
                  np.float32(0))
    t3 = _seq_sum(t2)                                     # (R, nchunk)

    # ---- B: every tile, from its row's totals ------------------------------
    c = np.arange(nchunk)
    s3 = _scan_high(t3) if n3 else np.zeros((R, nchunk), np.float32)
    before = np.where(c > 0, s3[:, np.maximum(c - 1, 0)], np.float32(0))
    s2 = _block_scan(t2, before, c > 0)                   # (R, nchunk, 16)
    bnd = np.zeros((R, nchunk), np.float32)               # chunk c >= 1
    bnd[:, 1:] = s2[:, :-1, BLK - 2] + t2[:, :-1, BLK - 1]
    s2 = s2.reshape(R, -1)
    m = np.arange(nchunk * BLK)                           # level-1 blocks
    before = np.where(m > 0, s2[:, np.maximum(m - 1, 0)], np.float32(0))
    s1 = _block_scan(t1.reshape(R, -1, BLK), before, m > 0).reshape(R, -1)
    b = np.arange(nchunk * THREADS)                       # level-0 blocks
    first = b % THREADS == 0
    before = np.where(first, bnd[:, b // THREADS],
                      s1[:, np.maximum(b - 1, 0)])
    v = _block_scan(blocks.reshape(R, -1, BLK), before, b > 0)
    out[:, 1:] = v.reshape(R, -1)[:, :F]
    return out


def look_back(x):
    """The textbook multi-block scan K6 does NOT take: each chunk of 4096
    scanned on its own in XLA's order, plus a carry from a sequential
    scan of the chunk totals."""
    x = torch.from_numpy(np.asarray(x, np.float32))
    chunks = [prefix_sum_ref(c)[:, 1:] for c in x.split(TILE, dim=1)]
    carry = torch.zeros(x.shape[0])
    parts = [torch.zeros(x.shape[0], 1)]
    for i, c in enumerate(chunks):
        parts.append(c if i == 0 else carry[:, None] + c)
        carry = carry + c[:, -1]
    return torch.cat(parts, dim=1).numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _signed_rows(B, F, seed):
    """Seeded rows of both signs over 12 decades, a third of them -0.0
    and a tenth +0.0."""
    rng = np.random.default_rng(seed)
    x = rng.lognormal(0.0, 6.0, (B, F)) * rng.choice([-1.0, 1.0], (B, F))
    x[rng.uniform(size=(B, F)) < 0.3] = -0.0
    x[rng.uniform(size=(B, F)) < 0.1] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("F", LENGTHS)
def test_design_equals_plain_and_jnp_cumsum_bitwise(F):
    x = prefix_rows(4, F, seed=F)
    got = emulate(x)
    want = prefix_sum_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    xla = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(x))
    np.testing.assert_array_equal(_bits(got[:, 1:]), _bits(xla))


@pytest.mark.parametrize("F", [17, 4097, 30016, 65537])
def test_design_equals_plain_on_signed_rows(F):
    """Both signs and both zeros, and a run of -0.0 at the row's front:
    the emulation keeps the plain version's bits and XLA's, signed
    zeros included (ROADMAP C11)."""
    x = _signed_rows(3, F, seed=F)
    x[:, :min(F, 40)] = -0.0
    got = emulate(x)
    want = prefix_sum_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    xla = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(x))
    np.testing.assert_array_equal(_bits(got[:, 1:]), _bits(xla))


def test_design_on_a_grouped_tensor():
    """A step's segment sums stacked into one (k B, F) call: each sum's
    rows equal its own call's and the plain version's."""
    B, F = 4, 30016
    counts = (np.random.default_rng(1).uniform(size=(B, F)) < 0.4)
    parts = [counts.astype(np.float32), prefix_rows(B, F, seed=2),
             _signed_rows(B, F, seed=3)]
    grouped = emulate(np.concatenate(parts))
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(_bits(grouped[i * B:(i + 1) * B]),
                                      _bits(emulate(p)))
    want = prefix_sum_ref(torch.from_numpy(np.concatenate(parts))).numpy()
    np.testing.assert_array_equal(_bits(grouped), _bits(want))


@pytest.mark.parametrize("F", [8193, 30016])
def test_look_back_over_chunk_totals_is_not_xlas_order(F):
    """The trap the design avoids: a carry over the chunk totals rounds
    elsewhere than XLA's nested totals on these rows, so an emulation
    that drifted into it would fail the tests above."""
    x = prefix_rows(4, F, seed=F)
    want = prefix_sum_ref(torch.from_numpy(x)).numpy()
    lb = look_back(x)
    np.testing.assert_array_equal(_bits(lb[:, :TILE + 1]),
                                  _bits(want[:, :TILE + 1]))
    assert (_bits(lb) != _bits(want)).sum() > 0.01 * x.size


def _swz(q):
    return q ^ ((q >> 3) & 3)   # csrc/prefix_sum.cu: swz


def test_tile_swizzle_is_a_conflict_free_permutation():
    """The shared-memory slots of a tile's 1024 float4s: a permutation;
    a quarter warp's 16-byte accesses (a thread's j-th float4 of its
    block, or 8 consecutive float4s of a coalesced load) hit 8 distinct
    bank groups, and a warp's 32 consecutive floats 32 distinct banks."""
    q = np.arange(TILE // 4)
    assert sorted(_swz(q)) == list(q)
    for t0 in range(0, THREADS, 8):
        t = np.arange(t0, t0 + 8)
        for j in range(4):
            assert len(set(_swz(4 * t + j) % 8)) == 8
        assert len(set(_swz(t) % 8)) == 8
    for e0 in range(0, TILE, 32):
        e = np.arange(e0, e0 + 32)
        assert len(set((4 * _swz(e >> 2) + (e & 3)) % 32)) == 32
