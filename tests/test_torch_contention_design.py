"""The arithmetic of K1's CUDA design (port-major bitmasks), emulated on
the CPU and held exactly to the plain version and to the JAX package.

The kernel (`csrc/contention.cu`) cannot run here, so this file keeps a
plain emulation of its two phases, on no path of the package:

* pack: for each (lane, s/r, 32 coflows, 32 ports) a warp's lane l
  gathers the 32 coflows' bits of port 32q + l and ANDs them with the
  ballot of the coflows' active flags (the port's mask word), and 32
  ballots transpose them into the coflows' port words;
* count: tiles of (lane, 8 mask words, 128 rows); lane q of a row's
  group walks the set bits of port word q of both lists and ORs the
  ports' 8 mask words, the group's words are OR-reduced by xor
  shuffles, the row's own bit is cleared, and the popcount is added to
  the row's count: one integer partial sum per word range.

Held with `==` against `ref.contention_ref` and against the Pallas
kernel in interpret mode (`repro.kernels.ops.contention(...,
force="interpret")`) on inputs made with numpy from a seed. The CUDA
kernel is held to the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels.ref import contention_ref

WK, RT = 8, 128   # csrc/contention.cu: mask words and rows of a tile


def _ballot(pred):
    """__ballot_sync over 32 lanes: bit l set where lane l's pred is."""
    return int(sum(int(bool(v)) << l for l, v in enumerate(pred)))


def emulate(a_send, a_recv, active):
    """K1's design: (B, C, P) incidence x2 (any dtype, non-zero = 1) and
    (B, C) bool -> (B, C) int64 counts, with the number of partial sums
    each row received."""
    on = [np.asarray(a_send) != 0, np.asarray(a_recv) != 0]
    act = np.asarray(active, bool)
    B, C, P = on[0].shape
    WC = -(-(-(-C // 32)) // WK) * WK
    WP = -(-P // 32)
    masks = np.zeros((B, 2, P, WC), np.uint64)
    rows = np.zeros((B, C, 2, WP), np.uint64)
    # ---- pack: one warp item per (b, arr, w, q) --------------------------
    for b in range(B):
        for arr in range(2):
            for w in range(WC):
                c0 = 32 * w
                live = _ballot([c0 + i < C and act[b, c0 + i]
                                for i in range(32)])
                for q in range(WP):
                    col = [0] * 32                    # lane l: port 32q + l
                    for lane in range(32):
                        p = 32 * q + lane
                        if p < P:
                            for i in range(min(32, C - c0)):
                                if on[arr][b, c0 + i, p]:
                                    col[lane] |= 1 << i
                        col[lane] &= live         # inactive coflows out
                        if p < P:
                            masks[b, arr, p, w] = col[lane]
                    for i in range(32):               # 32 ballots
                        if c0 + i < C:
                            rows[b, c0 + i, arr, q] = _ballot(
                                [(v >> i) & 1 for v in col])
    # ---- count: tiles of (b, k, r) ---------------------------------------
    lpr = 1
    while lpr < WP:
        lpr *= 2
    out = np.zeros((B, C), np.int64)
    parts = np.zeros((B, C), np.int64)
    K, RB = WC // WK, -(-C // RT)
    for tile in range(B * K * RB):
        r, k, b = tile % RB, (tile // RB) % K, tile // (RB * K)
        sm = masks[b, :, :, k * WK:(k + 1) * WK]
        for c in range(r * RT, min(C, (r + 1) * RT)):
            acc = np.zeros((lpr, WK), np.uint64)
            for q in range(min(lpr, WP)):
                for arr in range(2):
                    bits = int(rows[b, c, arr, q])
                    while bits:
                        low = bits & -bits
                        p = 32 * q + low.bit_length() - 1
                        bits ^= low
                        acc[q] |= sm[arr, p]
            o = lpr // 2
            while o:                                  # xor shuffles
                acc = acc | acc[np.arange(lpr) ^ o]
                o //= 2
            words = [int(v) for v in acc[0]]
            self_ = c - 32 * WK * k
            if 0 <= self_ < 32 * WK:
                words[self_ // 32] &= ~(1 << (self_ % 32))
            out[b, c] += sum(bin(v).count("1") for v in words)
            parts[b, c] += 1
    return out, parts


def _inputs(B, C, P, *, seed, density=0.1, act_frac=0.75):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(B, C, P)) < density,
            rng.uniform(size=(B, C, P)) < density,
            rng.uniform(size=(B, C)) < act_frac)


def _hold(a_s, a_r, act, dtype="float32"):
    """The emulation against contention_ref (in `dtype`) and, lane by
    lane, the Pallas kernel in interpret mode."""
    got, parts = emulate(a_s, a_r, act)
    tdt = getattr(torch, dtype)
    want = contention_ref(torch.as_tensor(a_s).to(tdt),
                          torch.as_tensor(a_r).to(tdt), torch.as_tensor(act))
    np.testing.assert_array_equal(got, want.numpy())
    for b in range(a_s.shape[0]):
        pal = jops.contention(jnp.asarray(a_s[b], jnp.float32),
                              jnp.asarray(a_r[b], jnp.float32),
                              jnp.asarray(act[b]), force="interpret")
        np.testing.assert_array_equal(got[b], np.asarray(pal))
    return got, parts


@pytest.mark.parametrize("B,C,P", [(1, 37, 40), (2, 300, 33), (1, 130, 150),
                                   (1, 600, 64)])
def test_design_matches_plain_and_pallas(B, C, P):
    """C no multiple of 32, P > 32, and C > 256 coflows (two or three
    mask-word ranges, so rows take partial sums, and rows past one
    128-row tile)."""
    _, parts = _hold(*_inputs(B, C, P, seed=C + P))
    assert (parts == -(-(-(-C // 32)) // WK)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bool"])
def test_design_input_types(dtype):
    """f32, bf16 and bool incidence count alike (non-zero reads as 1)."""
    _hold(*_inputs(1, 70, 45, seed=3), dtype=dtype)


def test_design_coflow_on_every_port():
    """A coflow on every send and receive port meets every active
    coflow that has a port; an inactive dense coflow meets none."""
    a_s, a_r, act = _inputs(1, 90, 50, seed=5, density=0.03)
    a_s[0, 4], a_r[0, 4], act[0, 4] = True, True, True
    a_s[0, 9], a_r[0, 9], act[0, 9] = True, True, False
    got, _ = _hold(a_s, a_r, act)
    has = (a_s[0].any(-1) | a_r[0].any(-1)) & act[0]
    assert got[0, 4] == has.sum() - 1
    assert got[0, 9] == 0


def test_design_all_inactive():
    a = np.ones((2, 40, 36), bool)
    got, _ = _hold(a, a, np.zeros((2, 40), bool))
    assert (got == 0).all()


def test_design_lanes_are_independent():
    """A (B, C, P) call equals B one-lane calls: the masks of one lane
    never reach another's rows."""
    a_s, a_r, act = _inputs(3, 70, 40, seed=8)
    whole, _ = _hold(a_s, a_r, act)
    for b in range(3):
        one, _ = emulate(a_s[b:b + 1], a_r[b:b + 1], act[b:b + 1])
        np.testing.assert_array_equal(whole[b:b + 1], one)


def test_design_word_ops_never_exceed_pairwise():
    """The port-major count does sum_c (|S_c| + |R_c|) x ceil(C/32) word
    ORs; with |S_c| + |R_c| <= 2P that is at most the pairwise
    C x C x 2 ceil(P/32) word ANDs, at any density."""
    for density in (0.02, 0.3, 1.0):
        a_s, a_r, act = _inputs(1, 200, 150, seed=1, density=density)
        ports = a_s[0].sum(-1) + a_r[0].sum(-1)
        port_major = int((ports * act[0]).sum()) * -(-200 // 32)
        assert port_major <= 200 * 200 * 2 * -(-150 // 32)
