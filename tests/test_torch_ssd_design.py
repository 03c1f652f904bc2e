"""The arithmetic of K4's CUDA design (the SSD chunked scan), emulated on
the CPU and held to the plain versions and the JAX package.

The kernel (`csrc/ssd_scan.cu`) cannot run here, so this file keeps a
plain emulation of its decomposition, on no path of the package:

* c b^T formed once per (batch, group, chunk), causal half only, and
  shared by every head of the group and every block of a head;
* blocks of DT columns of one head, each carrying its (DT, N) slice of
  the state across the chunks with nothing shared between blocks; a
  head width no multiple of DT leaves the last block's extra columns
  zero;
* per chunk the cumsum in the kernel's scan order (four steps a lane,
  then a Hillis-Steele scan over the 32 lanes), y as exp(cum) (c S^T)
  summed over k-panels of 32 state columns plus M x, the state update
  from b weighted by exp(cum_L - cum) dt; rows past L read as zeros
  (no padding copy).

Held against `ref.ssd_chunked_ref`, `ref.ssd_ref` and the Pallas kernel
in interpret mode at the reference's bar (atol 5e-4, rtol 1e-3), on the
shapes of tests/test_torch_ssd.py, with init_state chaining and G = 2.
The CUDA kernel is held to the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_ref

from tests.test_torch_ssd import SHAPES, TOL, J, T, close, inputs

# csrc/ssd_scan.cu: chunk rows held, k-panel rows, head columns a block
LCMAX, KP, DT = 128, 32, 64


def scan_cumsum(v):
    """The inclusive cumsum of 128 values as warp 0 takes it: lane l sums
    its four values in order, then a Hillis-Steele scan of the lane
    totals over 32 lanes, and each value adds its lane's exclusive
    prefix."""
    v = v.reshape(32, 4)
    local = torch.cumsum(v, 1)              # sequential within a lane
    incl = local[:, 3].clone()
    o = 1
    while o < 32:
        up = torch.cat([incl.new_zeros(o), incl[:-o]])
        incl = incl + up
        o *= 2
    return (incl - local[:, 3])[:, None] + local


def emulate(x, dt, a, b, c, *, init_state=None, lc=128):
    """K4's design in f32: x (B, L, H, Dh), dt (B, L, H), a (H,), b and
    c (B, L, G, N) -> (y, final state)."""
    f32 = torch.float32
    x, dt, a, b, c = (t.to(f32) for t in (x, dt, a, b, c))
    B, L, H, Dh = x.shape
    G, N = b.shape[2], b.shape[3]
    assert lc <= LCMAX and N <= 128
    nch = -(-L // lc)

    def rows(t, t0):        # the chunk's rows, zeros past L and lc
        out = t.new_zeros((LCMAX,) + t.shape[1:])
        n = max(0, min(lc, L - t0))
        out[:n] = t[t0:t0 + n]
        return out

    # c b^T once per (batch, group, chunk), causal half (u <= t < lc)
    tri = torch.tril(torch.ones(LCMAX, LCMAX, dtype=torch.bool))
    tri[lc:] = False
    gram = {}
    for bi in range(B):
        for g in range(G):
            for ch in range(nch):
                cc = rows(c[bi, :, g], ch * lc)
                bb = rows(b[bi, :, g], ch * lc)
                gram[bi, g, ch] = torch.where(tri, cc @ bb.T, 0.0)  # [t, u]
    y = torch.zeros(B, L, H, Dh, dtype=f32)
    s_fin = torch.zeros(B, H, Dh, N, dtype=f32)
    for bi in range(B):
        for h in range(H):
            g = h // (H // G)
            for d0 in range(0, Dh, DT):
                cols = slice(d0, min(Dh, d0 + DT))
                w_cols = cols.stop - d0
                S = torch.zeros(DT, N, dtype=f32)     # this block's slice
                if init_state is not None:
                    S[:w_cols] = init_state[bi, h, cols].to(f32)
                for ch in range(nch):
                    t0 = ch * lc
                    X = torch.zeros(LCMAX, DT, dtype=f32)
                    X[:, :w_cols] = rows(x[bi, :, h, cols], t0)
                    dtv = rows(dt[bi, :, h], t0)
                    cum = scan_cumsum(dtv * a[h]).reshape(-1)
                    cl = cum[lc - 1]
                    ecum, wv = torch.exp(cum), torch.exp(cl - cum) * dtv
                    cc = rows(c[bi, :, g], t0)
                    bb = rows(b[bi, :, g], t0)
                    acc = torch.zeros(LCMAX, DT, dtype=f32)
                    for n0 in range(0, N, KP):         # c S^T, k-panels
                        acc = acc + cc[:, n0:n0 + KP] @ S[:, n0:n0 + KP].T
                    acc = acc * ecum[:, None]
                    diff = torch.where(tri, cum[:, None] - cum[None, :], 0.)
                    m = torch.where(tri, gram[bi, g, ch] * torch.exp(diff)
                                    * dtv[None, :], 0.0)
                    for u0 in range(0, lc, KP):        # M x, k-panels
                        acc = acc + m[:, u0:u0 + KP] @ X[u0:u0 + KP]
                    n_rows = max(0, min(lc, L - t0))
                    y[bi, t0:t0 + n_rows, h, cols] = acc[:n_rows, :w_cols]
                    upd = torch.zeros(DT, N, dtype=f32)
                    for u0 in range(0, lc, KP):        # (x w)^T b
                        upd = upd + X[u0:u0 + KP].T @ (
                            bb[u0:u0 + KP] * wv[u0:u0 + KP, None])
                    S = torch.exp(cl) * S + upd
                assert not S[w_cols:].any()
                s_fin[bi, h, cols] = S[:w_cols]
    return y, s_fin


@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", SHAPES)
def test_design_matches_plain_and_pallas(B, L, H, G, Dh, N, lc):
    arrs = inputs(B, L, H, G, Dh, N, seed=L + H)
    got_y, got_s = emulate(*T(arrs), lc=lc)
    wants = [ssd_chunked_ref(*T(arrs), lc=lc), ssd_ref(*T(arrs)),
             jops.ssd_scan(*J(arrs), lc=lc, force="interpret")]
    for want_y, want_s in wants:
        close(got_y, want_y)
        close(got_s, want_s)


@pytest.mark.parametrize("Dh", [8, 40, 72])
def test_design_partial_column_slice(Dh):
    """Heads no multiple of DT = 64 wide: one partial block (8, 40
    columns) or a full block and a partial one (72), with a ragged last
    chunk and G = 2."""
    arrs = inputs(2, 150, 4, 2, Dh, 32, seed=Dh)
    got_y, got_s = emulate(*T(arrs), lc=64)
    want_y, want_s = jref.ssd_ref(*J(arrs))
    close(got_y, want_y)
    close(got_s, want_s)


@pytest.mark.parametrize("L,lc", [(1, 16), (37, 16), (300, 128)])
def test_design_reads_past_L_as_zeros(L, lc):
    """An L that is no multiple of lc, with no padding copy: the rows
    past L read as zeros give the sequential scan's y and state."""
    arrs = T(inputs(2, L, 4, 2, 16, 32, seed=L))
    y, s = emulate(*arrs, lc=lc)
    want_y, want_s = ssd_ref(*arrs)
    assert y.shape == want_y.shape
    close(y, want_y)
    close(s, want_s)


def test_design_state_chaining():
    """Two halves with the carried state == one full scan, and both ==
    the JAX package's sequential recurrence."""
    x, dt, a, b, c = T(inputs(1, 64, 2, 2, 16, 32, seed=5))
    y_full, s_full = emulate(x, dt, a, b, c, lc=16)
    y1, s1 = emulate(x[:, :32], dt[:, :32], a, b[:, :32], c[:, :32], lc=16)
    y2, s2 = emulate(x[:, 32:], dt[:, 32:], a, b[:, 32:], c[:, 32:],
                     init_state=s1, lc=16)
    close(torch.cat([y1, y2], 1), y_full, atol=1e-4, rtol=1e-3)
    close(s2, s_full, atol=1e-4, rtol=1e-3)
    want_y, want_s = jref.ssd_ref(*J([t.numpy() for t in (x, dt, a, b, c)]))
    close(y_full, want_y)
    close(s_full, want_s)


def test_design_init_state_matches_pallas():
    """A non-zero initial state through the design and the Pallas
    kernel in interpret mode."""
    arrs = inputs(2, 64, 4, 2, 16, 32, seed=13)
    s0 = np.random.default_rng(14).normal(size=(2, 4, 16, 32)).astype(
        np.float32)
    got_y, got_s = emulate(*T(arrs), init_state=torch.from_numpy(s0), lc=32)
    want_y, want_s = jops.ssd_scan(*J(arrs), init_state=jnp.asarray(s0),
                                   lc=32, force="interpret")
    close(got_y, want_y)
    close(got_s, want_s)


def test_design_scan_cumsum_order():
    """The warp scan's cumsum equals the sequential one to float
    rounding, and exactly on values whose sums are exact."""
    v = torch.arange(128, dtype=torch.float32) * 0.5
    assert torch.equal(scan_cumsum(v).reshape(-1), torch.cumsum(v, 0))
    w = -torch.from_numpy(np.random.default_rng(2).uniform(
        0.01, 0.6, 128).astype(np.float32))
    torch.testing.assert_close(scan_cumsum(w).reshape(-1),
                               torch.cumsum(w, 0), atol=1e-5, rtol=1e-6)


def test_design_mask_before_exp():
    """Large |a| dt: the decay is formed only for u <= t, so nothing
    overflows into inf * 0."""
    arrs = inputs(1, 64, 2, 1, 8, 16, seed=9, a_range=(20.0, 60.0),
                  dt_range=(1.0, 5.0))
    y, s = emulate(*T(arrs), lc=32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    want_y, want_s = jref.ssd_ref(*J(arrs))
    close(y, want_y)
    close(s, want_s)
