"""The port's SSD scan plain versions against the JAX package.

`repro_torch.kernels.ref.ssd_ref` (the sequential recurrence) and
`ssd_chunked_ref` (the chunked scan that kernel K4 computes on the card,
and what `ops.ssd_scan` runs on a CPU tensor) are held against the JAX
package's `ref.ssd_ref` and its Pallas kernel run in interpret mode, on
the shapes of `tests/test_kernels.py`, at the reference's own bar (atol
5e-4, rtol 1e-3). The same inputs, made from a seed with numpy, go to
both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_ref

TOL = dict(atol=5e-4, rtol=1e-3)
SHAPES = [(1, 16, 1, 1, 8, 8, 8), (2, 64, 4, 2, 16, 32, 16),
          (1, 128, 2, 1, 32, 64, 64), (1, 256, 8, 2, 64, 128, 128)]


def inputs(B, L, H, G, Dh, N, *, seed, a_range=(0.3, 2.0),
           dt_range=(0.01, 0.3)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, H, Dh)).astype(np.float32),
            rng.uniform(*dt_range, size=(B, L, H)).astype(np.float32),
            (-rng.uniform(*a_range, size=H)).astype(np.float32),
            rng.normal(size=(B, L, G, N)).astype(np.float32),
            rng.normal(size=(B, L, G, N)).astype(np.float32))


def T(arrs):
    return [torch.from_numpy(a) for a in arrs]


def J(arrs):
    return [jnp.asarray(a) for a in arrs]


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", SHAPES)
def test_ssd_plain_versions_match_jax(B, L, H, G, Dh, N, lc):
    arrs = inputs(B, L, H, G, Dh, N, seed=L + H)
    want_y, want_s = jref.ssd_ref(*J(arrs))
    pal_y, pal_s = jops.ssd_scan(*J(arrs), lc=lc, force="interpret")
    for got_y, got_s in (ssd_ref(*T(arrs)),
                         ssd_chunked_ref(*T(arrs), lc=lc),
                         ops.ssd_scan(*T(arrs), lc=lc)):
        for wy, ws in ((want_y, want_s), (pal_y, pal_s)):
            close(got_y, wy)
            close(got_s, ws)


def test_ssd_state_chaining():
    """Two halves with the carried state == one full scan (the decode /
    multi-step serving contract of `tests/test_kernels.py`)."""
    arrs = T(inputs(1, 64, 2, 1, 16, 32, seed=5))
    x, dt, a, b, c = arrs
    y_full, s_full = ops.ssd_scan(x, dt, a, b, c, lc=16)
    y1, s1 = ops.ssd_scan(x[:, :32], dt[:, :32], a, b[:, :32], c[:, :32],
                          lc=16)
    y2, s2 = ops.ssd_scan(x[:, 32:], dt[:, 32:], a, b[:, 32:], c[:, 32:],
                          init_state=s1, lc=16)
    close(torch.cat([y1, y2], 1), y_full, atol=1e-4, rtol=1e-3)
    close(s2, s_full, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("L,lc", [(1, 16), (37, 16), (300, 128)])
def test_ssd_padding_matches_sequential(L, lc):
    """An L that is not a multiple of lc: the zero pad (dt = 0) leaves y
    and the final state those of the unpadded sequential scan."""
    arrs = T(inputs(2, L, 4, 2, 16, 32, seed=L))
    y, s = ops.ssd_scan(*arrs, lc=lc)
    want_y, want_s = ssd_ref(*arrs)
    assert y.shape == want_y.shape
    close(y, want_y)
    close(s, want_s)


def test_ssd_mask_before_exp():
    """Large |a| dt: cum_t - cum_u above the diagonal reaches ~+1e3, whose
    exp overflows; masking the argument first keeps every value finite
    and equal to the sequential recurrence."""
    arrs = inputs(1, 64, 2, 1, 8, 16, seed=9, a_range=(20.0, 60.0),
                  dt_range=(1.0, 5.0))
    y, s = ssd_chunked_ref(*T(arrs), lc=32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    want_y, want_s = jref.ssd_ref(*J(arrs))
    close(y, want_y)
    close(s, want_s)
