"""The SSD scan's backward: the plain version, K8's decomposition and the
autograd function, on the CPU.

* `ref.ssd_chunked_bwd_ref` (the gradient written out) against
  `jax.vjp` of the JAX package's `ssd_chunked_jnp` and against
  `torch.autograd.grad` through the port's own forward
  `ssd_chunked_ref`, on the shapes of `tests/test_torch_ssd.py`, an L
  that is no multiple of lc and G > 1: f32 to rtol 1e-4 plus 1e-5 of
  each gradient's largest magnitude (sums in another order); bf16
  inputs (the gradients rounded to bf16 on both sides) to 2e-2 of the
  largest.
* K8's decomposition (`csrc/ssd_scan_bwd.cu`), emulated in plain torch
  on no path of the package: the chunk-start states and their
  gradients swept in DS-row slices, each chunk's gradients from G and dM
  over the whole lc x lc square with the dcum terms summed as the
  kernel sums them, db and dc per head then summed over each group's
  heads in head order, da's partials per (batch, chunk, head) summed in
  (batch, chunk) order. Held to the plain backward.
* `models.mamba.SSDScan` / `scan`: the gradients autograd hands back
  are the plain backward's, bit for bit.
* The repair: `ops.ssd_scan` and `ops.flash_attention` refuse a CUDA
  call that autograd would record (an input requiring a gradient, grad
  mode on), and pass inside an autograd function's forward; shown with
  the dispatch monkeypatched to a stub kernel.

K8 itself is held to the plain backward on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase 31).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import ssd_chunked_jnp
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import (flash_attention_ref,
                                     ssd_chunked_bwd_ref, ssd_chunked_ref)
from repro_torch.models import attention, mamba

from tests.test_torch_ssd import SHAPES, inputs

# (B, L, H, G, Dh, N, lc): test_torch_ssd's sweep, then L no multiple
# of lc (one chunk and a ragged one; several chunks and a ragged one)
CASES = SHAPES + [(2, 37, 4, 2, 16, 32, 16), (1, 300, 4, 1, 16, 16, 128)]
NAMES = ("dx", "ddt", "da", "db", "dc")
# csrc/ssd_scan_bwd.cu: state rows a sweep block owns
DS = 32


def _arrays(B, L, H, G, Dh, N, seed):
    arrs = inputs(B, L, H, G, Dh, N, seed=seed)
    dy = np.random.default_rng(seed + 1).normal(
        size=(B, L, H, Dh)).astype(np.float32)
    return arrs, dy


def _close(got, want, rtol, scale, what):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()),
                               err_msg=what)


def _torch(arrs, dy, dtype):
    ts = [torch.from_numpy(a) for a in arrs]
    ts = [t if i == 2 else t.to(dtype) for i, t in enumerate(ts)]
    return ts, torch.from_numpy(dy).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", CASES)
def test_plain_backward_matches_jax_vjp(B, L, H, G, Dh, N, lc, dtype):
    arrs, dy = _arrays(B, L, H, G, Dh, N, seed=L + H)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = [jnp.asarray(a) if i == 2 else jnp.asarray(a, jdt)
          for i, a in enumerate(arrs)]
    _, vjp = jax.vjp(lambda *t: ssd_chunked_jnp(*t, lc=lc)[0], *jx)
    want = vjp(jnp.asarray(dy, jdt))
    ts, tdy = _torch(arrs, dy, getattr(torch, dtype))
    got = ssd_chunked_bwd_ref(*ts, tdy, lc=lc)
    for name, g, w, t in zip(NAMES, got, want, ts):
        assert g.shape == tuple(w.shape) and g.dtype == t.dtype, name
        if dtype == "float32":
            _close(g, w, 1e-4, 1e-5, name)
        else:
            _close(g, np.asarray(w, np.float32), 0.0, 2e-2, name)


@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", CASES)
def test_plain_backward_matches_autograd(B, L, H, G, Dh, N, lc):
    arrs, dy = _arrays(B, L, H, G, Dh, N, seed=L + 7)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, _ = ssd_chunked_ref(*ts, lc=lc)
    want = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    got = ssd_chunked_bwd_ref(*(t.detach() for t in ts),
                              torch.from_numpy(dy), lc=lc)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, 1e-4, 1e-5, name)


def _sweep(p, q, coef, decay, nch, lc, reverse):
    """The sweep kernel in DS-row slices: out[k] = the value at chunk
    k's boundary (before its update); acc = decay_k acc + sum_u coef_u
    p_u q_u^T. p (B, Lp, H, Dh), q (B, Lp, H, N), coef (B, Lp, H),
    decay (B, nch, H)."""
    B, _, H, Dh = p.shape
    N = q.shape[3]
    out = p.new_zeros(B, nch, H, Dh, N)
    for d0 in range(0, Dh, DS):
        acc = p.new_zeros(B, H, min(DS, Dh - d0), N)
        for k in (reversed(range(nch)) if reverse else range(nch)):
            out[:, k, :, d0:d0 + DS] = acc
            sl = slice(k * lc, (k + 1) * lc)
            pw = p[:, sl, :, d0:d0 + DS] * coef[:, sl, :, None]
            acc = decay[:, k, :, None, None] * acc + torch.einsum(
                "buhd,buhn->bhdn", pw, q[:, sl])
    return out


def emulate_k8(x, dt, a, b, c, dy, *, lc):
    """K8's four launches in f32: (dx, ddt, da, db, dc)."""
    f32 = torch.float32
    B, L, H, Dh = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    nch = -(-L // lc)
    pad = nch * lc - L

    def rows(t):   # rows past L read as zeros
        return torch.nn.functional.pad(t.to(f32), (0,) * (2 * t.dim() - 4)
                                       + (0, pad))

    xf, dyf, dtf = rows(x), rows(dy), rows(dt)
    bh = rows(b).repeat_interleave(rep, dim=2)
    ch = rows(c).repeat_interleave(rep, dim=2)
    af = a.to(f32)
    dta = (dtf * af).view(B, nch, lc, H)
    cum = torch.cumsum(dta, dim=2)                       # (B, nch, lc, H)
    cl = cum[:, :, -1]                                   # (B, nch, H)
    e = torch.exp(cum)
    w = torch.exp(cl[:, :, None] - cum) * dtf.view(B, nch, lc, H)
    S = _sweep(xf, bh, w.reshape(B, -1, H), torch.exp(cl), nch, lc, False)
    dS = _sweep(dyf, ch, e.reshape(B, -1, H), torch.exp(cl), nch, lc, True)

    def chunks(t):
        return t.view((B, nch, lc) + t.shape[2:])

    xc, dyc, bc, cc = chunks(xf), chunks(dyf), chunks(bh), chunks(ch)
    dtc = chunks(dtf)
    tri = torch.tril(torch.ones(lc, lc, dtype=torch.bool))[None, None, :,
                                                           :, None]
    lv = torch.where(tri, torch.exp(torch.where(
        tri, cum[:, :, :, None] - cum[:, :, None], 0.0)), 0.0)
    gm = torch.einsum("bkthn,bkuhn->bktuh", cc, bc)      # each head's G
    dm = torch.where(tri, torch.einsum("bkthd,bkuhd->bktuh", dyc, xc), 0.0)
    m = gm * lv * dtc[:, :, None]
    dg = dm * lv * dtc[:, :, None]
    p = dm * m
    bds = torch.einsum("bkuhn,bkhdn->bkuhd", bc, dS)
    dys = torch.einsum("bkthd,bkhdn->bkthn", dyc, S)
    dx = torch.einsum("bktuh,bkthd->bkuhd", m, dyc) + w[..., None] * bds
    dch = torch.einsum("bktuh,bkuhn->bkthn", dg, bc) + e[..., None] * dys
    dbh = (torch.einsum("bktuh,bkthn->bkuhn", dg, cc)
           + w[..., None] * torch.einsum("bkuhd,bkhdn->bkuhn", xc, dS))
    dw = (xc * bds).sum(-1)
    eterm = e * (cc * dys).sum(-1)
    dcum = p.sum(3) - p.sum(2) + eterm - dw * w
    dcum[:, :, -1] += (dw * w).sum(2) + torch.exp(cl) * (dS * S).sum((-2, -1))
    # one thread's reverse cumsum, row by row from the chunk's last
    run = torch.zeros_like(dcum[:, :, 0])
    ddta = torch.empty_like(dcum)
    for u in reversed(range(lc)):
        run = run + dcum[:, :, u]
        ddta[:, :, u] = run
    ddt = (dm * gm * lv).sum(2) + dw * torch.exp(cl[:, :, None] - cum) \
        + af * ddta
    dap = (dtc * ddta).sum(2)                            # (B, nch, H)
    da = torch.zeros(H)
    for bi in range(B):                                  # (batch, chunk)
        for k in range(nch):
            da = da + dap[bi, k]

    def heads(t):   # head order within each group
        t = t.reshape(B, nch * lc, G, rep, N)[:, :L]
        out = t[:, :, :, 0]
        for r in range(1, rep):
            out = out + t[:, :, :, r]
        return out

    return (dx.reshape(B, -1, H, Dh)[:, :L].to(x.dtype),
            ddt.reshape(B, -1, H)[:, :L].to(dt.dtype), da,
            heads(dbh).to(b.dtype), heads(dch).to(c.dtype))


@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", CASES + [
    (1, 64, 2, 1, 48, 16, 32), (1, 20, 2, 2, 8, 4, 128)])
def test_k8_design_matches_the_plain_backward(B, L, H, G, Dh, N, lc):
    """Also a Dh no multiple of DS (two slices, the last short) and a
    chunk longer than L."""
    arrs, dy = _arrays(B, L, H, G, Dh, N, seed=L + 11)
    ts, tdy = _torch(arrs, dy, torch.float32)
    want = ssd_chunked_bwd_ref(*ts, tdy, lc=lc)
    got = emulate_k8(*ts, tdy, lc=lc)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _close(g, w, 1e-4, 1e-5, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_function_gradients_are_the_plain_backward(dtype):
    arrs, dy = _arrays(2, 150, 4, 2, 16, 32, seed=3)
    ts, tdy = _torch(arrs, dy, dtype)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    y, fin = mamba.scan(*leaves, lc=64)
    assert fin is None and y.dtype == dtype
    want_y, _ = ssd_chunked_ref(*ts, lc=64)
    assert torch.equal(y, want_y)
    got = torch.autograd.grad(y, leaves, tdy)
    want = ssd_chunked_bwd_ref(*ts, tdy, lc=64)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


def test_scan_without_grad_is_the_plain_call_and_refuses_a_state():
    ts, _ = _torch(*_arrays(1, 40, 2, 1, 8, 8, seed=4), torch.float32)
    s0 = torch.ones(1, 2, 8, 8)
    y, fin = mamba.scan(*ts, init_state=s0, lc=16)
    want = ops.ssd_scan(*ts, init_state=s0, lc=16)
    assert torch.equal(y, want[0]) and torch.equal(fin, want[1])
    leaves = [t.requires_grad_(True) for t in ts]
    with pytest.raises(ValueError, match="zero state"):
        mamba.scan(*leaves, init_state=s0, lc=16)
    with pytest.raises(ValueError, match="no initial state"):
        ops.ssd_scan_bwd(*ts, torch.zeros(1, 40, 2, 8), init_state=s0)


def test_kernel_calls_that_autograd_would_record_raise(monkeypatch):
    """With the dispatch sent to a stub kernel (as a CUDA tensor would
    be), a call whose input requires a gradient raises while grad mode
    is on; without a gradient, under no_grad and inside `SSDScan` and
    `FlashAttention` (whose forwards run with grad mode off) it passes."""
    calls = []

    def stub_scan(x, dt, a, b, c, *, init_state=None, lc=128):
        calls.append("ssd_scan")
        return ssd_chunked_ref(x, dt, a, b, c, init_state=init_state, lc=lc)

    def stub_attention(q, k, v, *, causal=True, q_offset=0):
        calls.append("flash_attention")
        return flash_attention_ref(q, k, v, causal=causal,
                                   q_offset=q_offset)

    monkeypatch.setattr(ops, "_use_kernel", lambda t, force: force is None)
    monkeypatch.setattr(_ssd, "ssd_scan_cuda", stub_scan)
    monkeypatch.setattr(_flash, "flash_attention_cuda", stub_attention)
    ts, _ = _torch(*_arrays(1, 32, 2, 1, 8, 8, seed=5), torch.float32)
    q = torch.randn(1, 2, 16, 16, generator=torch.Generator().manual_seed(0))

    ops.ssd_scan(*ts, lc=16)
    ops.flash_attention(q, q, q)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    ql = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="records no gradient"):
        ops.ssd_scan(*leaves, lc=16)
    with pytest.raises(RuntimeError, match="records no gradient"):
        ops.flash_attention(ql, q, q)
    with torch.no_grad():
        ops.ssd_scan(*leaves, lc=16)
        ops.flash_attention(ql, q, q)
    assert calls == ["ssd_scan", "flash_attention"] * 2
    calls.clear()
    y, _ = mamba.scan(*leaves, lc=16)
    o = attention.attend(ql, q, q)
    assert y.grad_fn is not None and o.grad_fn is not None
    assert calls == ["ssd_scan", "flash_attention"]
