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
  on no path of the package: each chunk's state and state-gradient
  updates, then the state pass; G once per (batch, chunk, group) with
  its strictly upper quarter left unformed (NaN, so a read would show),
  dM likewise; the resident-operand products over k-panels with their
  causal row groups skipped; each group's heads in splits of a given
  size (one head, or a split that does not divide them), dG B and dG^T C
  once per split from its heads' dG sum and X dS stacked over its heads,
  the splits' db and dc summed in split order; da's partials summed in
  (batch, chunk) order. Held to the plain backward and to `jax.vjp` of
  the JAX package's `ssd_chunked_jnp`.
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
# csrc/ssd_scan_bwd.cu: the rows of a tile, the k rows of a panel and the
# rows of a thread's row group in the resident-operand products
LC, KP, RG = 128, 16, 4


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


def _panels_live(K, rule):
    """The k-panels of KP rows of a resident-operand product and, for each,
    which output rows take part: rule "k>=row" (a row group of RG rows
    skips a panel whose last k is before its first row) or "k<=row" (one
    whose first k is past its last row)."""
    rows = torch.arange(LC)
    grp = rows - rows % RG
    for k0 in range(0, K, KP):
        if rule == "k>=row":
            yield k0, grp <= k0 + KP - 1
        else:
            yield k0, grp + RG - 1 >= k0


def emulate_k8(x, dt, a, b, c, dy, *, lc, hs):
    """K8's four launches in f32: (dx, ddt, da, db, dc). Chunks padded to
    LC rows as the kernel's tiles are; the strictly upper quarter of G
    and dM left unformed (G's reads as NaN: the kernel never writes it,
    and a read of it would show); the resident-operand products over
    k-panels with their causal row groups skipped; each group's heads
    in splits of `hs` heads, dG B and dG^T C
    once per split from the split's dG sum, X dS stacked over its heads,
    the splits summed in split order; da's partials in (batch, chunk)
    order."""
    f32 = torch.float32
    B, L, H, Dh = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    nch = -(-L // lc)
    nsp = -(-rep // hs)
    F = torch.nn.functional

    def chunks(t):   # (B, L, ...) -> (B, nch, LC, ...), zeros past L, lc
        t = F.pad(t.to(f32), (0,) * (2 * (t.dim() - 2)) + (0, nch * lc - L))
        t = t.reshape((B, nch, lc) + t.shape[2:])
        return F.pad(t, (0,) * (2 * (t.dim() - 3)) + (0, LC - lc))

    xc, yc, bc, cc, dtc = (chunks(t) for t in (x, dy, b, c, dt))
    af = a.to(f32)
    rows = torch.arange(LC)
    cum = torch.cumsum(dtc * af, dim=2)                  # (B, nch, LC, H)
    cl = cum[:, :, lc - 1]                               # (B, nch, H)
    inlc = (rows < lc)[None, None, :, None]
    e = torch.where(inlc, torch.exp(cum), 0.0)
    w = torch.where(inlc, torch.exp(cl[:, :, None] - cum) * dtc, 0.0)
    gi = torch.arange(H) // rep

    # launch 1: each chunk's state update and state-gradient update; G
    upd = torch.einsum("bkuhd,bkuhn->bkhdn", xc * w[..., None], bc[:, :, :, gi])
    dupd = torch.einsum("bkthd,bkthn->bkhdn", yc * e[..., None],
                        cc[:, :, :, gi])
    gram = torch.einsum("bktgn,bkugn->bkgtu", cc, bc)
    gram[..., :LC // 2, LC // 2:] = float("nan")
    # launch 2: the state pass
    S, dS = torch.empty_like(upd), torch.empty_like(dupd)
    st = torch.zeros_like(upd[:, 0])
    for k in range(nch):
        S[:, k] = st
        st = torch.exp(cl[:, k])[..., None, None] * st + upd[:, k]
    st = torch.zeros_like(dupd[:, 0])
    for k in reversed(range(nch)):
        dS[:, k] = st
        st = torch.exp(cl[:, k])[..., None, None] * st + dupd[:, k]

    # launch 3
    nv = torch.tensor([min(lc, L - k * lc) for k in range(nch)])
    on = (rows[:, None] >= rows[None, :])[None] & \
        (rows[None, :] < nv[:, None])[:, :, None]        # (nch, t, u)
    on = on[None]
    dx = torch.zeros(B, nch, LC, H, Dh)
    ddt = torch.zeros(B, nch, LC, H)
    dap = torch.zeros(B, nch, H)
    dbp = torch.zeros(nsp, B, nch, LC, G, N)
    dcp = torch.zeros(nsp, B, nch, LC, G, N)
    half = LC // 2
    for g in range(G):
        for sp in range(nsp):
            heads = range(g * rep + sp * hs, min(g * rep + (sp + 1) * hs,
                                                (g + 1) * rep))
            gt = torch.where(on, gram[:, :, g], 0.0)
            dgs = torch.zeros(B, nch, LC, LC)
            dcs = torch.zeros(B, nch, LC, N)
            d1, dirv, dw = {}, {}, {}
            for h in heads:
                dm = torch.zeros(B, nch, LC, LC)
                for r0, c0 in ((0, 0), (half, 0), (half, half)):
                    dm[:, :, r0:r0 + half, c0:c0 + half] = torch.einsum(
                        "bktd,bkud->bktu", yc[:, :, r0:r0 + half, h],
                        xc[:, :, c0:c0 + half, h])
                ch = cum[..., h]
                lv = torch.where(on, torch.exp(torch.where(
                    on, ch[..., :, None] - ch[..., None, :], 0.0)), 0.0)
                dm = torch.where(on, dm, 0.0)
                m = gt * lv * dtc[:, :, None, :, h]
                dgs = dgs + dm * lv * dtc[:, :, None, :, h]
                p = dm * m
                d1[h] = p.sum(3) - p.sum(2)
                dirv[h] = (dm * gt * lv).sum(2)
                bds = torch.einsum("bkun,bkdn->bkud", bc[:, :, :, g],
                                   dS[:, :, h])
                dw[h] = (xc[:, :, :, h] * bds).sum(-1)
                acc = w[..., h, None] * bds
                for k0, live in _panels_live(LC, "k>=row"):
                    acc = acc + torch.where(live[:, None], torch.einsum(
                        "bktu,bktd->bkud", m[:, :, k0:k0 + KP],
                        yc[:, :, k0:k0 + KP, h]), 0.0)
                dx[:, :, :, h] = acc
            for h in heads:
                dys = torch.einsum("bktd,bkdn->bktn",
                                   yc[:, :, :, h] * e[..., h, None],
                                   S[:, :, h])
                eterm = (cc[:, :, :, g] * dys).sum(-1)
                dcs = dcs + dys
                dsdot = (dS[:, :, h] * S[:, :, h]).sum((-2, -1))
                dww = dw[h] * w[..., h]
                dcum = torch.where(rows < lc, d1[h] + eterm - dww, 0.0)
                dcum[:, :, lc - 1] += dww.sum(-1) + torch.exp(cl[..., h]) \
                    * dsdot
                ddta = dcum.flip(-1).cumsum(-1).flip(-1)   # d(dt a)
                ddt[:, :, :, h] = dirv[h] + dw[h] * torch.exp(
                    cl[..., h, None] - cum[..., h]) + af[h] * ddta
                dap[:, :, h] = (dtc[..., h] * ddta).sum(-1)
            dC, dB = dcs, torch.zeros(B, nch, LC, N)
            for k0, live in _panels_live(LC, "k<=row"):
                dC = dC + torch.where(live[:, None], torch.einsum(
                    "bktu,bkun->bktn", dgs[:, :, :, k0:k0 + KP],
                    bc[:, :, k0:k0 + KP, g]), 0.0)
            for k0, live in _panels_live(LC, "k>=row"):
                dB = dB + torch.where(live[:, None], torch.einsum(
                    "bktu,bktn->bkun", dgs[:, :, k0:k0 + KP],
                    cc[:, :, k0:k0 + KP, g]), 0.0)
            for h in heads:   # the heads' X dS, stacked
                dB = dB + torch.einsum("bkud,bkdn->bkun",
                                       xc[:, :, :, h] * w[..., h, None],
                                       dS[:, :, h])
            dbp[sp, :, :, :, g] = dB
            dcp[sp, :, :, :, g] = dC
    # launch 4
    dbs, dcs = dbp[0], dcp[0]
    for sp in range(1, nsp):
        dbs, dcs = dbs + dbp[sp], dcs + dcp[sp]
    da = torch.zeros(H)
    for bi in range(B):
        for k in range(nch):
            da = da + dap[bi, k]

    def back(t):   # (B, nch, LC, ...) -> (B, L, ...)
        return t[:, :, :lc].reshape((B, nch * lc) + t.shape[3:])[:, :L]

    return (back(dx).to(x.dtype), back(ddt).to(dt.dtype), da,
            back(dbs).to(b.dtype), back(dcs).to(c.dtype))


def _jax_vjp(arrs, dy, lc):
    jx = [jnp.asarray(t) for t in arrs]
    _, vjp = jax.vjp(lambda *t: ssd_chunked_jnp(*t, lc=lc)[0], *jx)
    return vjp(jnp.asarray(dy))


@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", CASES + [
    (1, 64, 2, 1, 48, 16, 32), (1, 20, 2, 2, 8, 4, 128),
    (2, 150, 4, 1, 16, 16, 64)])
def test_k8_design_matches_the_plain_backward(B, L, H, G, Dh, N, lc):
    """Also Dh = 48 (a part-filled dX tile), a chunk longer than L, and
    N = 16 with a ragged last chunk and lc < 128. One head a block: the
    kernel library's split at these small shapes (the card test
    `test_ssd_bwd_split_rule_at_the_train_shapes` reads its rule). Held
    to the plain backward and to `jax.vjp` of the JAX package's scan."""
    arrs, dy = _arrays(B, L, H, G, Dh, N, seed=L + 11)
    ts, tdy = _torch(arrs, dy, torch.float32)
    want = ssd_chunked_bwd_ref(*ts, tdy, lc=lc)
    got = emulate_k8(*ts, tdy, lc=lc, hs=1)
    for name, g, w, j in zip(NAMES, got, want, _jax_vjp(arrs, dy, lc)):
        assert g.shape == w.shape, name
        _close(g, w, 1e-4, 1e-5, name)
        _close(g, j, 1e-4, 1e-5, name + " (jax.vjp)")


# (B, L, H, G, Dh, N, lc, heads a block): splits that do not divide a
# group's heads (3 = 2 + 1, 8 = 3 + 3 + 2, 7 = 4 + 3), N = 16, ragged
# last chunks, lc < 128; then one split a group, one head a split, and
# splits of 8 heads (Mamba2-1.3B's train shape gets 8, Jamba's 2)
SPLITS = [(2, 150, 6, 2, 16, 32, 64, 2), (1, 300, 8, 1, 16, 16, 128, 3),
          (1, 200, 14, 2, 32, 16, 64, 4), (2, 100, 4, 1, 16, 16, 32, 4),
          (1, 90, 3, 1, 72, 8, 128, 1), (1, 160, 16, 1, 16, 32, 64, 8)]


@pytest.mark.parametrize("B,L,H,G,Dh,N,lc,hs", SPLITS)
def test_k8_design_head_splits(B, L, H, G, Dh, N, lc, hs):
    """Each group's heads in splits of `hs`, the splits' db and dc summed
    in split order: held to the plain backward and to `jax.vjp`."""
    arrs, dy = _arrays(B, L, H, G, Dh, N, seed=L + 13)
    ts, tdy = _torch(arrs, dy, torch.float32)
    want = ssd_chunked_bwd_ref(*ts, tdy, lc=lc)
    got = emulate_k8(*ts, tdy, lc=lc, hs=hs)
    for name, g, w, j in zip(NAMES, got, want, _jax_vjp(arrs, dy, lc)):
        _close(g, w, 1e-4, 1e-5, name)
        _close(g, j, 1e-4, 1e-5, name + " (jax.vjp)")


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
