"""Plain PyTorch versions of the port's kernels.

The CPU path of `kernels.ops` runs these, and `chip_smoke.py` holds each
CUDA kernel against them on the card (`force="ref"`). They repeat the
kernels' arithmetic op for op, so on the same inputs the results are
equal bit for bit; they are no yardstick of speed.

* `contention_ref` is the counterpart of `repro.kernels.ref.contention_ref`
  with a leading batch axis.
* `tick_walk_ref` is the sequential part of the coordinator tick that
  XLA ran as `while_loop`s in `repro.core.jax_coordinator.tick_core`:
  the all-or-none MADD admission and the work-conservation fill, over
  W = 2P + 2Lf capacity columns (ports, then the leaf-spine uplinks and
  downlinks). It is a Python loop over the compacted priority list
  (vectorized across the batch lanes), reading the loop bounds on the
  host.
* `maxmin_ref` is `repro.kernels.ref.maxmin_ref` (max-min fair rates by
  progressive filling) in index form with a leading batch axis: each
  flow names its rows instead of owning a one-hot column.
* `ssd_ref` is `repro.kernels.ref.ssd_ref`, the Mamba-2 SSD sequential
  recurrence (the oracle), and `ssd_chunked_ref` is
  `repro.models.mamba.ssd_chunked_jnp`, the chunked SSD scan that the
  SSD kernel (K4) computes, padding included. Unlike the other plain
  versions these two do not repeat the kernel op for op: the kernel sums
  in its own order, so they agree to a float tolerance, not bit for bit.
  `ssd_chunked_bwd_ref` is the gradient of `ssd_chunked_ref` written out
  (what `jax.value_and_grad` derives from `ssd_chunked_jnp`), which the
  SSD scan's backward (K8) computes, likewise to a tolerance.
* `attention_ref` is `repro.kernels.ref.attention_ref` (GQA attention
  with a materialized softmax, causal mask aligned bottom-right), and
  `flash_attention_ref` is the online-softmax form of
  `repro.models.attention.jnp_flash` under the contract of the Pallas
  kernel `flash_attention_pallas` (causal mask aligned top-left and
  shifted by `q_offset`, scale on the f32 scores), which the attention
  kernel (K5) computes. The two agree where S == T or q_offset == T - S.
  Like the SSD versions they agree with the kernel to a float tolerance.
* `prefix_sum_ref` is `jnp.cumsum` over each row as XLA's CPU backend
  computes it (a recursive scan in blocks of 16), written as explicit
  adds, with the leading zero column of the engine's segment sums; the
  prefix-sum kernel (K6) repeats it add for add.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BIG = 1e30   # the MADD "port not used" sentinel (f32-representable)


def contention_ref(a_send: torch.Tensor, a_recv: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
    """(B, C, P) {0,1} incidence x2 + (B, C) active -> (B, C) int32:
    for each active coflow, the number of OTHER active coflows sharing at
    least one sender or receiver port with it; 0 when inactive."""
    act = active.to(torch.float32).unsqueeze(-1)
    a_s = a_send.to(torch.float32) * act
    a_r = a_recv.to(torch.float32) * act
    share = a_s @ a_s.transpose(-1, -2) + a_r @ a_r.transpose(-1, -2)
    blocks = share > 0.5
    k = blocks.sum(-1) - torch.diagonal(blocks, dim1=-2, dim2=-1).long()
    return torch.where(active, k, 0).to(torch.int32)


class WalkFlows(NamedTuple):
    """Per-flow inputs of the flow-granular work-conservation fill.
    Flows are stored contiguous per coflow: every flow f with cid[f] = c
    lies in [flow_lo[c], flow_hi[c]) (the `traces.batch` layout)."""
    cid: torch.Tensor      # (B, F) int64 owning coflow
    src: torch.Tensor      # (B, F) int64 sender port
    dst: torch.Tensor      # (B, F) int64 receiver port
    live: torch.Tensor     # (B, F) bool
    flow_lo: torch.Tensor  # (B, C) int64 segment start
    flow_hi: torch.Tensor  # (B, C) int64 segment end
    # leaf-spine link ids (None = big switch): the leaf in [0, Lf], with
    # Lf the "touches no shared link" sentinel (TraceBatch.link_up/_dn)
    up: Optional[torch.Tensor] = None   # (B, F) int64
    dn: Optional[torch.Tensor] = None   # (B, F) int64


def _madd(avail, inv, bigm, rows, c):
    """Each lane's MADD equal rate for coflow c: min over the W
    columns of avail * (1 / cnt) (+ BIG where the coflow has no flow)."""
    return (avail * inv[rows, c] + bigm[rows, c]).amin(-1)


def _spend(avail, r, cnt):
    """Admission's `avail - r * cnt`, the product rounded to f32 first,
    as K2 does (the reference's CPU backend fuses it into one FMA:
    ROADMAP C10, C12)."""
    return avail - r * cnt


def tick_walk_ref(order: torch.Tensor, n_live: torch.Tensor,
                  cnt: torch.Tensor, avail0: torch.Tensor,
                  min_rate: torch.Tensor, wc: torch.Tensor,
                  flows: Optional[WalkFlows] = None, *,
                  num_links: int = 0, admit_only: bool = False):
    """The coordinator's sequential walks, lane by lane in lock step.

    order (B, C) int64 priority permutation whose first n_live[b] entries
    are the coflows with live ports; cnt (B, C, W) f32 live-flow counts
    and avail0 (B, W) f32 capacities over W = 2P + 2Lf columns [senders
    | receivers | uplinks | downlinks] (Lf = `num_links`, 0 on the big
    switch); min_rate (B,) f32 admission floor; wc (B,) f32 work-
    conservation gate (> 0 = on). Returns (rate, admitted, wc_rate,
    wc_flow, avail): `avail` (B, W) is the capacity left after
    admission. With `admit_only` the walk stops there (the max-min fill
    runs next, `wc_rate` zero, `wc_flow` None); else with `flows` the
    per-flow greedy fill (`wc_rate` all zero, as in the reference),
    without it the coflow-granular fill (`wc_flow` None).
    """
    B, C, W = cnt.shape
    dev = cnt.device
    rows = torch.arange(B, device=dev)
    has = cnt > 0
    inv = torch.where(has, 1.0 / cnt.clamp(min=1e-9), 0.0)
    bigm = torch.where(has, 0.0, BIG)
    n_live = n_live.long()
    avail = avail0.clone()
    rate = torch.zeros(B, C, dtype=torch.float32, device=dev)
    admitted = torch.zeros(B, C, dtype=torch.bool, device=dev)

    # D1/D2 all-or-none admission with MADD equal rates
    # (jax_coordinator.py:311-322)
    for k in range(int(n_live.max()) if B else 0):
        on = k < n_live
        c = order[:, k]
        r = _madd(avail, inv, bigm, rows, c)
        ok = on & (r >= min_rate) & (r < BIG)
        r = torch.where(ok, r, 0.0)
        avail = _spend(avail, r[:, None], cnt[rows, c])
        rate[rows, c] = torch.where(on, r, rate[rows, c])
        admitted[rows, c] = torch.where(on, ok, admitted[rows, c])

    # D4 work conservation, gated by wc via the trip count
    n_wc = torch.where(wc > 0, n_live, 0)
    wc_rate = torch.zeros(B, C, dtype=torch.float32, device=dev)
    if admit_only:
        return rate, admitted, wc_rate, None, avail
    if flows is None:
        # coflow-granular fill (jax_coordinator.py:330-340)
        left = avail
        for j in range(int(n_wc.max()) if B else 0):
            on = j < n_wc
            c = order[:, j]
            r = _madd(left, inv, bigm, rows, c)
            ok = on & ~admitted[rows, c] & (r > 0) & (r < BIG)
            r = torch.where(ok, r, 0.0)
            left = left - r[:, None] * cnt[rows, c]
            wc_rate[rows, c] = torch.where(on, r, wc_rate[rows, c])
        return rate, admitted, wc_rate, None, avail

    # per-flow greedy fill (jax_coordinator.py:387-434): live flows of
    # missed coflows in (coflow priority, flow index) order, each taking
    # the least residual of its ports and (leaf-spine) its two links
    Lf = num_links
    P = W // 2 - Lf
    if Lf and (flows.up is None or flows.dn is None):
        raise ValueError("a leaf-spine walk needs the flows' up/dn links")
    F = flows.cid.shape[1]
    ar_c = torch.arange(C, device=dev).expand(B, C)
    hp = torch.zeros(B, C, dtype=torch.bool, device=dev).scatter_(
        1, order, ar_c < n_live[:, None])
    invp = torch.empty_like(order).scatter_(1, order, ar_c)
    missed = hp & ~admitted
    cand = flows.live & missed.gather(1, flows.cid) & (wc > 0)[:, None]
    # lexsort((arange(F), invp[cid], ~cand)) as stable sorts, least
    # significant key first
    flist = torch.arange(F, device=dev).expand(B, F)
    for key in (invp.gather(1, flows.cid), (~cand).long()):
        o = torch.sort(key.gather(1, flist), dim=-1, stable=True).indices
        flist = flist.gather(1, o)
    n_cand = cand.sum(-1)
    a_s, a_r = avail[:, :P].clone(), avail[:, P:2 * P].clone()
    if Lf:
        # the links get one BIG slot each at index Lf: a flow that stays
        # in its leaf is never link-capped, and the slot absorbs its
        # subtracts (BIG - r rounds back to BIG, as in the reference)
        big = torch.full((B, 1), BIG, dtype=torch.float32, device=dev)
        a_u = torch.cat([avail[:, 2 * P:2 * P + Lf], big], dim=1)
        a_d = torch.cat([avail[:, 2 * P + Lf:], big], dim=1)
    wc_flow = torch.zeros(B, F, dtype=torch.float32, device=dev)
    for i in range(int(n_cand.max()) if B else 0):
        on = i < n_cand
        f = flist[:, i]
        sp, dq = flows.src[rows, f], flows.dst[rows, f]
        r = torch.minimum(a_s[rows, sp], a_r[rows, dq])
        if Lf:
            u, d = flows.up[rows, f], flows.dn[rows, f]
            r = torch.minimum(r, torch.minimum(a_u[rows, u], a_d[rows, d]))
        r = torch.where(on, r.clamp(min=0.0), 0.0)
        a_s[rows, sp] = a_s[rows, sp] - r
        a_r[rows, dq] = a_r[rows, dq] - r
        if Lf:
            a_u[rows, u] = a_u[rows, u] - r
            a_d[rows, d] = a_d[rows, d] - r
        wc_flow[rows, f] = torch.where(on, r, wc_flow[rows, f])
    return rate, admitted, wc_rate, wc_flow, avail


def maxmin_rounds(width: int) -> int:
    """The reference's round count for W = 2(P + Lf) rows: 2 Pe + 2 with
    Pe = P + Lf rows per side (`repro/kernels/maxmin.py:78`)."""
    return width + 2


def maxmin_ref(src: torch.Tensor, dst: torch.Tensor, cand: torch.Tensor,
               avail: torch.Tensor, up: Optional[torch.Tensor] = None,
               dn: Optional[torch.Tensor] = None,
               num_links: int = 0) -> torch.Tensor:
    """Max-min fair rates of the candidate flows by progressive filling,
    lane by lane in lock step (`repro.kernels.ref.maxmin_ref` with the
    one-hot columns replaced by row ids).

    avail (B, W) f32 row capacities over W = 2P + 2Lf rows in the tick
    walk's layout [sender ports | receiver ports | uplinks | downlinks]
    (Lf = `num_links`); src/dst (B, F) int64 ports; up/dn (B, F) int64
    leaves in [0, Lf] (Lf = no link; None when Lf = 0); cand (B, F) bool.
    Flow f uses rows src, P + dst and, when it leaves its leaf, 2P + up
    and 2P + Lf + dn. Each of the W + 2 rounds counts the active flows
    per row, takes the least fair level avail / count, freezes the
    active flows on every row within 1e-12 of it at that level and
    subtracts level x frozen flows from every row (clamped at 0). Counts
    are 0/1 sums, exact in any order. Returns (B, F) f32 rates, 0 for
    non-candidates."""
    B, W = avail.shape
    F = src.shape[1]
    dev = avail.device
    Lf = num_links
    P = W // 2 - Lf
    # row ids per flow; row W is a dummy that the no-link sentinel hits
    ids = [src, P + dst]
    if Lf:
        ids.append(torch.where(up < Lf, 2 * P + up, W))
        ids.append(torch.where(dn < Lf, 2 * P + Lf + dn, W))
    f32 = torch.float32
    rates = torch.zeros(B, F, dtype=f32, device=dev)
    act = cand.clone()
    avail = avail.clone()
    for _ in range(maxmin_rounds(W)):
        actf = act.to(f32)
        cnt = torch.zeros(B, W + 1, dtype=f32, device=dev)
        for r in ids:
            cnt.scatter_add_(1, r, actf)
        cnt = cnt[:, :W]
        lvl_r = torch.where(cnt > 0, avail / cnt.clamp(min=1.0), BIG)
        lvl = lvl_r.amin(-1)                                  # (B,)
        sat = (lvl_r <= (lvl + 1e-12)[:, None]) & (cnt > 0)
        sat = torch.cat([sat, sat.new_zeros(B, 1)], dim=1)
        inc = sat.gather(1, ids[0])
        for r in ids[1:]:
            inc = inc | sat.gather(1, r)
        hit = act & inc
        rates = torch.where(hit, lvl[:, None], rates)
        hitf = hit.to(f32)
        n_hit = torch.zeros(B, W + 1, dtype=f32, device=dev)
        for r in ids:
            n_hit.scatter_add_(1, r, hitf)
        avail = (avail - lvl[:, None] * n_hit[:, :W]).clamp(min=0.0)
        act = act & ~hit
    return rates


def _ssd_heads(b, c, H):
    """b, c (B, L, G, N) -> per-head f32 (B, L, H, N): head h reads
    group h // (H // G)."""
    rep = H // b.shape[2]
    return (b.repeat_interleave(rep, dim=2).to(torch.float32),
            c.repeat_interleave(rep, dim=2).to(torch.float32))


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, *,
            init_state: Optional[torch.Tensor] = None):
    """Mamba-2 SSD, the sequential recurrence. x: (B, L, H, Dh); dt:
    (B, L, H) step sizes (post-softplus); a: (H,) negative decay rates;
    b, c: (B, L, G, N), heads grouped H // G per group; init_state:
    (B, H, Dh, N). Per head h:

        S_t = exp(dt_t a_h) S_{t-1} + dt_t x_t b_t^T,   y_t = S_t c_t

    Returns (y in x's dtype, final state f32 (B, H, Dh, N))."""
    B, L, H, Dh = x.shape
    N = b.shape[3]
    bh, ch = _ssd_heads(b, c, H)
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    af = a.to(torch.float32)
    s = (init_state.to(torch.float32) if init_state is not None else
         torch.zeros(B, H, Dh, N, dtype=torch.float32, device=x.device))
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * af)[..., None, None]
        s = decay * s + (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
                         * bh[:, t, :, None, :])
        ys.append(torch.einsum("bhdn,bhn->bhd", s, ch[:, t]))
    y = torch.stack(ys, 1) if ys else xf.new_zeros(B, 0, H, Dh)
    return y.to(x.dtype), s


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *,
                    init_state: Optional[torch.Tensor] = None,
                    lc: int = 128):
    """The chunked SSD scan, the contract of `ssd_ref` for any L: L is
    padded with zeros to a multiple of `lc` (dt = 0 in the pad leaves
    the state unchanged) and sliced back. Per chunk, with cum the
    inclusive cumsum of dt a over the chunk:

        y   = (c b^T * exp(cum_t - cum_u) [u <= t] * dt_u) x
              + exp(cum) (c S^T)
        S' = exp(cum_L) S + (x * exp(cum_L - cum) dt)^T b

    The decay's argument is masked to 0 above the diagonal before the
    exp, so a large |a| dt cannot overflow into inf * 0 = NaN."""
    B, L, H, Dh = x.shape
    N = b.shape[3]
    f32 = torch.float32
    pad = (-L) % lc
    xf = torch.nn.functional.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.to(f32), (0, 0, 0, pad))
    bh, ch = _ssd_heads(b, c, H)
    bh = torch.nn.functional.pad(bh, (0, 0, 0, 0, 0, pad))
    ch = torch.nn.functional.pad(ch, (0, 0, 0, 0, 0, pad))
    af = a.to(f32)
    s = (init_state.to(f32) if init_state is not None else
         torch.zeros(B, H, Dh, N, dtype=f32, device=x.device))
    tri = torch.tril(torch.ones(lc, lc, dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    ys = []
    for j in range(0, L + pad, lc):
        xc, dtc = xf[:, j:j + lc], dtf[:, j:j + lc]
        bc, cc = bh[:, j:j + lc], ch[:, j:j + lc]
        cum = torch.cumsum(dtc * af, dim=1)                  # (B, lc, H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # (B, t, u, H)
        decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)),
                            0.0)
        g = torch.einsum("bthn,buhn->btuh", cc, bc)
        m = g * decay * dtc[:, None, :, :]
        y = torch.einsum("btuh,buhd->bthd", m, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bthn,bhdn->bthd", cc, s)
        cl = cum[:, -1]                                      # (B, H)
        wgt = torch.exp(cl[:, None] - cum) * dtc
        s = torch.exp(cl)[..., None, None] * s + torch.einsum(
            "bthd,bthn->bhdn", xc * wgt[..., None], bc)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :L] if ys else xf.new_zeros(B, 0, H, Dh)
    return y.to(x.dtype), s


def ssd_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                        *, lc: int = 128):
    """The gradient of `ssd_chunked_ref`'s y, with no initial state,
    written out: (dx, ddt, da, db, dc) at (x, dt, a, b, c) for the
    output gradient dy (B, L, H, Dh), in the inputs' dtypes (da in f32),
    computed in f32 (f64 for f64 inputs). L is padded as the forward
    pads it. The chunk-start states S are recomputed first; then the
    chunks are swept in reverse, carrying dS (the gradient of the state
    at the chunk's end, 0 after the last). With the forward's names per
    chunk (cum, the decay L_tu = exp(cum_t - cum_u) [u <= t], G = c b^T,
    M = G * L * dt_u, w = exp(cl - cum) dt, e = exp(cum), cl = cum's
    last):

        dM  = dY X^T (lower triangle),      dG = dM * L * dt_u
        dX  = M^T dY + diag(w) B dS^T
        dC  = dG B + diag(e) dY S,          dB = dG^T C + diag(w) X dS
        dS' = exp(cl) dS + (diag(e) dY)^T C          (the chunk before)

    dt and a enter through cum, M and w. With dw_u = x_u^T dS b_u and
    P = dM * M: ddt's direct terms are sum_t dM_tu G_tu L_tu + dw_u
    exp(cl - cum_u); dcum = P's row sums - its column sums + e_t (dY_t .
    S c_t) - dw w, and cl (cum's last) takes sum_u dw_u w_u + exp(cl)
    <dS, S>; the reverse cumsum of dcum is d(dt a), so ddt += a d(dt a)
    and da = sum over (batch, t) of dt d(dt a). db and dc sum the H / G
    heads of each group."""
    B, L, H, Dh = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    ct = _compute_dtype(x)
    pad = (-L) % lc
    Lp = L + pad
    nn_pad = torch.nn.functional.pad
    xf = nn_pad(x.to(ct), (0, 0, 0, 0, 0, pad))
    dyf = nn_pad(dy.to(ct), (0, 0, 0, 0, 0, pad))
    dtf = nn_pad(dt.to(ct), (0, 0, 0, pad))
    bh = nn_pad(b.repeat_interleave(rep, dim=2).to(ct), (0, 0, 0, 0, 0, pad))
    ch = nn_pad(c.repeat_interleave(rep, dim=2).to(ct), (0, 0, 0, 0, 0, pad))
    af = a.to(ct)
    tri = torch.tril(torch.ones(lc, lc, dtype=torch.bool,
                                device=x.device))[None, :, :, None]

    def local(j):
        sl = slice(j, j + lc)
        dtc = dtf[:, sl]
        cum = torch.cumsum(dtc * af, dim=1)                  # (B, lc, H)
        cl = cum[:, -1]                                      # (B, H)
        return xf[:, sl], dtc, bh[:, sl], ch[:, sl], dyf[:, sl], cum, cl

    states, s = [], xf.new_zeros(B, H, Dh, N)
    for j in range(0, Lp, lc):
        xc, dtc, bc, _, _, cum, cl = local(j)
        states.append(s)
        w = torch.exp(cl[:, None] - cum) * dtc
        s = torch.exp(cl)[..., None, None] * s + torch.einsum(
            "buhd,buhn->bhdn", xc * w[..., None], bc)

    dx, ddt, dbh, dch = (torch.zeros_like(t) for t in (xf, dtf, bh, ch))
    da = af.new_zeros(H)
    ds = xf.new_zeros(B, H, Dh, N)
    for k in reversed(range(len(states))):
        j, sp = k * lc, states[k]
        xc, dtc, bc, cc, dyc, cum, cl = local(j)
        e = torch.exp(cum)
        w = torch.exp(cl[:, None] - cum) * dtc
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # (B, t, u, H)
        dec = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        g = torch.einsum("bthn,buhn->btuh", cc, bc)
        m = g * dec * dtc[:, None]
        dm = torch.where(tri, torch.einsum("bthd,buhd->btuh", dyc, xc), 0.0)
        dg = dm * dec * dtc[:, None]
        bds = torch.einsum("buhn,bhdn->buhd", bc, ds)        # B dS^T
        dys = torch.einsum("bthd,bhdn->bthn", dyc, sp)       # dY S
        dx[:, j:j + lc] = (torch.einsum("btuh,bthd->buhd", m, dyc)
                           + w[..., None] * bds)
        dch[:, j:j + lc] = (torch.einsum("btuh,buhn->bthn", dg, bc)
                            + e[..., None] * dys)
        dbh[:, j:j + lc] = (torch.einsum("btuh,bthn->buhn", dg, cc)
                            + w[..., None] * torch.einsum(
                                "buhd,bhdn->buhn", xc, ds))
        dw = (xc * bds).sum(-1)                              # (B, lc, H)
        p = dm * m
        dcum = p.sum(2) - p.sum(1) + e * (dys * cc).sum(-1) - dw * w
        dcum[:, -1] += (dw * w).sum(1) + torch.exp(cl) * (ds * sp).sum(
            (-2, -1))
        ddta = dcum.flip(1).cumsum(1).flip(1)                # d(dt a)
        ddt[:, j:j + lc] = ((dm * g * dec).sum(1)
                            + dw * torch.exp(cl[:, None] - cum)
                            + af * ddta)
        da += (dtc * ddta).sum((0, 1))
        ds = torch.exp(cl)[..., None, None] * ds + torch.einsum(
            "bthd,bthn->bhdn", e[..., None] * dyc, cc)

    def heads(t):   # (B, Lp, H, N) per head -> (B, L, G, N) per group
        return t[:, :L].reshape(B, L, G, rep, N).sum(3)

    return (dx[:, :L].to(x.dtype), ddt[:, :L].to(dt.dtype), da,
            heads(dbh).to(b.dtype), heads(dch).to(c.dtype))


NEG_INF = -1e30   # the masked score of the attention kernels


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """(B, H, S, D) x (B, Hkv, T, D) GQA attention, materialized f32
    softmax; query head h reads KV head h // (H // Hkv). The causal mask
    is aligned bottom-right (query i sees keys j <= i + T - S). Returns
    (B, H, S, D) in q's dtype."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    f32 = torch.float32
    qg = q.reshape(B, Hkv, H // Hkv, S, D).to(f32)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qg,
                          k.to(f32)) * (1.0 / D ** 0.5)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool,
                          device=q.device).tril(T - S)
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(f32))
    return o.reshape(B, H, S, D).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        block: int = 1024) -> torch.Tensor:
    """Forward GQA attention by online softmax over key blocks of
    `block`: q (B, H, S, D), k (B, Hkv, T, D) and v (B, Hkv, T, Dv) (Dv
    may differ from D, as in MLA's prefill: 192 against 128), H a
    multiple of Hkv, query head h reading KV head h // (H // Hkv) (K and
    V are never repeated). In f32: s = q k^T D^-1/2 (the q.k width);
    keys at or past T and, under `causal`, keys after q_offset + i
    (query i's absolute position) are set to -1e30; the running max m,
    sum l and accumulator (Dv wide); o = acc / max(l, 1e-30). Returns
    (B, H, S, Dv) in q's dtype. (f64 inputs are computed in f64, for
    gradient checks.)"""
    B, H, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    ct = _compute_dtype(q)
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, H // Hkv, S, D).to(ct)
    q_pos = q_offset + torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, H // Hkv, S), NEG_INF, dtype=ct,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, H // Hkv, S, Dv, dtype=ct, device=q.device)
    for j in range(0, T, block):
        kb, vb = k[:, :, j:j + block].to(ct), v[:, :, j:j + block].to(ct)
        s = torch.einsum("bhgsd,bhtd->bhgst", qg, kb) * scale
        if causal:
            k_pos = j + torch.arange(kb.shape[2], device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bhtd->bhgsd",
                                                    p, vb)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, S, Dv).to(q.dtype)


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs (the attention's plain versions)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            q_offset: int = 0):
    """The gradient of `flash_attention_ref` written out: (dq, dk, dv)
    at (q, k, v) for the output gradient `do`, given the forward's
    output o (B, H, S, Dv). In f32 (f64 for f64 inputs), with s and its
    mask as the forward forms them, p = exp(s - max) / max(sum, 1e-30)
    over each query's keys:

        dv = p^T do (summed over the G query heads of each KV head)
        dp = do v^T,  delta = rowsum(do o),  ds = p (dp - delta)
        dq = ds k D^-1/2,  dk = ds^T q D^-1/2 (summed as dv)

    Returns the three in the dtypes of q, k and v (the kernel K7's
    contract; `flash_attention_bwd.py`)."""
    B, H, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    ct = _compute_dtype(q)
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, G, S, D).to(ct)
    og = o.reshape(B, Hkv, G, S, Dv).to(ct)
    dog = do.reshape(B, Hkv, G, S, Dv).to(ct)
    kf, vf = k.to(ct), v.to(ct)
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, kf) * scale
    if causal:
        q_pos = q_offset + torch.arange(S, device=q.device)
        k_pos = torch.arange(T, device=q.device)
        s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    dv = torch.einsum("bhgst,bhgsd->bhtd", p, dog)
    dp = torch.einsum("bhgsd,bhtd->bhgst", dog, vf)
    ds = p * (dp - (dog * og).sum(-1, keepdim=True))
    dq = torch.einsum("bhgst,bhtd->bhgsd", ds, kf) * scale
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds, qg) * scale
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


PREFIX_BLOCK = 16   # XLA's scan block on the CPU (jnp.cumsum)


def _scan_blocks(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of each row of x (B, n) in XLA's order, as a new
    tensor: blocks of 16 summed sequentially from the identity +0.0,
    the block totals scanned by the same rule (recursively, until at
    most 16 remain), and each element of a block after the first = the
    scanned total of the blocks before it + its in-block prefix. The
    adds run in place on a zero-padded copy, one column of every block
    at a time. Starting each chain from +0.0 (not from its first
    element) is what turns a leading -0.0 into +0.0, as XLA does."""
    B, n = x.shape
    k = PREFIX_BLOCK
    nb = -(-n // k)
    blk = x.new_zeros((B, nb * k))
    blk[:, :n] = x
    blk = blk.view(B, nb, k)
    cols = blk.unbind(-1)
    cols[0].add_(x.new_zeros((B, 1)))   # +0.0 + x: -0.0 becomes +0.0
    for i in range(1, min(n, k)):
        cols[i].add_(cols[i - 1])
    if nb > 1:
        before = _scan_blocks(blk[..., -1])
        blk[:, 1:] += before[:, :-1, None]
    return blk.view(B, nb * k)[:, :n]


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """(B, F) f32 -> (B, F + 1) f32: a zero column, then each row's
    inclusive prefix sums in the order of the JAX package's `jnp.cumsum`
    on the CPU (`_scan_blocks`). No `torch.cumsum`: its order is
    another."""
    B, F = x.shape
    zero = x.new_zeros((B, 1))
    if F == 0:
        return zero
    return torch.cat([zero, _scan_blocks(x)], dim=-1)


__all__ = ["BIG", "NEG_INF", "PREFIX_BLOCK", "WalkFlows", "attention_ref",
           "contention_ref", "flash_attention_bwd_ref", "flash_attention_ref",
           "maxmin_ref", "maxmin_rounds", "prefix_sum_ref",
           "ssd_chunked_bwd_ref", "ssd_chunked_ref",
           "ssd_ref", "tick_walk_ref"]
