"""The arithmetic of the CUDA designs of K2 (tick walk) and K3 (max-min
fill), emulated on the CPU and held to the plain versions bit for bit.

The kernels cannot run here, so each design gets a plain emulation that
lives in this file and on no path of the package:

* K2 (`csrc/walk.cu`): admission as one warp computes it (lane l owns
  the columns l + 32 i and takes avail * inv + bigm for each, a min over
  its columns, then five xor-shuffles; a step that admits nothing skips
  its subtract), the coflow fill over a
  second stream of the rows, and the per-flow fill as a stream of the
  missed coflows' flows (priority order, each one's flows in index
  order, flows that are not live marked) taken 32 at a time: the first
  flow of a window whose rows are all > 0 takes its rate, then the later
  ones are tested again. Against `ref.tick_walk_ref` in all three modes,
  on both fabrics; and the property the skip rests on, at most W flows
  of a lane take a non-zero rate.
* K3 (`csrc/maxmin.cu`): a compacted candidate list in an order drawn
  from a seed (shuffled again every round), counts made once and then
  decremented by each round's hits, only the hit rows' levels recomputed
  after the first update, a flow frozen by its rows' levels alone, and
  an exit as soon as the list is empty. Against `ref.maxmin_ref`.

Inputs come from numpy seeds. The CUDA kernels are held to the same
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import WalkFlows, maxmin_ref, tick_walk_ref

from tests.test_torch_cuda import (UNIT, random_maxmin_inputs,
                                   random_tick_inputs, torch_tick_args)

F32 = np.float32
BIG = F32(1e30)


# ---- K2 ----------------------------------------------------------------

def _warp_min(x):
    """min over 32 lanes as the kernel takes it: each lane's columns
    l + 32 i, then five xor-shuffles."""
    lanes = np.full(-(-x.size // 32) * 32, BIG, F32)
    lanes[:x.size] = x
    m = lanes.reshape(-1, 32).min(0)
    for o in (16, 8, 4, 2, 1):
        m = np.minimum(m, m[np.arange(32) ^ o])
    return m[0]


def _madd(av, row):
    """The reference's form, avail * inv + bigm, from the rows the
    kernel's helper warps write beside each count row."""
    inv = np.where(row > 0, F32(1.0) / np.maximum(row, F32(1e-9)), F32(0))
    bigm = np.where(row > 0, F32(0), BIG)
    return _warp_min((av * inv.astype(F32) + bigm).astype(F32))


def emulate_walk(order, n_live, cnt, avail0, min_rate, wc, flows=None, *,
                 num_links=0, admit_only=False):
    """K2's design, lane by lane. Returns tick_walk_ref's outputs and
    the non-zero takes of each lane's per-flow fill."""
    B, C, W = cnt.shape
    Lf = num_links
    P = W // 2 - Lf
    order, cnt = order.numpy(), cnt.numpy()
    rate = np.zeros((B, C), F32)
    admitted = np.zeros((B, C), bool)
    wc_rate = np.zeros((B, C), F32)
    avail = np.zeros((B, W), F32)
    mode_flow = flows is not None and not admit_only
    wc_flow = np.zeros((B, flows.src.shape[1]), F32) if mode_flow else None
    takes = np.zeros(B, int)
    for b in range(B):
        nl = int(n_live[b])
        av = avail0[b].numpy().astype(F32)
        for c in order[b, :nl]:
            m = _madd(av, cnt[b, c])
            ok = bool(m >= F32(min_rate[b]) and m < BIG)
            r = m if ok else F32(0.0)
            if ok:
                av = (av - r * cnt[b, c]).astype(F32)
            rate[b, c], admitted[b, c] = r, ok
        avail[b] = av
        if admit_only or not wc[b] > 0:
            continue
        if flows is None:
            for c in order[b, :nl]:
                m = _madd(av, cnt[b, c])
                ok = bool(not admitted[b, c] and m > 0 and m < BIG)
                r = m if ok else F32(0.0)
                if ok:
                    av = (av - r * cnt[b, c]).astype(F32)
                wc_rate[b, c] = r
            continue
        a = np.concatenate([av, [BIG, BIG]]).astype(F32)
        lo, hi = flows.flow_lo[b].numpy(), flows.flow_hi[b].numpy()
        stream = [f for c in order[b, :nl] if not admitted[b, c]
                  for f in range(lo[c], hi[c])]
        src, dst = flows.src[b].numpy(), flows.dst[b].numpy()
        live = flows.live[b].numpy()
        if Lf:
            up, dn = flows.up[b].numpy(), flows.dn[b].numpy()

        def rows(f):
            ids = [src[f], P + dst[f]]
            if Lf:
                ids += [2 * P + up[f] if up[f] < Lf else W,
                        2 * P + Lf + dn[f] if dn[f] < Lf else W + 1]
            return ids

        for w0 in range(0, len(stream), 32):
            win = stream[w0:w0 + 32]
            todo = [bool(live[f]) for f in win]
            while True:
                can = [t and all(a[j] > 0 for j in rows(f))
                       for t, f in zip(todo, win)]
                if not any(can):
                    break
                i = can.index(True)
                ids = rows(win[i])
                r = min(a[j] for j in ids)
                for j in ids:
                    a[j] = F32(a[j] - r)
                wc_flow[b, win[i]] = r
                takes[b] += 1
                todo = [t and k > i for k, t in enumerate(can)]
    out = (torch.as_tensor(rate), torch.as_tensor(admitted),
           torch.as_tensor(wc_rate),
           None if wc_flow is None else torch.as_tensor(wc_flow),
           torch.as_tensor(avail))
    return out, takes


def _walk_args(d, hpl, mode, *, min_rate=None):
    """The walk's inputs from `random_tick_inputs`, ordered as the card
    tests order them (arrival rank, coflows with live ports first)."""
    _, batch, fv = torch_tick_args(d, torch.device("cpu"))
    Lf = batch.cnt_x.shape[-1] // 2 if hpl else 0
    cnt = torch.cat([batch.cnt_s, batch.cnt_r]
                    + ([batch.cnt_x] if hpl else []), -1)
    avail0 = torch.cat([batch.bw_s, batch.bw_r]
                       + ([batch.bw_x] if hpl else []), -1)
    hp = batch.active & ((batch.cnt_s > 0).any(-1)
                         | (batch.cnt_r > 0).any(-1))
    order = torch.argsort(batch.arrival, dim=-1)
    order = order.gather(1, torch.sort(
        (~hp).long().gather(1, order), dim=-1, stable=True).indices)
    B = order.shape[0]
    mr = UNIT.min_rate_frac * UNIT.port_bw if min_rate is None else min_rate
    args = (order, hp.sum(-1), cnt, avail0,
            torch.full((B,), mr, dtype=torch.float32), torch.ones(B),
            None if mode == "coflow" else fv)
    return args, dict(num_links=Lf, admit_only=mode == "admit")


def _check_walk(args, kw):
    want = tick_walk_ref(*args, **kw)
    got, takes = emulate_walk(*args, **kw)
    for k, g, w in zip(("rate", "admitted", "wc_rate", "wc_flow", "avail"),
                       got, want):
        if w is None:
            assert g is None, k
        else:
            assert torch.equal(g, w), k
    W = args[2].shape[-1]
    assert (takes <= W).all()
    if want[3] is not None:
        assert ((want[3] != 0).sum(-1) <= W).all()
        assert torch.equal(torch.as_tensor(takes),
                           (want[3] != 0).sum(-1))
    return want, takes


@pytest.mark.parametrize("mode", ["flow", "coflow", "admit"])
@pytest.mark.parametrize("B,C,P,hpl,seed", [
    (3, 64, 6, 0, 0), (2, 200, 40, 0, 1), (3, 64, 10, 4, 2),
    (2, 160, 24, 3, 3)])
def test_walk_design_matches_plain(B, C, P, hpl, seed, mode):
    d = random_tick_inputs(B, C, P, seed=seed, params=UNIT,
                           hosts_per_leaf=hpl)
    args, kw = _walk_args(d, hpl, mode)
    want, takes = _check_walk(args, kw)
    if mode == "flow":
        assert want[3].any() and takes.sum() > 0


@pytest.mark.parametrize("hpl", [0, 4])
def test_walk_design_rows_driven_negative(hpl):
    """Admission at counts of 3, 7 and 11 leaves rows below 0 (1 - (1/3)
    x 3 rounds to -1.19e-7); one row starts there, two at -0 and +0. The
    fill must skip every flow on them."""
    d = random_tick_inputs(3, 48, 8, seed=7, params=UNIT, max_width=12,
                           hosts_per_leaf=hpl)
    args, kw = _walk_args(d, hpl, "flow", min_rate=1e-6)
    cnt = args[2].clone()
    cnt[cnt > 0] = torch.tensor([3.0, 7.0, 11.0]).repeat(
        int((cnt > 0).sum()) // 3 + 1)[:int((cnt > 0).sum())]
    avail0 = args[3].clone()
    avail0[:, :3] = torch.tensor([-0.0, 0.0, -1.19e-7])
    args = args[:2] + (cnt, avail0) + args[4:]
    want, _ = _check_walk(args, kw)
    assert (want[4] < 0).any()


@pytest.mark.parametrize("hpl", [0, 2])
def test_walk_design_one_wide_coflow(hpl):
    """One missed coflow of 2000 flows on 4 ports a side, behind two
    small ones: 63 windows, and at most W non-zero takes."""
    rng = np.random.default_rng(11)
    P, n = 4, 2000
    widths = np.array([3, n, 5])
    C = widths.size
    F = int(widths.sum()) + 7
    hi = np.cumsum(widths)
    lo = hi - widths
    cid = np.full(F, C - 1)
    cid[:hi[-1]] = np.repeat(np.arange(C), widths)
    src, dst = rng.integers(0, P, F), rng.integers(0, P, F)
    live = np.zeros(F, bool)
    live[:hi[-1]] = rng.uniform(size=hi[-1]) < 0.9
    cnt = np.zeros((C, 2 * P), F32)
    np.add.at(cnt, (cid[live], src[live]), 1.0)
    np.add.at(cnt, (cid[live], P + dst[live]), 1.0)
    avail0 = rng.uniform(0.5, 2.0, 2 * P).astype(F32)
    up = dn = None
    Lf = 0
    if hpl:
        Lf = P // hpl
        ls, ld = src // hpl, dst // hpl
        up, dn = np.where(ls != ld, ls, Lf), np.where(ls != ld, ld, Lf)
        cx = np.zeros((C, 2 * Lf + 2), F32)
        np.add.at(cx, (cid[live], up[live]), 1.0)
        np.add.at(cx, (cid[live], Lf + 1 + dn[live]), 1.0)
        cnt = np.concatenate([cnt, cx[:, :Lf], cx[:, Lf + 1:-1]], 1)
        avail0 = np.concatenate([avail0, np.full(2 * Lf, 1.5, F32)])

    def t(x):
        return torch.as_tensor(np.asarray(x))[None]

    flows = WalkFlows(t(cid).long(), t(src).long(), t(dst).long(), t(live),
                      t(lo).long(), t(hi).long(),
                      t(up).long() if hpl else None,
                      t(dn).long() if hpl else None)
    args = (t([1, 0, 2]).long(), torch.tensor([C]), t(cnt), t(avail0),
            torch.tensor([0.05]), torch.ones(1), flows)
    want, takes = _check_walk(args, dict(num_links=Lf))
    assert not bool(want[1][0, 1])          # the wide coflow is missed
    assert 0 < takes[0] <= 2 * P + 2 * Lf


@pytest.mark.parametrize("mode", ["flow", "coflow"])
def test_walk_design_tie_heavy(mode):
    """Every port at one capacity, every coflow on the same ports: the
    MADD rates tie across coflows and the fill's rows hit 0 together."""
    B, C, P = 2, 16, 8
    k = np.arange(C * 4)
    cid = k // 4
    src, dst = k % P, (k + 1) % P
    live = np.ones(k.size, bool)
    cnt = np.zeros((C, 2 * P), F32)
    np.add.at(cnt, (cid, src), 1.0)
    np.add.at(cnt, (cid, P + dst), 1.0)

    def t(x):
        return torch.as_tensor(np.stack([np.asarray(x)] * B))

    lo = np.arange(C) * 4
    flows = WalkFlows(t(cid).long(), t(src).long(), t(dst).long(), t(live),
                      t(lo).long(), t(lo + 4).long())
    args = (t(np.arange(C)).long(), torch.tensor([C, C - 3]), t(cnt),
            torch.ones(B, 2 * P), torch.tensor([0.3, 0.1]), torch.ones(B),
            flows if mode == "flow" else None)
    _check_walk(args, {})


@pytest.mark.parametrize("mode", ["flow", "coflow", "admit"])
def test_walk_design_lane_without_live_coflows(mode):
    """A lane with n_live = 0 admits nothing and fills nothing, beside
    lanes that do."""
    d = random_tick_inputs(3, 40, 6, seed=4, params=UNIT)
    args, kw = _walk_args(d, 0, mode)
    n_live = args[1].clone()
    n_live[1] = 0
    args = args[:1] + (n_live,) + args[2:]
    want, _ = _check_walk(args, kw)
    assert not want[1][1].any() and torch.equal(want[4][1], args[3][1])


# ---- K3 ----------------------------------------------------------------

def emulate_maxmin(src, dst, cand, avail, up=None, dn=None, num_links=0,
                   *, seed=0):
    """K3's design, lane by lane: a compacted candidate list in an order
    drawn from `seed` (shuffled again every round), counts made once and
    decremented by each round's hits, only the hit rows' levels
    recomputed after the first update, a flow frozen by its rows' levels
    alone (every row of a listed flow carries it), the survivors kept for
    the next round. Returns the rates and each lane's rounds."""
    B, W = avail.shape
    F = src.shape[1]
    Lf = num_links
    P = W // 2 - Lf
    rng = np.random.default_rng(seed)
    rates = np.zeros((B, F), F32)
    rounds = np.zeros(B, int)
    for b in range(B):
        ids = [src[b].numpy(), P + dst[b].numpy()]
        if Lf:
            u, d = up[b].numpy(), dn[b].numpy()
            ids += [np.where(u < Lf, 2 * P + u, W),
                    np.where(d < Lf, 2 * P + Lf + d, W)]
        rows = np.stack(ids, 1)                      # (F, 2 or 4)
        lst = rng.permutation(np.nonzero(cand[b].numpy())[0])
        cnt = np.zeros(W + 1, np.int64)
        np.add.at(cnt, rows[lst].ravel(), 1)
        cnt[W] = 0
        av = avail[b].numpy().astype(F32)
        nhit = np.zeros(W + 1, np.int64)
        lvl = F32(0.0)
        for rnd in range(W + 2):
            if lst.size == 0:
                break
            rounds[b] += 1
            redo = np.ones(W, bool) if rnd <= 1 else nhit[:W] > 0
            if rnd:
                av[redo] = np.maximum(
                    (av - lvl * nhit[:W].astype(F32)).astype(F32),
                    F32(0.0))[redo]
                cnt[:W] -= nhit[:W]
                nhit[:] = 0
            new = np.where(cnt[:W] > 0,
                           av / np.maximum(cnt[:W], 1).astype(F32), BIG)
            lvl_r = np.where(redo, new.astype(F32), lvl_r) if rnd else \
                new.astype(F32)
            lvl = lvl_r.min()
            thr = F32(lvl + F32(1e-12))
            # every row of a listed flow carries it: the level decides
            sat = np.concatenate([lvl_r <= thr, [False]])
            hit = sat[rows[lst]].any(1)
            rates[b, lst[hit]] = lvl
            np.add.at(nhit, rows[lst[hit]].ravel(), 1)
            lst = rng.permutation(lst[~hit])
    return torch.as_tensor(rates), rounds


def _maxmin_ref(a):
    return maxmin_ref(a["src"], a["dst"], a["cand"], a["avail"], up=a["up"],
                      dn=a["dn"], num_links=a["num_links"])


def _check_maxmin(a, seed):
    want = _maxmin_ref(a)
    got, rounds = emulate_maxmin(a["src"], a["dst"], a["cand"], a["avail"],
                                 a["up"], a["dn"], a["num_links"],
                                 seed=seed)
    assert torch.equal(got, want)
    assert (rounds <= a["avail"].shape[1] + 2).all()
    return want, rounds


@pytest.mark.parametrize("B,P,Lf,F,frac,seed", [
    (1, 2, 0, 3, 0.9, 0), (3, 16, 4, 200, 0.7, 1), (2, 40, 10, 600, 0.5, 2),
    (2, 30, 0, 400, 0.3, 3), (2, 150, 38, 1500, 0.2, 4)])
def test_maxmin_design_matches_plain(B, P, Lf, F, frac, seed):
    a = random_maxmin_inputs(B, P, Lf, F, seed=seed, cand_frac=frac,
                             device=torch.device("cpu"))
    want, rounds = _check_maxmin(a, seed)
    assert want.any() and rounds.max() > (1 if F > 3 else 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_maxmin_design_list_order_is_free(seed):
    """Two list orders give the same rates bit for bit."""
    a = random_maxmin_inputs(2, 24, 6, 300, seed=9, cand_frac=0.6,
                             device=torch.device("cpu"))
    one, _ = emulate_maxmin(a["src"], a["dst"], a["cand"], a["avail"],
                            a["up"], a["dn"], a["num_links"], seed=seed)
    two, _ = emulate_maxmin(a["src"], a["dst"], a["cand"], a["avail"],
                            a["up"], a["dn"], a["num_links"], seed=seed + 7)
    assert torch.equal(one, two) and torch.equal(one, _maxmin_ref(a))


@pytest.mark.parametrize("per_row", [1, 2, 3])
def test_maxmin_design_tie_heavy(per_row):
    B, P = 2, 12
    F = per_row * P
    i = torch.arange(F).expand(B, F)
    a = dict(src=i % P, dst=(i + 1) % P, up=None, dn=None,
             cand=torch.ones(B, F, dtype=torch.bool),
             avail=torch.ones(B, 2 * P), num_links=0)
    want, rounds = _check_maxmin(a, per_row)
    assert torch.equal(want, torch.full_like(want, np.float32(1.0 / per_row)))
    assert (rounds == 1).all()


def test_maxmin_design_negative_rows_and_no_candidates():
    """Rows left below 0 by admission (and -0): the first round's level
    is negative, as in the plain version, and the rows are clamped at 0
    after it; a lane without candidates stays at 0."""
    a = random_maxmin_inputs(3, 20, 5, 500, seed=5, cand_frac=0.4,
                             device=torch.device("cpu"))
    a["avail"][:, :3] = torch.tensor([-1.19e-7, -0.0, 0.0])
    a["cand"][2] = False
    want, rounds = _check_maxmin(a, 3)
    assert not want[2].any() and rounds[2] == 0
    assert (want[:2] < 0).any() and (rounds[:2] > 1).all()
