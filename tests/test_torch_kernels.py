"""The port's plain kernel versions against the JAX package, on the CPU.

* contention: `repro_torch.kernels.ops.contention` on CPU tensors (the
  plain PyTorch version) against the Pallas kernel run in interpret mode
  and against `repro.kernels.ref.contention_ref`, on the sweep of
  tests/test_kernels.py — exact integers;
* the tick walk: `ref.tick_walk_ref` fed the JAX tick's own priority
  order reproduces the JAX tick's admission and work-conservation rates;
* the CUDA walk kernel's segment order (missed coflows in priority
  order, each one's live flows in index order) equals the reference's
  sorted candidate list, on the same inputs;
* the walk over W = 2P + 2Lf leaf-spine columns (link-aware greedy fill
  and admission only) reproduces the JAX tick's rates;
* max-min: `repro_torch.kernels.ops.maxmin_rates` on CPU tensors (the
  plain `maxmin_ref`, index form) against `repro.kernels.ref.maxmin_ref`
  and the Pallas kernel in interpret mode (one-hot form), on the
  stacked port+link shapes of tests/test_topology.py and the sweep of
  tests/test_kernels.py, to rtol 1e-5 / atol 1e-6 (the reference's own
  bar: XLA may contract `avail - lvl * n` into a fused multiply-add);
  plus the capacity and non-candidate invariants.

The CUDA kernels themselves are held against these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_coordinator as jc
from repro.core.params import SchedulerParams as JParams
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import WalkFlows, maxmin_ref, tick_walk_ref

from tests.test_torch_coordinator import _jax_lane
from tests.test_torch_cuda import UNIT, random_tick_inputs

RNG = np.random.default_rng(42)


@pytest.mark.parametrize("C,P", [(3, 5), (64, 64), (130, 150), (257, 96),
                                 (512, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contention_matches_pallas_and_ref(C, P, dtype):
    a_s = RNG.uniform(size=(C, P)) < 0.15
    a_r = RNG.uniform(size=(C, P)) < 0.15
    act = RNG.uniform(size=C) < 0.8
    jdt = getattr(jnp, dtype)
    want = np.asarray(jops.contention(jnp.asarray(a_s, jdt),
                                      jnp.asarray(a_r, jdt),
                                      jnp.asarray(act), force="interpret"))
    np.testing.assert_array_equal(
        want, np.asarray(jref.contention_ref(
            jnp.asarray(a_s, jnp.float32), jnp.asarray(a_r, jnp.float32),
            jnp.asarray(act))))
    tdt = getattr(torch, dtype)
    got = ops.contention(torch.as_tensor(a_s[None]).to(tdt),
                         torch.as_tensor(a_r[None]).to(tdt),
                         torch.as_tensor(act[None]))
    assert got.dtype == torch.int32 and got.shape == (1, C)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_contention_all_inactive():
    a = torch.ones(2, 8, 8)
    act = torch.zeros(2, 8, dtype=torch.bool)
    assert (ops.contention(a, a, act) == 0).all()


def test_contention_batch_equals_rows():
    """Lanes never see each other: a (B, C, P) call equals B one-lane
    calls."""
    B, C, P = 4, 40, 24
    a_s = torch.as_tensor(RNG.uniform(size=(B, C, P)) < 0.1).float()
    a_r = torch.as_tensor(RNG.uniform(size=(B, C, P)) < 0.1).float()
    act = torch.as_tensor(RNG.uniform(size=(B, C)) < 0.7)
    whole = ops.contention(a_s, a_r, act)
    for b in range(B):
        assert torch.equal(whole[b:b + 1], ops.contention(
            a_s[b:b + 1], a_r[b:b + 1], act[b:b + 1]))


def _walk_args(d, flows, wc_fill="greedy"):
    """The walk's inputs for every lane of `random_tick_inputs` and the
    JAX tick's outputs lane by lane (its order feeds the port's walk).
    A leaf-spine `d` adds its link columns and the flows' up/dn."""
    cp = jc.CoordParams.from_params(JParams(**dataclasses.asdict(UNIT)))
    outs = []
    for b in range(d["active"].shape[0]):
        state, batch, fv = _jax_lane(d, b, flows)
        outs.append(jc.schedule_tick(state, batch, jnp.float32(d["now"]),
                                     cp=cp, flows=fv, wc_fill=wc_fill)[1])
    order = torch.as_tensor(np.stack([np.asarray(o["order"])
                                      for o in outs])).long()
    hp = (d["cnt_s"] > 0).any(-1) | (d["cnt_r"] > 0).any(-1)
    n_live = torch.as_tensor((hp & d["active"]).sum(-1))
    leaf = "cnt_x" in d
    cnt = torch.as_tensor(np.concatenate(
        [d["cnt_s"], d["cnt_r"]] + ([d["cnt_x"]] if leaf else []), -1))
    avail0 = torch.as_tensor(np.concatenate(
        [d["bw_s"], d["bw_r"]] + ([d["bw_x"]] if leaf else []), -1))
    B = order.shape[0]
    min_rate = torch.full((B,), UNIT.min_rate_frac * UNIT.port_bw,
                          dtype=torch.float32)
    wc = torch.ones(B)
    wf = WalkFlows(*(torch.as_tensor(d[k]).long() for k in
                     ("cid", "src", "dst")),
                   torch.as_tensor(d["live"]),
                   torch.as_tensor(d["flow_lo"]).long(),
                   torch.as_tensor(d["flow_hi"]).long(),
                   *((torch.as_tensor(d["up"]).long(),
                      torch.as_tensor(d["dn"]).long()) if leaf else ())
                   ) if flows else None
    return (order, n_live, cnt, avail0, min_rate, wc, wf), outs


@pytest.mark.parametrize("flows", [True, False])
def test_walk_plain_matches_jax_tick(flows):
    d = random_tick_inputs(3, 48, 6, seed=11, params=UNIT)
    args, outs = _walk_args(d, flows)
    rate, admitted, wc_rate, wc_flow, _ = ops.tick_walk(*args)
    for b, o in enumerate(outs):
        np.testing.assert_array_equal(admitted[b].numpy(),
                                      np.asarray(o["admitted"]))
        np.testing.assert_allclose(rate[b].numpy(), np.asarray(o["rate"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(wc_rate[b].numpy(),
                                   np.asarray(o["wc_rate"]), rtol=1e-6,
                                   atol=1e-6)
        if flows:
            np.testing.assert_allclose(wc_flow[b].numpy(),
                                       np.asarray(o["wc_flow"]), rtol=1e-6,
                                       atol=1e-6)
        else:
            assert wc_flow is None and o["wc_flow"] is None


def test_walk_gate_off_leaves_no_fill():
    d = random_tick_inputs(2, 32, 6, seed=3, params=UNIT)
    args, _ = _walk_args(d, True)
    args = args[:5] + (torch.zeros(2),) + args[6:]
    _, _, wc_rate, wc_flow, _ = tick_walk_ref(*args)
    assert not wc_rate.any() and not wc_flow.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_walk_order_is_the_sorted_candidate_order(seed):
    """The CUDA walk kernel visits missed coflows' [flow_lo, flow_hi)
    segments in priority order instead of sorting the candidates; with
    flows stored contiguous per coflow the two orders coincide."""
    d = random_tick_inputs(2, 40, 5, seed=seed, params=UNIT)
    args, outs = _walk_args(d, True)
    order, n_live = args[0], args[1]
    for b, o in enumerate(outs):
        adm = np.asarray(o["admitted"])
        cid, live = d["cid"][b], d["live"][b]
        lo, hi = d["flow_lo"][b], d["flow_hi"][b]
        perm = order[b].numpy()
        walk = [f for c in perm[:int(n_live[b])] if not adm[c]
                for f in range(lo[c], hi[c]) if live[f]]
        invp = np.argsort(perm)
        hp = np.zeros_like(adm)
        hp[perm[:int(n_live[b])]] = True
        cand = live & (hp & ~adm)[cid]
        flist = np.lexsort((np.arange(cid.size), invp[cid], ~cand))
        assert walk == list(flist[:int(cand.sum())])


@pytest.mark.parametrize("hosts_per_leaf,oversub", [(4, 4.0), (3, 2.0)])
def test_leafspine_walk_plain_matches_jax_tick(hosts_per_leaf, oversub):
    """The walk over W = 2P + 2Lf columns: admission and the link-aware
    greedy fill (BIG sentinel slots for intra-leaf flows) against the
    JAX tick's, and the admission-only mode leaves the same admission
    and the capacity the greedy mode starts its fill from."""
    d = random_tick_inputs(3, 48, 10, seed=5, params=UNIT,
                           hosts_per_leaf=hosts_per_leaf, oversub=oversub)
    args, outs = _walk_args(d, True)
    Lf = d["bw_x"].shape[1] // 2
    rate, admitted, wc_rate, wc_flow, avail = ops.tick_walk(
        *args, num_links=Lf)
    assert avail.shape == (3, 2 * 10 + 2 * Lf)
    for b, o in enumerate(outs):
        np.testing.assert_array_equal(admitted[b].numpy(),
                                      np.asarray(o["admitted"]))
        for got, k in ((rate, "rate"), (wc_rate, "wc_rate"),
                       (wc_flow, "wc_flow")):
            np.testing.assert_allclose(got[b].numpy(), np.asarray(o[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert wc_flow.any()
    r2, a2, w2, f2, avail2 = ops.tick_walk(*args, num_links=Lf,
                                           admit_only=True)
    assert torch.equal(r2, rate) and torch.equal(a2, admitted)
    assert torch.equal(avail2, avail) and not w2.any() and f2 is None


def test_leafspine_walk_needs_the_links():
    d = random_tick_inputs(1, 16, 8, seed=1, params=UNIT, hosts_per_leaf=4)
    args, _ = _walk_args(d, True)
    args = args[:6] + (args[6]._replace(up=None, dn=None),)
    with pytest.raises(ValueError, match="up/dn"):
        ops.tick_walk(*args, num_links=2)


def _onehot(ids, n, F):
    m = np.zeros((n, F), np.float32)
    ok = ids < n
    m[ids[ok], np.nonzero(ok)[0]] = 1.0
    return m


def _maxmin_case(rng, P, Lf, F, live_frac=0.7, bw_links=2.0):
    """Seeded inputs in both forms: the JAX package's stacked one-hots
    (ports then links, the sentinel Lf one-hots to a zero column) and
    the port's row ids over the W = 2P + 2Lf capacity layout."""
    src, dst = rng.integers(0, P, F), rng.integers(0, P, F)
    up, dn = rng.integers(0, Lf + 1, F), rng.integers(0, Lf + 1, F)
    live = rng.random(F) < live_frac
    bw_p = rng.uniform(0.5, 2.0, P).astype(np.float32)
    bw_l = np.full(Lf, bw_links, np.float32)
    a_s = np.concatenate([_onehot(src, P, F), _onehot(up, Lf, F)])
    a_r = np.concatenate([_onehot(dst, P, F), _onehot(dn, Lf, F)])
    bw = np.concatenate([bw_p, bw_l])
    jax_args = [jnp.asarray(x) for x in (a_s, a_r, live, bw, bw)]

    def t(x):
        return torch.as_tensor(np.asarray(x)[None])

    port = dict(src=t(src).long(), dst=t(dst).long(), cand=t(live),
                avail=t(np.concatenate([bw_p, bw_p, bw_l, bw_l])),
                up=t(up).long() if Lf else None,
                dn=t(dn).long() if Lf else None, num_links=Lf)
    return jax_args, port, (a_s, a_r, bw, live)


@pytest.mark.parametrize("P,Lf,F", [(16, 4, 64), (16, 4, 200), (9, 3, 50),
                                    (2, 0, 3), (6, 0, 30), (16, 0, 128),
                                    (32, 0, 200)])
def test_maxmin_matches_jax_ref_and_pallas(P, Lf, F):
    rng = np.random.default_rng(5 + P + Lf + F)
    jax_args, port, (a_s, a_r, bw, live) = _maxmin_case(rng, P, Lf, F)
    want = np.asarray(jref.maxmin_ref(*jax_args))
    pallas = np.asarray(jops.maxmin_rates(*jax_args, force="interpret"))
    np.testing.assert_allclose(pallas, want, rtol=1e-5, atol=1e-6)
    p = dict(port)
    got = ops.maxmin_rates(p.pop("src"), p.pop("dst"), p.pop("cand"),
                           p.pop("avail"), **p)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)
    # invariants: no row over its capacity, non-candidates at 0
    assert (a_s @ got <= bw * (1 + 1e-6) + 1e-6).all()
    assert (a_r @ got <= bw * (1 + 1e-6) + 1e-6).all()
    assert (got[~live] == 0).all() and (got >= 0).all()


def test_maxmin_lanes_are_independent():
    """B lanes in one call equal B one-lane calls."""
    rng = np.random.default_rng(0)
    P, Lf, F = 12, 3, 90
    lanes = [_maxmin_case(rng, P, Lf, F)[1] for _ in range(3)]
    cat = {k: torch.cat([ln[k] for ln in lanes]) for k in
           ("src", "dst", "cand", "avail", "up", "dn")}
    whole = maxmin_ref(cat["src"], cat["dst"], cat["cand"], cat["avail"],
                       up=cat["up"], dn=cat["dn"], num_links=Lf)
    for b, ln in enumerate(lanes):
        one = maxmin_ref(ln["src"], ln["dst"], ln["cand"], ln["avail"],
                         up=ln["up"], dn=ln["dn"], num_links=Lf)
        assert torch.equal(whole[b:b + 1], one)


@pytest.mark.parametrize("per_row", [1, 2, 3])
def test_maxmin_tie_heavy(per_row):
    """Every row at the same capacity with `per_row` flows on it: all
    rows saturate in the first round, every flow at capacity / per_row,
    as the JAX reference gives."""
    P, Lf = 8, 2
    F = per_row * P
    i = np.arange(F)
    src, dst = i % P, (i + 1) % P
    up = np.where(src // 4 != dst // 4, src // 4, Lf)
    dn = np.where(src // 4 != dst // 4, dst // 4, Lf)
    # each link row carries per_row x (P // Lf) x (1/4) of the flows in
    # this layout; size it so that it saturates at the same level
    n_up = np.bincount(up[up < Lf], minlength=Lf)
    n_dn = np.bincount(dn[dn < Lf], minlength=Lf)
    cap_l = n_up / per_row
    assert (n_up == n_dn).all()

    def t(x):
        return torch.as_tensor(np.asarray(x)[None])

    got = ops.maxmin_rates(
        t(src).long(), t(dst).long(), t(np.ones(F, bool)),
        t(np.concatenate([np.ones(2 * P), cap_l, cap_l]).astype(np.float32)),
        up=t(up).long(), dn=t(dn).long(), num_links=Lf)[0]
    assert torch.equal(got, torch.full((F,), np.float32(1.0 / per_row)))
    a_s = np.concatenate([_onehot(src, P, F), _onehot(up, Lf, F)])
    a_r = np.concatenate([_onehot(dst, P, F), _onehot(dn, Lf, F)])
    bw = np.concatenate([np.ones(P), cap_l]).astype(np.float32)
    want = jref.maxmin_ref(*(jnp.asarray(x) for x in
                             (a_s, a_r, np.ones(F, bool), bw, bw)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_maxmin_no_candidates_gives_zero():
    rng = np.random.default_rng(1)
    _, port, _ = _maxmin_case(rng, 8, 2, 40, live_frac=0.0)
    p = dict(port)
    got = ops.maxmin_rates(p.pop("src"), p.pop("dst"), p.pop("cand"),
                           p.pop("avail"), **p)
    assert got.shape == (1, 40) and not got.any()
