"""The port's plain kernel versions against the JAX package, on the CPU.

* contention: `repro_torch.kernels.ops.contention` on CPU tensors (the
  plain PyTorch version) against the Pallas kernel run in interpret mode
  and against `repro.kernels.ref.contention_ref`, on the sweep of
  tests/test_kernels.py — exact integers;
* the tick walk: `ref.tick_walk_ref` fed the JAX tick's own priority
  order reproduces the JAX tick's admission and work-conservation rates;
* the CUDA walk kernel's segment order (missed coflows in priority
  order, each one's live flows in index order) equals the reference's
  sorted candidate list, on the same inputs.

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
from repro_torch.kernels.ref import WalkFlows, tick_walk_ref

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


def _walk_args(d, flows):
    """The walk's inputs for every lane of `random_tick_inputs` and the
    JAX tick's outputs lane by lane (its order feeds the port's walk)."""
    cp = jc.CoordParams.from_params(JParams(**dataclasses.asdict(UNIT)))
    outs = []
    for b in range(d["active"].shape[0]):
        state, batch, fv = _jax_lane(d, b, flows)
        outs.append(jc.schedule_tick(state, batch, jnp.float32(d["now"]),
                                     cp=cp, flows=fv)[1])
    order = torch.as_tensor(np.stack([np.asarray(o["order"])
                                      for o in outs])).long()
    hp = (d["cnt_s"] > 0).any(-1) | (d["cnt_r"] > 0).any(-1)
    n_live = torch.as_tensor((hp & d["active"]).sum(-1))
    cnt = torch.as_tensor(np.concatenate([d["cnt_s"], d["cnt_r"]], -1))
    avail0 = torch.as_tensor(np.concatenate([d["bw_s"], d["bw_r"]], -1))
    B = order.shape[0]
    min_rate = torch.full((B,), UNIT.min_rate_frac * UNIT.port_bw,
                          dtype=torch.float32)
    wc = torch.ones(B)
    wf = WalkFlows(*(torch.as_tensor(d[k]).long() for k in
                     ("cid", "src", "dst")),
                   torch.as_tensor(d["live"]),
                   torch.as_tensor(d["flow_lo"]).long(),
                   torch.as_tensor(d["flow_hi"]).long()) if flows else None
    return (order, n_live, cnt, avail0, min_rate, wc, wf), outs


@pytest.mark.parametrize("flows", [True, False])
def test_walk_plain_matches_jax_tick(flows):
    d = random_tick_inputs(3, 48, 6, seed=11, params=UNIT)
    args, outs = _walk_args(d, flows)
    rate, admitted, wc_rate, wc_flow = ops.tick_walk(*args)
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
    _, _, wc_rate, wc_flow = tick_walk_ref(*args)
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
