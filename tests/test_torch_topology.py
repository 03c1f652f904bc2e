"""The port's leaf-spine fabric against the JAX package's, on the CPU.

* the fabric models (`repro_torch.fabric.topology`) validate, lay out
  leaves and size links as `repro.fabric.topology` does, with the same
  `repr` (`Scenario.hash` hashes it);
* `pack(..., topology=LeafSpine(...))` writes the JAX package's link
  layout field by field;
* `tiny_trace` fleets replay under `LeafSpine(4, 4.0)` as the JAX
  package replays them: with the greedy fill, events and ticks equal and
  per-coflow CCTs to rtol 1e-6 (they agree bit for bit here); with the
  max-min fill, CCTs to rtol 1e-3, the JAX package's own kernel-vs-
  reference engine bar (tests/test_topology.py:229);
* the port's own contracts: 1:1 equals the big switch bit for bit, 4:1
  degrades avg CCT by more than 1.1x;
* a JAX leaf-spine mid-run state carried over with `from_reference`
  finishes in the port as the JAX replay does (events, ticks, CCTs and
  FCTs; bit for bit here).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core.params import SchedulerParams as JParams
from repro.fabric import jax_engine
from repro.fabric import topology as jtopo
from repro.traces import batch as jbatch
from repro.traces import synth as jsynth
from repro_torch.api import Scenario, run
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric import engine
from repro_torch.fabric.topology import (BigSwitch, LeafSpine,
                                         leaf_links_for, normalize_topology,
                                         wc_fill_of)
from repro_torch.traces import batch as pbatch
from repro_torch.traces import synth as psynth

from tests.test_torch_engine import _assert_same, _port_trace

TOPO_1 = LeafSpine(hosts_per_leaf=4, oversub=1.0)
TOPO_4 = LeafSpine(hosts_per_leaf=4, oversub=4.0)
MAXMIN_4 = LeafSpine(hosts_per_leaf=4, oversub=4.0, wc_fill="maxmin")


def _jtopo(t):
    """The JAX package's model with the same fields."""
    return jtopo.LeafSpine(**dataclasses.asdict(t))


def _fleets(n, C=24, P=16, load=0.8):
    return ([jsynth.tiny_trace(C, P, seed=s, load=load) for s in range(n)],
            [psynth.tiny_trace(C, P, seed=s, load=load) for s in range(n)])


# ---- the fabric models ---------------------------------------------------

def test_normalize_and_validate():
    assert isinstance(normalize_topology(None), BigSwitch)
    assert normalize_topology(TOPO_4) is TOPO_4
    with pytest.raises(TypeError):
        normalize_topology(object())
    with pytest.raises(TypeError):    # the JAX package's model is not ours
        normalize_topology(_jtopo(TOPO_4))
    for bad in (dict(hosts_per_leaf=0), dict(oversub=0.0),
                dict(wc_fill="random")):
        with pytest.raises(ValueError):
            LeafSpine(**bad)
    assert wc_fill_of(None) == "greedy" and wc_fill_of(MAXMIN_4) == "maxmin"
    assert leaf_links_for(None, 16) == 0 and leaf_links_for(TOPO_4, 14) == 4


@pytest.mark.parametrize("topo", [BigSwitch(), TOPO_1, MAXMIN_4,
                                  LeafSpine(3, 2.5)], ids=repr)
def test_repr_and_hash_match_the_reference(topo):
    ref = jtopo.BigSwitch() if isinstance(topo, BigSwitch) else _jtopo(topo)
    assert repr(topo) == repr(ref)
    assert hash(topo) == hash(type(topo)(**dataclasses.asdict(topo)))


@pytest.mark.parametrize("hosts_per_leaf,P", [(4, 16), (4, 14), (3, 10),
                                              (1, 5)])
def test_leaf_layout_and_link_caps_match_the_reference(hosts_per_leaf, P):
    rng = np.random.default_rng(P)
    mine = LeafSpine(hosts_per_leaf, 2.0)
    ref = jtopo.LeafSpine(hosts_per_leaf, 2.0)
    assert mine.leaf_count(P) == ref.leaf_count(P)
    bw = rng.uniform(0.5, 2.0, P)
    for a, b in zip(mine.link_caps(bw, bw[::-1].copy()),
                    ref.link_caps(bw, bw[::-1].copy())):
        np.testing.assert_array_equal(a, b)
    src, dst = rng.integers(0, P, 50), rng.integers(0, P, 50)
    for a, b in zip(mine.flow_links(src, dst), ref.flow_links(src, dst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hosts_per_leaf", [3, 4])
def test_pack_link_layout_equals_the_reference(hosts_per_leaf):
    jt = [jsynth.fb_like_trace(60, 22, seed=2)] + \
        [jsynth.tiny_trace(12, 10, seed=s) for s in range(3)]
    pt = [psynth.fb_like_trace(60, 22, seed=2)] + \
        [psynth.tiny_trace(12, 10, seed=s) for s in range(3)]
    jb = jbatch.pack(jt, port_bw=1.25e8,
                     topology=jtopo.LeafSpine(hosts_per_leaf, 2.0))
    pb = pbatch.pack(pt, port_bw=1.25e8,
                     topology=LeafSpine(hosts_per_leaf, 2.0))
    assert pb.num_leaf_links == jb.num_leaf_links > 0
    for name in jb._fields:
        a, b = getattr(jb, name), getattr(pb, name)
        if a is None:
            assert b is None, name
        else:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_big_switch_pack_has_no_links():
    tb = pbatch.pack([psynth.tiny_trace(8, 6, seed=0)], port_bw=1.0,
                     topology=BigSwitch())
    assert tb.num_leaf_links == 0 and (tb.link_up == 0).all()


@pytest.mark.parametrize("oversub", [4.0, 40.0])
def test_default_max_ticks_folds_in_the_links(oversub):
    jt, pt = _fleets(2)
    topo = LeafSpine(4, oversub)
    jb = jbatch.pack(jt, port_bw=1.25e8, topology=_jtopo(topo))
    pb = pbatch.pack(pt, port_bw=1.25e8, topology=topo)
    want = jax_engine.default_max_ticks(jb, 8e-3)
    assert engine.default_max_ticks(pb, 8e-3) == want
    if oversub > 10:    # the links, not the total bytes, bound the horizon
        assert want > engine.default_max_ticks(
            pbatch.pack(pt, port_bw=1.25e8), 8e-3)


def test_features_carry_the_fill():
    p = SchedulerParams()
    assert engine.features_for(p) == (True, True, False, False, False)
    assert engine.features_for(p, topology=TOPO_4)[3] is False
    assert engine.features_for(p, topology=MAXMIN_4)[3] is True
    with pytest.raises(TypeError):
        engine.features_for(p, topology=object())


# ---- fleet parity with the JAX package ------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(fidelity="coflow")])
def test_greedy_fleet_matches_jax_engine(kw):
    """Greedy fill, 4:1: events and ticks equal, CCTs to rtol 1e-6 (the
    largest deviation observed here is 0: bit for bit)."""
    jt, pt = _fleets(2)
    want = jax_engine.simulate_batch(jt, JParams(), topology=_jtopo(TOPO_4),
                                     **kw)
    got = engine.simulate_batch(pt, SchedulerParams(), topology=TOPO_4,
                                device="cpu", **kw)
    _assert_same(got, want, rtol=1e-6)


def test_maxmin_fleet_matches_jax_engine():
    """Max-min fill, 4:1: CCTs within rtol 1e-3, the JAX package's bar
    for its Pallas kernel against its plain reference inside the engine
    (XLA may contract the fill's `avail - lvl * n` into fused
    multiply-adds; the port rounds the product first)."""
    jt, pt = _fleets(2)
    want = jax_engine.simulate_batch(jt, JParams(),
                                     topology=_jtopo(MAXMIN_4))
    got = engine.simulate_batch(pt, SchedulerParams(), topology=MAXMIN_4,
                                device="cpu")
    assert got.events == want.events
    np.testing.assert_array_equal(got.finished, want.finished)
    np.testing.assert_allclose(got.cct, want.cct, rtol=1e-3)


def test_leafspine_sweep_matches_jax_engine():
    tr = jsynth.tiny_trace(16, 12, seed=3, load=0.8)
    settings = [SchedulerParams(start_threshold=s) for s in (2e6, 4e7)]
    topo = LeafSpine(3, 3.0)
    want = jax_engine.simulate_sweep(
        tr, [JParams(**dataclasses.asdict(p)) for p in settings],
        topology=_jtopo(topo))
    got = engine.simulate_sweep(_port_trace(tr), settings, topology=topo,
                                device="cpu")
    _assert_same(got, want, rtol=1e-6)


# ---- the port's own contracts ---------------------------------------------

def test_one_to_one_equals_the_big_switch():
    _, pt = _fleets(3, C=20)
    big = run(Scenario(traces=tuple(pt), device="cpu"))
    leaf = run(Scenario(traces=tuple(pt), topology=TOPO_1, device="cpu"))
    assert big.events == leaf.events and big.ticks == leaf.ticks
    np.testing.assert_array_equal(big.cct, leaf.cct)
    np.testing.assert_array_equal(big.fct, leaf.fct)


def test_oversubscription_degrades_avg_cct():
    tr = (psynth.tiny_trace(20, 16, seed=0, load=0.8),)
    base = run(Scenario(traces=tr, topology=TOPO_1, device="cpu"))
    for topo in (TOPO_4, MAXMIN_4):
        over = run(Scenario(traces=tr, topology=topo, device="cpu"))
        assert over.avg_cct[0] > 1.1 * base.avg_cct[0], topo
        t = over.table(0)
        assert t.finished.all()
        np.testing.assert_allclose(t.sent, t.size, rtol=1e-5)


def test_front_door_hashes_the_topology():
    tr = psynth.tiny_trace(8, 8, seed=1)
    a = Scenario(trace=tr, topology=TOPO_4, device="cpu")
    b = Scenario(trace=tr, topology=LeafSpine(4, 4.0), device="cpu")
    c = Scenario(trace=tr, topology=MAXMIN_4, device="cpu")
    assert a.hash() == b.hash() != c.hash()


def test_jax_leafspine_mid_run_state_finishes_in_the_port():
    """Two chunks of a leaf-spine max-min replay in the JAX package,
    carried over with `from_reference` and finished in the port."""
    jt, _ = _fleets(2)
    chunk = 16
    jtopo4 = _jtopo(MAXMIN_4)
    jtb = jbatch.pack(jt, port_bw=JParams().port_bw, topology=jtopo4)
    jep = jax_engine.EngineParams.from_scheduler(JParams())
    feats = jax_engine.features_for(JParams(), topology=jtopo4)
    state = jax_engine._init_batch(jtb, jep, sweep=False)
    for _ in range(2):
        state = jax_engine._run_chunk(state, jtb, jep, chunk=chunk,
                                      kernel=None, sweep=False,
                                      features=feats)
    assert not bool(np.asarray(state.finished).all())
    np_state = jax.tree_util.tree_map(np.asarray, state)
    np_ep = jax.tree_util.tree_map(np.asarray, jep)
    tb, ep, st = engine.from_reference(jtb, np_ep, np_state, device="cpu")
    assert tb.bw_up.shape[-1] == jtb.num_leaf_links
    got = engine._drive(
        tb, ep, jax_engine.default_max_ticks(jtb, JParams().delta), chunk,
        features=engine.features_for(SchedulerParams(), topology=MAXMIN_4),
        state=st, events=2 * chunk)
    want = jax_engine.simulate_batch(jt, JParams(), chunk=chunk,
                                     topology=jtopo4)
    _assert_same(got, want, rtol=1e-6)   # bit for bit here
