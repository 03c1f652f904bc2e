"""The port's fleet engine against the JAX package's, on the CPU.

* `fb_like_trace` and `pack` of the port equal the JAX package's, field
  by field (same numpy RNG draws, same host layout);
* `simulate_batch` / `simulate_sweep` replay the tests/test_jax_engine.py
  families and `tiny_trace` fleets with B > 1: `events` and `ticks`
  exact, CCTs to rtol 1e-5 (the largest deviation observed here is 0:
  the replays agree bit for bit);
* a JAX mid-run state carried over with `from_reference` and finished in
  the port gives the JAX package's CCTs.

A `slow` test regenerates tests/data/torch_port_fb_golden.json, the
full-width reference chip_smoke.py holds the card's replay against.
"""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.params import SchedulerParams as JParams
from repro.fabric import jax_engine
from repro.traces import batch as jbatch
from repro.traces import synth as jsynth
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric import engine
from repro_torch.traces import batch as pbatch
from repro_torch.traces import synth as psynth

from tests.test_jax_engine import FAMILIES, _trace as jax_family_trace

GOLDEN = Path(__file__).parent / "data" / "torch_port_fb_golden.json"
LEAF_GOLDEN = Path(__file__).parent / "data" / \
    "torch_port_leafspine_golden.json"
FULL = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                       growth=4.0, num_queues=5)
NO_DYN = dataclasses.replace(FULL, dynamics_requeue=False)


def _jp(p: SchedulerParams) -> JParams:
    return JParams(**dataclasses.asdict(p))


def _port_trace(tr):
    """The same trace as the port's own objects (no shared classes)."""
    from repro_torch.core.coflow import Coflow, Flow, Trace

    return Trace(tr.num_ports, [
        Coflow(c.cid, c.arrival,
               [Flow(f.fid, f.src, f.dst, f.size) for f in c.flows])
        for c in tr.coflows])


def _assert_same(got, want, rtol=1e-5, atol=0.0):
    assert got.events == want.events and got.ticks == want.ticks
    np.testing.assert_array_equal(got.finished, want.finished)
    np.testing.assert_allclose(got.cct, want.cct, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.fct, want.fct, rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", [0, 3])
def test_fb_like_trace_and_pack_equal_the_reference(seed):
    jt = jsynth.fb_like_trace(120, 40, seed=seed)
    pt = psynth.fb_like_trace(120, 40, seed=seed)
    assert len(jt.coflows) == len(pt.coflows)
    for a, b in zip(jt.coflows, pt.coflows):
        assert (a.cid, a.arrival) == (b.cid, b.arrival)
        assert [(f.fid, f.src, f.dst, f.size) for f in a.flows] == \
            [(f.fid, f.src, f.dst, f.size) for f in b.flows]
    tiny = [jsynth.tiny_trace(12, 8, seed=s) for s in range(3)]
    jb = jbatch.pack([jt] + tiny, port_bw=1.25e8)
    pb = pbatch.pack([pt] + [psynth.tiny_trace(12, 8, seed=s)
                             for s in range(3)], port_bw=1.25e8)
    assert jb._fields == pb._fields
    for name in jb._fields:
        a, b = getattr(jb, name), getattr(pb, name)
        if a is None:
            assert b is None, name
        else:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("params,kw", [
    (FULL, {}),
    (NO_DYN, dict(work_conservation=False)),
    (NO_DYN, dict(lcof=False, per_flow_threshold=False)),
    (NO_DYN, dict(lcof=False, per_flow_threshold=True)),
    (FULL, dict(fidelity="coflow")),
])
def test_simulate_batch_matches_jax_engine(kind, params, kw):
    traces = [jax_family_trace(kind, seed=s) for s in range(3)]
    want = jax_engine.simulate_batch(traces, _jp(params), **kw)
    got = engine.simulate_batch([_port_trace(t) for t in traces], params,
                                device="cpu", **kw)
    if kw.get("per_flow_threshold", True):
        _assert_same(got, want)
    else:
        # the Aalo-queue ablation reads each coflow's TOTAL bytes sent,
        # a float prefix-sum difference whose rounding depends on the
        # scan order (sequential here, a parallel scan in XLA and on the
        # card): a total-bytes threshold crossing may land a δ tick
        # apart and shift later completions. Held to the bar the JAX
        # package holds this ablation to against its numpy reference.
        _assert_same(got, want, rtol=1e-2, atol=2 * params.delta)


def test_tiny_trace_fleet_matches_jax_engine():
    """A 4-lane fleet at the paper's port rate and default parameters
    (MB flows, dynamics re-queue on)."""
    jt = [jsynth.tiny_trace(14, 10, seed=s) for s in range(4)]
    pt = [psynth.tiny_trace(14, 10, seed=s) for s in range(4)]
    want = jax_engine.simulate_batch(jt, JParams())
    got = engine.simulate_batch(pt, SchedulerParams(), device="cpu")
    _assert_same(got, want)


def test_simulate_sweep_matches_jax_engine():
    tr = jax_family_trace("uniform", seed=7)
    settings = [dataclasses.replace(FULL, start_threshold=s)
                for s in (2.0, 4.0, 16.0)] + [NO_DYN]
    want = jax_engine.simulate_sweep(tr, [_jp(p) for p in settings])
    got = engine.simulate_sweep(_port_trace(tr), settings, device="cpu")
    _assert_same(got, want)


def test_jax_mid_run_state_finishes_in_the_port():
    """Run two chunks in the JAX package, carry the state across with
    `from_reference`, finish in the port: the CCTs are the JAX run's."""
    traces = [jax_family_trace(k, seed=5) for k in FAMILIES]
    chunk = 8
    jtb = jbatch.pack(traces, port_bw=FULL.port_bw)
    jep = jax_engine.EngineParams.from_scheduler(_jp(FULL))
    feats = jax_engine.features_for(_jp(FULL))
    state = jax_engine._init_batch(jtb, jep, sweep=False)
    for _ in range(2):
        state = jax_engine._run_chunk(state, jtb, jep, chunk=chunk,
                                      kernel=None, sweep=False,
                                      features=feats)
    assert not bool(np.asarray(state.finished).all())
    np_state = jax.tree_util.tree_map(np.asarray, state)
    np_ep = jax.tree_util.tree_map(np.asarray, jep)
    tb, ep, st = engine.from_reference(jtb, np_ep, np_state, device="cpu")
    max_ticks = jax_engine.default_max_ticks(jtb, FULL.delta)
    got = engine._drive(tb, ep, max_ticks, chunk,
                        features=engine.features_for(FULL), state=st,
                        events=2 * chunk)
    want = jax_engine.simulate_batch(traces, _jp(FULL), chunk=chunk)
    _assert_same(got, want)


def test_from_reference_refuses_what_is_not_ported():
    """Leaf-spine batches and session states are carried now; pilot
    sampling (batches and learned lanes) is still refused."""
    from repro.fabric.topology import LeafSpine

    tr = [jax_family_trace("uniform", seed=1)]
    leaf = jbatch.pack(tr, port_bw=1.0, topology=LeafSpine(
        hosts_per_leaf=3, oversub=2.0))
    ep = jax.tree_util.tree_map(
        np.asarray, jax_engine.EngineParams.from_scheduler(_jp(FULL)))
    tb, _, _ = engine.from_reference(leaf, ep, device="cpu")
    assert tb.bw_up.shape[-1] == leaf.num_leaf_links > 0
    np.testing.assert_array_equal(tb.link_up.numpy(), leaf.link_up)
    piloted = jbatch.pack(tr, port_bw=1.0, sampling=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        engine.from_reference(piloted, ep, device="cpu")
    tb = jbatch.pack(tr, port_bw=1.0)
    learned = jax.tree_util.tree_map(
        np.asarray, jax_engine.EngineParams.from_scheduler(
            _jp(FULL), clairvoyant=False))
    with pytest.raises(NotImplementedError, match="item 6"):
        engine.from_reference(tb, learned, device="cpu")
    state = jax.tree_util.tree_map(
        np.asarray, jax_engine._init_batch(tb, jax_engine.EngineParams
                                           .from_scheduler(_jp(FULL)),
                                           sweep=False))
    rng = np.random.default_rng(3)
    B = state.sent.shape[0]
    session = state._replace(
        rate=rng.uniform(0.0, 2.0, state.sent.shape).astype(np.float32),
        pend_sent=rng.uniform(0.0, 5.0, state.sent.shape).astype(
            np.float32),
        pend_tick=np.full(B, 7.0, np.float32),
        pend_next=np.full(B, 19.0, np.float32))
    _, _, st = engine.from_reference(tb, ep, session, device="cpu")
    for name in ("rate", "pend_sent", "pend_tick", "pend_next"):
        got = getattr(st, name)
        assert got.dtype == torch.float32, name
        np.testing.assert_array_equal(got.numpy(), getattr(session, name),
                                      err_msg=name)


@pytest.mark.slow
def test_regenerate_fb_golden():
    """Recompute the full-width reference: two fb_like_trace(526, 150)
    lanes under the JAX package on the CPU (a few minutes)."""
    from repro.api import Scenario, run

    gold = json.loads(GOLDEN.read_text())
    res = run(Scenario(engine="jax", traces=tuple(
        jsynth.fb_like_trace(526, 150, seed=s) for s in gold["seeds"])))
    gold.update(avg_cct=[float(x) for x in res.avg_cct],
                events=res.steps // len(gold["seeds"]),
                jax=jax.__version__)
    GOLDEN.write_text(json.dumps(gold, indent=1) + "\n")


@pytest.mark.slow
def test_regenerate_leafspine_golden():
    """Recompute the leaf-spine max-min reference: two fb_like_trace(48,
    150) lanes under LeafSpine(4, 4.0, "maxmin") in the JAX package on
    the CPU (about 100 s)."""
    from repro.api import Scenario, run
    from repro.fabric.topology import LeafSpine

    seeds = (0, 1)
    topo = LeafSpine(hosts_per_leaf=4, oversub=4.0, wc_fill="maxmin")
    res = run(Scenario(engine="jax", traces=tuple(
        jsynth.fb_like_trace(48, 150, seed=s) for s in seeds),
        topology=topo))
    gold = {
        "what": "avg CCT per lane of the JAX package's leaf-spine max-min "
                "fleet replay, the reference for chip_smoke.py's leaf-spine "
                "whole-path parity check",
        "call": "repro.api.run(Scenario(engine='jax', traces=tuple("
                "fb_like_trace(48, 150, seed=s) for s in (0, 1)), "
                "topology=LeafSpine(hosts_per_leaf=4, oversub=4.0, "
                "wc_fill='maxmin')))",
        "params": "SchedulerParams() defaults, fidelity='flow', dynamics "
                  "re-queue on",
        "topology": repr(topo),
        "platform": "cpu",
        "jax": jax.__version__,
        "regenerate": "PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q "
                      "-m slow tests/test_torch_engine.py -k leafspine_golden",
        "seeds": list(seeds),
        "avg_cct": [float(x) for x in res.avg_cct],
        "events": res.steps // len(seeds),
    }
    LEAF_GOLDEN.write_text(json.dumps(gold, indent=1) + "\n")
