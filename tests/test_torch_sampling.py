"""The port's non-clairvoyant (pilot-learned) Saath against the JAX
package's, on the CPU: the counterparts of `tests/test_sampling.py`.

* `core.sampling` (pilot layout, `SizeEstimator`) and the packed pilot
  leaf equal the reference's exactly;
* `tick_core` with the pilot inputs (`s_mixed`, `s_m`) and a per-lane
  `clairvoyant` leaf: queue, order, contention, expiry and admission
  exact, rates at ROADMAP C1's bar;
* learned replays (`tiny_trace(10, 12, seed=5/6, load=1.2)`, the
  reference's own inputs, and a leaf-spine one) take the JAX package's
  event count and its per-coflow CCTs bit for bit (the pilot byte sums
  add in its scan order, ROADMAP C9); sweeps and carried states are
  held to the reference's learned bar (rtol 1e-2, atol 2δ);
  `clairvoyant=True` is bit for bit the default program, and in a mixed
  sweep the known row is bit for bit its solo run;
* a piloted JAX state carried over with `from_reference` takes the same
  next tick;
* serving plane: learned tenants join a pool pinned with sampling with
  no full upload beyond the first, a pool pinned without it refuses
  them, a learned session agrees with the JAX learned session, and the
  online replay equals the offline one bit for bit: the pilot estimate's
  float byte sum adds in the JAX package's scan order, which no slab
  row's layout or padding changes.

A `slow` test regenerates tests/data/torch_port_learned_golden.json.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_coordinator as jc
from repro.core import sampling as jsampling
from repro.core.params import SchedulerParams as JParams
from repro.fabric import jax_engine
from repro.fabric.state import FlowTable as JFlowTable
from repro.traces import batch as jbatch
from repro.traces import synth as jsynth
from repro_torch.api import Scenario, SaathSession, SessionPool, run
from repro_torch.core import coordinator as co
from repro_torch.core import sampling
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric import engine
from repro_torch.fabric.state import FlowTable
from repro_torch.fabric.topology import LeafSpine
from repro_torch.traces import batch as pbatch

from tests.test_torch_coordinator import _compare, _jax_lane
from tests.test_torch_cuda import UNIT, random_tick_inputs, torch_tick_args
from tests.test_torch_engine import _port_trace

GOLDEN = Path(__file__).parent / "data" / "torch_port_learned_golden.json"
PORTS = 12
DYN = SchedulerParams(dynamics_requeue=True)
LEARNED = dataclasses.replace(DYN, clairvoyant=False)
LEARNED_MECH = {"clairvoyant": False}
# the learned bar (tests/test_sampling.py:155-165), also ROADMAP C9's
RTOL, ATOL = 1e-2, 2 * DYN.delta


def _jp(p: SchedulerParams) -> JParams:
    return JParams(**dataclasses.asdict(p))


def _tiny(n, seed, load):
    """`tiny_trace` of the JAX package and the same trace as the port's
    objects."""
    jt = jsynth.tiny_trace(n, PORTS, seed=seed, load=load)
    return jt, _port_trace(jt)


def _within_bar(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---- pilot layout and estimator -------------------------------------------


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
def test_pilot_layout_matches_the_reference(frac):
    rng = np.random.default_rng(int(100 * frac))
    width = rng.integers(1, 60, 40)
    lo = np.concatenate([[0], np.cumsum(width)[:-1]])
    cid = np.repeat(np.arange(width.size), width)
    np.testing.assert_array_equal(sampling.pilot_count(width, frac),
                                  jsampling.pilot_count(width, frac))
    np.testing.assert_array_equal(
        sampling.pilot_mask(cid, lo, width, frac),
        jsampling.pilot_mask(cid, lo, width, frac))


@pytest.mark.parametrize("seed", [0, 1])
def test_size_estimator_matches_the_reference(seed):
    jt, pt = _tiny(16, seed, 1.0)
    jtab = JFlowTable.from_trace(jt, DYN.port_bw)
    ptab = FlowTable.from_trace(pt, DYN.port_bw)
    rng = np.random.default_rng(seed)
    F = ptab.size.size
    done = rng.uniform(size=F) < 0.4
    sent = np.where(done, ptab.size, ptab.size * rng.uniform(size=F))
    for tab in (jtab, ptab):
        tab.done[:] = done
        tab.sent[:] = sent
    p = dataclasses.replace(LEARNED, pilot_frac=0.3)
    want = jsampling.SizeEstimator(_jp(p)).estimates(jtab)
    got = sampling.SizeEstimator(p).estimates(ptab)
    assert got[2].any() and not got[2].all()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_packed_pilot_leaf_matches_the_reference():
    """`pack(sampling=True)` writes the reference's pilot leaf; a blanked
    row clears it, `pack_row` bakes it from the packed cid/flow_lo/width,
    and `stack_rows` carries it."""
    jts = [jsynth.fb_like_trace(60, 20, seed=3)] + \
        [jsynth.tiny_trace(12, 8, seed=s) for s in range(2)]
    pts = [_port_trace(t) for t in jts]
    for frac in (0.1, 0.5):
        jb = jbatch.pack(jts, port_bw=1.25e8, sampling=True, pilot_frac=frac)
        pb = pbatch.pack(pts, port_bw=1.25e8, sampling=True, pilot_frac=frac)
        assert pb.pilot is not None and pb.pilot.dtype == bool
        for name in jb._fields:
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(jb, name), err_msg=name)
    assert pbatch.pack(pts, port_bw=1.25e8).pilot is None
    # the row primitives of the pool's slab
    tb = pbatch.empty_batch(2, flow_capacity=pb.max_flows,
                            coflow_capacity=pb.max_coflows,
                            port_capacity=pb.num_ports, sampling=True)
    table = FlowTable.from_trace(pts[1], 1.25e8)
    pbatch.pack_row(tb, 1, table, pilot_frac=0.5)
    np.testing.assert_array_equal(tb.pilot[1], pb.pilot[1])
    stacked = pbatch.stack_rows([pbatch.row_of(tb, 1), pbatch.row_of(tb, 0)])
    np.testing.assert_array_equal(stacked.pilot[0], pb.pilot[1])
    assert not stacked.pilot[1].any()
    pbatch.blank_row(tb, 1)
    assert not tb.pilot.any()


# ---- the coordinator tick --------------------------------------------------


@pytest.mark.parametrize("flows", [True, False])
def test_learned_tick_matches_jax_per_lane(flows):
    """B = 3 lanes, learned (0.0), known (1.0) and learned: the pilot
    re-queue moves the learned lanes' queues, the known lane reads the
    exact median, each against the JAX tick with the same leaf."""
    B, C, P = 3, 48, 6
    d = random_tick_inputs(B, C, P, seed=11 + flows, params=UNIT)
    rng = np.random.default_rng(5)
    d["s_mixed"] = d["active"] & (rng.uniform(size=(B, C)) < 0.5)
    d["s_m"] = (d["m"] * rng.uniform(0.0, 30.0, (B, C))).astype(np.float32)
    clair = np.array([0.0, 1.0, 0.0], np.float32)
    state, batch, fv = torch_tick_args(d, "cpu", flows=flows)
    batch = batch._replace(s_mixed=torch.as_tensor(d["s_mixed"]),
                           s_m=torch.as_tensor(d["s_m"]))
    dp = co.DynCoordParams.from_cp(co.CoordParams.from_params(UNIT)).lanes(
        B)._replace(clairvoyant=torch.as_tensor(clair))
    now = torch.full((B,), float(d["now"]))
    ps, pout = co.tick_core(state, batch, now, dp, flows=fv)
    _, known = co.tick_core(state, batch, now, dp._replace(
        clairvoyant=torch.ones(B)), flows=fv)
    assert not torch.equal(pout["queue"][0], known["queue"][0])
    assert torch.equal(pout["queue"][1], known["queue"][1])
    jdp = jc.DynCoordParams.from_cp(jc.CoordParams.from_params(_jp(UNIT)))
    for b in range(B):
        jstate, jbatch_, jfv = _jax_lane(d, b, flows)
        jbatch_ = jbatch_._replace(s_mixed=jnp.asarray(d["s_mixed"][b]),
                                   s_m=jnp.asarray(d["s_m"][b]))
        js, jout = jc.tick_core(
            jstate, jbatch_, jnp.float32(d["now"]),
            jdp._replace(clairvoyant=jnp.float32(clair[b])), flows=jfv)
        _compare(jout, js, pout, ps, b, bw=UNIT.port_bw)


@pytest.mark.parametrize("dyn,clair", [(True, True), (True, False),
                                       (False, True), (False, False)])
def test_features_for_matches_the_reference(dyn, clair):
    p = dataclasses.replace(DYN, dynamics_requeue=dyn, clairvoyant=clair)
    topo = LeafSpine(4, 4.0, "maxmin")
    for kw in ({}, dict(lcof=False), dict(topology=topo)):
        assert engine.features_for(p, **kw) == \
            jax_engine.features_for(_jp(p), **kw)
    assert engine._norm_features((True, True)) == \
        jax_engine._norm_features((True, True))


# ---- offline replays ------------------------------------------------------


def test_learned_replay_matches_the_reference():
    """tests/test_sampling.py's learned inputs through both engines."""
    pair = [_tiny(10, s, 1.2) for s in (5, 6)]
    want = jax_engine.simulate_batch([j for j, _ in pair], _jp(LEARNED))
    got = engine.simulate_batch([p for _, p in pair], LEARNED,
                                device="cpu")
    assert got.events == want.events and got.ticks == want.ticks
    assert got.finished.all()
    np.testing.assert_array_equal(got.cct, want.cct)


def test_learned_leafspine_replay_matches_the_reference():
    """Learned sizes under the leaf-spine max-min fill (K3's path)."""
    from repro.fabric.topology import LeafSpine as JLeafSpine

    jt, pt = _tiny(8, 2, 1.2)
    want = jax_engine.simulate_batch(
        [jt], _jp(LEARNED), topology=JLeafSpine(3, 2.0, "maxmin"))
    got = engine.simulate_batch([pt], LEARNED, device="cpu",
                                topology=LeafSpine(3, 2.0, "maxmin"))
    assert got.events == want.events
    np.testing.assert_array_equal(got.cct, want.cct)


def test_clairvoyant_explicit_bitwise_equals_default():
    traces = [_tiny(8, s, 1.2)[1] for s in (0, 1)]
    base = engine.simulate_batch(traces, DYN, device="cpu")
    expl = engine.simulate_batch(traces, DYN, clairvoyant=True,
                                 device="cpu")
    np.testing.assert_array_equal(base.cct, expl.cct)
    np.testing.assert_array_equal(base.fct, expl.fct)


def test_mixed_sweep_keeps_the_known_row_bitwise():
    """Building the pilot estimate in (a learned row in the sweep) leaves
    the known row bit for bit its solo run; the learned row is its own
    solo run, a different schedule, and the JAX sweep's at the bar."""
    jt, pt = _tiny(10, 3, 1.2)
    solo = engine.simulate_batch([pt], DYN, device="cpu")
    solo_l = engine.simulate_batch([pt], LEARNED, device="cpu")
    sweep = engine.simulate_sweep(pt, [DYN, LEARNED], device="cpu")
    np.testing.assert_array_equal(sweep.cct[0], solo.cct[0])
    np.testing.assert_array_equal(sweep.cct[1], solo_l.cct[0])
    assert not np.array_equal(sweep.cct[1], solo.cct[0])
    want = jax_engine.simulate_sweep(jt, [_jp(DYN), _jp(LEARNED)])
    assert sweep.events == want.events
    _within_bar(sweep.cct, want.cct)


def test_learned_mode_changes_the_schedule():
    pt = _tiny(12, 7, 2.0)[1]
    known = engine.simulate_batch([pt], DYN, device="cpu")
    learned = engine.simulate_batch([pt], LEARNED, device="cpu")
    assert not np.array_equal(known.cct, learned.cct)


def test_learned_runs_refuse_what_they_cannot_run():
    pt = _tiny(6, 0, 1.0)[1]
    bare = pbatch.pack([pt], port_bw=DYN.port_bw)
    with pytest.raises(ValueError, match="sampling=True"):
        engine.simulate_batch(bare, LEARNED, device="cpu")
    with pytest.raises(ValueError, match="pilot_frac"):
        engine.simulate_sweep(pt, [LEARNED, dataclasses.replace(
            LEARNED, pilot_frac=0.5)], device="cpu")


def test_scenario_learned_run_and_sweep():
    """The front door: `Scenario(clairvoyance=False)`, the "clairvoyant"
    mechanism, and a sweep over known and learned settings."""
    pt = _tiny(10, 5, 1.2)[1]
    want = engine.simulate_batch([pt], LEARNED, device="cpu")
    for kw in (dict(clairvoyance=False), dict(mechanisms=LEARNED_MECH)):
        res = run(Scenario(trace=pt, params=DYN, device="cpu", **kw))
        np.testing.assert_array_equal(res.cct, want.cct)
    sw = run(Scenario(trace=pt, sweep=(DYN, LEARNED), device="cpu"))
    np.testing.assert_array_equal(sw.cct[1], want.cct[0])


def test_piloted_jax_state_takes_the_same_next_tick():
    """Two chunks of a learned JAX replay carried over with
    `from_reference` (pilot leaf and clairvoyant leaf): the port's next
    tick equals the JAX package's, and the port finishes the replay
    within the learned bar."""
    jts = [_tiny(10, s, 1.2)[0] for s in (5, 6)]
    jp = _jp(LEARNED)
    jtb = jbatch.pack(jts, port_bw=jp.port_bw, sampling=True)
    jep = jax_engine.EngineParams.from_scheduler(jp)
    feats = jax_engine.features_for(jp)
    assert feats[4]
    state = jax_engine._init_batch(jtb, jep, sweep=False)
    for _ in range(2):
        state = jax_engine._run_chunk(state, jtb, jep, chunk=8, kernel=None,
                                      sweep=False, features=feats)
    nxt = jax_engine._run_chunk(state, jtb, jep, chunk=1, kernel=None,
                                sweep=False, features=feats)
    np_ep = jax.tree_util.tree_map(np.asarray, jep)
    tb, ep, st = engine.from_reference(
        jtb, np_ep, jax.tree_util.tree_map(np.asarray, state), device="cpu")
    assert tb.pilot is not None and ep.dp.clairvoyant is not None
    got = engine._run_chunk(st, tb, ep, chunk=1, features=feats)
    want = jax.tree_util.tree_map(np.asarray, nxt)
    for name in ("sent", "done", "finished", "cct", "tick"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.coord.queue.numpy(), want.coord.queue)
    max_ticks = jax_engine.default_max_ticks(jtb, LEARNED.delta)
    res = engine._drive(tb, ep, max_ticks, 8, features=feats, state=st,
                        events=16)
    _within_bar(res.cct, jax_engine.simulate_batch(jts, jp, chunk=8).cct)


# ---- the serving plane ----------------------------------------------------


def _pool(**kw):
    return SessionPool(DYN, num_ports=PORTS, device="cpu", **kw)


def _collect(pool, got):
    for s, d in pool.poll():
        got.setdefault(id(s), {})[d.handle] = d.cct


def test_pool_with_sampling_admits_a_learned_tenant_mid_flight():
    """tests/test_sampling.py's pinned-pool join: the learned tenant
    joins a pool pinned with sampling by row scatters, no full upload
    beyond the first, and its CCTs are a standalone learned session's
    at the C9 bar."""
    pool = _pool(max_sessions=4, min_flow_capacity=256,
                 features=(True, True, False, False, True))
    a = pool.session()
    a.submit(_tiny(4, 3, 1.5)[1].coflows)
    pool.advance(0.5)
    b = pool.session()
    b.submit(_tiny(4, 4, 1.5)[1].coflows)
    pool.advance(0.5)
    got = {}
    _collect(pool, got)
    uploads = pool.io["full_uploads"]
    assert uploads == 1
    c = pool.session(mechanisms=LEARNED_MECH)
    joined = _tiny(4, 5, 1.5)[1].coflows
    c.submit(joined)
    pool.advance(0.5)
    pool.advance(60.0)
    _collect(pool, got)
    assert pool.io["full_uploads"] == uploads
    assert pool._tb.pilot is not None
    assert len(got[id(c)]) == len(joined)
    solo = SaathSession(LEARNED, num_ports=PORTS, device="cpu")
    solo.submit(joined)
    solo.advance(0.5)
    solo.advance(60.0)
    want = {d.handle: d.cct for d in solo.poll()}
    _within_bar(np.array([got[id(c)][h] for h in sorted(want)]),
                np.array([want[h] for h in sorted(want)]))


def test_pool_without_sampling_pin_refuses_a_learned_tenant():
    pool = _pool(max_sessions=2, features=(True, True, False, False))
    assert pool._pinned == (True, True, False, False, False)
    pool.session()
    with pytest.raises(ValueError, match="with_sampling"):
        pool.session(mechanisms=LEARNED_MECH)
    with pytest.raises(ValueError, match="with_sampling"):
        pool.session(params=LEARNED)


def test_pool_sampling_switch_is_a_full_rebuild_and_keeps_known_rows():
    """An unpinned pool turns sampling on when a learned tenant joins: a
    full rebuild (the pilot mask is a slab leaf), a 1.0 clairvoyant leaf
    on the known rows, and the known tenant's CCTs bit for bit a
    standalone known session's."""
    wl = _tiny(6, 1, 1.2)[1].coflows
    pool = _pool(max_sessions=2)
    known = pool.session()
    known.submit(wl)
    pool.advance(0.3)
    assert pool._tb.pilot is None and pool.io["full_uploads"] == 1
    learned = pool.session(mechanisms=LEARNED_MECH)
    learned.submit(_tiny(6, 2, 1.2)[1].coflows)
    pool.advance(0.3)
    assert pool._tb.pilot is not None and pool.io["full_uploads"] == 2
    np.testing.assert_array_equal(pool._ep_stack.dp.clairvoyant.numpy(),
                                  [1.0, 0.0])
    pool.advance(60.0)
    got = {}
    _collect(pool, got)
    solo = SaathSession(DYN, num_ports=PORTS, device="cpu")
    solo.submit(wl)
    for dt in (0.3, 0.3, 60.0):
        solo.advance(dt)
    want = {d.handle: d.cct for d in solo.poll()}
    assert got[id(known)] == want


def test_learned_session_matches_the_jax_learned_session():
    """tests/test_sampling.py:217-237's inputs, port against the JAX
    package's `SaathSession(backend="jax")` (rtol 1e-2)."""
    from repro.api.session import SaathSession as JaxSession

    jt, pt = _tiny(8, 9, 1.5)
    ccts = {}
    for name, sess, tr in (
            ("jax", JaxSession(_jp(LEARNED), num_ports=PORTS,
                               backend="jax"), jt),
            ("torch", SaathSession(LEARNED, num_ports=PORTS, device="cpu"),
             pt)):
        sess.submit(tr.coflows)
        done = {}
        for _ in range(4000):
            sess.advance(0.05)
            done.update({d.handle: d.cct for d in sess.poll()})
            if len(done) == 8:
                break
        assert len(done) == 8
        ccts[name] = np.array([done[h] for h in sorted(done)])
    np.testing.assert_allclose(ccts["torch"], ccts["jax"], rtol=1e-2)


@pytest.mark.parametrize("seed", [5, 6])
def test_learned_online_equals_offline_at_the_c9_bar(seed):
    """Submitting a trace's coflows at their arrival times against the
    offline learned replay: bit for bit, since the pilot sums add in
    the JAX package's scan order on both (ROADMAP C9; the count of
    differing CCTs is printed)."""
    pt = _tiny(10, seed, 1.2)[1]
    sess = SaathSession(LEARNED, num_ports=PORTS, device="cpu")
    cid_of, out = {}, np.full(len(pt.coflows), np.nan)
    for c in sorted(pt.coflows, key=lambda c: (c.arrival, c.cid)):
        sess.advance(max(c.arrival - sess.now, 0.0))
        cid_of[sess.submit([c])[0]] = c.cid
        for d in sess.poll():
            out[cid_of[d.handle]] = d.cct
    for d in sess.drain(step=5.0, max_seconds=500.0):
        out[cid_of[d.handle]] = d.cct
    want = run(Scenario(trace=pt, params=LEARNED, device="cpu")).row_cct()
    print(f"seed {seed}: {int((out != want).sum())} of {out.size} "
          f"CCTs differ from the offline replay")
    np.testing.assert_array_equal(out, want)


# ---- the golden chip_smoke.py holds the card to ---------------------------


@pytest.mark.slow
def test_full_width_learned_lanes_equal_the_golden():
    """ROADMAP C9's own input: lanes 0 and 1 of the full-width learned
    fleet (fb_like_trace(526, 150, seed=0/1)) through the port on the
    CPU take the JAX package's event count, and their avg CCTs sit within
    1e-6 of its (lane 1 was 1.1e-4 off while the pilot sums were taken
    in another order; what is left is C10's last-bit rounding). About
    eight minutes here."""
    from repro_torch.traces.synth import fb_like_trace

    gold = json.loads(GOLDEN.read_text())
    res = run(Scenario(traces=tuple(fb_like_trace(526, 150, seed=s)
                                    for s in gold["seeds"]),
                       clairvoyance=False, device="cpu"))
    assert res.events == gold["fleet"]["events"]
    np.testing.assert_allclose(res.avg_cct, gold["fleet"]["avg_cct"],
                               rtol=1e-6, atol=0)


@pytest.mark.slow
def test_regenerate_learned_golden():
    """Recompute tests/data/torch_port_learned_golden.json under the JAX
    package on the CPU: lanes 0 and 1 of the full-width learned fleet,
    the learned leaf-spine pair and fig_sampling's three jax-plane lanes
    (several minutes)."""
    from repro.api import Scenario as JScenario, run as jrun
    from repro.fabric.topology import LeafSpine as JLeafSpine

    seeds = (0, 1)
    full = jrun(JScenario(engine="jax", clairvoyance=False, traces=tuple(
        jsynth.fb_like_trace(526, 150, seed=s) for s in seeds)))
    topo = JLeafSpine(hosts_per_leaf=4, oversub=4.0, wc_fill="maxmin")
    leaf = jrun(JScenario(engine="jax", clairvoyance=False, topology=topo,
                          traces=tuple(jsynth.fb_like_trace(48, 150, seed=s)
                                       for s in seeds)))
    p = JParams(dynamics_requeue=True)
    tr = jsynth.fb_like_trace(240, 100, seed=0)
    lanes = {"known": dict(clairvoyance=True),
             "learned": dict(clairvoyance=False),
             "aalo-like": dict(mechanisms=dict(lcof=False,
                                               per_flow_threshold=False))}
    fig = {}
    for lane, kw in lanes.items():
        r = jrun(JScenario(engine="jax", trace=tr, params=p, **kw))
        fig[lane] = {"avg_cct": float(r.avg_cct[0]), "events": r.steps}
    gold = {
        "what": "avg CCT and event steps of the JAX package's learned-size "
                "(non-clairvoyant) replays, the reference for chip_smoke.py's "
                "phase 18",
        "calls": {
            "fleet": "repro.api.run(Scenario(engine='jax', "
                     "clairvoyance=False, traces=tuple(fb_like_trace(526, "
                     "150, seed=s) for s in (0, 1))))",
            "leafspine": "the same with fb_like_trace(48, 150, seed=s) and "
                         "topology=LeafSpine(hosts_per_leaf=4, oversub=4.0, "
                         "wc_fill='maxmin')",
            "fig_sampling": "benchmarks/fig_sampling.py's jax-plane lanes: "
                            "trace=fb_like_trace(240, 100, seed=0), params="
                            "SchedulerParams(dynamics_requeue=True), "
                            "clairvoyance=True / False / mechanisms=dict("
                            "lcof=False, per_flow_threshold=False)"},
        "params": "SchedulerParams() defaults (pilot_frac 0.1), "
                  "fidelity='flow', dynamics re-queue on",
        "platform": "cpu",
        "jax": jax.__version__,
        "regenerate": "PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q "
                      "-m slow tests/test_torch_sampling.py -k golden",
        "seeds": list(seeds),
        "fleet": {"avg_cct": [float(x) for x in full.avg_cct],
                  "events": full.steps // len(seeds)},
        "leafspine": {"avg_cct": [float(x) for x in leaf.avg_cct],
                      "events": leaf.steps // len(seeds)},
        "fig_sampling": fig,
    }
    GOLDEN.write_text(json.dumps(gold, indent=1) + "\n")
