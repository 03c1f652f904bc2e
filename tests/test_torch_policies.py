"""The port's event-driven host plane against the JAX package's, on the
CPU.

`repro_torch.api.run(Scenario(engine="numpy", device="cpu"))` replays a
trace through the port's `fabric.simulator.Simulator` under every
registry policy; `repro.api.run(Scenario(engine="numpy"))` replays the
same trace (built by each package's own classes from the same draws)
through the reference. On `tests/test_jax_engine.py`'s three families
(uniform shuffles, skewed widths, staggered arrivals), unit-scale
parameters with the §4.3 re-queue on:

* the eight host policies (saath, aalo, fifo, scf, srtf, lwtf,
  varys-sebf, uc-tcp) on the big switch and on `LeafSpine(4, 4.0)`
  with both work-conservation fills take the reference's steps and give
  its per-coflow CCTs and per-flow FCTs bit for bit; so do learned
  (`clairvoyance=False`) Saath, the Fig. 10 ablations and the
  beyond-paper admitted-coflow round (the contention count runs through
  `ops.contention`: exact integers);
* `saath-torch` (the port's coordinator tick, one tick a schedule)
  takes the steps of the reference's `saath-jax` on the families, its
  CCTs within the reference's own engine bar (rtol 1e-2, atol 2δ; the
  deadline FMA of ROADMAP C1 moves a deadline event by one δ, C12), and
  stays within that bar of numpy Saath; on a leaf-spine fabric, where
  `saath-jax` ignores the fabric, it is held to numpy Saath's bar;
* `SaathSession(backend="numpy")` fed a trace's coflows at their
  arrival times equals the offline replay bit for bit, and the
  reference's numpy session too;
* `core.contention.contention` equals the reference's sgemm count.

`slow` tests replay the FB-width trace (526 coflows, 150 ports) through
Saath and Aalo in both packages, and regenerate
`tests/data/torch_port_numpy_golden.json`, the reference numbers
`chip_smoke.py` holds the card's host plane against.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import Scenario as JScenario, SaathSession as JSession
from repro.api import run as jrun
from repro.core.params import SchedulerParams as JParams
from repro.fabric.topology import LeafSpine as JLeafSpine
from repro_torch.api import SaathSession, Scenario, run
from repro_torch.core.coflow import Coflow, Flow, Trace
from repro_torch.core.params import SchedulerParams
from repro_torch.core.policies import (REGISTRY, available, make_policy,
                                       resolve_policy)
from repro_torch.fabric.simulator import Simulator
from repro_torch.fabric.state import FlowTable
from repro_torch.fabric.topology import LeafSpine

from tests.test_jax_engine import FAMILIES, _trace as jax_family_trace

GOLDEN = Path(__file__).parent / "data" / "torch_port_numpy_golden.json"
FULL = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                       growth=4.0, num_queues=5)
HOST = ("saath", "aalo", "fifo", "scf", "srtf", "lwtf", "varys-sebf",
        "uc-tcp")
FABRICS = {"bigswitch": (None, None),
           "leaf-greedy": (LeafSpine(4, 4.0, "greedy"),
                           JLeafSpine(4, 4.0, "greedy")),
           "leaf-maxmin": (LeafSpine(4, 4.0, "maxmin"),
                           JLeafSpine(4, 4.0, "maxmin"))}
# Fig. 10's ablation lanes (benchmarks/fig10_breakdown.py) and the two
# params-field switches
ABLATIONS = {"A/N": dict(lcof=False, per_flow_threshold=False),
             "A/N+PF": dict(lcof=False, per_flow_threshold=True),
             "no-wc": dict(work_conservation=False),
             "no-dynamics": dict(dynamics_requeue=False)}


def _jp(p: SchedulerParams) -> JParams:
    return JParams(**dataclasses.asdict(p))


def _port_trace(tr) -> Trace:
    """The same trace as the port's own objects (no shared classes)."""
    return Trace(tr.num_ports, [
        Coflow(c.cid, c.arrival,
               [Flow(f.fid, f.src, f.dst, f.size) for f in c.flows])
        for c in tr.coflows])


def _pair(jtrace, policy, jpolicy=None, params=FULL, fabric="bigswitch",
          **kw):
    """(port Result, reference Result) of one numpy-engine replay."""
    topo, jtopo = FABRICS[fabric]
    got = run(Scenario(engine="numpy", policy=policy,
                       trace=_port_trace(jtrace), params=params,
                       topology=topo, device="cpu", **kw))
    want = jrun(JScenario(engine="numpy", policy=jpolicy or policy,
                          trace=jtrace, params=_jp(params), topology=jtopo,
                          **kw))
    return got, want


def _assert_bitwise(got, want):
    assert got.steps == want.steps
    np.testing.assert_array_equal(got.cct, want.cct)
    np.testing.assert_array_equal(got.fct, want.fct)
    np.testing.assert_array_equal(got.sent, want.sent)


@pytest.mark.parametrize("fabric", sorted(FABRICS))
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("policy", HOST)
def test_host_policy_equals_the_reference_bitwise(policy, family, fabric):
    got, want = _pair(jax_family_trace(family, seed=1, n=8), policy,
                      fabric=fabric)
    assert np.isfinite(got.row_cct()).all()
    _assert_bitwise(got, want)


@pytest.mark.parametrize("fabric", ["bigswitch", "leaf-maxmin"])
@pytest.mark.parametrize("family", FAMILIES)
def test_learned_saath_equals_the_reference_bitwise(family, fabric):
    """Pilot-learned sizes (`clairvoyance=False`): the §4.3 re-queue runs
    off the pilot estimate in both packages."""
    got, want = _pair(jax_family_trace(family, seed=2, n=8), "saath",
                      fabric=fabric, clairvoyance=False)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("fabric", ["bigswitch", "leaf-greedy"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("ablation", sorted(ABLATIONS))
def test_fig10_ablations_equal_the_reference_bitwise(ablation, family,
                                                      fabric):
    got, want = _pair(jax_family_trace(family, seed=3, n=8), "saath",
                      fabric=fabric, mechanisms=ABLATIONS[ablation])
    _assert_bitwise(got, want)


@pytest.mark.parametrize("fabric", ["bigswitch", "leaf-maxmin"])
def test_admitted_round_and_max_jump_equal_the_reference(fabric):
    """The beyond-paper admitted-coflow round, a short event horizon
    and policy kwargs pass through to the same replay."""
    p = dataclasses.replace(FULL, wc_admitted_round=True)
    got, want = _pair(jax_family_trace("skewed", seed=4, n=8), "saath",
                      params=p, fabric=fabric, max_jump=0.05,
                      policy_kwargs={"all_or_none": False})
    _assert_bitwise(got, want)


def test_sweep_loops_one_setting_per_row():
    jt = jax_family_trace("uniform", seed=5, n=8)
    sweep = tuple(dataclasses.replace(FULL, start_threshold=s)
                  for s in (2.0, 8.0))
    got = run(Scenario(engine="numpy", policy="lwtf",
                       trace=_port_trace(jt), sweep=sweep, device="cpu"))
    want = jrun(JScenario(engine="numpy", policy="lwtf", trace=jt,
                          sweep=tuple(_jp(p) for p in sweep)))
    assert got.batch == 2 and got.params_rows == list(sweep)
    _assert_bitwise(got, want)
    assert got.table(1).finished.all()


# ---- saath-torch: the coordinator tick, one tick a schedule -------------

@pytest.mark.parametrize("family", FAMILIES)
def test_saath_torch_tracks_saath_jax(family):
    """Steps equal to `saath-jax`'s. CCTs within the reference's engine
    bar (rtol 1e-2, atol 2δ), not bit for bit: the reference's CPU
    backend fuses the tick's deadline `now + d * C_q * t` into one FMA
    and the port rounds the product first (ROADMAP C1), and this policy
    hands the f32 deadline to the simulator as an event instant, so a
    deadline one ulp later lands one δ tick later (ROADMAP C12: two of
    the skewed family's eight CCTs, by one δ)."""
    jt = jax_family_trace(family, seed=0, n=8)
    got, want = _pair(jt, "saath-torch", jpolicy="saath-jax")
    assert got.steps == want.steps
    np.testing.assert_allclose(got.cct, want.cct, rtol=1e-2,
                               atol=2 * FULL.delta)
    numpy_saath = jrun(JScenario(engine="numpy", trace=jt,
                                 params=_jp(FULL)))
    np.testing.assert_allclose(got.row_cct(), numpy_saath.row_cct(),
                               rtol=1e-2, atol=2 * FULL.delta)


def _deadline_fma(now, factor, n_q, t_min):
    """The reference's fused deadline: `factor * n_q` rounded to f32,
    then its product with `t_min` (exact in f64) plus `now`, rounded
    once to f32."""
    prod = (factor * n_q).double() * t_min.double()
    return (prod + now.double()).float()


@pytest.mark.parametrize("family", FAMILIES)
def test_saath_torch_with_the_deadline_fma_equals_saath_jax(family,
                                                            monkeypatch):
    """Pins ROADMAP C12's cause: with the tick's D5 deadline formed as
    the reference's CPU backend forms it (one FMA), `saath-torch` gives
    `saath-jax`'s steps, CCTs and FCTs bit for bit on every family,
    the skewed family's two CCTs that land one δ late without it
    included."""
    from repro_torch.core import coordinator as co

    monkeypatch.setattr(co, "_deadline", _deadline_fma)
    got, want = _pair(jax_family_trace(family, seed=0, n=8), "saath-torch",
                      jpolicy="saath-jax")
    _assert_bitwise(got, want)


def test_saath_torch_on_a_leafspine_within_the_numpy_bar():
    """Under a 4:1 max-min leaf-spine fabric `saath-torch` allocates
    against the links (K3's fill on the card) and stays within the
    reference's engine bar of numpy Saath on the same fabric."""
    jt = jax_family_trace("uniform", seed=6, n=8)
    tr = _port_trace(jt)
    got = run(Scenario(engine="numpy", policy="saath-torch", trace=tr,
                       params=FULL, topology=LeafSpine(4, 4.0, "maxmin"),
                       device="cpu"))
    want = run(Scenario(engine="numpy", policy="saath", trace=tr,
                        params=FULL, topology=LeafSpine(4, 4.0, "maxmin"),
                        device="cpu"))
    np.testing.assert_allclose(got.row_cct(), want.row_cct(), rtol=1e-2,
                               atol=2 * FULL.delta)
    big = run(Scenario(engine="numpy", policy="saath-torch", trace=tr,
                       params=FULL, device="cpu"))
    assert not np.array_equal(got.row_cct(), big.row_cct())


# ---- the contention count -------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_contention_equals_the_reference_sgemm_count(seed):
    """Random (C, P) incidences with inactive rows, empty rows and a
    dense row: the port's count (the plain version of K1 on the CPU)
    equals the reference's f32 sgemm count, inactive rows 0."""
    from repro.core.contention import contention as jcontention
    from repro_torch.core.contention import contention

    rng = np.random.default_rng(seed)
    C, P = int(rng.integers(1, 90)), int(rng.integers(1, 200))
    a_s = rng.uniform(size=(C, P)) < 0.05
    a_r = rng.uniform(size=(C, P)) < 0.05
    a_s[rng.uniform(size=C) < 0.2] = False
    a_s[0] = True
    active = rng.uniform(size=C) < 0.7
    got = contention(a_s, a_r, active, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jcontention(a_s, a_r, active))
    assert (got[~active] == 0).all()
    none = contention(a_s, a_r, np.zeros(C, bool), device="cpu")
    np.testing.assert_array_equal(none, 0)


def test_contention_refuses_more_ports_than_k1_takes():
    from repro_torch.core.contention import contention
    from repro_torch.kernels.contention import MAX_PORTS

    a = np.ones((2, MAX_PORTS + 1), bool)
    with pytest.raises(ValueError, match=f"P <= {MAX_PORTS}"):
        contention(a, a, np.ones(2, bool), device="cpu")


# ---- the registry and the simulator's report -----------------------------

def test_registry_names_and_messages():
    assert sorted(REGISTRY) == available("numpy")
    assert available("torch") == ["saath", "saath-torch"]
    assert resolve_policy("saath-torch", "torch") == "saath"
    assert resolve_policy("lwtf", "numpy") == "lwtf"
    with pytest.raises(ValueError, match="no batched implementation"):
        resolve_policy("aalo", "torch")
    with pytest.raises(ValueError, match="available: aalo, fifo"):
        make_policy("bogus", FULL, device="cpu")
    with pytest.raises(ValueError, match="numpy-engine only"):
        run(Scenario(engine="torch", trace=_port_trace(
            jax_family_trace("uniform")), policy_kwargs={"lcof": False},
            device="cpu"))


def test_simulator_reports_launches_and_bytes():
    """On the CPU the contention count runs its plain version: no
    launch, no byte crosses to a device; the run's steps and its
    policy's device are reported."""
    tr = _port_trace(jax_family_trace("skewed", seed=7))
    table = FlowTable.from_trace(tr, FULL.port_bw)
    pol = make_policy("lwtf", FULL, device="cpu")
    res = Simulator(FULL).run(table, pol)
    assert res.steps > 0 and table.finished.all()
    assert pol.device == torch.device("cpu")
    assert set(res.launches) >= {"contention", "tick_walk"}
    assert not any(res.launches.values())
    assert res.io["h2d_bytes"] == res.io["d2h_bytes"] == 0


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_a_directly_built_policy_defaults_to_cuda(name, monkeypatch):
    """A policy built by its class, not through `make_policy`, runs its
    kernel work on CUDA unless the caller passes a device, and raises
    without a card; `device="cpu"` takes the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        REGISTRY[name](FULL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_policy(name, FULL)
    tr = _port_trace(jax_family_trace("uniform", seed=8, n=4))
    table = FlowTable.from_trace(tr, FULL.port_bw)
    pol = REGISTRY[name](FULL, device="cpu")
    assert pol.device == torch.device("cpu")
    assert Simulator(FULL).run(table, pol).steps > 0
    assert table.finished.all()


def test_numpy_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(Scenario(engine="numpy", policy="aalo", trace=_port_trace(
            jax_family_trace("uniform"))))


# ---- the numpy session backend --------------------------------------------

def _replay_online(trace, session):
    """Submit the trace's coflows at their arrival times, polling as it
    goes (tests/test_session.py's replay); the CCTs in cid order."""
    ccts = {}
    for c in sorted(trace.coflows, key=lambda c: (c.arrival, c.cid)):
        session.advance(max(c.arrival - session.now, 0.0))
        h = session.submit([c])[0]
        ccts[h] = c.cid
        for d in session.poll():
            ccts[d.handle] = (ccts[d.handle], d.cct)
    for d in session.drain(step=5.0, max_seconds=500.0):
        ccts[d.handle] = (ccts[d.handle], d.cct)
    out = np.full(len(trace.coflows), np.nan)
    for cid, cct in ccts.values():
        out[cid] = cct
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_session_online_equals_offline_bitwise(seed):
    """tests/test_session.py:75 on the port: the online numpy backend
    shares `integrate_interval` with the offline Simulator, and resumes
    a capped interval instead of re-evaluating, so it is exact; and so
    is the reference's numpy session on the same trace."""
    from tests.test_session import PARAMS as JPARAMS, PORTS
    from tests.test_session import _trace as session_trace

    params = SchedulerParams(**dataclasses.asdict(JPARAMS))
    jt = session_trace(seed)
    tr = _port_trace(jt)
    offline = run(Scenario(engine="numpy", trace=tr, params=params,
                           device="cpu"))
    got = _replay_online(tr, SaathSession(params, num_ports=PORTS,
                                          backend="numpy", device="cpu"))
    np.testing.assert_array_equal(got, offline.row_cct())
    want = _replay_online(jt, JSession(JPARAMS, num_ports=PORTS,
                                       backend="numpy"))
    np.testing.assert_array_equal(got, want)


def test_numpy_session_plan_tick_and_snapshot_equal_the_reference():
    """Wave planning and the scheduler view on the numpy backend, tick
    by tick, against the reference's numpy session; a leaf-spine
    ablated session replays as its offline run."""
    from tests.test_session import PARAMS as JPARAMS, PORTS
    from tests.test_session import _trace as session_trace

    params = SchedulerParams(**dataclasses.asdict(JPARAMS))
    jt = session_trace(6, n=10)
    js = JSession(JPARAMS, num_ports=PORTS, backend="numpy")
    ps = SaathSession(params, num_ports=PORTS, backend="numpy",
                      device="cpu")
    js.submit(sorted(jt.coflows, key=lambda c: (c.arrival, c.cid)))
    ps.submit(sorted(_port_trace(jt).coflows,
                     key=lambda c: (c.arrival, c.cid)))
    for _ in range(400):
        assert ps.plan_tick() == js.plan_tick() and ps.now == js.now
        assert ps.snapshot() == js.snapshot()
        assert [d.handle for d in ps.poll()] == \
            [d.handle for d in js.poll()]
        if not js.num_live:
            break
    assert not ps.num_live
    tr = _port_trace(session_trace(7))
    mech = {"lcof": False, "work_conservation": False}
    topo = LeafSpine(2, 2.0, "maxmin")
    got = _replay_online(tr, SaathSession(
        params, num_ports=PORTS, backend="numpy", mechanisms=mech,
        topology=topo, device="cpu"))
    want = run(Scenario(engine="numpy", trace=tr, params=params,
                        mechanisms=mech, topology=topo, device="cpu"))
    np.testing.assert_array_equal(got, want.row_cct())


# ---- the FB-width trace ---------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("policy", ["saath", "aalo"])
def test_fb_width_replay_equals_the_reference_bitwise(policy):
    """fb_like_trace(526, 150, seed=0), the trace the paper's
    simulations replay, through each package's numpy plane (about a
    minute for Saath)."""
    from repro.traces.synth import fb_like_trace as jfb
    from repro_torch.traces.synth import fb_like_trace

    got = run(Scenario(engine="numpy", policy=policy,
                       trace=fb_like_trace(526, 150, seed=0), device="cpu"))
    want = jrun(JScenario(engine="numpy", policy=policy,
                          trace=jfb(526, 150, seed=0)))
    _assert_bitwise(got, want)


@pytest.mark.slow
def test_fb_like_saath_torch_with_both_fmas_equals_saath_jax(monkeypatch):
    """ROADMAP C12 at FB widths: with the deadline and the admission
    walk's `avail - r * cnt` each fused as the reference's CPU backend
    fuses them, `saath-torch` on fb_like_trace(100, 150, seed=0) gives
    `saath-jax`'s steps, CCTs and FCTs bit for bit (about 40 s)."""
    from repro.traces.synth import fb_like_trace as jfb
    from repro_torch.core import coordinator as co
    from repro_torch.kernels import ref
    from repro_torch.traces.synth import fb_like_trace

    monkeypatch.setattr(co, "_deadline", _deadline_fma)
    monkeypatch.setattr(ref, "_spend", lambda avail, r, cnt: (
        avail.double() - r.double() * cnt.double()).float())
    got = run(Scenario(engine="numpy", policy="saath-torch",
                       trace=fb_like_trace(100, 150, seed=0), device="cpu"))
    want = jrun(JScenario(engine="numpy", policy="saath-jax",
                          trace=jfb(100, 150, seed=0)))
    _assert_bitwise(got, want)


@pytest.mark.slow
def test_regenerate_numpy_golden():
    """Recompute the host plane's reference: fb_like_trace(526, 150,
    seed=0) through the JAX package's numpy engine under every registry
    policy (`saath-jax` for the port's `saath-torch`; about two and a
    half minutes on the CPU)."""
    import jax
    from repro.traces.synth import fb_like_trace as jfb

    rows = {}
    tr = jfb(526, 150, seed=0)
    for name in ("saath", "saath-jax", "aalo", "fifo", "scf", "srtf",
                 "lwtf", "varys-sebf", "uc-tcp"):
        res = jrun(JScenario(engine="numpy", policy=name, trace=tr))
        s = res.summary()
        rows[name] = {"steps": res.steps, "avg_cct": s["avg_cct"],
                      "p90_cct": s["p90_cct"],
                      "cct": [float(x) for x in res.row_cct()]}
    GOLDEN.write_text(json.dumps({
        "what": "the JAX package's numpy-engine replay of fb_like_trace("
                "526, 150, seed=0) under each registry policy: steps, avg "
                "and p90 CCT and every coflow's CCT; the reference "
                "chip_smoke.py phase 22 holds the port's host plane to",
        "call": "repro.api.run(Scenario(engine='numpy', policy=name, "
                "trace=fb_like_trace(526, 150, seed=0)))",
        "params": "SchedulerParams() defaults, big switch",
        "platform": "cpu", "jax": jax.__version__,
        "regenerate": "PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest "
                      "-q -m slow tests/test_torch_policies.py -k golden",
        "seed": 0, "ports": 150, "rows": rows}, indent=1) + "\n")
