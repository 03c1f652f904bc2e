"""The port's runtime bridge (`repro_torch.runtime`) against the JAX
package's on the CPU: the counterparts of `tests/test_runtime_bridge.py`
and of the wave-order gate of `tests/test_session.py`, and the three
examples that import the bridge.

* `bucketize` gives the reference's buckets (ids, paths, leaf indices,
  bytes) on the same nested containers, a `state_dict()` among them;
* `plan_waves` keeps every collective once, never puts two collectives
  sharing a resource in one wave, serializes gradient buckets, keeps
  colliding arrival ranks, and gives the reference's waves;
* on the bridge workload (`tests/test_session.py::_bridge_workload`)
  the port's torch and numpy backends and the reference's numpy and
  jax backends give the same wave lists, bit for bit;
* `scheduled_psum` over a world of 1 (gloo, rendezvous through an
  in-memory `HashStore`: no TCP port) returns its inputs' values,
  issuing the all-reduces wave by wave.
"""
import collections
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro.runtime import buckets as jbuckets
from repro.runtime import coflow_bridge as jbridge
from repro_torch.runtime.buckets import bucketize, leaves_with_path
from repro_torch.runtime.coflow_bridge import (CollectiveCoflow,
                                               grad_bucket_coflows,
                                               plan_waves)
from repro_torch.runtime.overlap import issue_waves, scheduled_psum

ROOT = Path(__file__).resolve().parents[1]


def _ref_coflows(cfs):
    return [jbridge.CollectiveCoflow(c.name, c.bytes, c.resources,
                                     c.arrival_rank, c.chips) for c in cfs]


def _port_coflows(cfs):
    return [CollectiveCoflow(c.name, c.bytes, c.resources, c.arrival_rank,
                             c.chips) for c in cfs]


def _plan(cfs, **kw):
    return plan_waves(cfs, device="cpu", **kw)


# ---- bucketize --------------------------------------------------------


def test_bucketize_order_and_coverage():
    tree = {f"l{i}": torch.zeros((128, 128)) for i in range(6)}
    bks = bucketize(tree, bucket_bytes=3 * 128 * 128 * 4)
    idx = [i for b in bks for i in b.leaf_idx]
    assert sorted(idx) == list(range(6))        # every leaf exactly once
    assert idx[0] == 5                          # reverse-layer order
    assert all(b.bytes <= 3 * 128 * 128 * 4 for b in bks)


def _trees():
    """(port tree, the same tree of numpy arrays for the reference)."""
    rng = np.random.default_rng(0)

    def arr(*shape, dtype=np.float32):
        return rng.standard_normal(shape).astype(dtype)

    nested = {"b": {"w": arr(16, 8), "bias": arr(8)},
              "a": [arr(4, 4), (arr(3), None, arr(2, 2, 2, dtype=np.float16))],
              "c": arr(64, 64)}
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4),
                                torch.nn.LayerNorm(4))
    sd = model.state_dict()
    flat = [arr(10), arr(20), arr(30)]

    def to_torch(t):
        if isinstance(t, dict):
            return type(t)((k, to_torch(v)) for k, v in t.items())
        if isinstance(t, (list, tuple)):
            return type(t)(to_torch(v) for v in t)
        return None if t is None else torch.from_numpy(t)

    return {
        "nested": (to_torch(nested), nested),
        "state_dict": (sd, collections.OrderedDict(
            (k, v.numpy()) for k, v in sd.items())),
        "flat_list": (to_torch(flat), flat),
    }


@pytest.mark.parametrize("bucket_bytes", [1, 200, 4096, 1 << 20])
@pytest.mark.parametrize("name", ["nested", "state_dict", "flat_list"])
def test_bucketize_equals_the_reference(name, bucket_bytes):
    import jax

    tree, jtree = _trees()[name]
    for reverse in (True, False):
        got = bucketize(tree, bucket_bytes=bucket_bytes, reverse=reverse)
        want = jbuckets.bucketize(jtree, bucket_bytes=bucket_bytes,
                                  reverse=reverse)
        assert [dataclasses.astuple(b) for b in got] == \
            [dataclasses.astuple(b) for b in want]
    paths = [p for p, _ in leaves_with_path(tree)]
    assert paths == [jax.tree_util.keystr(kp) for kp, _ in
                     jax.tree_util.tree_leaves_with_path(jtree)]


def test_state_dict_paths_keep_insertion_order():
    sd = torch.nn.Linear(3, 2).state_dict()
    assert [p for p, _ in leaves_with_path(sd)] == ["['weight']",
                                                     "['bias']"]
    assert [p for p, _ in leaves_with_path({"b": 1, "a": 2})] == [
        "['a']", "['b']"]


# ---- plan_waves -------------------------------------------------------


@given(st.lists(st.sampled_from(["ici:data", "ici:model", "dcn", "host"]),
                min_size=1, max_size=3, unique=True),
       st.integers(2, 10))
@settings(max_examples=25, deadline=None, derandomize=True)
def test_plan_waves_properties(res, n):
    rng = np.random.default_rng(0)
    coflows = [CollectiveCoflow(f"c{i}", int(rng.integers(1 << 20, 1 << 28)),
                                tuple(rng.choice(res, rng.integers(
                                    1, len(res) + 1), replace=False)),
                                i)
               for i in range(n)]
    waves = _plan(coflows, num_chips=8)
    flat = [c for w in waves for c in w]
    assert sorted(flat) == sorted(c.name for c in coflows)  # all, once
    # within a wave, coflows share no resource (all-or-none feasibility)
    by_name = {c.name: c for c in coflows}
    for w in waves:
        used = []
        for nme in w:
            for r in by_name[nme].resources:
                assert r not in used, (w, r)
                used.append(r)
    assert waves == jbridge.plan_waves(_ref_coflows(coflows), num_chips=8,
                                       backend="numpy")


def test_grad_buckets_serialize_lcof_orders_tenants():
    bks = bucketize({f"l{i}": torch.zeros((64, 64)) for i in range(4)},
                    bucket_bytes=64 * 64 * 4)
    cfs = grad_bucket_coflows(bks)
    cfs += [CollectiveCoflow("bg/dcn", 1 << 30, ("dcn",), 99)]
    waves = _plan(cfs, num_chips=4)
    # grad buckets all on ici:data -> exactly one per wave, arrival order
    grads = [n for w in waves for n in w if n.startswith("grad/")]
    assert grads == [f"grad/{i}" for i in range(len(bks))]
    per_wave = [sum(n.startswith("grad/") for n in w) for w in waves]
    assert max(per_wave) == 1
    # the DCN tenant rides wave 0 (disjoint resource)
    assert "bg/dcn" in waves[0]


def test_plan_waves_colliding_ranks_keep_all_collectives():
    """Two tenants built with the same rank_offset collide in arrival
    rank; every collective is still planned once, in (rank, submission)
    order, as the reference plans them."""
    bks = bucketize({f"l{i}": torch.zeros((64, 64)) for i in range(3)},
                    bucket_bytes=64 * 64 * 4)
    tenant_a = grad_bucket_coflows(bks, rank_offset=0)
    tenant_b = grad_bucket_coflows(bks, axes=("ici:model",), rank_offset=0)
    tenant_b = [dataclasses.replace(c, name=f"b/{c.name}")
                for c in tenant_b]
    cfs = tenant_a + tenant_b + [
        CollectiveCoflow("bg/dcn", 1 << 30, ("dcn",), 0)]  # third collision
    for backend in ("torch", "numpy"):
        waves = _plan(cfs, num_chips=4, backend=backend)
        flat = [n for w in waves for n in w]
        assert sorted(flat) == sorted(c.name for c in cfs), flat
        assert len(flat) == len(cfs)  # nothing dropped, nothing duplicated
        grads_a = [n for w in waves for n in w if n.startswith("grad/")]
        assert grads_a == [f"grad/{i}" for i in range(len(bks))]
        assert waves == jbridge.plan_waves(_ref_coflows(cfs), num_chips=4,
                                           backend="numpy")


def test_plan_waves_wave_order_equals_the_reference_bitwise():
    """The framework plane's acceptance gate on the port: the slab
    planner (torch) and the host oracle (numpy) emit the wave lists of
    the reference's numpy and jax planners on the bridge workload."""
    from tests.test_session import _bridge_workload

    jcfs = _bridge_workload()
    cfs = _port_coflows(jcfs)
    wt = _plan(cfs, num_chips=16, backend="torch")
    wn = _plan(cfs, num_chips=16, backend="numpy")
    want_np = jbridge.plan_waves(jcfs, num_chips=16, backend="numpy")
    want_jax = jbridge.plan_waves(jcfs, num_chips=16, backend="jax")
    assert wt == wn == want_np == want_jax
    flat = [n for w in wt for n in w]
    assert sorted(flat) == sorted(c.name for c in cfs)
    grads = [n for n in flat if n.startswith("grad/")]
    assert grads == [f"grad/{i}" for i in range(6)]


def test_plan_waves_edges():
    assert plan_waves([]) == []
    with pytest.raises(ValueError, match="torch, numpy"):
        plan_waves([CollectiveCoflow("x", 1, ("dcn",), 0)], backend="jax",
                   device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan_waves([CollectiveCoflow("x", 1, ("dcn",), 0)])


# ---- the wave-ordered all-reduce --------------------------------------


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank, its rendezvous in memory."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_scheduled_psum_preserves_values_and_orders(world_of_one,
                                                    monkeypatch):
    tree = {"a": torch.arange(16.0).reshape(4, 4), "b": torch.ones((8,)),
            "c": {"d": torch.linspace(-1, 1, 7)}}
    bks = bucketize(tree, bucket_bytes=40)
    assert len(bks) == 3
    waves = [["grad/2"], ["grad/0", "grad/1"]]
    flat = [leaf for _, leaf in leaves_with_path(tree)]
    before = [t.clone() for t in flat]
    events = []
    real = dist.all_reduce

    class Spy:
        def __init__(self, name, work):
            self.name, self.work = name, work

        def wait(self):
            events.append(("wait", self.name))
            return self.work.wait()

    def spy(x, group=None, async_op=False):
        name = next(f"grad/{b.bid}" for b in bks
                    if x.numel() == sum(flat[i].numel() for i in b.leaf_idx))
        events.append(("issue", name))
        return Spy(name, real(x, group=group, async_op=async_op))

    monkeypatch.setattr(dist, "all_reduce", spy)
    out = scheduled_psum(flat, bks, waves)
    for a, b, c in zip(out, flat, before):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, c, rtol=0, atol=0)
        torch.testing.assert_close(b, c, rtol=0, atol=0)  # inputs intact
    # wave 0 is issued and waited on before wave 1 is issued
    assert events == [("issue", "grad/2"), ("wait", "grad/2"),
                      ("issue", "grad/0"), ("issue", "grad/1"),
                      ("wait", "grad/0"), ("wait", "grad/1")]


def test_issue_waves_takes_synchronous_ops():
    seen = []
    out = issue_waves({"x": torch.ones(2), "y": torch.zeros(2)},
                      [["y"], ["x"]],
                      lambda n, t: (seen.append(n) or t + 1, None))
    assert seen == ["y", "x"]
    torch.testing.assert_close(out["x"], torch.full((2,), 2.0))


# ---- the examples that import the bridge ------------------------------


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_on_the_cpu():
    out = _example("quickstart_torch").main(["--device", "cpu"],
                                             num_coflows=30, num_ports=16)
    assert out["speedup"]["p50"] > 1.0 and len(out["ideas"]) == 3
    assert out["waves"][0] == ["grad/0", "moe/a2a", "ckpt/upload"]


def test_multi_tenant_fabric_example_on_the_cpu():
    from tests.test_session import _bridge_workload

    mod = _example("multi_tenant_fabric_torch")
    # the port's one copy of the workload (the card test and the smoke
    # load it) is the reference's, field for field
    assert mod.bridge_workload() == _port_coflows(_bridge_workload())
    out = mod.main(["--device", "cpu"], steps=4)
    assert out["waves"] == jbridge.plan_waves(_bridge_workload(),
                                              num_chips=16, backend="numpy")
    assert out["speedup"]["n"] == 17


@pytest.mark.parametrize("backend,tenants", [("torch", 1), ("numpy", 1),
                                             ("torch", 2)])
def test_online_service_example_on_the_cpu(backend, tenants):
    """The open-loop tenant mix drains; the host-reference session gives
    the reference example's completions (its numpy backend) bit for
    bit."""
    stats = _example("online_service_torch").main(
        seconds=0.05, seed=0, backend=backend, tenants=tenants,
        device="cpu")
    assert stats["completed"] >= 10 * tenants
    assert stats["unfinished"] == 0
    assert np.isfinite(stats["avg_cct"]) and stats["avg_cct"] > 0
    ref = _example("online_service").main(seconds=0.05, seed=0,
                                          backend="numpy")
    if backend == "numpy":
        assert (stats["completed"], stats["avg_cct"]) == \
            (ref["completed"], ref["avg_cct"])
    elif tenants == 1:
        assert stats["completed"] == ref["completed"]
        assert stats["avg_cct"] == pytest.approx(ref["avg_cct"], rel=1e-6)
    with pytest.raises(ValueError, match="--backend torch"):
        _example("online_service_torch").main(backend="numpy", tenants=2,
                                              device="cpu")
