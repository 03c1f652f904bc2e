"""The port's runtime sanitizers (`repro_torch.analysis.sanitize`): the
build counter and the transfer guard, their seeded negatives, and the
reference's sanitizer scopes (tests/test_pool.py, tests/test_serve.py,
tests/test_sampling.py) on the port's own paths.

On the CPU the choke-point counter is the guard: a CPU tensor never
crosses a device boundary, so `engine.host_to_device`, the session
loop's flag read and `SessionPool._download` report every crossing
themselves, and an unaccounted one raises. The dispatch-mode half of
the guard is shown with `meta` as the other device."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitize
from repro_torch.analysis.sanitize import (RecompileError, TransferError,
                                           accounted_transfer,
                                           assert_no_recompiles,
                                           assert_no_transfers)
from repro_torch.api import SessionPool
from repro_torch.core.coflow import Coflow, Flow
from repro_torch.core.params import SchedulerParams
from repro_torch.fabric import engine as eng
from repro_torch.kernels import build, prefix_sum
from repro_torch.launch.serve import CoflowServer, TenantQuota
from repro_torch.traces.synth import tiny_trace

ROOT = Path(__file__).resolve().parents[1]
PORTS = 6
PARAMS = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                         growth=4.0, num_queues=5)
DYN = SchedulerParams(dynamics_requeue=True)
CPU = torch.device("cpu")


def _coflows(seed: int, n: int, base: int = 0, spread: float = 2.0):
    rng = np.random.default_rng(seed)
    cfs, fid = [], 0
    for c in range(n):
        w = int(rng.integers(1, 5))
        flows = [Flow(fid + i, int(rng.integers(0, PORTS)),
                      int(rng.integers(0, PORTS)),
                      float(rng.uniform(1.0, 15.0))) for i in range(w)]
        fid += w
        cfs.append(Coflow(base + c, float(rng.uniform(0.0, spread)),
                          flows))
    return sorted(cfs, key=lambda c: (c.arrival, c.cid))


def _drain(srv, tenants, max_steps=200, step=1.0):
    for _ in range(max_steps):
        srv.advance(step)
        if not any(srv.num_live(t) for t in tenants):
            return
    raise RuntimeError("server failed to drain")


# ---- assert_no_recompiles ------------------------------------------------

def _fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler that writes its `-o` target, with the build
    directory moved to `tmp_path`: `build_all` then runs its real
    bookkeeping without a CUDA toolkit."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != \"-o\" ]; do shift; "
                    "done\ntouch \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "built", list(build.built))


def test_assert_no_recompiles_flags_an_nvcc_build(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch)
    with pytest.raises(RecompileError, match="nvcc contention"):
        with assert_no_recompiles():
            build.build_all(["contention"])
    # built once: the library exists, a second build_all builds nothing
    with assert_no_recompiles():
        assert build.build_all(["contention"]) == {}


def test_assert_no_recompiles_flags_a_library_load(monkeypatch):
    monkeypatch.setattr(build, "_loaded", dict(build._loaded))
    with pytest.raises(RecompileError, match="load walk"):
        with assert_no_recompiles():
            build._loaded["walk"] = object()


def test_assert_no_recompiles_flags_a_new_k6_scratch_size(monkeypatch):
    monkeypatch.setattr(prefix_sum, "_scratch_per_row",
                        dict(prefix_sum._scratch_per_row))
    prefix_sum._scratch_per_row[64] = 0           # warm
    with assert_no_recompiles():
        prefix_sum._scratch_per_row[64] = 0       # reuse: clean
    with pytest.raises(RecompileError, match="K6 scratch size F=128"):
        with assert_no_recompiles():
            prefix_sum._scratch_per_row[128] = 0  # a new row length


def test_assert_no_recompiles_allow_budget_and_scope_listing(monkeypatch):
    monkeypatch.setattr(build, "_loaded", dict(build._loaded))
    with assert_no_recompiles(allow=1) as scope:
        build._loaded["maxmin"] = object()
    assert scope.compiles == ["load maxmin"]


def test_launch_configurations_read_zero_before_a_library_loads():
    from repro_torch.kernels import contention

    if contention._lib is None and prefix_sum._lib is None:
        assert contention.launch_configs() == 0
        assert prefix_sum.launch_configs() == 0
    state = sanitize.build_state()
    assert set(state) == {"nvcc", "load", "k6_scratch", "k1_config",
                          "k6_config", "device_peak"}
    assert sanitize.built_since(state, state) == []


def test_a_higher_device_memory_peak_counts_as_one_build():
    """On the card a warm path that needs more device memory at once
    than before is a build; a peak that did not grow (a new allocator
    segment at the same peak) is none; off the card the peak is None."""
    base = {"nvcc": [], "load": set(), "k6_scratch": set(), "k1_config": 0,
            "k6_config": 0, "device_peak": 1 << 20}
    grown = dict(base, device_peak=(1 << 20) + 512)
    assert sanitize.built_since(base, grown) == [
        "device memory peak +512 bytes"]
    assert sanitize.built_since(base, dict(base)) == []
    assert sanitize.built_since(grown, base) == []
    off = dict(base, device_peak=None)
    assert sanitize.built_since(off, off) == []


# ---- assert_no_transfers: the choke points --------------------------------

def test_assert_no_transfers_blocks_unaccounted_uploads():
    x = np.ones((4,), np.float32)
    with pytest.raises(TransferError, match="[Tt]ransfer.*host_to_device"):
        with assert_no_transfers():
            eng.host_to_device(x, CPU)


def test_accounted_transfer_carves_out_sanctioned_uploads():
    x = np.ones((4,), np.float32)
    with assert_no_transfers() as scope:
        with accounted_transfer():
            y = eng.host_to_device(x, CPU)
    np.testing.assert_array_equal(y.numpy(), x)
    assert scope.uploads == 1 and scope.upload_bytes == x.nbytes


def test_pool_download_outside_an_accounted_frame_raises():
    pool, _ = _warm_pool()
    with pytest.raises(TransferError, match="pool._download"):
        with assert_no_transfers():
            pool._download(pool._state.tick)


def test_choke_points_read_one_flag_when_disarmed():
    assert sanitize.armed is False
    with assert_no_transfers():
        assert sanitize.armed is True
    assert sanitize.armed is False


def test_flag_read_is_an_accounted_download():
    flag = torch.ones((), dtype=torch.bool)
    with assert_no_transfers() as scope:
        assert eng._read_flag(flag) is True
    assert scope.flag_reads == 1 and scope.download_bytes == 1


# ---- assert_no_transfers: the dispatch mode (meta as the other device) ----

_META_UPLOADS = {
    "from_numpy.to": lambda a: torch.from_numpy(a).to("meta"),
    "tensor": lambda a: torch.tensor(a, device="meta"),
    "as_tensor": lambda a: torch.as_tensor(a, device="meta"),
    "empty.copy_": lambda a: torch.empty(a.shape, device="meta").copy_(
        torch.from_numpy(a)),
}


@pytest.mark.parametrize("how", sorted(_META_UPLOADS))
def test_dispatch_mode_sees_uploads_to_another_device(how):
    a = np.arange(4, dtype=np.float32)
    with pytest.raises(TransferError, match="host-to-device.*aten"):
        with assert_no_transfers():
            _META_UPLOADS[how](a)
    with assert_no_transfers() as scope:
        with accounted_transfer():
            out = _META_UPLOADS[how](a)
    assert out.device.type == "meta"
    assert scope.uploads == 1 and scope.upload_bytes == a.nbytes


@pytest.mark.parametrize("how", ["item", "bool", "to_cpu"])
def test_dispatch_mode_sees_reads_of_another_device(how):
    t = torch.ones((), device="meta")
    pull = {"item": lambda: t.item(), "bool": lambda: bool(t),
            "to_cpu": lambda: t.to("cpu")}[how]
    with pytest.raises(TransferError, match="device-to-host"):
        with assert_no_transfers():
            pull()


def test_host_copies_are_no_crossing():
    x = torch.arange(4.0)
    with assert_no_transfers() as scope:
        y = x.to(torch.float64).clone()
        float(x[0])
        torch.empty(4).copy_(x)
    assert y.dtype == torch.float64
    assert scope.uploads == scope.downloads == 0


# ---- the pool under both guards (reference tests/test_pool.py:176) --------

def _warm_pool():
    pool = SessionPool(PARAMS, num_ports=PORTS, max_sessions=3,
                       device="cpu")
    a, b = pool.session(), pool.session()
    # big flows so nothing completes during the probe advances
    a.submit([Coflow(0, 0.0, [Flow(0, 0, 1, 500.0)])])
    b.submit([Coflow(0, 0.0, [Flow(0, 2, 3, 500.0)])])
    pool.advance(1.0)                    # first _ensure: ONE full upload
    return pool, (a, b)


def test_pool_clean_row_advances_under_the_guards():
    """The acceptance bar: a warm clean-row advance runs under
    `assert_no_transfers()` and `assert_no_recompiles()`, uploads no
    slab byte, and the guard's counted downloads equal the io ledger:
    one a flag read (`loop_reads`) plus the pool's downloads, byte for
    byte."""
    pool, (a, b) = _warm_pool()
    io = pool.io
    before = dict(io)
    with assert_no_recompiles(), assert_no_transfers() as scope:
        for _ in range(5):
            pool.advance(1.0)            # clean rows: nothing uploads
        assert a.poll() == [] and b.poll() == []
    delta = {k: io[k] - before[k] for k in io}
    assert delta["full_uploads"] == delta["row_uploads"] == 0
    assert delta["upload_bytes"] == 0
    assert delta["row_downloads"] == 0   # nobody looked: no gathers
    assert delta["loop_reads"] > 0 and scope.flag_reads == \
        delta["loop_reads"]
    pool_downloads = scope.crossings[("d2h", "pool._download")]
    assert scope.downloads == delta["loop_reads"] + pool_downloads
    assert scope.download_bytes == delta["loop_reads"] + \
        delta["download_bytes"] + delta["ctl_bytes"]
    # the only uploads are the advances' dispatch arguments
    assert scope.crossings[("h2d", "engine.host_to_device")] == \
        scope.uploads == delta["dispatches"]


def test_pool_gathers_and_host_view_are_counted_downloads():
    pool, (a, _) = _warm_pool()
    before = dict(pool.io)
    with assert_no_transfers() as scope:
        assert a.snapshot()[0]["sent"] > 0   # forces a row gather
        tb, st = pool.host_view()
    got = pool.io["download_bytes"] + pool.io["ctl_bytes"] - \
        before["download_bytes"] - before["ctl_bytes"]
    assert scope.download_bytes == got and scope.flag_reads == 0
    assert int(np.asarray(st.tick).max()) > 0 and tb.size.ndim == 2


def test_dirty_row_scatter_is_an_accounted_upload():
    pool, (a, _) = _warm_pool()
    with assert_no_transfers() as scope:
        a.submit([Coflow(1, a.now, [Flow(1, 1, 2, 500.0)])])
        pool.advance(1.0)
    assert pool.io["row_uploads"] == 1
    assert scope.uploads > 1             # the scatter + the advance


def test_seeded_unaccounted_pool_method_trips_the_guard(monkeypatch):
    """Strip `_io_accounted` from `_scatter_dirty` (its undecorated
    original): the dirty-row upload must now raise inside the guard."""
    pool, (a, _) = _warm_pool()
    raw = SessionPool._scatter_dirty.__wrapped__
    monkeypatch.setattr(SessionPool, "_scatter_dirty", raw)
    monkeypatch.setattr(SessionPool, "_ensure",
                        SessionPool._ensure.__wrapped__)
    monkeypatch.setattr(SessionPool, "_dispatch_async",
                        SessionPool._dispatch_async.__wrapped__)
    monkeypatch.setattr(SessionPool, "_advance",
                        SessionPool._advance.__wrapped__)
    a.submit([Coflow(1, a.now, [Flow(1, 1, 2, 500.0)])])
    with pytest.raises(TransferError, match="unaccounted"):
        with assert_no_transfers():
            pool.advance(1.0)


def test_io_accounted_wraps_the_reference_ten():
    names = ("session", "_advance", "_dispatch_async", "_sync_ctl",
             "_plan_tick", "_ensure", "_scatter_dirty", "_rebuild",
             "_materialize", "host_view")
    for name in names:
        assert hasattr(getattr(SessionPool, name), "__wrapped__"), name
    assert not hasattr(SessionPool.advance, "__wrapped__")


# ---- the warm server (reference tests/test_serve.py:68 and :348) ----------

def test_server_steady_state_recycle_under_both_guards():
    srv = CoflowServer(PARAMS, num_ports=PORTS, max_tenants=2,
                       device="cpu")
    srv.register("a")
    srv.register("b")
    srv.submit("a", _coflows(0, 2))
    srv.submit("b", _coflows(1, 2))
    srv.advance(1.0)
    srv.evict("a")
    srv.register("c")
    srv.submit("c", _coflows(2, 3))
    _drain(srv, ["b", "c"])
    assert len(srv.poll("c")) == 3
    assert len(srv.poll("b")) == 2
    # every path is warm: the steady-state recycle must neither build
    # nor move an unaccounted byte
    with assert_no_recompiles(), assert_no_transfers() as scope:
        srv.evict("c")
        srv.register("d")
        srv.submit("d", _coflows(3, 1))
        _drain(srv, ["b", "d"])
        assert len(srv.poll("d")) == 1
    assert scope.flag_reads > 0 and scope.uploads > 0


def test_server_deferred_readmission_under_both_guards():
    srv = CoflowServer(PARAMS, num_ports=PORTS, max_tenants=1,
                       device="cpu")
    srv.register("d", quota=TenantQuota(max_live_coflows=2,
                                        policy="defer"))
    assert len(srv.submit("d", _coflows(30, 6, spread=0.0))) == 2
    done = 0
    for _ in range(100):
        srv.advance(1.0)
        done += len(srv.poll("d"))
        if done:
            break
    assert done, "no completion within the warmup budget"
    with assert_no_recompiles(), assert_no_transfers():
        for _ in range(300):
            srv.advance(1.0)
            done += len(srv.poll("d"))
            assert srv.num_live("d") <= 2
            if done == 6 and srv.stats()["deferred_pending"] == 0:
                break
    assert done == 6, f"only {done}/6 deferred coflows completed"
    assert srv.aggregates("d").coflows == 6


# ---- a learned tenant joins a pinned pool (tests/test_sampling.py:198) ----

def test_heterogeneous_tenant_joining_pinned_pool_builds_nothing():
    pool = SessionPool(DYN, num_ports=12, max_sessions=4,
                       min_flow_capacity=256,
                       features=(True, True, False, False, True),
                       device="cpu")
    a = pool.session()
    a.submit(tiny_trace(4, 12, seed=3, load=1.5).coflows)
    pool.advance(0.5)
    b = pool.session()                   # warm the join path too
    b.submit(tiny_trace(4, 12, seed=4, load=1.5).coflows)
    pool.advance(0.5)
    pool.poll()
    with assert_no_recompiles(), assert_no_transfers():
        c = pool.session(mechanisms={"clairvoyant": False})
        c.submit(tiny_trace(4, 12, seed=5, load=1.5).coflows)
        pool.advance(0.5)
    assert pool.io["full_uploads"] == 1  # a pinned slab: no rebuild
    pool.advance(60.0)
    assert {s for s, _ in pool.poll()} <= {a, b, c}


# ---- the package boundary --------------------------------------------------

def test_analysis_imports_leave_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.analysis, "
            "repro_torch.analysis.sanitize, repro_torch.analysis.op_scan, "
            "repro_torch.analysis.audit, repro_torch.analysis.rules, "
            "repro_torch.analysis.lint, repro_torch.analysis.contracts, "
            "repro_torch.analysis.coherence, repro_torch.analysis.explore; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
