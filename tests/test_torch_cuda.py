"""The port's CUDA kernels (K1 contention, K2 tick walk, K3 max-min fill,
K4 SSD scan, K5 attention, K6 prefix sums, K7 the attention backward, K8
the SSD scan's backward)
against their plain PyTorch versions, on the
card (learned-size ticks among them), the replays, pools and a small
`CoflowServer` on the card against the CPU, a 2-layer full-width Mamba2
serve with K4 against the plain path, a 2-layer full-width
StarCoder2 serve through K5 against the JAX package's golden, K5 at
MLA's widths (192, 128), K4 at Jamba's state width 16, the SMOKE MoE,
MLA and hybrid sessions against their plain paths, and the
runtime bridge (its wave plan, an NCCL world of 1), a SMOKE
StarCoder2 train step through K5 and K7 against the plain path, K8
against its plain version (bitwise repeatable, strided views), K5 and
K7 non-causal with more queries than keys, the refusal of a kernel call
autograd would record, and a SMOKE Mamba2 train step through K4 and K8
against the CPU's. Every
test marked `gpu` needs a CUDA device and skips without one; run them
on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports no JAX (the card tests need only torch). It also
holds `random_tick_inputs`, the seeded coordinator-tick inputs that
`tests/test_torch_coordinator.py` feeds to both packages, and
`prefix_rows` and `negative_zero_rows`, the rows
`tests/test_torch_prefix_sum.py` sums in both.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import coordinator as co
from repro_torch.core.params import SchedulerParams
from repro_torch.core.queues import queue_of
from repro_torch.kernels import ops

UNIT = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                       growth=4.0, num_queues=5)


def random_tick_inputs(B, C, P, *, seed, params=UNIT, max_width=6,
                       flow_multiple=64, hosts_per_leaf=0, oversub=4.0):
    """Seeded numpy inputs of one coordinator tick for B lanes: live
    flows stored contiguous per coflow (traces.batch's layout), the
    (coflow, port) live counts they imply, Eq. 1 values spread across
    the queue thresholds, a carried state with some expired deadlines,
    and the optional §4.3 / ablation inputs. With `hosts_per_leaf` > 0
    also a leaf-spine layout: per-flow up/dn leaves (sentinel Lf for a
    flow inside its leaf), the (coflow, link) live counts `cnt_x` and
    the link capacities `bw_x` (subtended port rate / `oversub`)."""
    rng = np.random.default_rng(seed)
    th0 = params.thresholds()[0]
    widths = rng.integers(1, max_width + 1, (B, C))
    F = -(-int(widths.sum(1).max()) // flow_multiple) * flow_multiple
    d = {k: [] for k in ("cid", "src", "dst", "live", "flow_lo",
                         "flow_hi", "cnt_s", "cnt_r")}
    active = rng.uniform(size=(B, C)) < 0.8
    for b in range(B):
        w = widths[b]
        hi = np.cumsum(w)
        lo = hi - w
        f = int(hi[-1])
        cid = np.full(F, C - 1, np.int32)
        cid[:f] = np.repeat(np.arange(C), w)
        src = rng.integers(0, P, F).astype(np.int32)
        dst = rng.integers(0, P, F).astype(np.int32)
        live = np.zeros(F, bool)
        live[:f] = active[b][cid[:f]] & (rng.uniform(size=f) < 0.7)
        cnt_s = np.zeros((C, P), np.float32)
        cnt_r = np.zeros((C, P), np.float32)
        np.add.at(cnt_s, (cid[live], src[live]), 1.0)
        np.add.at(cnt_r, (cid[live], dst[live]), 1.0)
        for k, v in (("cid", cid), ("src", src), ("dst", dst),
                     ("live", live), ("flow_lo", lo.astype(np.int32)),
                     ("flow_hi", hi.astype(np.int32)), ("cnt_s", cnt_s),
                     ("cnt_r", cnt_r)):
            d[k].append(v)
    out = {k: np.stack(v) for k, v in d.items()}
    width = widths.astype(np.int32)
    m = (th0 * 10.0 ** rng.uniform(-1.5, 3.0, (B, C)) / width)
    q_true = queue_of(m * width, params)
    queue = np.where(rng.uniform(size=(B, C)) < 0.6, q_true,
                     rng.integers(-1, params.num_queues, (B, C)))
    if hosts_per_leaf:
        Lf = -(-P // hosts_per_leaf)
        ls, ld = out["src"] // hosts_per_leaf, out["dst"] // hosts_per_leaf
        up = np.where(ls != ld, ls, Lf).astype(np.int32)
        dn = np.where(ls != ld, ld, Lf).astype(np.int32)
        cnt_x = np.zeros((B, C, 2 * Lf + 2), np.float32)
        for b in range(B):
            lv = out["live"][b]
            np.add.at(cnt_x[b], (out["cid"][b][lv], up[b][lv]), 1.0)
            np.add.at(cnt_x[b], (out["cid"][b][lv], Lf + 1 + dn[b][lv]),
                      1.0)
        cap = np.bincount(np.arange(P) // hosts_per_leaf,
                          weights=np.full(P, params.port_bw),
                          minlength=Lf) / oversub
        out.update(up=up, dn=dn,
                   cnt_x=np.concatenate([cnt_x[..., :Lf],
                                         cnt_x[..., Lf + 1:-1]], -1),
                   bw_x=np.tile(np.concatenate([cap, cap]), (B, 1))
                   .astype(np.float32))
    out.update(
        active=active, width=width, m=m.astype(np.float32),
        arrival=np.stack([rng.permutation(C) for _ in range(B)]
                         ).astype(np.int32),
        bw_s=np.full((B, P), params.port_bw, np.float32),
        bw_r=np.full((B, P), params.port_bw, np.float32),
        total=(m * width * rng.uniform(0.5, 2.0, (B, C))
               ).astype(np.float32),
        mixed=active & (rng.uniform(size=(B, C)) < 0.3),
        m_dyn=(m * rng.uniform(0.0, 1.0, (B, C))).astype(np.float32),
        queue=queue.astype(np.int32),
        deadline=(1.0 + rng.uniform(-0.5, 0.5, (B, C))).astype(np.float32),
        running=rng.uniform(size=(B, C)) < 0.3,
        now=np.float32(1.0))
    return out


def torch_tick_args(d, device, *, flows=True):
    """(state, batch, flows) tensors of the port from `random_tick_inputs`."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    i64, f32, b8 = torch.int64, torch.float32, torch.bool
    leaf = "cnt_x" in d
    state = co.CoordState(t(d["queue"], i64), t(d["deadline"], f32),
                          t(d["running"], b8))
    batch = co.CoflowBatch(
        active=t(d["active"], b8), arrival=t(d["arrival"], i64),
        m=t(d["m"], f32), width=t(d["width"], i64),
        cnt_s=t(d["cnt_s"], f32), cnt_r=t(d["cnt_r"], f32),
        bw_s=t(d["bw_s"], f32), bw_r=t(d["bw_r"], f32),
        total=t(d["total"], f32), mixed=t(d["mixed"], b8),
        m_dyn=t(d["m_dyn"], f32),
        cnt_x=t(d["cnt_x"], f32) if leaf else None,
        bw_x=t(d["bw_x"], f32) if leaf else None)
    fv = co.FlowView(t(d["cid"], i64), t(d["src"], i64), t(d["dst"], i64),
                     t(d["live"], b8), t(d["flow_lo"], i64),
                     t(d["flow_hi"], i64),
                     up=t(d["up"], i64) if leaf else None,
                     dn=t(d["dn"], i64) if leaf else None) \
        if flows else None
    return state, batch, fv


def prefix_rows(B, F, *, seed):
    """Seeded f32 rows (B, F) for the prefix sums: about a third zeros,
    the rest of magnitudes from 1 to 1e9."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1.0, 10.0, (B, F)) * 10.0 ** rng.integers(0, 9, (B, F))
    x[rng.uniform(size=(B, F)) < 0.3] = 0.0
    return x.astype(np.float32)


def negative_zero_rows(F, seed):
    """Seeded f32 rows (4, F) of both signs over 12 decades with 10% -0.0
    scattered and runs of -0.0 where XLA's scan chains start: row 0 at
    the front (1 to 300 long), row 1 across a block-of-16 boundary, row
    2 across a 4096-tile boundary (where the row has one), row 3 all
    -0.0 (ROADMAP C11)."""
    rng = np.random.default_rng(seed)
    x = rng.lognormal(0.0, 3.0, (4, F)) * rng.choice([-1.0, 1.0], (4, F))
    x[rng.uniform(size=x.shape) < 0.1] = -0.0
    x[0, :int(rng.integers(1, 301))] = -0.0
    b = 16 * int(rng.integers(1, max(F // 16, 1) + 1))
    x[1, max(b - 5, 0):b + 7] = -0.0
    t = 4096 if F > 4096 else b
    x[2, :3] = -0.0
    x[2, max(t - 40, 0):t + 40] = -0.0
    x[3] = -0.0
    return x.astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,P", [(1, 3, 5), (2, 64, 64), (3, 130, 150),
                                   (16, 528, 150), (1, 4096, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contention_kernel_matches_plain(cuda, B, C, P, dtype):
    g = torch.Generator(device="cpu").manual_seed(C * 7 + P)
    a_s = (torch.rand(B, C, P, generator=g) < 0.05).to(dtype).to(cuda)
    a_r = (torch.rand(B, C, P, generator=g) < 0.05).to(dtype).to(cuda)
    act = (torch.rand(B, C, generator=g) < 0.7).to(cuda)
    got = ops.contention(a_s, a_r, act)
    want = ops.contention(a_s, a_r, act, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_contention_kernel_all_inactive(cuda):
    a = torch.ones(2, 8, 8, device=cuda)
    act = torch.zeros(2, 8, dtype=torch.bool, device=cuda)
    assert (ops.contention(a, a, act) == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,P", [(2, 130, 150), (16, 528, 150),
                                   (1, 4096, 512)])
def test_contention_kernel_bool_incidence(cuda, B, C, P):
    """The coordinator's bool incidence (no cast to f32) gives the counts
    of the f32 incidence and of the plain version."""
    g = torch.Generator(device="cpu").manual_seed(C + P)
    a_s = (torch.rand(B, C, P, generator=g) < 0.05).to(cuda)
    a_r = (torch.rand(B, C, P, generator=g) < 0.05).to(cuda)
    act = (torch.rand(B, C, generator=g) < 0.7).to(cuda)
    got = ops.contention(a_s, a_r, act)
    assert torch.equal(got, ops.contention(a_s.float(), a_r.float(), act))
    assert torch.equal(got, ops.contention(a_s, a_r, act, force="ref"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bool])
def test_contention_kernel_dense_coflow(cuda, dtype):
    """A coflow on every port, beside sparse ones and inactive ones, in
    lanes of C no multiple of 32 and P > 32: every active coflow counts
    the dense one, and the dense one counts every active coflow with a
    port."""
    g = torch.Generator(device="cpu").manual_seed(3)
    B, C, P = 3, 300, 150
    a_s = torch.rand(B, C, P, generator=g) < 0.02
    a_r = torch.rand(B, C, P, generator=g) < 0.02
    act = torch.rand(B, C, generator=g) < 0.8
    a_s[:, 7], a_r[:, 7], act[:, 7] = True, True, True
    a_s[:, 11], a_r[:, 11], act[:, 11] = True, True, False
    a_s, a_r, act = (t.to(cuda) for t in (a_s.to(dtype), a_r.to(dtype),
                                          act))
    got = ops.contention(a_s, a_r, act)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.contention(a_s, a_r, act, force="ref"))
    has_port = (a_s.bool().any(-1) | a_r.bool().any(-1)) & act
    assert torch.equal(got[:, 7], (has_port.sum(1) - 1).to(torch.int32))
    assert (got[:, 11] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("flows", [True, False])
@pytest.mark.parametrize("B,C,P", [(4, 64, 6), (3, 512, 150)])
def test_tick_kernels_match_plain(cuda, B, C, P, flows):
    """A whole coordinator tick with both kernels equals the tick with
    both plain versions, output by output, exactly (the walk kernel is
    built without FMA contraction)."""
    d = random_tick_inputs(B, C, P, seed=B + C, params=UNIT)
    state, batch, fv = torch_tick_args(d, cuda, flows=flows)
    cp = co.CoordParams.from_params(UNIT)
    _, got = co.schedule_tick(state, batch, float(d["now"]), cp=cp,
                              flows=fv)
    _, want = co.schedule_tick(state, batch, float(d["now"]), cp=cp,
                               flows=fv, force="ref")
    torch.cuda.synchronize()
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert torch.equal(got[k], v), k


@pytest.mark.gpu
def test_fleet_replay_on_card_matches_cpu(cuda):
    from repro_torch.api import Scenario, run
    from repro_torch.traces.synth import tiny_trace

    fleet = tuple(tiny_trace(16, 12, seed=s) for s in range(3))
    gpu = run(Scenario(traces=fleet))
    cpu = run(Scenario(traces=fleet, device="cpu"))
    assert gpu.events == cpu.events and gpu.ticks == cpu.ticks
    np.testing.assert_array_equal(gpu.cct, cpu.cct)


def random_maxmin_inputs(B, P, Lf, F, *, seed, cand_frac=0.3, device):
    """Seeded (src, dst, up, dn, cand, avail) of the max-min fill: ports
    and leaves drawn uniformly (leaf Lf = no link), row capacities
    uniform in (0, 1.25e8) B/s, in the tick walk's W = 2P + 2Lf
    layout."""
    rng = np.random.default_rng(seed)

    def t(x, dtype):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    i64 = torch.int64
    return dict(
        src=t(rng.integers(0, P, (B, F)), i64),
        dst=t(rng.integers(0, P, (B, F)), i64),
        up=t(rng.integers(0, Lf + 1, (B, F)), i64) if Lf else None,
        dn=t(rng.integers(0, Lf + 1, (B, F)), i64) if Lf else None,
        cand=t(rng.uniform(size=(B, F)) < cand_frac, torch.bool),
        avail=t(rng.uniform(0.0, 1.25e8, (B, 2 * P + 2 * Lf)),
                torch.float32),
        num_links=Lf)


def _maxmin(args, **kw):
    a = dict(args)
    return ops.maxmin_rates(a.pop("src"), a.pop("dst"), a.pop("cand"),
                            a.pop("avail"), **a, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("B,P,Lf,F,frac", [
    (1, 2, 0, 3, 0.9), (3, 16, 4, 200, 0.7), (4, 150, 38, 2048, 0.5),
    (16, 150, 38, 30016, 0.1), (16, 150, 38, 30016, 0.6)])
def test_maxmin_kernel_matches_plain(cuda, B, P, Lf, F, frac):
    """K3 equals its plain version bit for bit, up to the fleet's shape
    (16 lanes, 188 rows a side, 30,016 flows)."""
    args = random_maxmin_inputs(B, P, Lf, F, seed=F + P, cand_frac=frac,
                                device=cuda)
    got = _maxmin(args)
    want = _maxmin(args, force="ref")
    torch.cuda.synchronize()
    assert got.any()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("per_row", [1, 3])
def test_maxmin_kernel_tie_heavy(cuda, per_row):
    """Every row at one capacity with `per_row` flows on each port:
    many rows saturate in the same round."""
    B, P = 2, 150
    F = per_row * P
    i = torch.arange(F, device=cuda).expand(B, F)
    args = dict(src=i % P, dst=(i + 1) % P, up=None, dn=None,
                cand=torch.ones(B, F, dtype=torch.bool, device=cuda),
                avail=torch.ones(B, 2 * P, device=cuda), num_links=0)
    got = _maxmin(args)
    want = _maxmin(args, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, torch.full_like(got, 1.0 / per_row))


@pytest.mark.gpu
def test_maxmin_kernel_no_candidates(cuda):
    args = random_maxmin_inputs(3, 20, 5, 500, seed=2, cand_frac=0.0,
                                device=cuda)
    got = _maxmin(args)
    torch.cuda.synchronize()
    assert got.shape == (3, 500) and not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["flow", "coflow", "admit"])
@pytest.mark.parametrize("B,C,P,hpl", [(4, 64, 6, 0), (3, 512, 150, 0),
                                       (4, 64, 10, 4), (3, 512, 150, 4)])
def test_walk_kernel_matches_plain(cuda, B, C, P, hpl, mode):
    """K2 over W = 2P + 2Lf columns (Lf = 0: the big-switch walk) in
    each mode, against its plain version, output by output, exactly."""
    d = random_tick_inputs(B, C, P, seed=B + C + hpl, params=UNIT,
                           hosts_per_leaf=hpl)
    _, batch, fv = torch_tick_args(d, cuda)
    Lf = batch.cnt_x.shape[-1] // 2 if hpl else 0
    cnt = torch.cat([batch.cnt_s, batch.cnt_r]
                    + ([batch.cnt_x] if hpl else []), -1)
    avail0 = torch.cat([batch.bw_s, batch.bw_r]
                       + ([batch.bw_x] if hpl else []), -1)
    # a priority order: arrival rank, coflows with live ports first
    hp = batch.active & ((batch.cnt_s > 0).any(-1)
                         | (batch.cnt_r > 0).any(-1))
    order = torch.argsort(batch.arrival, dim=-1)
    order = order.gather(1, torch.sort(
        (~hp).long().gather(1, order), dim=-1, stable=True).indices)
    n_live = hp.sum(-1)
    min_rate = torch.full((B,), UNIT.min_rate_frac * UNIT.port_bw,
                          device=cuda)
    wc = torch.ones(B, device=cuda)
    args = (order, n_live, cnt, avail0, min_rate, wc,
            None if mode == "coflow" else fv)
    kw = dict(num_links=Lf, admit_only=mode == "admit")
    got = ops.tick_walk(*args, **kw)
    want = ops.tick_walk(*args, **kw, force="ref")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("wc_fill", ["greedy", "maxmin"])
@pytest.mark.parametrize("B,C,P", [(4, 64, 10), (3, 512, 150)])
def test_leafspine_tick_kernels_match_plain(cuda, B, C, P, wc_fill):
    """A whole leaf-spine tick with K1 + K2 (+ K3 under max-min) equals
    the tick with the plain versions, output by output, exactly."""
    d = random_tick_inputs(B, C, P, seed=B + C, params=UNIT,
                           hosts_per_leaf=4)
    state, batch, fv = torch_tick_args(d, cuda)
    cp = co.CoordParams.from_params(UNIT)
    _, got = co.schedule_tick(state, batch, float(d["now"]), cp=cp,
                              flows=fv, wc_fill=wc_fill)
    _, want = co.schedule_tick(state, batch, float(d["now"]), cp=cp,
                               flows=fv, wc_fill=wc_fill, force="ref")
    torch.cuda.synchronize()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.gpu
def test_leafspine_fleet_replay_on_card_matches_cpu(cuda):
    from repro_torch.api import Scenario, run
    from repro_torch.fabric.topology import LeafSpine
    from repro_torch.traces.synth import tiny_trace

    fleet = tuple(tiny_trace(16, 12, seed=s) for s in range(3))
    topo = LeafSpine(hosts_per_leaf=4, oversub=4.0, wc_fill="maxmin")
    gpu = run(Scenario(traces=fleet, topology=topo))
    cpu = run(Scenario(traces=fleet, topology=topo, device="cpu"))
    assert gpu.events == cpu.events and gpu.ticks == cpu.ticks
    np.testing.assert_array_equal(gpu.cct, cpu.cct)


# ---- the online session and the pool slab --------------------------------

def _stream_pool(device, topology=None, tenants=4, advances=None):
    """`tenants` rows of a `SessionPool`, tenant i streaming
    tiny_trace(16, 12, seed=i): every arrival before the new clock is
    submitted, then the fleet advances 16 δ; once all are in, it drains
    in 1 s advances. With `advances` it stops mid-stream after that
    many. Returns ({(tenant, handle): (cct, fct)}, pool)."""
    from repro_torch.api import SessionPool
    from repro_torch.traces.synth import tiny_trace

    params = SchedulerParams()
    pool = SessionPool(params, num_ports=12, max_sessions=tenants,
                       topology=topology, device=device)
    rows = [pool.session() for _ in range(tenants)]
    queues = [sorted(tiny_trace(16, 12, seed=i).coflows,
                     key=lambda c: (c.arrival, c.cid))
              for i in range(tenants)]
    out = {}

    def harvest():
        for s, d in pool.poll():
            key = (rows.index(s), d.handle)
            assert key not in out
            out[key] = (d.cct, tuple(d.fct))

    clock, dt = 0.0, 16 * params.delta
    while any(queues):
        clock += dt
        for s, q in zip(rows, queues):
            while q and q[0].arrival < clock:
                s.submit([q.pop(0)])
        pool.advance(dt)
        harvest()
        if advances is not None and pool.io["dispatches"] >= advances:
            return out, pool
    for _ in range(10_000):
        if not any(s.num_live for s in rows):
            break
        pool.advance(1.0)
        harvest()
    assert len(out) == 16 * tenants
    return out, pool


@pytest.mark.gpu
@pytest.mark.parametrize("maxmin", [False, True])
def test_session_pool_on_card_matches_cpu(cuda, maxmin):
    """A 4-tenant pool streaming its traces on the card equals the same
    pool on the CPU, completion for completion, bit for bit (on the big
    switch, and on a leaf-spine fabric through K3)."""
    from repro_torch.fabric.topology import LeafSpine

    topo = LeafSpine(4, 4.0, "maxmin") if maxmin else None
    gpu, _ = _stream_pool(cuda, topo)
    cpu, _ = _stream_pool("cpu", topo)
    assert gpu == cpu


@pytest.mark.gpu
def test_session_advance_past_every_horizon_changes_no_leaf(cuda):
    """Mid-stream, with every lane at its horizon, a session advance is
    an exact no-op on every leaf of the slab (NaNs included), and K1 and
    K2 run once per event step of the loop."""
    from repro_torch.fabric import engine as eng

    _, pool = _stream_pool(cuda, advances=6)
    pool._sync_ctl()
    before = eng.tree_map(lambda a: a.cpu().numpy(), pool._state)
    ops.reset_launches()
    state, steps, reads = eng.session_advance(
        pool._state, pool._tb, pool._ep_stack,
        n_end=pool._ticks.astype(np.float32),
        features=pool._features_now)
    counts = ops.launch_counts()
    assert steps == reads == 1
    assert counts["contention"] == counts["tick_walk"] == steps
    eng.tree_map(lambda a, b: np.testing.assert_array_equal(
        a.cpu().numpy(), b), state, before)


@pytest.mark.gpu
def test_session_pool_launches_equal_loop_steps(cuda, monkeypatch):
    """Over a streamed 4-tenant pool, K1 and K2 launch exactly once per
    event step the session loops ran (discarded steps included), and
    the max-min kernel not at all on the big switch."""
    from repro_torch.fabric import engine as eng

    steps = [0]
    real = eng.session_advance

    def spy(*a, **kw):
        out = real(*a, **kw)
        steps[0] += out[1]
        return out

    monkeypatch.setattr(eng, "session_advance", spy)
    ops.reset_launches()
    _stream_pool(cuda)
    counts = ops.launch_counts()
    assert steps[0] > 0
    assert counts["contention"] == counts["tick_walk"] == steps[0]
    assert counts["maxmin"] == 0


# ---- learned (non-clairvoyant) sizes and the serving front door ----------

LEARNED = SchedulerParams(clairvoyant=False)


@pytest.mark.gpu
@pytest.mark.parametrize("hpl,wc_fill", [(0, "greedy"), (4, "maxmin")])
def test_learned_tick_kernels_match_plain(cuda, hpl, wc_fill):
    """A tick with the pilot re-queue inputs and a per-lane clairvoyant
    leaf (learned, known, learned) through K1 + K2 (+ K3) equals the
    tick with the plain versions, output by output, exactly."""
    B, C, P = 3, 512, 150
    d = random_tick_inputs(B, C, P, seed=21 + hpl, params=UNIT,
                           hosts_per_leaf=hpl)
    rng = np.random.default_rng(hpl)
    state, batch, fv = torch_tick_args(d, cuda)
    batch = batch._replace(
        s_mixed=torch.as_tensor(d["active"] & (rng.uniform(size=(B, C))
                                               < 0.5), device=cuda),
        s_m=torch.as_tensor((d["m"] * rng.uniform(0.0, 30.0, (B, C))
                             ).astype(np.float32), device=cuda))
    dp = co.DynCoordParams.from_cp(co.CoordParams.from_params(UNIT),
                                   cuda).lanes(B)._replace(
        clairvoyant=torch.tensor([0.0, 1.0, 0.0], device=cuda))
    now = torch.full((B,), float(d["now"]), device=cuda)
    _, got = co.tick_core(state, batch, now, dp, flows=fv, wc_fill=wc_fill)
    _, want = co.tick_core(state, batch, now, dp, flows=fv,
                           wc_fill=wc_fill, force="ref")
    torch.cuda.synchronize()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.gpu
@pytest.mark.parametrize("maxmin", [False, True])
def test_learned_fleet_replay_on_card_matches_cpu(cuda, maxmin):
    """A learned replay on the card against the CPU: the same events;
    CCTs at ROADMAP C9's bar (the pilot sums add in one order on both,
    K6's; the bar stays for the rest of the float work)."""
    from repro_torch.api import Scenario, run
    from repro_torch.fabric.topology import LeafSpine
    from repro_torch.traces.synth import tiny_trace

    fleet = tuple(tiny_trace(16, 12, seed=s) for s in range(3))
    kw = dict(traces=fleet, params=LEARNED,
              topology=LeafSpine(4, 4.0, "maxmin") if maxmin else None)
    gpu = run(Scenario(**kw))
    cpu = run(Scenario(device="cpu", **kw))
    assert gpu.events == cpu.events
    np.testing.assert_allclose(gpu.cct, cpu.cct, rtol=1e-2,
                               atol=2 * LEARNED.delta)


def _serve(device):
    """A 3-row `CoflowServer` pinned with sampling: a known tenant, a
    learned one, and a known one under a defer quota, streaming
    tiny_trace(16, 12) in 16 δ advances. Returns ({tenant: per-coflow
    CCTs}, stats, launch counts, event steps of the session loops)."""
    from repro_torch.fabric import engine as eng
    from repro_torch.launch.serve import CoflowServer, TenantQuota
    from repro_torch.traces.synth import tiny_trace

    p = SchedulerParams()
    srv = CoflowServer(p, num_ports=12, max_tenants=3, device=device,
                       features=(True, True, False, False, True))
    srv.register("known")
    srv.register("learned", mechanisms={"clairvoyant": False})
    srv.register("quota", quota=TenantQuota(max_live_coflows=3,
                                            policy="defer"))
    queues = {t: sorted(tiny_trace(16, 12, seed=i).coflows,
                        key=lambda c: (c.arrival, c.cid))
              for i, t in enumerate(srv.tenants)}
    cid_of = {t: {} for t in queues}
    cct = {t: {} for t in queues}
    steps, real = [0], eng.session_advance

    def spy(*a, **kw):
        out = real(*a, **kw)
        steps[0] += out[1]
        return out

    eng.session_advance = spy
    ops.reset_launches()
    try:
        for _ in range(20_000):
            clock = srv._tenants["known"].now + 16 * p.delta
            for t, q in queues.items():
                while q and q[0].arrival < clock:
                    c = q.pop(0)
                    for h in srv.submit(t, [c]):
                        cid_of[t][h] = c.cid
            srv.advance(16 * p.delta)
            for t in queues:
                for d in srv.poll(t):
                    cct[t][cid_of[t].get(d.handle, d.handle)] = d.cct
            if not any(queues.values()) and not any(
                    srv.num_live(t) for t in queues) and \
                    not srv.stats()["deferred_pending"]:
                break
    finally:
        eng.session_advance = real
    return cct, srv.stats(), ops.launch_counts(), steps[0]


@pytest.mark.gpu
def test_coflow_server_on_card_matches_cpu(cuda):
    """The server on the card against the same script on the CPU: the
    known tenant bit for bit, the learned one at C9's bar, the same
    stats; K1 and K2 launch once per event step of the session loops."""
    gpu, gst, counts, steps = _serve(cuda)
    cpu, cst, _, _ = _serve("cpu")
    assert gst == cst
    assert gpu["known"] == cpu["known"] and len(gpu["known"]) == 16
    keys = sorted(cpu["learned"])
    assert sorted(gpu["learned"]) == keys and len(keys) == 16
    np.testing.assert_allclose([gpu["learned"][k] for k in keys],
                               [cpu["learned"][k] for k in keys],
                               rtol=1e-2, atol=2 * LEARNED.delta)
    assert steps > 0
    assert counts["contention"] == counts["tick_walk"] == steps
    assert counts["maxmin"] == 0



# ---- the redesigned K2 and K3 at their edges -----------------------------

def _walk_inputs(d, hpl, mode, device):
    """The walk's inputs from `random_tick_inputs` on `device`, ordered
    by arrival rank with the coflows that have live ports first."""
    _, batch, fv = torch_tick_args(d, device)
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
    args = [order, hp.sum(-1), cnt, avail0,
            torch.full((B,), UNIT.min_rate_frac * UNIT.port_bw,
                       device=device),
            torch.ones(B, device=device),
            None if mode == "coflow" else fv]
    return args, dict(num_links=Lf, admit_only=mode == "admit")


def _walk_equal(args, kw):
    got = ops.tick_walk(*args, **kw)
    want = ops.tick_walk(*args, **kw, force="ref")
    torch.cuda.synchronize()
    for k, g, w in zip(("rate", "admitted", "wc_rate", "wc_flow", "avail"),
                       got, want):
        if w is None:
            assert g is None, k
        else:
            assert torch.equal(g, w), k
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("hpl", [0, 4])
def test_walk_kernel_exhausted_and_negative_rows(cuda, hpl):
    """Rows at -0, +0 and below 0 (as admission rounding leaves them)
    and counts of 3, 7 and 11: the fill skips every flow on them."""
    d = random_tick_inputs(3, 256, 150, seed=21, params=UNIT, max_width=12,
                           hosts_per_leaf=hpl)
    args, kw = _walk_inputs(d, hpl, "flow", cuda)
    cnt = args[2].clone()
    on = cnt > 0
    cnt[on] = torch.tensor([3.0, 7.0, 11.0], device=cuda).repeat(
        int(on.sum()) // 3 + 1)[:int(on.sum())]
    avail0 = args[3].clone()
    avail0[:, :3] = torch.tensor([-0.0, 0.0, -1.19e-7], device=cuda)
    args[2], args[3], args[4] = cnt, avail0, torch.full_like(args[4], 1e-6)
    want = _walk_equal(args, kw)
    assert (want[4] < 0).any() and want[3].any()


@pytest.mark.gpu
@pytest.mark.parametrize("hpl", [0, 4])
def test_walk_kernel_coflow_wider_than_the_flow_ring(cuda, hpl):
    """A missed coflow of 3000 flows (the ring holds 32 windows of 32)
    among ordinary ones."""
    d = random_tick_inputs(2, 64, 16, seed=5, params=UNIT,
                           hosts_per_leaf=hpl)
    rng = np.random.default_rng(6)
    wide = 3000
    B, C, P = 2, 64, 16
    d["width"][:, 0] = wide
    F = 64 * (-(-(wide + 6 * C) // 64))
    for k in ("cid", "src", "dst", "live", "up", "dn"):
        if k in d:
            d[k] = np.zeros((B, F), d[k].dtype)
    lo = np.zeros((B, C), np.int32)
    hi = np.zeros((B, C), np.int32)
    cnt_s = np.zeros((B, C, P), np.float32)
    cnt_r = np.zeros((B, C, P), np.float32)
    for b in range(B):
        w = rng.integers(1, 7, C)
        w[0] = wide
        hi[b] = np.cumsum(w)
        lo[b] = hi[b] - w
        n = int(hi[b, -1])
        d["cid"][b, :n] = np.repeat(np.arange(C), w)
        d["cid"][b, n:] = C - 1
        d["src"][b] = rng.integers(0, P, F)
        d["dst"][b] = rng.integers(0, P, F)
        d["active"][b, 0] = True
        d["live"][b, :n] = d["active"][b][d["cid"][b, :n]] \
            & (rng.uniform(size=n) < 0.9)
        lv = d["live"][b]
        np.add.at(cnt_s[b], (d["cid"][b][lv], d["src"][b][lv]), 1.0)
        np.add.at(cnt_r[b], (d["cid"][b][lv], d["dst"][b][lv]), 1.0)
    d.update(flow_lo=lo, flow_hi=hi, cnt_s=cnt_s, cnt_r=cnt_r)
    if hpl:
        Lf = -(-P // hpl)
        ls, ld = d["src"] // hpl, d["dst"] // hpl
        d["up"] = np.where(ls != ld, ls, Lf).astype(np.int32)
        d["dn"] = np.where(ls != ld, ld, Lf).astype(np.int32)
        cx = np.zeros((B, C, 2 * Lf + 2), np.float32)
        for b in range(B):
            lv = d["live"][b]
            np.add.at(cx[b], (d["cid"][b][lv], d["up"][b][lv]), 1.0)
            np.add.at(cx[b], (d["cid"][b][lv], Lf + 1 + d["dn"][b][lv]),
                      1.0)
        d["cnt_x"] = np.concatenate([cx[..., :Lf], cx[..., Lf + 1:-1]], -1)
    args, kw = _walk_inputs(d, hpl, "flow", cuda)
    args[4] = torch.full_like(args[4], 0.01)   # above the wide one's MADD
    want = _walk_equal(args, kw)
    assert not want[1][:, 0].any()          # the wide coflow is missed
    assert want[3].any()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["flow", "coflow", "admit"])
@pytest.mark.parametrize("P,hpl,C", [(200, 0, 256), (180, 4, 256),
                                     (4096, 0, 24)])
def test_walk_kernel_above_register_width(cuda, P, hpl, C, mode):
    """W = 400, 450 and 8192 (MAX_COLUMNS) columns, above the 384 a warp
    keeps in registers: the instance with the capacity in shared memory,
    and at 8192 a ring of one stage."""
    d = random_tick_inputs(3, C, P, seed=P + hpl, params=UNIT,
                           hosts_per_leaf=hpl)
    args, kw = _walk_inputs(d, hpl, mode, cuda)
    assert args[2].shape[-1] > 384
    _walk_equal(args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["flow", "coflow", "admit"])
def test_walk_kernel_lanes_with_different_n_live(cuda, mode):
    """Lanes at n_live 0, 3, and all their live coflows, in one call."""
    d = random_tick_inputs(4, 512, 150, seed=8, params=UNIT)
    args, kw = _walk_inputs(d, 0, mode, cuda)
    n_live = args[1].clone()
    n_live[0], n_live[1] = 0, 3
    args[1] = n_live
    want = _walk_equal(args, kw)
    assert not want[1][0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["flow", "admit"])
def test_walk_kernel_many_coflows(cuda, mode):
    """C = 4200 coflows: the walk's prefix outgrows shared memory and
    lives in the wrapper's scratch."""
    d = random_tick_inputs(2, 4200, 6, seed=3, params=UNIT, max_width=2)
    args, kw = _walk_inputs(d, 0, mode, cuda)
    _walk_equal(args, kw)


@pytest.mark.gpu
def test_walk_kernel_unaligned_rows(cuda):
    """cnt at a base 4 bytes past a 16-byte boundary: the loader warps'
    plain loads read the rows at any float-aligned address."""
    d = random_tick_inputs(3, 512, 150, seed=9, params=UNIT)
    args, kw = _walk_inputs(d, 0, "coflow", cuda)
    cnt = args[2]
    buf = torch.empty(cnt.numel() + 1, device=cuda)
    moved = buf[1:].view(cnt.shape)
    moved.copy_(cnt)
    assert moved.data_ptr() % 16 and moved.is_contiguous()
    args[2] = moved
    _walk_equal(args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("Lf", [38, 0])
def test_maxmin_kernel_every_flow_a_candidate(cuda, Lf):
    """All 30,016 flows of each lane are candidates: the list outgrows
    shared memory and lives in the wrapper's scratch."""
    args = random_maxmin_inputs(2, 150, Lf, 30016, seed=31, cand_frac=1.0,
                                device=cuda)
    got = _maxmin(args)
    want = _maxmin(args, force="ref")
    torch.cuda.synchronize()
    assert got.all() if Lf == 0 else got.any()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("Lf", [38, 0])
def test_maxmin_kernel_exhausted_and_negative_rows(cuda, Lf):
    """Rows at -0, +0 and below 0 (as admission rounding leaves them)."""
    args = random_maxmin_inputs(4, 150, Lf, 4096, seed=37 + Lf,
                                cand_frac=0.3, device=cuda)
    args["avail"][:, :3] = torch.tensor([-0.0, 0.0, -1.19e-7], device=cuda)
    if Lf:
        args["avail"][:, 300:302] = torch.tensor([-0.0, -1.19e-7],
                                                 device=cuda)
    got = _maxmin(args)
    want = _maxmin(args, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---- K4, the SSD chunked scan, and the Mamba2 serve path ---------------

SSD_SHAPES = [(1, 16, 1, 1, 8, 8, 8), (2, 64, 4, 2, 16, 32, 16),
              (1, 128, 2, 1, 32, 64, 64), (1, 256, 8, 2, 64, 128, 128),
              (2, 300, 8, 2, 64, 128, 128), (4, 1024, 64, 1, 64, 128, 128)]


def ssd_inputs(B, L, H, G, Dh, N, *, seed, dtype, device):
    """The seeded inputs of `tests/test_kernels.py`'s SSD sweep."""
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, L, H, Dh)),
            rng.uniform(0.01, 0.3, size=(B, L, H)),
            -rng.uniform(0.3, 2.0, size=H),
            rng.normal(size=(B, L, G, N)), rng.normal(size=(B, L, G, N)))
    return [torch.as_tensor(a, dtype=torch.float32 if i == 2 else dtype,
                            device=device) for i, a in enumerate(arrs)]


def assert_ssd_close(got, want, *, atol=5e-4):
    """The reference's bar (atol 5e-4, rtol 1e-3); a bf16 output may be
    one bf16 rounding step apart besides (at most 2^-7 relative), since
    both sides round their f32 sums to bf16."""
    rtol = 1e-3 + (2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, B, L, H, G, Dh, N, lc, dtype):
    """K4 against `ssd_chunked_ref` on the card; at the serve shape the
    absolute bar scales with max|y|. L = 300 goes through the padding."""
    args = ssd_inputs(B, L, H, G, Dh, N, seed=L + H, dtype=dtype,
                      device=cuda)
    before = ops.launch_counts()["ssd_scan"]
    y, s = ops.ssd_scan(*args, lc=lc)
    assert ops.launch_counts()["ssd_scan"] == before + 1
    y_ref, s_ref = ops.ssd_scan(*args, lc=lc, force="ref")
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    scale = float(y_ref.float().abs().max()) if B * L >= 4096 else 1.0
    assert_ssd_close(y, y_ref, atol=5e-4 * scale)
    assert_ssd_close(s, s_ref)


@pytest.mark.gpu
def test_ssd_kernel_state_chaining(cuda):
    x, dt, a, b, c = ssd_inputs(1, 64, 2, 1, 16, 32, seed=5,
                                dtype=torch.float32, device=cuda)
    y_full, s_full = ops.ssd_scan(x, dt, a, b, c, lc=16, force="ref")
    y1, s1 = ops.ssd_scan(x[:, :32], dt[:, :32], a, b[:, :32], c[:, :32],
                          lc=16)
    y2, s2 = ops.ssd_scan(x[:, 32:], dt[:, 32:], a, b[:, 32:], c[:, 32:],
                          init_state=s1, lc=16)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-4,
                               rtol=1e-3)
    torch.testing.assert_close(s2, s_full, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
def test_ssd_kernel_large_decay_is_finite(cuda):
    """|a| dt up to 300 a step: the decay's masked argument never
    overflows into inf * 0."""
    x, dt, a, b, c = ssd_inputs(1, 128, 2, 1, 16, 32, seed=9,
                                dtype=torch.float32, device=cuda)
    y, s = ops.ssd_scan(x, dt * 20.0, a * 30.0, b, c, lc=64)
    y_ref, s_ref = ops.ssd_scan(x, dt * 20.0, a * 30.0, b, c, lc=64,
                                force="ref")
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert_ssd_close(y, y_ref)
    assert_ssd_close(s, s_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", [(1, 1024, 64, 1, 64, 128, 128),
                                             (1, 300, 4, 2, 40, 128, 128),
                                             (2, 100, 3, 1, 8, 16, 32)])
def test_ssd_kernel_one_batch_row_and_partial_columns(cuda, B, L, H, G, Dh,
                                                      N, lc, dtype):
    """B = 1 at the serve heads, and head widths no multiple of the
    kernel's column slice (Dh = 40, 8) with a ragged last chunk."""
    args = ssd_inputs(B, L, H, G, Dh, N, seed=L + Dh, dtype=dtype,
                      device=cuda)
    y, s = ops.ssd_scan(*args, lc=lc)
    y_ref, s_ref = ops.ssd_scan(*args, lc=lc, force="ref")
    torch.cuda.synchronize()
    scale = float(y_ref.float().abs().max()) if B * L >= 1024 else 1.0
    assert_ssd_close(y, y_ref, atol=5e-4 * scale)
    assert_ssd_close(s, s_ref)


@pytest.mark.gpu
def test_ssd_kernel_reads_strided_views(cuda):
    """x, b and c as the Mamba mixer passes them: views of one (B, L,
    channels) tensor, with a time-step stride of the channel count,
    read in place (no copy) and equal to the same scan on contiguous
    copies; an init_state besides."""
    B, L, H, Dh, G, N = 2, 200, 4, 16, 2, 32
    rng = np.random.default_rng(11)
    conv = torch.as_tensor(rng.normal(size=(B, L, H * Dh + 2 * G * N)),
                           dtype=torch.float32, device=cuda)
    x = conv[..., :H * Dh].reshape(B, L, H, Dh)
    b = conv[..., H * Dh:H * Dh + G * N].reshape(B, L, G, N)
    c = conv[..., H * Dh + G * N:].reshape(B, L, G, N)
    assert x.stride(1) == conv.shape[-1] and not x.is_contiguous()
    dt = torch.as_tensor(rng.uniform(0.01, 0.3, size=(B, L, H)),
                         dtype=torch.float32, device=cuda)
    a = torch.as_tensor(-rng.uniform(0.3, 2.0, size=H), dtype=torch.float32,
                        device=cuda)
    s0 = torch.as_tensor(rng.normal(size=(B, H, Dh, N)), dtype=torch.float32,
                         device=cuda)
    y, s = ops.ssd_scan(x, dt, a, b, c, init_state=s0, lc=64)
    y_c, s_c = ops.ssd_scan(x.contiguous(), dt, a, b.contiguous(),
                            c.contiguous(), init_state=s0, lc=64)
    y_ref, s_ref = ops.ssd_scan(x, dt, a, b, c, init_state=s0, lc=64,
                                force="ref")
    torch.cuda.synchronize()
    assert torch.equal(y, y_c) and torch.equal(s, s_c)
    assert_ssd_close(y, y_ref)
    assert_ssd_close(s, s_ref)


@pytest.mark.gpu
def test_ssd_kernel_cuda_launches_per_call(cuda):
    """One call of `ops.ssd_scan` counts once in `launch_counts` and runs
    two CUDA kernels (c b^T once per group, then the scan), and nothing
    else: no pad, copy or slice around them."""
    from torch.profiler import ProfilerActivity, profile

    args = ssd_inputs(4, 1000, 64, 1, 64, 128, seed=1, dtype=torch.bfloat16,
                      device=cuda)
    ops.ssd_scan(*args)
    torch.cuda.synchronize()
    before = ops.launch_counts()["ssd_scan"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ops.ssd_scan(*args)
        torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.key for e in rows]
    assert sum(e.count for e in rows) == 2, names
    assert sorted("ssd_gram" in n for n in names) == [False, True], names
    assert all("ssd_" in n for n in names), names


@pytest.mark.gpu
def test_two_layer_full_width_serve_kernel_vs_plain(cuda):
    """Mamba2-1.3B at full width, 2 layers, f32, served by `ServeSession`
    on one model: prefill and greedy decode with K4 against the plain SSD
    path (logits to the JAX package's prefill bar 2e-3, tokens equal),
    K4 once per layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.lm_serve import ServeSession
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2,
                              dtype="float32")
    model = lm.init_model(cfg, seed=0, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 300))
    runs = {}
    for force in ("ref", None):
        sess = ServeSession("mamba2-1.3b", batch=2, max_len=304,
                            force=force, model=model)
        ops.reset_launches()
        runs[force] = list(sess.stream(prompts, 4))
        assert ops.launch_counts()["ssd_scan"] == (
            0 if force else cfg.num_layers)
    for (tok, got), (want_tok, want) in zip(runs[None], runs["ref"]):
        torch.testing.assert_close(got, want, atol=2e-3, rtol=0)
        assert torch.equal(tok, want_tok)


def test_serve_session_without_card_raises(monkeypatch):
    """`ServeSession()` runs on the card by default and raises where
    there is none (here, or with CUDA hidden)."""
    from repro_torch.launch.lm_serve import ServeSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeSession("mamba2-1.3b")


# ---- K5, the attention kernel, and the StarCoder2 serve path -----------

# (B, H, Hkv, S, T, D, q_offset): tests/test_kernels.py's sweep, its
# chunked-prefill offset, a ragged S against T > S, the smoke head size,
# the serve shape (4 prompts of 2000 tokens, StarCoder2-3B heads), then
# at D = 128 StarCoder2's G = 12 with S and T no multiple of the bf16
# kernel's 128-row tiles, and a chunk at q_offset 250 against T > S
FLASH_SHAPES = [(1, 1, 1, 16, 16, 32, 0), (2, 4, 2, 64, 64, 64, 0),
                (1, 8, 1, 32, 32, 128, 0), (1, 2, 2, 40, 40, 64, 0),
                (1, 2, 2, 32, 64, 32, 32), (2, 4, 2, 23, 40, 32, 17),
                (2, 4, 2, 100, 100, 16, 0), (4, 24, 2, 2000, 2000, 128, 0),
                (1, 24, 2, 300, 300, 128, 0), (2, 8, 2, 150, 400, 128, 250)]
FLASH_ATOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


def flash_inputs(B, H, Hkv, S, T, D, *, seed, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                            device=device).to(dtype)
            for shape in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D))]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,T,D,q_offset", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, B, H, Hkv, S, T, D,
                                              q_offset, dtype, causal):
    """K5 against `flash_attention_ref` on the card at the reference's
    bars (atol 2e-6 f32, 2e-2 bf16), one launch per call."""
    q, k, v = flash_inputs(B, H, Hkv, S, T, D, seed=S + D, dtype=dtype,
                           device=cuda)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               force="ref")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, S, D)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_reads_strided_views(cuda, dtype):
    """(B, S, H, D) tensors passed as transposed views, K and V as slices
    of a longer cache (whose rows past S hold other values): the same
    result as contiguous copies, causal and not (f32 exactly, bf16 to
    its bar), and o laid out like q (its transpose back is
    contiguous)."""
    B, S, H, Hkv, D = 2, 70, 6, 2, 64
    rng = np.random.default_rng(0)
    qs = torch.as_tensor(rng.normal(size=(B, S, H, D)).astype(np.float32),
                         device=cuda).to(dtype)
    cache = torch.as_tensor(rng.normal(size=(2, B, 96, Hkv, D)).astype(
        np.float32), device=cuda).to(dtype)
    q = qs.transpose(1, 2)
    k, v = (c[:, :S].transpose(1, 2) for c in cache)
    atol = 0 if dtype == torch.float32 else FLASH_ATOL[dtype]
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal)
        torch.testing.assert_close(got, want, atol=atol, rtol=0)
        assert got.transpose(1, 2).is_contiguous()


@pytest.mark.gpu
def test_flash_attention_bf16_rejects_views_tma_cannot_load(cuda):
    """The bf16 kernel loads q, k and v with TMA: a base pointer one
    element off a 16-byte boundary, or a row stride that is no multiple
    of 16 bytes, raises ValueError naming it (no fallback)."""
    q, k, v = flash_inputs(1, 2, 1, 8, 8, 32, seed=0,
                           dtype=torch.bfloat16, device=cuda)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="q: .*16-byte-aligned base"):
        ops.flash_attention(shifted, k, v)
    wide = torch.zeros(1, 1, 8, 36, dtype=torch.bfloat16, device=cuda)
    wide[..., :32] = k
    with pytest.raises(ValueError, match="k: .*row stride is 36 elements"):
        ops.flash_attention(q, wide[..., :32], v)


@pytest.mark.gpu
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = flash_inputs(1, 2, 1, 8, 8, 48, seed=0,
                           dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="D = 48"):
        ops.flash_attention(q, k, v)
    q, k, v = flash_inputs(1, 2, 1, 8, 8, 32, seed=0,
                           dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="k: expected"):
        ops.flash_attention(q, k.bfloat16(), v)


@pytest.mark.gpu
def test_starcoder2_serve_launches_k5_once_per_layer_prefill(cuda):
    """The smoke StarCoder2 session on the card: one K5 launch per layer
    in the prefill, none in decode, and the plain path's tokens."""
    from repro_torch.launch.lm_serve import ServeSession

    runs = {}
    prompts = np.random.default_rng(3).integers(0, 256, (4, 40))
    for force in ("ref", None):
        sess = ServeSession("starcoder2-3b", device=cuda, dtype="float32",
                            force=force)
        ops.reset_launches()
        out = list(sess.stream(prompts, 6))
        assert ops.launch_counts()["flash_attention"] == (
            0 if force else sess.cfg.num_layers)
        runs[force] = out
    for (tok, got), (want_tok, want) in zip(runs[None], runs["ref"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        assert torch.equal(tok, want_tok)


@pytest.mark.gpu
def test_two_layer_full_width_starcoder2_matches_golden(cuda):
    """StarCoder2-3B at full width, 2 layers, f32, weights from
    `numpy_params(cfg, seed=0)`, served by `ServeSession(model=...)`
    through K5 against the JAX package's numbers
    (`tests/data/torch_port_starcoder2_golden.json`): top-8 logits to
    2e-3, tokens equal, per-layer K and V cache norms (summed in f64) to
    rtol 1e-4."""
    import dataclasses
    import json
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.launch.lm_serve import ServeSession
    from repro_torch.models import lm

    gold = json.loads((Path(__file__).parent / "data" /
                       "torch_port_starcoder2_golden.json").read_text())
    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              num_layers=gold["num_layers"],
                              dtype="float32")
    model = lm.from_reference(*lm.numpy_params(cfg, gold["weights_seed"]),
                              cfg, device=cuda)
    prompts = torch.as_tensor(gold["prompts"], device=cuda)
    n = len(gold["tokens"][0])
    sess = ServeSession("starcoder2-3b", batch=prompts.shape[0],
                        max_len=prompts.shape[1] + n, model=model)
    ops.reset_launches()
    out = list(sess.stream(prompts, n))
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    top = out[0][1].gather(1, torch.as_tensor(gold["top8_index"],
                                              device=cuda))
    torch.testing.assert_close(
        top, torch.as_tensor(gold["top8_value"], device=cuda), atol=2e-3,
        rtol=0)
    assert torch.stack([t for t, _ in out], 1).tolist() == gold["tokens"]
    with torch.inference_mode():
        _, cache = sess.prefill_fn(prompts, lm.init_cache(
            cfg, prompts.shape[0], prompts.shape[1], device=cuda))
    for key in ("k", "v"):
        np.testing.assert_allclose(
            [float(c[key].double().norm()) for c in cache],
            gold[f"{key}_cache_norm"], rtol=1e-4)


# ---- K5 at MLA's widths, K4 at Jamba's state width, the MoE models -----

# (B, H, Hkv, S, T, D, Dv, q_offset): K5 at MLA's (192, 128): the smoke
# heads, a chunk at q_offset 250 against T > S, a ragged S against T > S
# with GQA groups, and DeepSeek-V2's prefill shape (4 x 1000 tokens, 128
# heads)
MLA_SHAPES = [(1, 2, 2, 16, 16, 192, 128, 0), (2, 4, 2, 150, 400, 192, 128, 250),
              (2, 4, 4, 23, 40, 192, 128, 17), (4, 128, 128, 1000, 1000, 192,
                                                 128, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,T,D,Dv,q_offset", MLA_SHAPES)
def test_flash_attention_kernel_mla_widths_match_plain(
        cuda, B, H, Hkv, S, T, D, Dv, q_offset, dtype, causal):
    """K5's (192, 128) instance against `flash_attention_ref` at the
    reference's bars (atol 2e-6 f32, 2e-2 bf16), one launch per call;
    o is (B, H, S, Dv)."""
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                               device=cuda).to(dtype)
               for s in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv)))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               force="ref")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, S, Dv)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_mla_reads_strided_views(cuda, dtype):
    """MLA's prefill passes (B, S, H, 192) q and k and (B, S, H, 128) v
    as transposed views: the result of contiguous copies, and o (B, H,
    S, 128) laid out like q."""
    B, S, H = 2, 70, 6
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, H, d)).astype(
        np.float32), device=cuda).to(dtype).transpose(1, 2)
        for d in (192, 192, 128))
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert got.shape == (B, H, S, 128) and got.transpose(1, 2).is_contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", [(4, 1000, 128, 1, 64, 16, 128),
                                             (1, 300, 8, 1, 64, 16, 128)])
def test_ssd_kernel_at_jamba_state_width(cuda, B, L, H, G, Dh, N, lc,
                                         dtype):
    """K4 at Jamba's N = 16 (its Mamba prefill shape, and a ragged
    short one) against `ssd_chunked_ref` at the reference's bar, the
    absolute part scaled by max|y| at the prefill shape."""
    args = ssd_inputs(B, L, H, G, Dh, N, seed=L + N, dtype=dtype,
                      device=cuda)
    y, s = ops.ssd_scan(*args, lc=lc)
    y_ref, s_ref = ops.ssd_scan(*args, lc=lc, force="ref")
    torch.cuda.synchronize()
    scale = float(y_ref.float().abs().max()) if B * L >= 4000 else 1.0
    assert_ssd_close(y, y_ref, atol=5e-4 * scale)
    assert_ssd_close(s, s_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,k4,k5", [("qwen3-moe-235b-a22b", 0, 2),
                                        ("deepseek-v2-236b", 0, 3),
                                        ("jamba-v0.1-52b", 7, 1)])
def test_moe_smoke_serve_on_card_matches_plain(cuda, arch, k4, k5):
    """The SMOKE MoE, MLA and hybrid models on the card in f32 (DeepSeek-
    V2's at MLA's published head widths, 128 + 64 and 128: K5 has no
    instance at its SMOKE widths): K4 once per Mamba layer and K5 once
    per attention layer in the prefill, nothing else, and the plain
    path's tokens and logits (1e-4)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.lm_serve import ServeSession
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.mla:
        cfg = dataclasses.replace(cfg, head_dim=128, rope_head_dim=64)
    model = lm.init_model(cfg, seed=0, device=cuda)
    runs = {}
    prompts = np.random.default_rng(5).integers(0, 256, (4, 40))
    for force in ("ref", None):
        sess = ServeSession(arch, max_len=46, force=force, model=model)
        ops.reset_launches()
        out = list(sess.stream(prompts, 6))
        counts = ops.launch_counts()
        assert (counts["ssd_scan"], counts["flash_attention"]) == (
            (0, 0) if force else (k4, k5))
        assert sum(counts.values()) == counts["ssd_scan"] + counts[
            "flash_attention"]
        runs[force] = out
    for (tok, got), (want_tok, want) in zip(runs[None], runs["ref"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        assert torch.equal(tok, want_tok)


# ---- K5 at (256, 256), non-causal with S != T, G = 7; the dense and ------
# ---- encoder-decoder models ---------------------------------------------

# (B, H, Hkv, S, T, D, q_offset): K5 at Gemma's (256, 256): ragged S
# against T > S, a chunk at q_offset 250 and Gemma-7B's prefill shape (4 x
# 1000 tokens, 16 heads); SeamlessM4T's cross attention (16 decoder rows
# against 1000 encoder rows, D 64) and a short one; DeepSeek-Coder-33B's
# G = 7 at its prefill shape and ragged
DENSE_SHAPES = [(2, 4, 2, 23, 40, 256, 17), (2, 4, 2, 150, 400, 256, 250),
                (4, 16, 16, 1000, 1000, 256, 0), (4, 16, 16, 16, 1000, 64, 0),
                (2, 4, 4, 16, 300, 64, 0), (2, 14, 2, 77, 130, 128, 0),
                (4, 56, 8, 1000, 1000, 128, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,T,D,q_offset", DENSE_SHAPES)
def test_flash_attention_kernel_dense_shapes_match_plain(
        cuda, B, H, Hkv, S, T, D, q_offset, dtype, causal):
    """K5 against `flash_attention_ref` at the reference's bars (atol
    2e-6 f32, 2e-2 bf16), one launch per call: the (256, 256) instance,
    the non-causal branch with S != T and G = 7."""
    q, k, v = flash_inputs(B, H, Hkv, S, T, D, seed=S + D, dtype=dtype,
                           device=cuda)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               force="ref")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, S, D)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,k5", [("gemma-7b", 2), ("deepseek-7b", 2),
                                     ("deepseek-coder-33b", 2),
                                     ("chameleon-34b", 2),
                                     ("seamless-m4t-medium", 6)])
def test_dense_smoke_serve_on_card_matches_plain(cuda, arch, k5):
    """The SMOKE dense and encoder-decoder models on the card in f32
    (SeamlessM4T with 16 frames a request): K5 once per attention in
    the prefill (SeamlessM4T: 2 encoder layers, 2 decoder
    self-attentions, 2 cross attentions), nothing else, and the plain
    path's tokens and logits (1e-4)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.lm_serve import ServeSession
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = lm.init_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 256, (4, 40))
    src = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32) \
        if cfg.enc_dec else None
    runs = {}
    for force in ("ref", None):
        sess = ServeSession(arch, max_len=46, force=force, model=model)
        ops.reset_launches()
        out = list(sess.stream(prompts, 6, src_embeds=src))
        counts = ops.launch_counts()
        assert counts["flash_attention"] == (0 if force else k5)
        assert sum(counts.values()) == counts["flash_attention"]
        runs[force] = out
    for (tok, got), (want_tok, want) in zip(runs[None], runs["ref"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        assert torch.equal(tok, want_tok)


# ---- K6: prefix sums in the JAX package's scan order ----------------------

@pytest.mark.gpu
@pytest.mark.parametrize("B,F", [(1, 1), (3, 15), (3, 16), (2, 17),
                                 (4, 257), (2, 4095), (2, 4096),
                                 (2, 4097), (2, 8193), (16, 30016),
                                 (96, 30016), (2, 65537), (2, 200_000)])
def test_prefix_sum_kernel_matches_plain_bitwise(cuda, B, F):
    """K6 equals `prefix_sum_ref` bit for bit (signed zeros included),
    one launch a call counting its rows: one tile (F <= 4096), the
    chunk boundaries, the fleet's per-sum and grouped shapes (16 and
    6 x 16 rows), and rows with a fourth level of totals (F > 65,536)."""
    x = torch.from_numpy(prefix_rows(B, F, seed=F)).to(cuda)
    before = ops.launch_counts()
    got = ops.prefix_sum(x)
    after = ops.launch_counts()
    assert after["prefix_sum"] == before["prefix_sum"] + 1
    assert after["prefix_sum_rows"] == before["prefix_sum_rows"] + B
    want = ops.prefix_sum(x, force="ref")
    torch.cuda.synchronize()
    assert got.shape == (B, F + 1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("F", [17, 4097, 30016, 65537])
def test_prefix_sum_kernel_negative_zero_runs(cuda, F):
    """ROADMAP C11: rows with runs of -0.0 at the front and across the
    16-block and 4096-tile boundaries: K6 starts every chain from +0.0
    as the plain version (and XLA) does, bit for bit, and writes no
    -0.0."""
    x = torch.from_numpy(negative_zero_rows(F, seed=F)).to(cuda)
    got, want = ops.prefix_sum(x), ops.prefix_sum(x, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not bool((got.view(torch.int32) == -2 ** 31).any())


@pytest.mark.gpu
@pytest.mark.parametrize("B,F", [(320, 30016), (2000, 100), (1, 1 << 23)])
def test_prefix_sum_kernel_loops_over_more_tiles_than_blocks(cuda, B, F):
    """More tiles (or rows) than the card holds co-resident blocks (at
    most 8 of 256 threads an SM): each block loops over several, and
    re-reads its tiles' x in the output phase; the longest row taken
    (2^23: five levels of totals, 2184 of them scanned in shared
    memory)."""
    x = torch.from_numpy(prefix_rows(B, F, seed=B)).to(cuda)
    got, want = ops.prefix_sum(x), ops.prefix_sum(x, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_prefix_sum_kernel_unaligned_rows_and_signed_values(cuda):
    """Rows whose start is not 16-byte aligned (F odd: 4-byte loads) and
    a view whose base is offset by one float, of both signs with -0.0
    and +0.0: the plain version's bits."""
    rng = np.random.default_rng(7)
    x = rng.lognormal(0.0, 6.0, (5, 8195)) * rng.choice([-1.0, 1.0],
                                                        (5, 8195))
    x[rng.uniform(size=x.shape) < 0.3] = -0.0
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    for v in (x, x.view(-1)[1:1 + 4 * 8192].view(4, 8192)):
        got, want = ops.prefix_sum(v), ops.prefix_sum(v, force="ref")
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("leaf", [False, True])
def test_event_step_sums_in_two_k6_launches(cuda, leaf):
    """One event step of the fleet engine on the card: K6 launches twice
    (the step's grouped sums, the completions' undone count) and sums 4
    rows a lane on the big switch, 6 on the leaf-spine batch."""
    from repro_torch.fabric import engine as eng
    from repro_torch.fabric.topology import LeafSpine
    from repro_torch.traces.batch import pack, to_device
    from repro_torch.traces.synth import tiny_trace

    p = SchedulerParams()
    topo = LeafSpine(4, 4.0, "maxmin") if leaf else None
    tb = to_device(pack([tiny_trace(24, 12, seed=s, load=0.8)
                         for s in range(3)], port_bw=p.port_bw,
                        topology=topo), cuda)
    ep = eng.EngineParams.from_scheduler(p, device=cuda).lanes(3)
    feats = eng.features_for(p, topology=topo)
    state = eng._init_state(tb)
    ops.reset_launches()
    eng._run_chunk(state, tb, ep, chunk=1, features=feats)
    counts = ops.launch_counts()
    assert counts["prefix_sum"] == 2
    assert counts["prefix_sum_rows"] == 3 * (6 if leaf else 4)


@pytest.mark.gpu
def test_prefix_sum_kernel_reads_a_strided_view(cuda):
    """A non-contiguous (B, F) view (the engine's gathers are contiguous,
    a caller's slice need not be) sums like its contiguous copy."""
    x = torch.from_numpy(prefix_rows(4, 600, seed=3)).to(cuda)[:, ::2]
    got = ops.prefix_sum(x)
    want = ops.prefix_sum(x.contiguous(), force="ref")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_prefix_sum_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError):
        ops.prefix_sum(torch.ones(4, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        ops.prefix_sum(torch.ones(2, 4, 8, device=cuda))
    with pytest.raises(ValueError):   # rows of at most 2^23 floats
        ops.prefix_sum(torch.ones(1, (1 << 23) + 1, device=cuda))


# ---- the event-driven host plane: K1 (and saath-torch's tick) on the card -

HOST_POLICIES = ("saath", "aalo", "fifo", "scf", "srtf", "lwtf",
                 "varys-sebf", "uc-tcp", "saath-torch")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
def test_host_contention_on_card_equals_plain(cuda, seed):
    """`core.contention` on the card (K1 on the active rows) against the
    same call on the CPU (the plain version): random incidences with
    inactive, empty and dense rows, up to the full 1024 ports."""
    from repro_torch.core.contention import contention

    rng = np.random.default_rng(seed)
    C, P = int(rng.integers(1, 600)), int(rng.integers(1, 1025))
    a_s = rng.uniform(size=(C, P)) < 0.02
    a_r = rng.uniform(size=(C, P)) < 0.02
    a_s[0] = True
    active = rng.uniform(size=C) < 0.6
    before = ops.launch_counts()["contention"]
    got = contention(a_s, a_r, active, device=cuda)
    assert ops.launch_counts()["contention"] == before + int(active.any())
    np.testing.assert_array_equal(
        got, contention(a_s, a_r, active, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("policy", HOST_POLICIES)
def test_numpy_engine_on_card_matches_cpu(cuda, policy):
    """`run(Scenario(engine="numpy"))` under every registry policy, its
    kernel work on the card, against the same replay on the CPU: steps
    equal and every CCT and FCT bit for bit (K1's counts are exact
    integers; `saath-torch`'s tick is the port's, bit for bit across
    devices). Saath and LWTF launch K1 once a schedule, `saath-torch`
    K1 and K2 once a schedule, the rest nothing."""
    from repro_torch.api import Scenario, run
    from repro_torch.traces.synth import fb_like_trace

    kw = dict(engine="numpy", policy=policy,
              trace=fb_like_trace(40, 24, seed=3))
    ops.reset_launches()
    gpu = run(Scenario(**kw))
    counts = ops.launch_counts()
    cpu = run(Scenario(device="cpu", **kw))
    assert gpu.steps == cpu.steps
    np.testing.assert_array_equal(gpu.cct, cpu.cct)
    np.testing.assert_array_equal(gpu.fct, cpu.fct)
    uses_k1 = policy in ("saath", "lwtf", "saath-torch")
    assert counts["contention"] == (gpu.steps if uses_k1 else 0)
    assert counts["tick_walk"] == (gpu.steps if policy == "saath-torch"
                                   else 0)
    assert counts["maxmin"] == counts["ssd_scan"] == 0


@pytest.mark.gpu
def test_saath_torch_leafspine_maxmin_on_card_matches_cpu(cuda):
    """`saath-torch` under `LeafSpine(4, 4.0, "maxmin")`: K1, K2 and K3
    once a schedule, the replay bit for bit the CPU's."""
    from repro_torch.api import Scenario, run
    from repro_torch.fabric.topology import LeafSpine
    from repro_torch.traces.synth import fb_like_trace

    kw = dict(engine="numpy", policy="saath-torch",
              trace=fb_like_trace(40, 24, seed=4),
              topology=LeafSpine(4, 4.0, "maxmin"))
    ops.reset_launches()
    gpu = run(Scenario(**kw))
    counts = ops.launch_counts()
    cpu = run(Scenario(device="cpu", **kw))
    assert gpu.steps == cpu.steps
    np.testing.assert_array_equal(gpu.cct, cpu.cct)
    for name in ("contention", "tick_walk", "maxmin"):
        assert counts[name] == gpu.steps, name


@pytest.mark.gpu
def test_numpy_session_on_card_equals_cpu_and_offline(cuda):
    """`SaathSession(backend="numpy")` with its contention count on the
    card, fed a trace's coflows at their arrival times: the same session
    on the CPU bit for bit, and the offline numpy replay within the
    reference's own bar for this oracle (rtol 1e-9: the session clock
    `now + (arrival - now)` may land an ulp past an arrival)."""
    from repro_torch.api import SaathSession, Scenario, run
    from repro_torch.traces.synth import fb_like_trace

    tr = fb_like_trace(30, 16, seed=5)

    def online(device):
        sess = SaathSession(num_ports=16, backend="numpy", device=device)
        got = {}
        for c in sorted(tr.coflows, key=lambda c: (c.arrival, c.cid)):
            sess.advance(max(c.arrival - sess.now, 0.0))
            got[sess.submit([c])[0]] = c.cid
        cct = np.full(len(tr.coflows), np.nan)
        for d in sess.drain(step=1.0, max_seconds=3600.0):
            cct[got[d.handle]] = d.cct
        return cct

    ops.reset_launches()
    gpu = online(None)
    assert ops.launch_counts()["contention"] > 0
    np.testing.assert_array_equal(gpu, online("cpu"))
    want = run(Scenario(engine="numpy", trace=tr))
    np.testing.assert_allclose(gpu, want.row_cct(), rtol=1e-9)


def _bridge_workload():
    """The bridge workload of `tests/test_session.py`, from the port's
    one copy of it in `examples/multi_tenant_fabric_torch.py`."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "multi_tenant_fabric_torch.py"
    spec = importlib.util.spec_from_file_location("multi_tenant_fabric_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bridge_workload()


@pytest.mark.gpu
def test_plan_waves_on_card_equals_cpu_and_numpy(cuda):
    """The bridge's wave plan with the torch session on the card (K1, K2
    and K6 launched) equals the same planner on the CPU and the numpy
    backend on the card."""
    from repro_torch.runtime.coflow_bridge import plan_waves

    cfs = _bridge_workload()
    ops.reset_launches()
    got = plan_waves(cfs)
    counts = ops.launch_counts()
    assert counts["contention"] == counts["tick_walk"] == len(got)
    assert counts["prefix_sum"] > 0
    assert got == plan_waves(cfs, device="cpu") == \
        plan_waves(cfs, backend="numpy")
    assert [n for w in got for n in w if n.startswith("grad/")] == [
        f"grad/{b}" for b in range(6)]


@pytest.mark.gpu
def test_scheduled_psum_over_an_nccl_world_of_one(cuda):
    """A per-bucket NCCL all-reduce over a world of 1 (rendezvous in an
    in-memory store) returns the card tensors' values."""
    import torch.distributed as dist

    from repro_torch.runtime.buckets import bucketize, leaves_with_path
    from repro_torch.runtime.overlap import scheduled_psum

    tree = {"a": torch.arange(16.0, device=cuda).reshape(4, 4),
            "b": torch.ones(8, device=cuda)}
    bks = bucketize(tree, bucket_bytes=40)
    flat = [leaf for _, leaf in leaves_with_path(tree)]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        out = scheduled_psum(flat, bks, [[f"grad/{b.bid}"] for b in bks])
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for a, b in zip(out, flat):
        assert a.device.type == "cuda" and torch.equal(a, b)


# ---- training: K7 (the attention backward) and a train step -------------

K7_BAR = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(16, 16), (32, 32), (64, 64),
                                    (128, 128), (192, 128)])
def test_flash_attention_bwd_kernel_matches_plain(cuda, widths, dtype,
                                                  causal):
    """K7 against `flash_attention_bwd_ref` on the card at every (D, Dv)
    pair K5 is built for, on transposed (B, S, H, D) views, q_offset 0
    and a chunk against T > S: each gradient within 1e-5 (f32) or 2e-2
    (bf16) of its largest magnitude, laid out like its input, one call
    counted per backward."""
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda)

    D, Dv = widths
    rng = np.random.default_rng(D + Dv)
    for B, H, Hkv, S, T, qo in ((2, 4, 2, 70, 70, 0),
                                (1, 2, 1, 37, 150, 113)):
        q, k, v, do = (torch.as_tensor(rng.normal(size=s).astype(
            np.float32), device=cuda).to(dtype).transpose(1, 2)
            for s in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, Dv),
                      (B, S, H, Dv)))
        o = ops.flash_attention(q, k, v, causal=causal, q_offset=qo,
                                force="ref")
        before = ops.launch_counts()["flash_attention_bwd"]
        got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                      q_offset=qo)
        assert ops.launch_counts()["flash_attention_bwd"] == before + 1
        want = ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                       q_offset=qo, force="ref")
        torch.cuda.synchronize()
        for g, w, x in zip(got, want, (q, k, v)):
            assert g.dtype == dtype and g.shape == x.shape
            assert g.transpose(1, 2).is_contiguous()
            bar = K7_BAR[dtype] * float(w.float().abs().max())
            torch.testing.assert_close(g.float(), w.float(), atol=bar,
                                       rtol=0)
    with pytest.raises(ValueError, match="must be one of"):
        flash_attention_bwd_cuda(q[..., :8], k[..., :8], v, o, do)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 24, 2, 2048, 2048, 128, 128),
                                   (2, 12, 2, 150, 150, 16, 16),
                                   (2, 12, 2, 150, 150, 32, 32),
                                   (2, 12, 2, 150, 150, 64, 64),
                                   (2, 12, 2, 150, 150, 128, 128),
                                   (2, 12, 2, 150, 150, 192, 128)], ids=str)
def test_flash_attention_bwd_kernel_is_bitwise_repeatable(cuda, shape,
                                                           dtype):
    """Two K7 calls on the same inputs give the same bits of dq, dk and
    dv: no atomics, and the head split's partials (G = 12 here, split 4
    ways at StarCoder2-3B's train shape and 3 ways at the small ones) are
    summed in a fixed order."""
    B, H, Hkv, S, T, D, Dv = shape
    rng = np.random.default_rng(S + D)
    q, k, v, do = (torch.as_tensor(rng.normal(size=s).astype(
        np.float32), device=cuda).to(dtype).transpose(1, 2)
        for s in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, Dv),
                  (B, S, H, Dv)))
    o = ops.flash_attention(q, k, v)
    first = ops.flash_attention_bwd(q, k, v, o, do)
    second = ops.flash_attention_bwd(q, k, v, o, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


@pytest.mark.gpu
def test_train_step_through_k5_and_k7_matches_the_plain_path(cuda):
    """One train step of the SMOKE StarCoder2 (bf16 on f32 masters) on
    the card: K5 twice a layer (remat), K7 once, nothing else; its loss
    and grad norm within 2e-2 of the plain attention's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as ST
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    cfg = get_smoke_config("starcoder2-3b")
    t = SyntheticLMData(cfg.vocab_size, 64, 4, device=cuda).batch(0)[
        "tokens"]
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    out = {}
    for force in (None, "ref"):
        masters = lm.init_masters(cfg, seed=0, device=cuda)
        opt = make_optimizer(cfg, total_steps=2)
        state = opt.init(masters)
        ops.reset_launches()
        _, _, m = ST.make_train_step(cfg, opt, force=force)(
            masters, state, 0, batch)
        out[force] = (float(m["loss"]), float(m["grad_norm"]),
                      ops.launch_counts())
    (lk, gk, ck), (lr_, gr, cr) = out[None], out["ref"]
    L = cfg.num_layers
    assert ck["flash_attention"] == 2 * L and \
        ck["flash_attention_bwd"] == L
    assert not any(v for n, v in ck.items()
                   if n not in ("flash_attention", "flash_attention_bwd"))
    assert not any(cr.values())
    assert abs(lk - lr_) < 2e-2 and abs(gk - gr) < 2e-2 * gr


# ---- training through the Mamba mixer: K8 (the SSD scan's backward) -------

# SSD_SHAPES, then Mamba2-1.3B's train shape (4 x 2048 tokens), Jamba's
# microbatch shape (1 x 1024 tokens, H 128, N 16), K8's N <= 16
# instance with a ragged last chunk, G = 2 and groups of 20 heads that the
# chunk launch splits 3 a block (the last split 2), and odd sizes whose
# workspaces have odd float counts (each part must still start aligned)
SSD_BWD_SHAPES = SSD_SHAPES[:5] + [(4, 2048, 64, 1, 64, 128, 128),
                                   (1, 1024, 128, 1, 64, 16, 128),
                                   (2, 2000, 40, 2, 64, 16, 128),
                                   (1, 100, 1, 1, 3, 5, 128)]


def ssd_bwd_inputs(B, L, H, G, Dh, N, *, seed, dtype, device):
    """`ssd_inputs` and a seeded output gradient dy (B, L, H, Dh)."""
    args = ssd_inputs(B, L, H, G, Dh, N, seed=seed, dtype=dtype,
                      device=device)
    dy = np.random.default_rng(seed + 1).normal(size=(B, L, H, Dh))
    return args, torch.as_tensor(dy, dtype=dtype, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,G,Dh,N,lc", SSD_BWD_SHAPES)
def test_ssd_bwd_kernel_matches_plain(cuda, B, L, H, G, Dh, N, lc, dtype):
    """K8 against `ssd_chunked_bwd_ref` on the card: each gradient (da
    included) within K4's bar, atol 5e-4 of its largest magnitude and
    rtol 1e-3 (plus one bf16 step for a bf16 gradient); one call counted
    per backward."""
    args, dy = ssd_bwd_inputs(B, L, H, G, Dh, N, seed=L + H, dtype=dtype,
                              device=cuda)
    before = ops.launch_counts()["ssd_scan_bwd"]
    got = ops.ssd_scan_bwd(*args, dy, lc=lc)
    assert ops.launch_counts()["ssd_scan_bwd"] == before + 1
    want = ops.ssd_scan_bwd(*args, dy, lc=lc, force="ref")
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, args):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert bool(torch.isfinite(g).all())
        assert_ssd_close(g, w, atol=5e-4 * float(w.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_is_bitwise_repeatable(cuda, dtype):
    """No atomics: two calls give the same bits (G = 2, a ragged chunk)."""
    args, dy = ssd_bwd_inputs(2, 300, 8, 2, 64, 128, seed=3, dtype=dtype,
                              device=cuda)
    first = ops.ssd_scan_bwd(*args, dy)
    second = ops.ssd_scan_bwd(*args, dy)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_ssd_bwd_split_rule_at_the_train_shapes(cuda):
    """The kernel library's split of each group's heads (the last entry
    its workspace query fills; the CPU emulation takes a split as
    given): 8 heads a chunk block at Mamba2-1.3B's train shape, 2 at
    Jamba's, 3 for groups of 20 heads, 1 at small shapes; and every
    workspace a multiple of 64 floats, so that each part the kernel
    carves from one buffer starts 256-byte aligned."""
    import ctypes

    from repro_torch.kernels import ssd_scan_bwd as k8

    nw = len(k8.WORKSPACES)
    out = (ctypes.c_longlong * (nw + 1))()
    for (B, L, H, G, Dh, N, lc), hs in (
            ((4, 2048, 64, 1, 64, 128, 128), 8),
            ((1, 1024, 128, 1, 64, 16, 128), 2),
            ((2, 2000, 40, 2, 64, 16, 128), 3),
            ((1, 16, 1, 1, 8, 8, 8), 1), ((1, 100, 1, 1, 3, 5, 128), 1)):
        k8._library().saath_ssd_scan_bwd_workspace(B, L, H, Dh, G, N, lc,
                                                    out)
        assert out[nw] == hs
        assert all(out[i] % 64 == 0 for i in range(nw))


@pytest.mark.gpu
def test_ssd_bwd_kernel_reads_strided_views(cuda):
    """x, b, c and dy as views of wider rows (the mixer's conv output,
    autograd's gradient of a slice) give the contiguous inputs' bits."""
    args, dy = ssd_bwd_inputs(2, 200, 4, 2, 32, 16, seed=8,
                              dtype=torch.bfloat16, device=cuda)
    x, dt, a, b, c = args

    def wide(t):
        w = torch.zeros(t.shape[:2] + (t.shape[2] * t.shape[3] + 24,),
                        dtype=t.dtype, device=cuda)
        w[..., 8:8 + t.shape[2] * t.shape[3]] = t.flatten(2)
        return w[..., 8:8 + t.shape[2] * t.shape[3]].view(t.shape)

    views = [wide(t) for t in (x, b, c, dy)]
    assert not views[0].is_contiguous()
    got = ops.ssd_scan_bwd(views[0], dt, a, views[1], views[2], views[3],
                           lc=64)
    want = ops.ssd_scan_bwd(x, dt, a, b, c, dy, lc=64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_ssd_bwd_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd_cuda

    args, dy = ssd_bwd_inputs(1, 32, 2, 1, 8, 129, seed=1,
                              dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="N = 129"):
        ssd_scan_bwd_cuda(*args, dy)
    args, dy = ssd_bwd_inputs(1, 32, 3, 2, 8, 16, seed=1,
                              dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan_bwd_cuda(*args, dy)
    with pytest.raises(ValueError, match="lc = 256"):
        ssd_scan_bwd_cuda(*args[:3], args[3][:, :, :1], args[4][:, :, :1],
                          dy, lc=256)
    with pytest.raises(ValueError, match="no initial state"):
        ops.ssd_scan_bwd(*args, dy, init_state=torch.zeros(1, 3, 8, 16,
                                                           device=cuda))


@pytest.mark.gpu
def test_kernel_calls_autograd_would_record_raise(cuda):
    """A CUDA kernel call with an input requiring a gradient under grad
    mode raises (its output would carry no gradient); `models.mamba.scan`
    and `models.attention.attend` carry it through K8 and K7."""
    from repro_torch.models import attention, mamba

    args, dy = ssd_bwd_inputs(1, 64, 2, 1, 16, 16, seed=2,
                              dtype=torch.float32, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in args]
    with pytest.raises(RuntimeError, match="records no gradient"):
        ops.ssd_scan(*leaves, lc=32)
    q = torch.randn(1, 2, 32, 16, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="records no gradient"):
        ops.flash_attention(q, q, q)
    y, _ = mamba.scan(*leaves, lc=32)
    got = torch.autograd.grad(y, leaves, dy)
    want = ops.ssd_scan_bwd(*args, dy, lc=32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert attention.attend(q, q, q).grad_fn is not None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 16, 2048, 32, 64),
                                   (2, 4, 2, 301, 21, 64)], ids=str)
def test_attention_non_causal_with_more_queries_than_keys(cuda, shape,
                                                          dtype):
    """SeamlessM4T's cross attention in training: S decoder rows against
    T frames, T under one key tile; K5 (atol 2e-6 f32, 2e-2 bf16) and K7
    (each gradient within 1e-5 / 2e-2 of its largest) against their plain
    versions, non-causal, on transposed (B, S, H, D) views."""
    B, H, Hkv, S, T, D = shape
    rng = np.random.default_rng(S + T)
    q, k, v, do = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device=cuda).to(dtype).transpose(1, 2)
                   for s in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D),
                             (B, S, H, D)))
    o = ops.flash_attention(q, k, v, causal=False)
    o_ref = ops.flash_attention(q, k, v, causal=False, force="ref")
    torch.cuda.synchronize()
    bar = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=bar, rtol=0)
    got = ops.flash_attention_bwd(q, k, v, o_ref, do, causal=False)
    want = ops.flash_attention_bwd(q, k, v, o_ref, do, causal=False,
                                   force="ref")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        bar = K7_BAR[dtype] * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=bar, rtol=0)


@pytest.mark.gpu
def test_mamba2_smoke_train_step_matches_the_cpu(cuda):
    """One f32 train step of the SMOKE Mamba2 on the card (K4 twice a
    layer under remat, K8 once, nothing else) against the same step on
    the CPU (the plain versions): loss rtol 1e-5, grad norm and every
    master leaf's norm after the update rtol 1e-4."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as ST
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              dtype="float32")
    t = SyntheticLMData(cfg.vocab_size, 300, 2).batch(0)["tokens"]
    drawn = lm.init_masters(cfg, seed=0)   # one draw, on the CPU
    out = {}
    for dev in (cuda, torch.device("cpu")):
        masters = type(drawn)((n, p.detach().to(dev).requires_grad_(True))
                              for n, p in drawn.items())
        opt = make_optimizer(cfg, total_steps=2)
        state = opt.init(masters)
        ops.reset_launches()
        masters, _, m = ST.make_train_step(cfg, opt)(
            masters, state, 0, {"tokens": t[:, :-1].to(dev),
                                "labels": t[:, 1:].to(dev)})
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         {n: float(torch.linalg.vector_norm(
                             p.detach().double())) for n, p in
                          masters.items()}, ops.launch_counts())
    (lk, gk, nk, ck), (lc_, gc, nc, cc) = out["cuda"], out["cpu"]
    L = cfg.num_layers
    assert ck["ssd_scan"] == 2 * L and ck["ssd_scan_bwd"] == L
    assert not any(v for n, v in ck.items()
                   if n not in ("ssd_scan", "ssd_scan_bwd"))
    assert not any(cc.values())
    assert abs(lk - lc_) <= 1e-5 * abs(lc_)
    assert abs(gk - gc) <= 1e-4 * gc
    for n in nc:
        assert abs(nk[n] - nc[n]) <= 1e-4 * nc[n], n
