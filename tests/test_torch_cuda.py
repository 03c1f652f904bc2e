"""The port's CUDA kernels (K1 contention, K2 tick walk, K3 max-min fill,
K4 SSD scan, K5 attention) against their plain PyTorch versions, on the
card, a 2-layer full-width Mamba2 serve with K4 against the plain path,
and a 2-layer full-width StarCoder2 serve through K5 against the JAX
package's golden. Every
test marked `gpu` needs a CUDA device and skips without one; run them
on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

This file imports no JAX (the card tests need only torch). It also
holds `random_tick_inputs`, the seeded coordinator-tick inputs that
`tests/test_torch_coordinator.py` feeds to both packages.
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
