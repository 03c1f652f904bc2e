#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — `repro_torch.api.run` replaying a fleet
of 16 FB-like traces (526 coflows, 150 ports each, the paper's
full-width trace) through the Saath coordinator tick — on the card, and
holds each hand-written CUDA kernel of that path against its plain
PyTorch version on the same inputs:

1. the card's name and power limit; build both kernels with nvcc
   (`src/repro_torch/kernels/csrc/`, sm_90a) and print nvcc's register
   and shared-memory report and the build time;
2. K1 (LCoF contention) against its plain version, exact, at Table 2's
   shapes (B=1, C=2048 and 4096, P=512), f32 and bf16;
3. one chunk of 128 event steps under `torch.cuda.set_sync_debug_mode(
   "error")`: the tick loop makes no host synchronization;
4. the main path: the 16-trace fleet through `run(Scenario(...))`, with
   both kernels' launch counters set to 0 just before and read just
   after (each must equal the event steps); per-lane avg CCT, events,
   ticks, wall seconds and peak device memory; every real coflow
   finished, every byte delivered. Tick inputs are captured on the way
   (a spy on `tick_core` that clones its arguments);
5. whole-path parity: lanes 0 and 1 within 1% of the JAX package's avg
   CCT on the same traces (`tests/data/torch_port_fb_golden.json`);
6. on the heaviest captured ticks, the whole tick with both kernels
   against the tick with both plain versions (order, queue, contention,
   expiry and admission exact; rates to rtol 1e-6), and each kernel's
   time at the main path's shapes beside its plain version, the bound
   and (K1) one PyTorch call computing the same function.

Prints a `{"kernels": [...]}` line, the nvidia-smi line, and as the last
line `{"ok": true, "device": {...}}`. Any failed phase exits non-zero
before the result lines. Exits non-zero without a CUDA device.

`python3 chip_smoke.py --profile` adds one profiled chunk of the main
path (`profile_chunk`): wall time per event step, device busy share,
kernel launches per step and the kernels with the most device time.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_fb_golden.json"
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # non-tensor f32; used for 32-bit word ops too
FLEET = 16
COFLOWS, PORTS = 526, 150
CAPTURE_EVERY = 64


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean device milliseconds of `fn` over `reps` back-to-back calls
    (CUDA events, after warm-up)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn):
    """Milliseconds of one synchronized call (for the slow plain walk)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def contention_library(a_s, a_r, active):
    """One bf16 tensor-core product form of the contention count (the
    yardstick `library_ms`; the port never calls it)."""
    import torch

    act = active.to(torch.bfloat16).unsqueeze(-1)
    s, r = a_s * act, a_r * act
    blocks = (s @ s.mT + r @ r.mT) > 0.5
    k = blocks.sum(-1) - torch.diagonal(blocks, dim1=-2, dim2=-1).long()
    return torch.where(active, k, 0)


def contention_bound_ms(B, C, P, elt):
    W2 = 2 * ((P + 31) // 32)
    nbytes = 2 * B * C * P * elt + B * C + 4 * B * C
    ops = 2 * B * C * C * W2          # an AND and an OR per word pair
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def walk_bound_ms(args, out):
    """Bytes and operations this tick's data needs: the n_live rows of
    cnt, the missed coflows' flows, the outputs."""
    import torch

    order, n_live, cnt, avail0, _, _, flows = args
    B, C, P2 = cnt.shape
    rate, admitted, _, wc_flow = out
    nl = int(n_live.sum())
    lead = torch.arange(C, device=cnt.device)[None] < n_live[:, None]
    missed = torch.zeros_like(admitted).scatter_(1, order, lead) & ~admitted
    nf = int(((flows.flow_hi - flows.flow_lo) * missed).sum())
    nbytes = (nl * (8 + 4 * P2) + B * (8 + 8 * P2 + 8)
              + int(missed.sum()) * 16 + nf * 17
              + B * C * 9 + wc_flow.numel() * 4)
    ops = nl * P2 * 5 + nf * 4
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def profile_chunk(fleet, params, feats, warm_chunks=8):
    """(`--profile` only) Where one chunk of the main path's time goes:
    replay `warm_chunks` chunks unprofiled, then one chunk of 128 event
    steps under torch.profiler. Prints the wall time per event step, the
    device's busy share (summed kernel time over wall time; one stream,
    so kernels do not overlap), kernel launches per step and the
    kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fabric import engine as eng
    from repro_torch.traces.batch import pack, to_device

    dev = torch.device("cuda")
    tb = to_device(pack(fleet, port_bw=params.port_bw), dev)
    ep = eng.EngineParams.from_scheduler(params, device=dev).lanes(len(fleet))
    state = eng._init_state(tb)
    for _ in range(warm_chunks):
        state = eng._run_chunk(state, tb, ep, chunk=128, features=feats)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = eng._run_chunk(state, tb, ep, chunk=128, features=feats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    print(f"[p] chunk of 128 event steps after {warm_chunks * 128}: wall "
          f"{1e3 * wall / 128:.3f} ms per step (profiled)")
    if not rows:
        print("[p] device time: not measured (the profiler saw no CUDA "
              "kernels)")
        return
    print(f"[p] device busy {busy_us / 1e3 / 128:.3f} ms per step, share "
          f"{busy_us / 1e6 / wall:.3f}; {launches / 128:.1f} kernel "
          f"launches per step")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[p]   {e.self_device_time_total / 128:9.1f} us/step "
              f"{e.count / 128:6.1f} x  {e.key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import Scenario, run
    from repro_torch.core import coordinator as co
    from repro_torch.fabric import engine as eng
    from repro_torch.kernels import build, ops
    from repro_torch.traces.batch import pack, to_device
    from repro_torch.traces.synth import fb_like_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    print(f"card: {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all(ptxas_info=True)
    print(f"[1] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    # ---- 2. K1 at Table 2's shapes -------------------------------------
    g = torch.Generator(device="cpu").manual_seed(0)
    for C in (2048, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            a_s = (torch.rand(1, C, 512, generator=g) < 0.05).to(dtype).to(dev)
            a_r = (torch.rand(1, C, 512, generator=g) < 0.05).to(dtype).to(dev)
            act = (torch.rand(1, C, generator=g) < 0.7).to(dev)
            got = ops.contention(a_s, a_r, act)
            want = ops.contention(a_s, a_r, act, force="ref")
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K1 disagrees with its plain version at (1, {C}, 512)"
                     f" {dtype}")
            ms = cuda_ms(lambda: ops.contention(a_s, a_r, act), 20)
            plain = cuda_ms(lambda: ops.contention(a_s, a_r, act,
                                                   force="ref"), 5)
            lib = cuda_ms(lambda: contention_library(
                a_s.bfloat16(), a_r.bfloat16(), act), 5)
            bound, by = contention_bound_ms(1, C, 512, a_s.element_size())
            print(f"[2] K1 (1, {C}, 512) {str(dtype)[6:]}: exact; kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, bf16 matmul "
                  f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")

    # ---- 3. no host sync inside a chunk --------------------------------
    params = Scenario().params
    fleet = tuple(fb_like_trace(COFLOWS, PORTS, seed=s)
                  for s in range(FLEET))
    tb = to_device(pack(fleet, port_bw=params.port_bw), dev)
    feats = eng.features_for(params)
    ep = eng.EngineParams.from_scheduler(params, device=dev).lanes(FLEET)
    state = eng._init_state(tb)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = eng._run_chunk(state, tb, ep, chunk=128, features=feats)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("[3] 128 event steps of the fleet ran under "
          "set_sync_debug_mode('error'): no host sync in the tick loop")
    del state, tb

    # ---- 4. the main path ----------------------------------------------
    captured, calls = [], [0]
    real_tick_core = co.tick_core

    def spy(state, batch, now, dp, **kw):
        if calls[0] % CAPTURE_EVERY == CAPTURE_EVERY // 2:
            clone = (lambda t: None if t is None else
                     type(t)(*(None if x is None else x.clone()
                               for x in t)))
            captured.append((clone(state), clone(batch), now.clone(),
                             clone(dp), clone(kw.get("flows"))))
        calls[0] += 1
        return real_tick_core(state, batch, now, dp, **kw)

    sc = Scenario(engine="torch", traces=fleet)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.tick_core = spy
    ops.reset_launches()
    try:
        res = run(sc)
    finally:
        counts = ops.launch_counts()
        co.tick_core = real_tick_core
    peak = torch.cuda.max_memory_allocated()
    print(f"[4] fleet of {FLEET} x fb_like_trace({COFLOWS}, {PORTS}): "
          f"events {res.events}, ticks {res.ticks}, wall "
          f"{res.wall_seconds:.3f} s, peak device memory "
          f"{peak / 2**20:.1f} MiB, launches {counts}")
    print("    avg CCT per lane: " + " ".join(f"{x:.6f}"
                                               for x in res.avg_cct))
    for name, n in counts.items():
        if n != res.events:
            fail(f"{name} launched {n} times for {res.events} event steps")
    for b, tr in enumerate(fleet):
        cct = res.row_cct(b)
        if cct.shape != (len(tr.coflows),) or not (cct > 0).all():
            fail(f"lane {b}: unfinished or non-positive CCTs")
        t = res.table(b)
        if abs(t.sent.sum() - t.size.sum()) > 1e-5 * t.size.sum():
            fail(f"lane {b}: bytes delivered differ from the trace's")

    # ---- 5. whole-path parity with the JAX package ---------------------
    gold = json.loads(GOLDEN.read_text())
    for b, want in zip(gold["seeds"], gold["avg_cct"]):
        dev_rel = abs(res.avg_cct[b] - want) / want
        print(f"[5] lane {b}: avg CCT {res.avg_cct[b]:.6f} vs JAX "
              f"{want:.6f} (relative deviation {dev_rel:.3e})")
        if dev_rel > 1e-2:
            fail(f"lane {b} avg CCT deviates {dev_rel:.3%} from the JAX "
                 f"package")

    # ---- 6. kernels vs plain versions on captured ticks ----------------
    def work(c):
        return int(c[1].active.sum())

    heavy = sorted(captured, key=work)[-3:]
    grabbed = {}
    real_ops = ops.contention, ops.tick_walk

    def grab(name, fn):
        def f(*a, **k):
            if k.get("force") is None:
                grabbed[name] = (a, k)
            return fn(*a, **k)
        return f

    err = {"contention": 0.0, "tick_walk": 0.0}
    for i, (st, batch, now, dp, flows) in enumerate(heavy):
        ops.contention = grab("contention", real_ops[0])
        ops.tick_walk = grab("tick_walk", real_ops[1])
        try:
            ns_k, got = co.tick_core(st, batch, now, dp, flows=flows)
        finally:
            ops.contention, ops.tick_walk = real_ops
        ns_p, want = co.tick_core(st, batch, now, dp, flows=flows,
                                  force="ref")
        torch.cuda.synchronize()
        for k in ("order", "queue", "contention", "expired", "admitted"):
            if not torch.equal(got[k], want[k]):
                fail(f"captured tick {i}: {k} differs between kernels and "
                     f"plain versions")
        for k in ("rate", "wc_rate", "wc_flow"):
            a, b = got[k], want[k]
            if not torch.allclose(a, b, rtol=1e-6, atol=0):
                fail(f"captured tick {i}: {k} differs beyond rtol 1e-6")
            err["tick_walk"] = max(err["tick_walk"],
                                   float((a - b).abs().max()))
        err["contention"] = max(err["contention"], float(
            (got["contention"] - want["contention"]).abs().max()))
        print(f"[6] captured tick {i} ({work((st, batch))} active coflows "
              f"in {FLEET} lanes): kernels == plain versions (max abs "
              f"rate diff {err['tick_walk']:.3g})")

    (ca, ck) = grabbed["contention"]
    (wa, wk) = grabbed["tick_walk"]
    B, C, P = ca[0].shape
    k1_ms = cuda_ms(lambda: ops.contention(*ca), 50)
    k1_plain = cuda_ms(lambda: ops.contention(*ca, force="ref"), 10)
    k1_lib = cuda_ms(lambda: contention_library(
        ca[0].bfloat16(), ca[1].bfloat16(), ca[2]), 10)
    k1_bound, k1_by = contention_bound_ms(B, C, P, ca[0].element_size())
    walk_out = ops.tick_walk(*wa)
    k2_ms = cuda_ms(lambda: ops.tick_walk(*wa), 20)
    k2_plain = host_ms(lambda: ops.tick_walk(*wa, force="ref"))
    k2_bound, k2_by = walk_bound_ms(wa, walk_out)
    print(f"[6] K1 at ({B}, {C}, {P}): kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain:.4f} ms, bf16 matmul {k1_lib:.4f} ms, bound "
          f"{k1_bound:.5f} ms ({k1_by})")
    print(f"[6] K2 at ({B}, {C}, {2 * P}), n_live "
          f"{int(wa[1].sum())}: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain:.1f} ms, bound {k2_bound:.5f} ms ({k2_by})")

    kernels = [
        {"name": "contention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/contention.cu",
         "replaces": "src/repro/kernels/contention.py:51",
         "launches": counts["contention"], "max_abs_err":
         err["contention"], "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib},
        {"name": "tick_walk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/walk.cu",
         "replaces": "src/repro/core/jax_coordinator.py:311",
         "launches": counts["tick_walk"], "max_abs_err": err["tick_walk"],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    if "--profile" in sys.argv[1:]:
        profile_chunk(fleet, params, feats)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
