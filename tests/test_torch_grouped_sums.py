"""The event step's segment sums taken together, on the CPU.

`engine._views` writes the inputs of a step's independent segment sums
(the sender and receiver live counts, the ablation's total bytes, the
leaf-spine link counts, the live flows per coflow, the learned pilot
count and byte sum) into the rows of one (k B, F) buffer and sums them
with one `ops.prefix_sum` call (K6 on the card). Rows are independent,
so each sum must equal its own call on its own input bit for bit, under
every structure switch; and a step makes 2 calls (3 with ablations)
where it made one a sum.
"""
import pytest
import torch

from repro_torch.core.params import SchedulerParams
from repro_torch.fabric import engine
from repro_torch.fabric.topology import LeafSpine
from repro_torch.kernels import ops
from repro_torch.traces.batch import pack, to_device
from repro_torch.traces.synth import tiny_trace

PARAMS = SchedulerParams()
# (per_flow_wc, with_dynamics, with_ablations, wc_maxmin, with_sampling),
# leaf-spine batch
SWITCHES = {
    "defaults": ((True, True, False, False, False), False),
    "no_dynamics": ((True, False, False, False, False), False),
    "coflow_fill": ((False, True, False, False, False), False),
    "ablations": ((True, True, True, False, False), False),
    "sampling": ((True, False, False, False, True), False),
    "sampling_ablations": ((True, False, True, False, True), False),
    "leafspine": ((True, True, False, True, False), True),
    "leafspine_every_sum": ((True, True, True, True, True), True),
}
# the grouped buffer's row blocks, in the engine's order
ORDER = ("cnt_s", "cnt_r", "total", "cnt_up", "cnt_dn", "n_live_c", "n_p",
         "p_sum")


def _mid_run(features, leaf, steps=6):
    """A 3-lane batch of tiny traces and its state after `steps` event
    steps under `features`."""
    traces = [tiny_trace(24, 12, seed=s, load=0.8) for s in range(3)]
    topo = LeafSpine(4, 4.0, "maxmin") if leaf else None
    tb = to_device(pack(traces, port_bw=PARAMS.port_bw, topology=topo,
                        sampling=features[4]), "cpu")
    ep = engine.EngineParams.from_scheduler(PARAMS, device="cpu")
    ep = ep.lanes(tb.cid.shape[0])
    state = engine._init_state(tb)
    state = engine._run_chunk(state, tb, ep, chunk=steps, features=features)
    return tb, ep, state


def _per_sum_inputs(state, tb, live, features, leaf):
    """Each segment sum's own (B, F) input and boundaries, as one call
    each would take them."""
    _, dyn, abl, _, samp = features
    livef = live.to(torch.float32)
    sums = {"cnt_s": (livef.gather(1, tb.perm_src), tb.lo_src, tb.hi_src),
            "cnt_r": (livef.gather(1, tb.perm_dst), tb.lo_dst, tb.hi_dst)}
    if abl:
        sums["total"] = (state.sent * tb.flow_valid, tb.flow_lo,
                         tb.flow_hi)
    if leaf:
        sums["cnt_up"] = (livef.gather(1, tb.perm_up), tb.lo_up, tb.hi_up)
        sums["cnt_dn"] = (livef.gather(1, tb.perm_dn), tb.lo_dn, tb.hi_dn)
    if dyn or samp:
        sums["n_live_c"] = (livef, tb.flow_lo, tb.flow_hi)
    if samp:
        pdone = (tb.pilot & tb.flow_valid & state.done).to(torch.float32)
        sums["n_p"] = (pdone, tb.flow_lo, tb.flow_hi)
        sums["p_sum"] = (pdone * tb.size, tb.flow_lo, tb.flow_hi)
    return sums


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", sorted(SWITCHES))
def test_grouped_sums_equal_per_sum_calls_bitwise(case, monkeypatch):
    features, leaf = SWITCHES[case]
    tb, ep, state = _mid_run(features, leaf)
    calls = []
    real = ops.prefix_sum

    def spy(x, **kw):
        out = real(x, **kw)
        calls.append((x.clone(), out))
        return out

    monkeypatch.setattr(ops, "prefix_sum", spy)
    now = state.t0 + state.tick.to(torch.float32) * ep.delta
    batch, _, _, live, livef = engine._views(
        state, tb, now, 1e-3 * ep.delta, per_flow_wc=features[0],
        with_dynamics=features[1], with_ablations=features[2],
        with_sampling=features[4])
    monkeypatch.setattr(ops, "prefix_sum", real)
    want = _per_sum_inputs(state, tb, live, features, leaf)
    names = [n for n in ORDER if n in want]
    assert len(calls) == 1
    x, s = calls[0]
    B, F = live.shape
    assert x.shape == (len(names) * B, F)
    assert torch.equal(livef, live.to(torch.float32))
    got = {}
    for i, name in enumerate(names):
        data, lo, hi = want[name]
        rows = slice(i * B, (i + 1) * B)
        assert torch.equal(_bits(x[rows]), _bits(data)), name
        got[name] = engine._segments(s[rows], lo, hi)
        alone = engine._segment_sum(data, lo, hi)
        assert torch.equal(_bits(got[name]), _bits(alone)), name
    assert torch.equal(_bits(batch.cnt_s), _bits(got["cnt_s"]))
    assert torch.equal(_bits(batch.cnt_r), _bits(got["cnt_r"]))
    if features[2]:
        assert torch.equal(_bits(batch.total), _bits(got["total"]))
    if leaf:
        assert torch.equal(_bits(batch.cnt_x), _bits(
            torch.cat([got["cnt_up"], got["cnt_dn"]], dim=-1)))
    assert float(got["cnt_s"].sum()) > 0   # some flow is live mid-run


# calls of ops.prefix_sum one event step makes, and the segment sums
# those calls hold: the grouped call, the ablation's rate sum, the
# completions' undone count
@pytest.mark.parametrize("case,calls,sums", [
    ("defaults", 2, 4), ("no_dynamics", 2, 3), ("ablations", 3, 6),
    ("sampling", 2, 6), ("leafspine", 2, 6),
    ("leafspine_every_sum", 3, 10)])
def test_one_event_step_makes_two_calls_three_with_ablations(
        case, calls, sums, monkeypatch):
    features, leaf = SWITCHES[case]
    tb, ep, state = _mid_run(features, leaf, steps=2)
    B = tb.cid.shape[0]
    shapes = []
    real = ops.prefix_sum

    def spy(x, **kw):
        shapes.append(tuple(x.shape))
        return real(x, **kw)

    monkeypatch.setattr(ops, "prefix_sum", spy)
    engine._tick(state, tb, ep, **engine._switches(features))
    assert len(shapes) == calls
    assert sum(r for r, _ in shapes) == sums * B
    assert all(f == tb.cid.shape[1] for _, f in shapes)

