"""Smoke of the port's scheduling front door (the counterpart of
`benchmarks/api_smoke.py`).

One tiny Scenario on both of the port's engines. The batched engine
(`engine="torch"`) is held to the JAX package's avg CCT and per-coflow
CCTs on the same trace (stored in
`tests/data/torch_port_api_smoke_golden.json`, regenerated by the slow
test `tests/test_torch_drivers.py -k api_smoke_golden`) at rtol 1e-5
(the port-vs-JAX engine bar of `tests/test_torch_engine.py`), and to the
port's numpy engine (the host reference, its contention count on the
same device) within the reference's 1% engine-equivalence contract
(per-coflow rtol 1e-2 plus 2δ, avg CCT within 1%), as
`benchmarks/api_smoke.py` holds its two engines. Then a 3-step
`SaathSession` (submit / advance / poll) whose per-coflow CCTs must
equal the port's offline replay bit for bit (the online = offline
contract).

    PYTHONPATH=src python -m benchmarks.torch_api_smoke          # card
    PYTHONPATH=src python -m benchmarks.torch_api_smoke --device cpu
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from benchmarks.torch_common import cli_parser, device_name
from repro_torch.api import Scenario, SaathSession, run
from repro_torch.core.params import SchedulerParams
from repro_torch.traces import tiny_trace

GOLDEN = Path(__file__).resolve().parents[1] / "tests" / "data" / \
    "torch_port_api_smoke_golden.json"
# tiny_trace(N, PORTS, seed=SEED, load=LOAD): the reference smoke's trace
N, PORTS, SEED, LOAD = 24, 12, 3, 0.8
RTOL = 1e-5


def smoke_trace():
    return tiny_trace(N, PORTS, seed=SEED, load=LOAD)


def main(argv=None) -> dict:
    args = cli_parser(description=__doc__.splitlines()[0]).parse_args(argv)
    t0 = time.time()
    p = SchedulerParams()
    trace = smoke_trace()
    gold = json.loads(GOLDEN.read_text())

    res = run(Scenario(policy="saath", trace=trace, params=p,
                       device=args.device, label="api-smoke"))
    where = device_name(args.device)
    print(f"# torch on {where}: avg_cct={res.avg_cct[0]:.6f}s (JAX "
          f"{gold['avg_cct']:.6f}s) makespan={res.makespan[0]:.3f}s "
          f"steps={res.steps} wall={res.wall_seconds:.2f}s",
          file=sys.stderr)
    want = np.asarray(gold["cct"], float)
    got = res.row_cct()
    dev = float(np.max(np.abs(got - want) / want))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert abs(res.avg_cct[0] / gold["avg_cct"] - 1.0) <= RTOL, \
        (res.avg_cct[0], gold["avg_cct"])

    # the host reference on the same trace: the 1% engine contract
    rn = run(Scenario(policy="saath", engine="numpy", trace=trace, params=p,
                      device=args.device, label="api-smoke"))
    print(f"# numpy on {where}: avg_cct={rn.avg_cct[0]:.6f}s "
          f"makespan={rn.makespan[0]:.3f}s steps={rn.steps} "
          f"wall={rn.wall_seconds:.2f}s", file=sys.stderr)
    np.testing.assert_allclose(got, rn.row_cct(), rtol=1e-2,
                               atol=2 * p.delta)
    engine_ratio = float(res.avg_cct[0] / rn.avg_cct[0])
    assert abs(engine_ratio - 1.0) < 1e-2, engine_ratio

    # 3-step online session: submit the trace incrementally
    sess = SaathSession(p, num_ports=PORTS, device=args.device)
    ordered = sorted(trace.coflows, key=lambda c: c.arrival)
    cut1, cut2 = len(ordered) // 3, 2 * len(ordered) // 3
    ccts = {}
    for step, group in enumerate((ordered[:cut1], ordered[cut1:cut2],
                                  ordered[cut2:])):
        last = max(c.arrival for c in group)
        for c in group:
            sess.advance(max(c.arrival - sess.now, 0.0))
            sess.submit([c])
        sess.advance(max(last - sess.now, 0.0))
        done = sess.poll()
        print(f"# session step {step}: t={sess.now:.3f}s "
              f"live={sess.num_live} completed={len(done)}",
              file=sys.stderr)
        ccts.update({d.handle: d.cct for d in done})
    ccts.update({d.handle: d.cct for d in sess.drain(step=5.0)})
    online = np.array([ccts[h] for h in sorted(ccts)])
    offline = got[[c.cid for c in ordered]]
    np.testing.assert_array_equal(online, offline)
    print(f"# torch api smoke OK on {where} in {time.time() - t0:.1f}s "
          f"(max rel deviation from the JAX package {dev:.2e}; torch / "
          f"numpy engine avg CCT {engine_ratio:.6f}; the session "
          f"reproduced the offline CCTs bit for bit)", file=sys.stderr)
    return {"avg_cct": float(res.avg_cct[0]), "max_rel_dev": dev,
            "numpy_avg_cct": float(rn.avg_cct[0]),
            "engine_ratio": engine_ratio, "device": where}


if __name__ == "__main__":
    main()
