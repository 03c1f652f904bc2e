"""FB-like synthetic trace generator (the port's own copy of
`repro.traces.synth`: the same numpy RNG draws, so one seed gives the
same trace on both planes).

The public Facebook trace (coflow-benchmark) is not bundled; this module
re-synthesizes a trace matching the distributions the paper reports:

* Fig. 2(a): 23% of coflows have a single flow; the rest are map-reduce
  shuffles (M senders x R receivers, all-pairs flows) with heavy-tailed
  M, R.
* Fig. 2(b): of the multi-flow coflows, ~65% have equal-length flows
  (50/77 of all multi-flow coflows in the trace) and the rest have
  lognormal-skewed per-flow sizes.
* Table 1 bins: coflow total sizes are lognormal-heavy-tailed so that
  roughly half the coflows are <=100 MB and half the widths are <=10.
* 150 ports, 1 Gbps each, Poisson arrivals sized by a target load.

Deterministic given `seed`. `load` ~ offered bytes / fabric capacity.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.coflow import Coflow, Flow, Trace

MB = 1024.0 * 1024.0
GBPS = 1e9 / 8.0

_FLOW_FLOOR = 1024.0


def _floor_preserving_total(per: np.ndarray, total: float) -> np.ndarray:
    """Apply the 1 KB per-flow floor WITHOUT inflating the coflow total.

    Clamping after normalization (`np.maximum(per, 1024.0)`) silently
    adds bytes on skewed coflows and drifts the Table-1 size bins.
    Instead, flows at the floor are fixed and the remainder is
    renormalized into the leftover budget, iterating until no flow
    falls below the floor. When the floor is infeasible
    (total < w * 1KB) the bytes are split equally. Deterministic —
    pure arithmetic on `per`, no RNG draws."""
    per = np.asarray(per, float).copy()
    w = per.size
    if total <= _FLOW_FLOOR * w:
        return np.full(w, total / w)
    fixed = np.zeros(w, bool)
    for _ in range(w):
        budget = total - _FLOW_FLOOR * fixed.sum()
        free = ~fixed
        per[free] *= budget / per[free].sum()
        low = free & (per < _FLOW_FLOOR)
        if not low.any():
            break
        fixed |= low
        per[fixed] = _FLOW_FLOOR
    return per


def fb_like_trace(num_coflows: int = 526, num_ports: int = 150, *,
                  seed: int = 0, load: float = 0.9,
                  arrival_speedup: float = 1.0,
                  max_width: int = 2000,
                  frac_single: float = 0.23,
                  frac_equal_of_multi: float = 0.65) -> Trace:
    rng = np.random.default_rng(seed)
    coflows = []

    # ---- per-coflow structure -------------------------------------------
    kind = rng.uniform(size=num_coflows)
    sizes_total = np.exp(rng.normal(np.log(30 * MB), 2.3, num_coflows))
    sizes_total = np.clip(sizes_total, 64 * 1024, 4e12)

    # heavy-tailed sender/receiver counts (capped by ports)
    def _fanout(n):
        x = 1 + rng.pareto(1.1, n) * 2.0
        return np.minimum(np.ceil(x).astype(int), num_ports)

    M = _fanout(num_coflows)
    R = _fanout(num_coflows)

    # arrivals: Poisson with rate matching target load on the fabric
    mean_bytes = float(sizes_total.mean())
    lam = load * num_ports * GBPS / mean_bytes  # coflows / second
    gaps = rng.exponential(1.0 / lam, num_coflows) / arrival_speedup
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])

    fid = 0
    for c in range(num_coflows):
        arrival = float(arrivals[c])
        total = float(sizes_total[c])
        if kind[c] < frac_single:
            src, dst = rng.choice(num_ports, 2, replace=False)
            flows = [Flow(fid, int(src), int(dst), total)]
            fid += 1
        else:
            m, r = int(M[c]), int(R[c])
            while m * r > max_width:
                if m >= r:
                    m = max(1, m // 2)
                else:
                    r = max(1, r // 2)
            senders = rng.choice(num_ports, m, replace=False)
            receivers = rng.choice(num_ports, r, replace=False)
            w = m * r
            equal = rng.uniform() < frac_equal_of_multi
            if equal:
                per = np.full(w, total / w)
            else:
                skew = np.exp(rng.normal(0.0, 1.0, w))
                per = total * skew / skew.sum()
            per = _floor_preserving_total(per, total)
            flows = []
            i = 0
            for s in senders:
                for d in receivers:
                    flows.append(Flow(fid, int(s), int(d), float(per[i])))
                    fid += 1
                    i += 1
        coflows.append(Coflow(cid=c, arrival=arrival, flows=flows))

    tr = Trace(num_ports=num_ports, coflows=coflows)
    tr.validate()
    return tr


def tiny_trace(num_coflows: int = 40, num_ports: int = 20, *,
               seed: int = 0, **kw) -> Trace:
    """Small trace for tests (same generator, smaller fabric)."""
    kw.setdefault("max_width", 64)
    return fb_like_trace(num_coflows, num_ports, seed=seed, **kw)
