"""Evaluation metrics used by the paper's figures (the port's own copy
of `repro.fabric.metrics`: numpy over the port's `FlowTable`, the same
outputs on the same tables).

CCT durations are measured from the coflow's arrival (the paper's CCT
definition: first flow arrives -> last flow completes).
"""
from __future__ import annotations

import dataclasses

import numpy as np

MB = 1024.0 * 1024.0


def nan_row_mean(x: np.ndarray) -> np.ndarray:
    """Row-wise mean over finite entries of a (B, N) array; NaN
    (silently — no all-NaN RuntimeWarning) for rows with none.

    The one definition of "nothing completed" shared by
    `repro_torch.api.Result.avg_cct` and `EngineResult.avg_cct`.
    """
    x = np.asarray(x, float)
    fin = np.isfinite(x)
    cnt = fin.sum(axis=1)
    tot = np.where(fin, x, 0.0).sum(axis=1)
    return np.where(cnt > 0, tot / np.maximum(cnt, 1), np.nan)


def percentile_speedup(cct_base: np.ndarray, cct_new: np.ndarray,
                       qs=(10, 50, 90)) -> dict:
    """Per-coflow speedup = CCT_base / CCT_new (Fig. 9's metric).

    When no coflow completed in both runs (empty `ok` mask — overload
    sweeps hit this on hard points) every statistic is NaN with n=0,
    mirroring the `nan_row_mean` "silently NaN" contract above.
    """
    cct_base = np.asarray(cct_base, float)
    cct_new = np.asarray(cct_new, float)
    ok = np.isfinite(cct_base) & np.isfinite(cct_new) & (cct_new > 0)
    if not ok.any():
        out = {f"p{q}": float("nan") for q in qs}
        out["mean"] = float("nan")
        out["overall"] = float("nan")
        out["n"] = 0
        return out
    s = cct_base[ok] / cct_new[ok]
    out = {f"p{q}": float(np.percentile(s, q)) for q in qs}
    out["mean"] = float(s.mean())
    out["overall"] = float(np.mean(cct_base[ok]) / np.mean(cct_new[ok]))
    out["n"] = int(ok.sum())
    return out


def fct_normalized_std(table) -> dict:
    """Fig. 2(c)/13: per-coflow std of flow completion *durations*
    normalized by their mean, split by equal/unequal flow lengths.
    Single-flow coflows are excluded (as in the paper). `table` is a
    `fabric.state.FlowTable` (e.g. `Result.table(b)`)."""
    eq, uneq = [], []
    for c in range(table.num_coflows):
        lo, hi = table.flow_lo[c], table.flow_hi[c]
        if hi - lo < 2 or not table.finished[c]:
            continue
        d = table.fct[lo:hi] - table.arrival[c]
        v = float(d.std() / max(d.mean(), 1e-12))
        sizes = table.size[lo:hi]
        (eq if sizes.std() <= 1e-9 * max(sizes.mean(), 1.0) else
         uneq).append(v)
    return {"equal": np.asarray(eq), "unequal": np.asarray(uneq)}


def width_size_bins(table) -> np.ndarray:
    """Table 1 bins: 1 = small/thin, 2 = small/wide, 3 = large/thin,
    4 = large/wide. width<=10, size<=100MB are 'thin'/'small'."""
    total = np.zeros(table.num_coflows)
    np.add.at(total, table.cid, table.size)
    thin = table.width <= 10
    small = total <= 100 * MB
    return np.where(small & thin, 1,
                    np.where(small & ~thin, 2, np.where(thin, 3, 4)))


def bin_speedups(table_base, table_new, qs=(50,)) -> dict:
    """Fig. 11/12: median speedup per Table-1 bin + bin fractions."""
    bins = width_size_bins(table_base)
    out = {}
    for b in (1, 2, 3, 4):
        sel = bins == b
        if sel.sum() == 0:
            out[f"bin{b}"] = {"frac": 0.0}
            continue
        d = percentile_speedup(table_base.cct[sel], table_new.cct[sel], qs)
        d["frac"] = float(sel.mean())
        out[f"bin{b}"] = d
    return out


@dataclasses.dataclass
class RunSummary:
    policy: str
    avg_cct: float
    p50_cct: float
    p90_cct: float
    makespan: float
    steps: int
    sched_seconds: float

    @staticmethod
    def from_result(policy: str, res, b: int = 0) -> "RunSummary":
        """Row `b` of a `repro_torch.api.Result`: its CCTs, makespan and
        the run's coordinator calls. The batched engine does not time
        the policy apart from the simulation, so `sched_seconds` is the
        replay's wall. An all-NaN CCT row (nothing completed) summarizes
        to NaN silently."""
        cct = np.asarray(res.row_cct(b), float)
        fin = cct[np.isfinite(cct)]
        return RunSummary(
            policy=policy,
            avg_cct=float(nan_row_mean(cct[None, :])[0]),
            p50_cct=float(np.percentile(fin, 50)) if fin.size
            else float("nan"),
            p90_cct=float(np.percentile(fin, 90)) if fin.size
            else float("nan"),
            makespan=float(res.makespan[b]),
            steps=res.steps,
            sched_seconds=res.wall_seconds,
        )


__all__ = ["MB", "RunSummary", "bin_speedups", "fct_normalized_std",
           "nan_row_mean", "percentile_speedup", "width_size_bins"]
