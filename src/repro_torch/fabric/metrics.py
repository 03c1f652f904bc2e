"""Evaluation metrics (the port's copy of the two helpers of
`repro.fabric.metrics` that the fleet replay's results use).

CCT durations are measured from the coflow's arrival (the paper's CCT
definition: first flow arrives -> last flow completes).
"""
from __future__ import annotations

import numpy as np


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


__all__ = ["nan_row_mean", "percentile_speedup"]
