"""Sampling-based coflow size learning (non-clairvoyant mode).

The port's own copy of `repro.core.sampling`. Pilot-flow estimation in
the style of the sampling follow-up paper (arxiv 2108.11255): a small,
deterministic subset of each coflow's flows, the *pilots*, is observed,
and once pilots finish their exact sizes are known (bytes delivered ==
size). The mean finished-pilot size becomes the coflow's per-flow size
estimate, and the §4.3 re-queue runs off it instead of the clairvoyant
finished-flow median. Before the first pilot completes there is no
estimate, and the scheduler keeps the bytes-sent Eq. 1 placement.

The pilot layout rule, shared with `traces.batch.pack_row` (which bakes
it into the slab as a mask):

    K_c = min(width_c, max(1, ceil(pilot_frac * width_c)))
    pilots of coflow c = its first K_c flows in table/slab layout order

On the card the estimate is plain tensor code inside the tick
(`fabric.engine._views`); `SizeEstimator` is its host-side reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.params import SchedulerParams


def pilot_count(width: np.ndarray, pilot_frac: float) -> np.ndarray:
    """K_c per coflow: at least one pilot, at most every flow."""
    w = np.asarray(width, np.int64)
    k = np.ceil(pilot_frac * w).astype(np.int64)
    return np.minimum(np.maximum(k, 1), np.maximum(w, 1))


def pilot_mask(cid: np.ndarray, flow_lo: np.ndarray, width: np.ndarray,
               pilot_frac: float) -> np.ndarray:
    """Bool mask over the flow axis: the first K_c flows of each coflow
    (in layout order) are pilots. `flow_lo`/`width` are per-coflow."""
    cid = np.asarray(cid, np.int64)
    pos = np.arange(cid.size, dtype=np.int64) - np.asarray(flow_lo)[cid]
    return pos < pilot_count(width, pilot_frac)[cid]


class SizeEstimator:
    """Host-side size estimator (stateless recompute per call).

    `estimates(table)` returns per-coflow arrays
    ``(est_flow, est_total, learned)``:

    * ``learned[c]``: at least one pilot of c has finished;
    * ``est_flow[c]``: the mean finished pilot size when learned, else
      the max bytes sent by any flow of c so far;
    * ``est_total[c]``: ``est_flow * width`` when learned, else the total
      bytes sent so far.
    """

    def __init__(self, params: SchedulerParams):
        self.params = params

    def pilot_mask(self, table) -> np.ndarray:
        return pilot_mask(table.cid, table.flow_lo, table.width,
                          self.params.pilot_frac)

    def estimates(self, table):
        C = table.num_coflows
        pm = self.pilot_mask(table)
        pdone = pm & table.done
        n = np.bincount(table.cid[pdone], minlength=C).astype(np.float64)
        s = np.bincount(table.cid[pdone], weights=table.size[pdone],
                        minlength=C)
        learned = n > 0
        f_hat = s / np.maximum(n, 1.0)
        sent_max = np.zeros(C)
        np.maximum.at(sent_max, table.cid, table.sent)
        sent_tot = np.bincount(table.cid, weights=table.sent, minlength=C)
        est_flow = np.where(learned, f_hat, sent_max)
        est_total = np.where(learned, f_hat * np.maximum(table.width, 1),
                             sent_tot)
        return est_flow, est_total, learned


__all__ = ["pilot_count", "pilot_mask", "SizeEstimator"]
