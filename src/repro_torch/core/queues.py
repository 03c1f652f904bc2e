"""Priority-queue threshold logic (Aalo-style exponential queues).

The port's own copy of `repro.core.queues.CROSS_EPS` and `queue_of`
(the port imports nothing of `repro`). Saath (Eq. 1) compares
m_c * N_c against the queue's upper threshold Q_q^hi; the coordinator
tick applies the same rule on f32 tensors (`core.coordinator._queue_of`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.params import SchedulerParams

# Relative crossing tolerance: the event-driven replay lands a flow
# EXACTLY on its queue threshold (the crossing instant is an event), so
# an exact `value < Q_q^hi` comparison is a coin flip on the last float
# ulp. Counting a value within this relative band below the threshold as
# crossed makes the decision identical in f32 and f64; the transition
# moves <= 0.001% early.
CROSS_EPS = 1e-5


def queue_of(value: np.ndarray, params: SchedulerParams) -> np.ndarray:
    """Queue index for a 'progress' value against exponential thresholds:
    the smallest q with value < Q_q^hi, as a searchsorted over
    ``params.thresholds()`` (the rule `core.coordinator._queue_of` uses)."""
    th = np.asarray(params.thresholds(), dtype=np.float64)
    value = np.asarray(value, dtype=np.float64) * (1.0 + CROSS_EPS)
    q = np.searchsorted(th, value, side="right")
    return np.clip(q, 0, params.num_queues - 1).astype(np.int32)


__all__ = ["CROSS_EPS", "queue_of"]
