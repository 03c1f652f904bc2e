"""Priority-queue threshold logic (Aalo-style exponential queues).

The port's own copy of `repro.core.queues` (the port imports nothing of
`repro`). Aalo assigns a coflow to queue q when its TOTAL bytes sent
lies in [Q_{q-1}^hi, Q_q^hi); Saath (Eq. 1) compares m_c * N_c, the
max bytes sent by any one flow times the flow count, against Q_q^hi.
The coordinator tick applies the same rule on f32 tensors
(`core.coordinator._queue_of`); the host policies (`core.policies`)
call these in f64.
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


def aalo_queue(total_sent: np.ndarray, params: SchedulerParams) -> np.ndarray:
    """Aalo: queue from TOTAL bytes sent by the coflow."""
    return queue_of(total_sent, params)


def saath_queue(max_flow_sent: np.ndarray, width: np.ndarray,
                params: SchedulerParams) -> np.ndarray:
    """Saath Eq. 1: per-flow thresholds — compare m_c against Q_q^hi/N_c,
    i.e. m_c * N_c against Q_q^hi."""
    return queue_of(np.asarray(max_flow_sent) * np.asarray(width), params)


def min_queue_residence(queue: np.ndarray, width: np.ndarray,
                        params: SchedulerParams) -> np.ndarray:
    """t in the deadline formula d*C_q*t (§4.2 D5): the minimum time a
    coflow must spend in queue q — the per-flow span of the queue sent at
    full port rate."""
    th = params.thresholds()
    lo = np.array([0.0] + th[:-1])
    hi = np.array(th)
    # last queue is unbounded; use one growth step beyond its lower bound
    hi[-1] = lo[-1] * params.growth if len(th) > 1 else params.start_threshold
    span = (hi - lo)[queue]
    return span / (np.maximum(width, 1) * params.port_bw)


__all__ = ["CROSS_EPS", "queue_of", "aalo_queue", "saath_queue",
           "min_queue_residence"]
