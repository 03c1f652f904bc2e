"""UC-TCP: uncoordinated per-flow TCP fair sharing (§6.1) — every live
flow gets its bipartite max-min fair share; no queues, no coordination.
The port's own copy of `repro.core.policies.uctcp`: the f64 host
water-fill, as in the reference, which runs no kernel here either."""
from __future__ import annotations

import numpy as np

from repro_torch.core.policies.base import Policy, maxmin_waterfill
from repro_torch.fabric.state import FlowTable


class UCTCP(Policy):
    name = "uc-tcp"

    def schedule(self, table: FlowTable, now: float) -> np.ndarray:
        live = table.flow_live()
        if not live.any():
            return np.zeros(table.size.shape[0])
        return maxmin_waterfill(table, live,
                                extra=self.fabric_binding(table))
