"""Scheduler parameters (paper §6 defaults).

The port's own copy of `repro.core.params`: the port imports nothing of
`repro`, and the same fields give the same thresholds on both planes.
"""
from __future__ import annotations

import dataclasses

MB = 1024.0 * 1024.0
GBPS = 1e9 / 8.0  # bytes/sec for a 1 Gbps port (paper's testbed NIC)


@dataclasses.dataclass(frozen=True)
class SchedulerParams:
    """Knobs from the paper (§6 'default parameters')."""

    num_queues: int = 10          # K
    start_threshold: float = 10 * MB  # S = Q_0^hi, bytes
    growth: float = 10.0          # E, exponential threshold factor
    delta: float = 8e-3           # δ, coordinator sync interval (seconds)
    deadline_factor: float = 2.0  # d, starvation deadline multiplier
    port_bw: float = GBPS         # B_p, bytes/sec per port (uniform default)
    min_rate_frac: float = 1e-3   # all-or-none admission floor (fraction of B)
    # D4 work conservation (per-flow greedy fill of leftover bandwidth)
    work_conservation: bool = True
    # §4.3 cluster-dynamics handling (SRTF re-queue from finished-flow median)
    dynamics_requeue: bool = True
    # Beyond-paper option: a second work-conservation round that raises the
    # equal rate of already-admitted coflows when all their ports have slack.
    wc_admitted_round: bool = False
    # Non-clairvoyant mode (arxiv 2108.11255): when False, exact flow
    # sizes are hidden from the scheduler; the §4.3 re-queue runs off a
    # pilot-flow size estimate instead of the finished-flow median, and
    # queue placement falls back to bytes-sent-so-far before the first
    # pilot completes.
    clairvoyant: bool = True
    # Fraction of a coflow's flows tagged as pilots (at least one).
    pilot_frac: float = 0.1

    def thresholds(self) -> list:
        """[Q_0^hi .. Q_{K-1}^hi]; Q_{K-1}^hi is +inf."""
        out = []
        t = self.start_threshold
        for q in range(self.num_queues):
            out.append(float("inf") if q == self.num_queues - 1 else t)
            t *= self.growth
        return out

    def with_mechanisms(self, mechanisms: "dict | None"
                        ) -> "SchedulerParams":
        """A copy with the mechanism switches that live ON the params
        (work_conservation / dynamics_requeue) overridden from a shared
        `repro_torch.api.MECHANISM_KEYS`-style dict; lcof /
        per_flow_threshold are engine/policy arguments, not params
        fields, and are ignored here."""
        mech = dict(mechanisms or {})
        out = self
        if "dynamics_requeue" in mech:
            out = dataclasses.replace(
                out, dynamics_requeue=mech["dynamics_requeue"])
        if "work_conservation" in mech:
            out = dataclasses.replace(
                out, work_conservation=mech["work_conservation"])
        if "clairvoyant" in mech:
            out = dataclasses.replace(out, clairvoyant=mech["clairvoyant"])
        return out

    @property
    def min_rate(self) -> float:
        return self.port_bw * self.min_rate_frac
