"""`repro_torch.api` — the port's scheduling front door::

    from repro_torch.api import Scenario, run
    res = run(Scenario(traces=fleet))            # on the CUDA card
    res = run(Scenario(traces=fleet, device="cpu"))
    res.avg_cct, res.makespan, res.table(0)
"""
from repro_torch.api.scenario import (MECHANISM_KEYS, Result, Scenario,
                                      check_mechanisms, resolve_traces,
                                      result_from_completions, run)

__all__ = ["Scenario", "Result", "run", "resolve_traces",
           "result_from_completions", "MECHANISM_KEYS", "check_mechanisms"]
