"""`repro_torch.api` — the port's scheduling front door::

    from repro_torch.api import Scenario, run
    res = run(Scenario(traces=fleet))            # on the CUDA card
    res = run(Scenario(traces=fleet, device="cpu"))
    res.avg_cct, res.makespan, res.table(0)

Online sessions and multi-tenant fleets (one slab, one batched advance)::

    from repro_torch.api import SaathSession, SessionPool
    sess = SaathSession(params, num_ports=24)    # device="cpu" off-card
    sess.submit(coflows); sess.advance(0.5); done = sess.poll()
    pool = SessionPool(params, num_ports=24, max_sessions=16)
    tenants = [pool.session() for _ in range(16)]
    pool.advance(0.5); done = pool.poll()
"""
from repro_torch.api.pool import PoolFullError, SessionPool
from repro_torch.api.scenario import (MECHANISM_KEYS, Result, Scenario,
                                      check_mechanisms, resolve_traces,
                                      result_from_completions, run)
from repro_torch.api.session import CompletedCoflow, SaathSession

__all__ = ["Scenario", "Result", "run", "resolve_traces",
           "result_from_completions", "MECHANISM_KEYS", "check_mechanisms",
           "SaathSession", "CompletedCoflow", "SessionPool",
           "PoolFullError"]
