"""Runtime interleaving explorer: a race detector for the port's serving
plane (the port of `repro.analysis.explore`).

The static coherence checker (`repro_torch.analysis.coherence`) proves
the protocol is FOLLOWED; this module probes that the protocol is
SUFFICIENT: it fuzzes deterministic schedules of pool API calls --
admit / release (row recycling) / submit / fleet and per-session
advance / poll / snapshot -- and replays each schedule on the async
pool (the candidate: its advance parks the control download until the
next sync point) and on the oracle, every tenant run alone as a
standalone `SaathSession(backend="torch")` on the same device (the
port's pool has no blocking mode). A pooled session equals the same
session alone bit for bit (an established pool property), so ANY
divergence -- a completion seen earlier or later, a different CCT bit
pattern, a snapshot reading a stale mirror -- is a coherence race.

Observations are taken only at sync-point ops (poll / snapshot /
admit / release / submit returns); clocks and raw tick counters are
deliberately NOT observed, because the async fast path leaves them
stale between sync points by design. The sharded variants wait for the
port's sharded slab (ROADMAP queue A item 8).

Usage:
    python -m repro_torch.analysis.explore                 # CPU smoke
    python -m repro_torch.analysis.explore --schedules 20 --ops 60 --seed 7
    python -m repro_torch.analysis.explore --device cuda   # on the card
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.coflow import Coflow, Flow
from repro_torch.core.params import SchedulerParams

PORTS = 6
MAX_SESSIONS = 4
PARAMS = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                         growth=4.0, num_queues=5)
# fleet-advance quanta: coarse enough to finish small coflows in a
# handful of ops, misaligned enough to exercise partial-tick carry
_DTS = (0.3, 0.7, 1.1)
_DTS_ONE = (0.5, 0.9)


def _coflows(seed: int, n: int, base: int = 0,
             spread: float = 2.0) -> List[Coflow]:
    rng = np.random.default_rng(seed)
    cfs, fid = [], 0
    for c in range(n):
        w = int(rng.integers(1, 5))
        flows = [Flow(fid + i, int(rng.integers(0, PORTS)),
                      int(rng.integers(0, PORTS)),
                      float(rng.uniform(1.0, 15.0)))
                 for i in range(w)]
        fid += w
        cfs.append(Coflow(base + c, float(rng.uniform(0.0, spread)),
                          flows))
    return cfs


# ---- schedule generation -------------------------------------------------


def make_schedule(seed: int, n_ops: int,
                  max_sessions: int = MAX_SESSIONS) -> List[tuple]:
    """A deterministic, always-valid op schedule.  Validity (admission
    cap, live-session targets) depends only on this shadow roster, so
    the same schedule replays against every pool configuration."""
    rng = np.random.default_rng(seed)
    ops: List[tuple] = []
    live: List[int] = []
    next_sid = 0

    def admit():
        nonlocal next_sid
        ops.append(("admit", next_sid))
        live.append(next_sid)
        next_sid += 1

    admit()
    ops.append(("submit", live[0], 3, int(rng.integers(1 << 16)), 0))
    cbase = 100
    while len(ops) < n_ops:
        r = rng.random()
        if r < 0.12 and len(live) < max_sessions:
            admit()
        elif r < 0.18 and len(live) > 1:
            # release a mid-life row so the next admit recycles it
            ops.append(("release",
                        live.pop(int(rng.integers(len(live))))))
        elif r < 0.38:
            sid = live[int(rng.integers(len(live)))]
            ops.append(("submit", sid, int(rng.integers(1, 4)),
                        int(rng.integers(1 << 16)), cbase))
            cbase += 100
        elif r < 0.60:
            ops.append(("advance",
                        float(_DTS[int(rng.integers(len(_DTS)))])))
        elif r < 0.70:
            sid = live[int(rng.integers(len(live)))]
            ops.append(("advance_one", sid,
                        float(_DTS_ONE[int(rng.integers(2))])))
        elif r < 0.84:
            ops.append(("poll",))
        elif r < 0.93:
            ops.append(("poll_one",
                        live[int(rng.integers(len(live)))]))
        else:
            ops.append(("snapshot",
                        live[int(rng.integers(len(live)))]))
    return ops


# ---- schedule execution --------------------------------------------------


def _norm(x):
    """Hashable, exactly-comparable form of an observation value."""
    if isinstance(x, dict):
        return tuple(sorted((k, _norm(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, np.ndarray):
        return tuple(_norm(v) for v in x.tolist())
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, float) and x != x:
        return "nan"
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    return repr(x)


def _done(sid_of, pairs):
    return tuple(sorted((sid_of[id(s)], d.handle, _norm(d.cct),
                         _norm(d.fct)) for s, d in pairs))


class _Alone:
    """The oracle's fleet: each tenant a standalone session (its own
    one-row pool), driven through the pool's surface."""

    def __init__(self, device):
        from repro_torch.api import SaathSession

        self._make = lambda: SaathSession(PARAMS, num_ports=PORTS,
                                          device=device)
        self.sessions: list = []

    @property
    def num_sessions(self) -> int:
        return len(self.sessions)

    def session(self):
        s = self._make()
        self.sessions.append(s)
        return s

    def release(self, s) -> None:
        self.sessions.remove(s)
        s.close()

    def advance(self, dt: float) -> None:
        for s in self.sessions:
            s.advance(dt)

    def poll(self) -> list:
        return [(s, d) for s in self.sessions for d in s.poll()]


def run_schedule(ops: List[tuple], *, standalone: bool = False,
                 device="cpu", drain_steps: int = 400) -> List[tuple]:
    """Replay a schedule on a fresh async pool (or, `standalone`, on
    every tenant alone); return its observations."""
    from repro_torch.api import SessionPool
    pool = _Alone(device) if standalone else SessionPool(
        PARAMS, num_ports=PORTS, max_sessions=MAX_SESSIONS, device=device)
    sess: dict = {}
    sid_of: dict = {}
    obs: List[tuple] = []
    for i, op in enumerate(ops):
        kind = op[0]
        if kind == "admit":
            s = pool.session()
            sess[op[1]] = s
            sid_of[id(s)] = op[1]
            obs.append((i, "admit", op[1], pool.num_sessions))
        elif kind == "release":
            pool.release(sess.pop(op[1]))
            obs.append((i, "release", op[1], pool.num_sessions))
        elif kind == "submit":
            sid, n, cseed, base = op[1:]
            handles = sess[sid].submit(
                sorted(_coflows(cseed, n, base=base),
                       key=lambda c: (c.arrival, c.cid)))
            obs.append((i, "submit", sid, tuple(handles)))
        elif kind == "advance":
            pool.advance(op[1])
        elif kind == "advance_one":
            sess[op[1]].advance(op[2])
        elif kind == "poll":
            obs.append((i, "poll", _done(sid_of, pool.poll())))
        elif kind == "poll_one":
            done = sess[op[1]].poll()
            obs.append((i, "poll_one", op[1],
                        tuple(sorted((d.handle, _norm(d.cct),
                                      _norm(d.fct)) for d in done))))
        elif kind == "snapshot":
            obs.append((i, "snapshot", op[1],
                        _norm(sess[op[1]].snapshot())))
        else:
            raise ValueError(f"unknown op {op!r}")
    for step in range(drain_steps):
        if not any(s.num_live for s in sess.values()):
            break
        pool.advance(2.0)
        done = pool.poll()
        if done:
            obs.append(("drain", step, _done(sid_of, done)))
    else:
        raise RuntimeError(
            f"schedule failed to drain in {drain_steps} steps")
    obs.append(("final",
                tuple(sorted((sid, s.num_live)
                             for sid, s in sess.items()))))
    return obs


def first_divergence(oracle: List[tuple], got: List[tuple]
                     ) -> Optional[Tuple[int, object, object]]:
    for i, (a, b) in enumerate(zip(oracle, got)):
        if a != b:
            return (i, a, b)
    if len(oracle) != len(got):
        i = min(len(oracle), len(got))
        return (i, oracle[i] if i < len(oracle) else "<end>",
                got[i] if i < len(got) else "<end>")
    return None


# ---- the explorer --------------------------------------------------------


def explore(schedules: int = 3, n_ops: int = 24, seed: int = 0,
            out=sys.stdout, device="cpu") -> int:
    print(f"explore: {schedules} schedule(s) x {n_ops} ops on {device}, "
          f"oracle=(each tenant alone), candidate=(async pool)",
          file=out)
    failures = 0
    for k in range(schedules):
        ops = make_schedule(seed + k, n_ops)
        oracle = run_schedule(ops, standalone=True, device=device)
        got = run_schedule(ops, device=device)
        div = first_divergence(oracle, got)
        tag = f"schedule {seed + k} vs (async pool)"
        if div is None:
            print(f"explore: ok   {tag} -- "
                  f"{len(oracle)} observations match", file=out)
        else:
            failures += 1
            i, a, b = div
            print(f"explore: RACE {tag} at observation {i}:\n"
                  f"  oracle: {a}\n"
                  f"  got:    {b}", file=out)
    if failures:
        print(f"explore: {failures} divergence(s) from the standalone "
              f"oracle -- the coherence protocol is NOT sufficient "
              f"for this interleaving", file=out)
    else:
        print("explore: no divergences -- the async pool matches "
              "every tenant alone bitwise", file=out)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.explore",
        description="pool interleaving race detector of the port")
    ap.add_argument("--schedules", type=int, default=3)
    ap.add_argument("--ops", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu",
                    help="where the pools run (cuda: the card)")
    args = ap.parse_args(argv)
    return explore(args.schedules, args.ops, args.seed,
                   device=args.device)


if __name__ == "__main__":
    sys.exit(main())
