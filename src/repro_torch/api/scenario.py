"""The scheduling front door of the port: `Scenario` -> `run` -> `Result`.

The port of `repro.api.scenario`, with two engines:

* ``engine="torch"`` (the default): the batched fleet replay — `run`
  replays the scenario's traces (or one trace under a sweep of
  settings) through `fabric.engine` on the card;
* ``engine="numpy"``: the event-driven host simulator
  (`fabric.simulator.Simulator`) under any registry policy
  (`core.policies`: Saath, the Aalo, FIFO, SCF, SRTF, LWTF, Varys-SEBF
  and UC-TCP baselines, and `saath-torch`), one trace (or one sweep
  setting) at a time, its bookkeeping in host f64 and its kernel work
  (the contention count, `saath-torch`'s tick) on the card.

``device`` picks where the kernels run on either engine: None = CUDA
(raises without a card), "cpu" = the plain PyTorch versions.

`Result` is the single place padding/NaN semantics live:

* ``cct[b, c]`` is NaN for unfinished or padded coflows;
* ``fct[b, f]`` is NaN for unfinished or padded flows;
* ``makespan[b]`` (last absolute FCT) and ``avg_cct[b]`` are NaN when a
  row finished nothing — never 0.0.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.coflow import Trace
from repro_torch.core.params import SchedulerParams
from repro_torch.core.policies import resolve_policy

# the mechanism-switch names both engines resolve (shared with the JAX
# package's `repro.api.MECHANISM_KEYS`): tensor switches on the torch
# plane, policy ctor kwargs (or SchedulerParams fields) on the numpy one
MECHANISM_KEYS = ("work_conservation", "dynamics_requeue", "lcof",
                  "per_flow_threshold", "clairvoyant")


@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """A declarative scheduling experiment.

    Exactly one trace source must be set: `trace` (one Trace), `traces`
    (a fleet, replayed batched), `synth` (kwargs for
    `traces.synth.fb_like_trace`) or `trace_path` (a file in the public
    coflow-benchmark format, `traces.loader`). `sweep` replaces `params`
    with a grid of settings over ONE trace (batched on the torch engine,
    looped on numpy). `mechanisms` holds the Fig. 10 ablation switches
    by their shared names; `policy_kwargs` passes extra host-policy
    ctor args (numpy engine only), and `max_jump` bounds the numpy
    simulator's event horizon. `device` is where the kernels run: None
    = CUDA (raises without a card), "cpu" = the plain path.
    `warm_timing` (torch engine) replays twice more and reports the
    best warm wall, with the first run's excess in
    `Result.compile_seconds` (on the card: first-use kernel builds,
    which `Result.build_seconds` reports apart on both engines, and the
    caching allocator's first growth).
    """
    policy: str = "saath"
    engine: str = "torch"
    params: SchedulerParams = dataclasses.field(
        default_factory=SchedulerParams)
    sweep: Optional[Tuple[SchedulerParams, ...]] = None
    # trace source (exactly one)
    trace: Optional[Trace] = None
    traces: Optional[Tuple[Trace, ...]] = None
    synth: Optional[Mapping] = None
    trace_path: Optional[str] = None
    # engine knobs
    fidelity: str = "flow"             # torch: "flow" | "coflow"
    mechanisms: Optional[Mapping] = None
    policy_kwargs: Optional[Mapping] = None
    max_jump: Optional[float] = None   # numpy: Simulator re-eval cadence
    topology: Optional[object] = None  # None | BigSwitch() | LeafSpine()
    device: Optional[str] = None
    warm_timing: bool = False          # extra runs split first-run cost
    clairvoyance: Optional[bool] = None  # sugar for "clairvoyant"
    label: str = ""

    def hash(self) -> str:
        """Stable digest of everything that determines the outcome."""
        h = hashlib.blake2b(digest_size=8)

        def upd(*parts):
            h.update(repr(parts).encode())

        upd(self.policy, self.engine, self.fidelity, self.label,
            dataclasses.astuple(self.params), repr(self.topology),
            self.clairvoyance)
        if self.sweep is not None:
            upd(tuple(dataclasses.astuple(p) for p in self.sweep))
        upd(tuple(sorted((self.mechanisms or {}).items())))
        if self.policy_kwargs or self.max_jump is not None:
            upd(tuple(sorted((self.policy_kwargs or {}).items())),
                self.max_jump)
        if self.synth is not None:
            upd("synth", tuple(sorted(self.synth.items())))
        elif self.trace_path is not None:
            upd("path", self.trace_path)
        else:
            for t in resolve_traces(self):
                upd(t.num_ports, len(t.coflows))
                for c in t.coflows:
                    h.update(np.float64(c.arrival).tobytes())
                    h.update(np.asarray(
                        [(f.src, f.dst, f.size) for f in c.flows],
                        np.float64).tobytes())
        return h.hexdigest()


def resolve_traces(sc: Scenario) -> List[Trace]:
    """Materialize the scenario's trace source (exactly one allowed)."""
    sources = [sc.trace is not None, sc.traces is not None,
               sc.synth is not None, sc.trace_path is not None]
    if sum(sources) != 1:
        raise ValueError(
            "Scenario needs exactly one trace source: trace | traces | "
            "synth | trace_path")
    if sc.trace is not None:
        return [sc.trace]
    if sc.traces is not None:
        return list(sc.traces)
    if sc.trace_path is not None:
        from repro_torch.traces.loader import load_coflow_benchmark
        return [load_coflow_benchmark(sc.trace_path)]
    from repro_torch.traces.synth import fb_like_trace
    return [fb_like_trace(**dict(sc.synth))]


@dataclasses.dataclass
class Result:
    """Normalized outcome of `run` (see the module docstring for the
    NaN/padding contract). The leading axis is the trace axis for fleet
    scenarios and the setting axis for sweeps."""
    engine: str
    policy: str
    cct: np.ndarray           # (B, C) seconds, arrival-relative
    fct: np.ndarray           # (B, F) seconds, ABSOLUTE completion time
    sent: np.ndarray          # (B, F) bytes
    num_coflows: np.ndarray   # (B,) real (un-padded) coflows per row
    num_flows: np.ndarray     # (B,) real flows per row
    steps: int                # TOTAL coordinator calls across the batch
    #                           (torch: event steps x lanes; numpy: the
    #                           summed Simulator steps)
    wall_seconds: float
    compile_seconds: float = 0.0   # warm_timing: cold - best warm wall
    build_seconds: float = 0.0     # kernel builds (nvcc) during the run
    events: int = 0                # event steps (batched ticks) executed
    ticks: int = 0                 # max δ-grid ticks across the batch
    sched_seconds: float = 0.0     # numpy: host time inside the policy
    scenario: Optional[Scenario] = None
    traces: Optional[list] = dataclasses.field(default=None, repr=False)
    params_rows: Optional[list] = dataclasses.field(default=None,
                                                    repr=False)
    _tables: Optional[list] = dataclasses.field(default=None, repr=False)

    @property
    def batch(self) -> int:
        return self.cct.shape[0]

    @property
    def avg_cct(self) -> np.ndarray:
        """(B,) mean CCT over finished real coflows; NaN when none."""
        from repro_torch.fabric.metrics import nan_row_mean

        return nan_row_mean(self.cct)

    @property
    def makespan(self) -> np.ndarray:
        """(B,) last ABSOLUTE flow completion time; NaN when a row
        finished nothing (including zero-flow rows)."""
        if self.fct.shape[1] == 0:
            return np.full(self.fct.shape[0], np.nan)
        fin = np.isfinite(self.fct)
        safe = np.where(fin, self.fct, -np.inf).max(axis=1)
        return np.where(fin.any(axis=1), safe, np.nan)

    def row_cct(self, b: int = 0) -> np.ndarray:
        """(C_b,) per-coflow CCTs of row `b`, padding trimmed."""
        return self.cct[b, :int(self.num_coflows[b])]

    def row_fct(self, b: int = 0) -> np.ndarray:
        return self.fct[b, :int(self.num_flows[b])]

    def table(self, b: int = 0):
        """Materialize row `b` as a filled `FlowTable` (the numpy
        engine's own replayed table)."""
        if self._tables is not None:
            return self._tables[b]
        if self.traces is None:
            raise ValueError("Result carries no traces to rebuild from")
        from repro_torch.fabric.state import FlowTable

        p = (self.params_rows[b] if self.params_rows
             else SchedulerParams())
        t = FlowTable.from_trace(self.traces[b], p.port_bw)
        F, C = t.size.shape[0], t.num_coflows
        t.sent[:] = self.sent[b, :F]
        t.fct[:] = self.fct[b, :F]
        t.done[:] = np.isfinite(self.fct[b, :F])
        t.cct[:] = self.cct[b, :C]
        t.finished[:] = np.isfinite(self.cct[b, :C])
        t.active[:] = False
        return t

    def summary(self, b: int = 0) -> dict:
        """Flat record for machine-readable emission."""
        cct = self.row_cct(b)
        fin = cct[np.isfinite(cct)]
        return {
            "engine": self.engine, "policy": self.policy,
            "scenario": self.scenario.hash() if self.scenario else "",
            "label": self.scenario.label if self.scenario else "",
            "row": b,
            "num_coflows": int(self.num_coflows[b]),
            "avg_cct": float(self.avg_cct[b]),
            "p50_cct": float(np.percentile(fin, 50)) if fin.size
            else float("nan"),
            "p90_cct": float(np.percentile(fin, 90)) if fin.size
            else float("nan"),
            "makespan": float(self.makespan[b]),
            "steps": self.steps,
            "wall_seconds": self.wall_seconds,
        }


def result_from_completions(completions, *, engine: str = "torch",
                            policy: str = "saath", steps: int = 0,
                            wall_seconds: float = 0.0) -> Result:
    """Normalize a stream of completed coflows (objects with `cct`,
    `fct` and optionally `size`) into a single-row `Result`. An empty
    stream yields the canonical "nothing completed" row."""
    comps = list(completions)
    C = len(comps)
    F = int(sum(d.fct.size for d in comps))
    cct = np.full((1, C), np.nan)
    fct = np.full((1, F), np.nan)
    sent = np.zeros((1, F))
    lo = 0
    for i, d in enumerate(comps):
        n = d.fct.size
        cct[0, i] = d.cct
        fct[0, lo:lo + n] = d.fct
        if getattr(d, "size", None) is not None:
            sent[0, lo:lo + n] = d.size
        lo += n
    return Result(engine=engine, policy=policy, cct=cct, fct=fct,
                  sent=sent, num_coflows=np.array([C]),
                  num_flows=np.array([F]), steps=steps,
                  wall_seconds=wall_seconds)


def check_mechanisms(mechanisms: "Mapping | None") -> dict:
    """Validate mechanism-switch names; returns a plain dict copy."""
    mech = dict(mechanisms or {})
    unknown = set(mech) - set(MECHANISM_KEYS)
    if unknown:
        raise ValueError(
            f"unknown mechanism switches {sorted(unknown)}; "
            f"available: {', '.join(MECHANISM_KEYS)}")
    return mech


def run(scenario: Scenario) -> Result:
    """Execute a Scenario on its engine and normalize the outcome."""
    from repro_torch.fabric import engine as eng
    from repro_torch.fabric.topology import normalize_topology

    sc = scenario
    if sc.engine not in ("numpy", "torch"):
        raise ValueError(
            f"unknown engine {sc.engine!r}; available: numpy, torch")
    if sc.fidelity not in ("flow", "coflow"):
        raise ValueError(f"unknown fidelity {sc.fidelity!r}; "
                         f"available: flow, coflow")
    if sc.engine == "numpy" and sc.fidelity != "flow":
        raise ValueError(
            "the numpy reference replay is inherently flow-fidelity; "
            'fidelity="coflow" is the torch engine\'s throughput mode')
    resolve_policy(sc.policy, sc.engine)   # raises with available list
    normalize_topology(sc.topology)        # raises on a non-fabric object
    mech = check_mechanisms(sc.mechanisms)
    if sc.clairvoyance is not None:
        mech.setdefault("clairvoyant", sc.clairvoyance)
    device = eng.resolve_device(sc.device)
    traces = resolve_traces(sc)
    settings = list(sc.sweep) if sc.sweep is not None else None
    if settings is not None and len(traces) != 1:
        raise ValueError("sweep scenarios take exactly one trace")
    if sc.engine == "numpy":
        return _run_numpy(sc, traces, settings, mech, device)
    return _run_torch(sc, traces, settings, mech, device)


def _run_numpy(sc: Scenario, traces: List[Trace], settings, mech: dict,
               device) -> Result:
    from repro_torch.core.policies import make_policy
    from repro_torch.fabric.simulator import Simulator
    from repro_torch.fabric.state import FlowTable
    from repro_torch.kernels import build as kbuild

    def one(trace, params):
        params = params.with_mechanisms(mech)
        pol_kw = dict(sc.policy_kwargs or {})
        for k in ("lcof", "per_flow_threshold"):
            if k in mech:
                pol_kw[k] = mech[k]
        table = FlowTable.from_trace(trace, params.port_bw)
        policy = make_policy(sc.policy, params, device=device, **pol_kw)
        res = Simulator(params, max_jump=sc.max_jump,
                        topology=sc.topology).run(table, policy)
        return res, params

    built = kbuild.build_seconds
    t0 = time.perf_counter()
    if settings is not None:
        rows = [one(traces[0], p) for p in settings]
        row_traces = [traces[0]] * len(settings)
    else:
        rows = [one(t, sc.params) for t in traces]
        row_traces = traces
    wall = time.perf_counter() - t0

    results = [r for r, _ in rows]
    B = len(results)
    Cm = max(r.table.num_coflows for r in results)
    Fm = max(r.table.size.shape[0] for r in results)
    cct = np.full((B, Cm), np.nan)
    fct = np.full((B, Fm), np.nan)
    sent = np.zeros((B, Fm))
    for b, r in enumerate(results):
        C, F = r.table.num_coflows, r.table.size.shape[0]
        cct[b, :C] = r.table.cct
        fct[b, :F] = r.table.fct
        sent[b, :F] = r.table.sent
    return Result(
        engine="numpy", policy=sc.policy, cct=cct, fct=fct, sent=sent,
        num_coflows=np.array([r.table.num_coflows for r in results]),
        num_flows=np.array([r.table.size.shape[0] for r in results]),
        steps=sum(r.steps for r in results), wall_seconds=wall,
        build_seconds=kbuild.build_seconds - built,
        sched_seconds=sum(r.sched_seconds for r in results),
        scenario=sc, traces=row_traces,
        params_rows=[p for _, p in rows],
        _tables=[r.table for r in results])


def _run_torch(sc: Scenario, traces: List[Trace], settings, mech: dict,
               device) -> Result:
    from repro_torch.fabric import engine as eng
    from repro_torch.kernels import build as kbuild

    if sc.policy_kwargs:
        raise ValueError(
            "policy_kwargs are numpy-engine only; use mechanisms= for "
            "the shared ablation switches")
    if settings is not None:
        if mech:
            raise ValueError(
                "sweep scenarios encode work_conservation / "
                "dynamics_requeue / clairvoyant per setting "
                "(SchedulerParams fields); lcof / per_flow_threshold "
                "ablations need per-setting scenarios")

        def go():
            return eng.simulate_sweep(traces[0], settings,
                                      fidelity=sc.fidelity,
                                      topology=sc.topology, device=device)
        row_traces = [traces[0]] * len(settings)
        params_rows = settings
    else:
        def go():
            return eng.simulate_batch(traces, sc.params,
                                      fidelity=sc.fidelity,
                                      topology=sc.topology, device=device,
                                      **mech)
        row_traces = traces
        params_rows = [sc.params] * len(traces)

    built = kbuild.build_seconds
    t0 = time.perf_counter()
    eres = go()
    wall = time.perf_counter() - t0
    built = kbuild.build_seconds - built
    compile_s = 0.0
    if sc.warm_timing:
        # best of two warm runs: one-shot wall clocks on a shared host
        # wander; the first run's excess (kernel builds, first
        # allocations) is reported apart
        warm = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            eres = go()
            warm = min(warm, time.perf_counter() - t0)
        compile_s, wall = max(wall - warm, 0.0), warm

    return Result(
        engine="torch", policy=sc.policy, cct=eres.cct, fct=eres.fct,
        sent=eres.sent,
        num_coflows=np.array([len(t.coflows) for t in row_traces]),
        num_flows=np.array([t.num_flows for t in row_traces]),
        steps=eres.events * eres.cct.shape[0], wall_seconds=wall,
        compile_seconds=compile_s, build_seconds=built,
        events=eres.events, ticks=eres.ticks,
        scenario=sc, traces=row_traces, params_rows=params_rows)


__all__ = ["Scenario", "Result", "run", "resolve_traces",
           "result_from_completions", "MECHANISM_KEYS",
           "check_mechanisms"]
