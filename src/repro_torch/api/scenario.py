"""The scheduling front door of the port: `Scenario` -> `run` -> `Result`.

The port of `repro.api.scenario` for the batched fleet replay, on one
engine, ``engine="torch"``: `run` replays the scenario's traces (or one
trace under a sweep of settings) through `fabric.engine` on the card
(``device`` defaults to CUDA; ``device="cpu"`` runs the plain PyTorch
path) and normalizes the outcome into a `Result`. The event-driven numpy
reference (``engine="numpy"``) stays in the JAX package:
``repro.api.run(Scenario(engine="numpy", ...))``.

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

# the mechanism-switch names the engine resolves (shared with the JAX
# package's `repro.api.MECHANISM_KEYS`)
MECHANISM_KEYS = ("work_conservation", "dynamics_requeue", "lcof",
                  "per_flow_threshold", "clairvoyant")
# policies with a batched implementation (the Saath coordinator tick)
TORCH_ENGINE_POLICIES = ("saath",)


@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """A declarative scheduling experiment.

    Exactly one trace source must be set: `trace` (one Trace), `traces`
    (a fleet, replayed batched), `synth` (kwargs for
    `traces.synth.fb_like_trace`) or `trace_path` (a file in the public
    coflow-benchmark format, `traces.loader`). `sweep` replaces `params`
    with a grid of settings over ONE trace. `mechanisms` holds the Fig.
    10 ablation switches by their shared names. `device` is where the
    replay runs: None = CUDA (raises without a card), "cpu" = the plain
    path. `warm_timing` replays twice more and reports the best warm
    wall, with the first run's excess in `Result.compile_seconds` (on
    the card: first-use kernel builds, which `Result.build_seconds`
    reports apart, and the caching allocator's first growth).
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
    fidelity: str = "flow"             # "flow" | "coflow"
    mechanisms: Optional[Mapping] = None
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
    steps: int                # event steps x lanes: coordinator calls
    wall_seconds: float
    compile_seconds: float = 0.0   # warm_timing: cold - best warm wall
    build_seconds: float = 0.0     # kernel builds (nvcc) during the run
    events: int = 0                # event steps (batched ticks) executed
    ticks: int = 0                 # max δ-grid ticks across the batch
    scenario: Optional[Scenario] = None
    traces: Optional[list] = dataclasses.field(default=None, repr=False)
    params_rows: Optional[list] = dataclasses.field(default=None,
                                                    repr=False)

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
        """Materialize row `b` as a filled `FlowTable`."""
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
    """Execute a Scenario and normalize the outcome."""
    from repro_torch.fabric import engine as eng
    from repro_torch.kernels import build as kbuild

    sc = scenario
    if sc.engine == "numpy":
        raise ValueError(
            "the numpy reference replay lives in the JAX package: "
            "repro.api.run(Scenario(engine='numpy', ...)); this port's "
            "engine is 'torch'")
    if sc.engine != "torch":
        raise ValueError(f"unknown engine {sc.engine!r}; available: torch")
    if sc.fidelity not in ("flow", "coflow"):
        raise ValueError(f"unknown fidelity {sc.fidelity!r}; "
                         f"available: flow, coflow")
    if sc.policy not in TORCH_ENGINE_POLICIES:
        raise ValueError(
            f"policy {sc.policy!r} has no batched implementation; "
            f"engine='torch' supports: {', '.join(TORCH_ENGINE_POLICIES)} "
            f"(the host policies are the JAX package's numpy engine)")
    mech = check_mechanisms(sc.mechanisms)
    if sc.clairvoyance is not None:
        mech.setdefault("clairvoyant", sc.clairvoyance)
    device = eng.resolve_device(sc.device)
    traces = resolve_traces(sc)
    settings = list(sc.sweep) if sc.sweep is not None else None

    if settings is not None:
        if len(traces) != 1:
            raise ValueError("sweep scenarios take exactly one trace")
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
