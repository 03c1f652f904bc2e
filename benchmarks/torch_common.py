"""Shared machinery of the port's drivers (`benchmarks/torch_*.py`):
Scenario cache, CSV emit and the port's own record file.

The counterpart of `benchmarks/common.py` for `repro_torch`, which that
module cannot serve (it imports the JAX package). `Bench.run` builds a
`repro_torch.api.Scenario` from the bench fabric spec on the bench's
device and caches the normalized `Result` by scenario hash and device.
`record` appends a run to `BENCH_torch.json` (scenario hash, device,
wall clock, CCT stats and what the caller adds); the file is a scratch
record, not kept in the repository: numbers that matter go to PERF.md.

    PYTHONPATH=src python -m benchmarks.torch_table2_coordinator_latency
    PYTHONPATH=src python -m benchmarks.torch_table2_coordinator_latency \
        --device cpu
    PYTHONPATH=src python -m benchmarks.torch_fig9_speedup --device cpu

The figure drivers (`torch_fig*.py`, run together by `torch_run.py`)
take `cli_bench`'s options: `--full`, `--engine numpy|torch` (the
Saath side's engine; the host baselines always replay on numpy) and
`--device`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.api import Result, Scenario
from repro_torch.api import run as api_run
from repro_torch.core.params import SchedulerParams

# default benchmark fabric: FB-like (paper: 526 coflows / 150 ports);
# the quick one keeps a CPU run to minutes
FULL = dict(num_coflows=526, num_ports=150, seed=0)
QUICK = dict(num_coflows=240, num_ports=100, seed=0)

BENCH_JSON = "BENCH_torch.json"


def device_name(device) -> str:
    """What a record names as its device: the card's name, or "cpu"."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def record(name: str, result: Result, row: int = 0, **extra) -> dict:
    """Append one machine-readable record to BENCH_torch.json
    (idempotent per (bench, scenario, device, row) key)."""
    rec = {"bench": name, **result.summary(row),
           "device": device_name(result.scenario.device or "cuda")
           if result.scenario is not None else None, **extra}
    rec = {k: (None if isinstance(v, float) and not math.isfinite(v)
               else v) for k, v in rec.items()}
    key = (rec["bench"], rec["scenario"], rec["device"], rec["row"])
    existing = []
    if os.path.exists(BENCH_JSON):
        try:
            with open(BENCH_JSON) as fh:
                existing = json.load(fh)
        except (json.JSONDecodeError, OSError):
            existing = []
    existing = [r for r in existing
                if (r.get("bench"), r.get("scenario"), r.get("device"),
                    r.get("row")) != key]
    existing.append(rec)
    with open(BENCH_JSON, "w") as fh:
        json.dump(existing, fh, indent=1)
    return rec


@dataclasses.dataclass
class Bench:
    quick: bool = True
    device: str = "cuda"
    _cache: Dict[Tuple[str, str], Result] = dataclasses.field(
        default_factory=dict)
    _trace_kw: dict = None

    def __post_init__(self):
        self._trace_kw = QUICK if self.quick else FULL

    def scenario(self, policy: str = "saath", *, engine: str = "torch",
                 params: Optional[SchedulerParams] = None,
                 mechanisms: Optional[dict] = None, label: str = "",
                 warm_timing: bool = False,
                 **trace_overrides) -> Scenario:
        """A Scenario over the bench fabric (QUICK/FULL synth spec plus
        per-benchmark overrides) on the bench's device."""
        synth = dict(self._trace_kw)
        synth.update(trace_overrides)
        return Scenario(policy=policy, engine=engine,
                        params=params or SchedulerParams(),
                        synth=synth, mechanisms=mechanisms, label=label,
                        device=self.device, warm_timing=warm_timing)

    def run(self, policy: str = "saath", *,
            scenario: Optional[Scenario] = None, record_as: str = "",
            **kw) -> Result:
        """Run (or fetch the cached) Result for a scenario. `record_as`
        names the BENCH_torch.json record for uncached runs."""
        sc = scenario if scenario is not None else \
            self.scenario(policy, **kw)
        key = (sc.hash(), str(sc.device))
        if key not in self._cache:
            t0 = time.perf_counter()
            self._cache[key] = api_run(sc)
            print(f"#   ran {sc.policy}[{sc.engine} on {sc.device}]"
                  f"{'/' + sc.label if sc.label else ''} in "
                  f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
            if record_as:
                record(record_as, self._cache[key])
        return self._cache[key]


def cli_parser(**kw) -> argparse.ArgumentParser:
    """The drivers' common options: --full fabric scale, --device."""
    ap = argparse.ArgumentParser(**kw)
    ap.add_argument("--full", action="store_true",
                    help="FB-scale fabric (526 coflows x 150 ports)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the port runs on (default cuda; "
                    "'cpu' runs the plain PyTorch path)")
    return ap


def cli_bench(argv=None) -> Tuple[Bench, str]:
    """The figure drivers' CLI: `cli_parser`'s options plus --engine,
    the replay engine of the Saath side (scenario data, not a code
    path: the host baselines replay on numpy whatever it says)."""
    ap = cli_parser()
    ap.add_argument("--engine", choices=("numpy", "torch"),
                    default="torch",
                    help="replay engine for the Saath side")
    args = ap.parse_args(argv)
    return Bench(quick=not args.full, device=args.device), args.engine


def emit(name: str, rows):
    """CSV rows: list of dicts with consistent keys."""
    if not rows:
        print(f"{name},EMPTY")
        return
    keys = list(rows[0])
    print(f"# {name}")
    print(",".join(["bench"] + keys))
    for r in rows:
        print(",".join([name] + [_fmt(r[k]) for k in keys]))


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def pctl(x, q):
    return float(np.nanpercentile(np.asarray(x, float), q))


__all__ = ["BENCH_JSON", "Bench", "FULL", "QUICK", "cli_bench",
           "cli_parser", "device_name", "emit", "pctl", "record"]
