"""Dispatch auditor: an op-level gate on the device step's entry points.

The port of `repro.analysis.audit`. The port is eager, so each entry
point runs once on a tiny seeded canonical slab under the op scan
(`analysis.op_scan`), which records what it dispatches, and is checked
for:

* HARD invariants (always enforced, even on `--update`, on any
  device): no float64 site (an f64 output or a cast to f64) and no host
  synchronization or transfer inside the step (a scalar read, a
  data-dependent shape, a host-device copy). The session loop's flag
  reads are not sites: they go through a choke point
  (`engine._read_flag`), whose crossings are counted apart and must
  equal the flag reads `session_advance` reports;
* DRIFT against the committed golden
  ``analysis/torch_dispatch_manifest.json``: the input signatures (dtype
  and shape of every tensor argument) and the choke-point crossings are
  compared always; the op histogram (aten overloads and ``kernel:*``
  calls) is compared exactly only under the torch version the manifest
  records, and reported as a warning under any other (eager dispatch
  details move between releases). On a device other than the CPU (the
  card) only the hard invariants, the signatures and the ``kernel:*``
  entries are compared: the card dispatches other aten ops for the same
  step (pinned copies, fused kernels' wrappers).

Usage::

    python -m repro_torch.analysis.audit            # gate, on the CPU
    python -m repro_torch.analysis.audit --update   # refresh the manifest

Keep manifest diffs in review: a new op in `session_advance` is a
reviewable artifact.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis.op_scan import Scan, scan

__all__ = ["ENTRYPOINTS", "build_manifest", "check_manifest",
           "default_manifest_path", "hard_problems", "main"]

# canonical slab: tiny on purpose (the reference's B, F, C, P), holding
# seeded coflows so that the loop, the walks and the completions run
B, F, C, P = 2, 8, 4, 4
CHUNK = 4
N_END = 6.0
FEATURES = (True, True, False, False, False)
# leaf-spine canonical slab: P ports over LF leaves (2 hosts a leaf),
# with the max-min fill (K3)
LF = 2
SEED = 0
# the session loop's flag read, as its choke point reports it
FLAG = "d2h:engine.session_advance"
SESSION_ENTRIES = ("session_advance", "session_advance_leafspine",
                   "session_advance_sampling")


def _params(sampling: bool = False):
    from repro_torch.core.params import SchedulerParams

    p = SchedulerParams(port_bw=1.0, delta=1e-2, start_threshold=4.0,
                        growth=4.0, num_queues=5)
    if sampling:
        p = dataclasses.replace(p, dynamics_requeue=True,
                                clairvoyant=False, pilot_frac=0.5)
    return p


def _traces():
    """B seeded traces of 3 coflows of 1-2 flows over P ports, arriving
    within the first two δ ticks."""
    from repro_torch.core.coflow import Coflow, Flow, Trace

    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(B):
        cfs, fid = [], 0
        for c in range(3):
            w = int(rng.integers(1, 3))
            flows = [Flow(fid + i, int(rng.integers(P)),
                          int(rng.integers(P)),
                          float(rng.uniform(0.005, 0.04)))
                     for i in range(w)]
            fid += w
            cfs.append(Coflow(c, float(rng.uniform(0.0, 0.02)), flows))
        out.append(Trace(P, cfs))
    return out


def canonical_slab(leaf: bool = False, sampling: bool = False,
                   device="cpu"):
    """(tb, ep1, ep_rows, state) of the canonical slab on `device`: the
    TraceBatch, one EngineParams, its (B,)-row stack and a session
    state (the four pending leaves zero)."""
    from repro_torch.fabric import engine as eng
    from repro_torch.fabric.topology import LeafSpine
    from repro_torch.traces.batch import pack, to_device

    dev = torch.device(device)
    p = _params(sampling)
    topo = LeafSpine(hosts_per_leaf=P // LF, oversub=2.0,
                     wc_fill="maxmin") if leaf else None
    tb = to_device(pack(_traces(), port_bw=p.port_bw, flow_multiple=F,
                        coflow_multiple=C, port_capacity=P, topology=topo,
                        sampling=sampling, pilot_frac=p.pilot_frac), dev)
    ep1 = eng.EngineParams.from_scheduler(p, device=dev)
    ep_rows = eng.tree_map(lambda x: torch.stack([x] * B), ep1)
    zf = torch.zeros((B, F), dtype=torch.float32, device=dev)
    zb = torch.zeros((B,), dtype=torch.float32, device=dev)
    state = eng._init_state(tb)._replace(rate=zf, pend_sent=zf.clone(),
                                         pend_tick=zb, pend_next=zb.clone())
    return tb, ep1, ep_rows, state


def _session_advance(device, leaf=False, sampling=False, features=FEATURES):
    from repro_torch.fabric import engine as eng

    tb, _, ep_rows, state = canonical_slab(leaf, sampling, device)
    return scan(eng.session_advance, state, tb, ep_rows,
                n_end=np.full((B,), N_END, np.float32), chunk=CHUNK,
                features=features)


def _entry_session_advance(device="cpu"):
    """The pool's hot path: `engine.session_advance`, chunks of
    `_session_chunk` and a flag read after each."""
    return _session_advance(device)


def _entry_session_advance_leafspine(device="cpu"):
    """The same loop on a leaf-spine slab with the max-min fill (K3)."""
    return _session_advance(device, leaf=True,
                            features=(True, True, False, True, False))


def _entry_session_advance_sampling(device="cpu"):
    """The same loop with the pilot estimate built in (a learned row)."""
    return _session_advance(device, sampling=True,
                            features=(True, True, False, False, True))


def _entry_session_plan_tick(device="cpu"):
    from repro_torch.fabric import engine as eng

    tb, _, ep_rows, state = canonical_slab(device=device)
    mask = np.zeros((B,), bool)
    mask[0] = True
    return scan(eng.session_plan_tick, state, tb, ep_rows,
                features=(True, False, False, False, False), row_mask=mask)


def _entry_simulate_sweep(device="cpu"):
    """The offline chunk `simulate_batch` and `simulate_sweep` drive."""
    from repro_torch.fabric import engine as eng

    tb, ep1, _, _ = canonical_slab(device=device)
    return scan(eng._run_chunk, eng._init_state(tb), tb, ep1.lanes(B),
                chunk=CHUNK, features=FEATURES)


def _entry_scatter_rows(device="cpu"):
    """The dirty-row upload: one row scattered into the state slab."""
    from repro_torch.fabric import engine as eng

    _, _, _, state = canonical_slab(device=device)
    idx = torch.zeros((1,), dtype=torch.int64, device=device)
    rows = eng.tree_map(lambda a: a[:1].clone(), state)
    return scan(eng.scatter_rows, state, idx, rows)


def _entry_gather_rows(device="cpu"):
    from repro_torch.fabric import engine as eng

    _, _, _, state = canonical_slab(device=device)
    idx = torch.zeros((1,), dtype=torch.int64, device=device)
    return scan(eng.gather_rows, state, idx)


ENTRYPOINTS: Dict[str, Callable[..., Scan]] = {
    "session_advance": _entry_session_advance,
    "session_advance_leafspine": _entry_session_advance_leafspine,
    "session_advance_sampling": _entry_session_advance_sampling,
    "session_plan_tick": _entry_session_plan_tick,
    "simulate_sweep": _entry_simulate_sweep,
    "scatter_rows": _entry_scatter_rows,
    "gather_rows": _entry_gather_rows,
}


def default_manifest_path() -> Path:
    """`analysis/torch_dispatch_manifest.json` at the repository root
    (resolved from the package, so any working directory works)."""
    import repro_torch
    src_root = Path(list(repro_torch.__path__)[0]).resolve().parent
    return src_root.parent / "analysis" / "torch_dispatch_manifest.json"


def _record(name: str, s: Scan) -> dict:
    rec = {"signature": s.signature,
           "ops": dict(sorted(s.ops.items())),
           "crossings": dict(sorted(s.crossings.items())),
           "f64_sites": list(s.f64_sites),
           "host_sites": list(s.host_sites)}
    if name in SESSION_ENTRIES:
        rec["flag_reads"] = int(s.result[2])
    return rec


def build_manifest(entrypoints: Optional[Dict[str, Callable]] = None,
                   device="cpu") -> dict:
    entrypoints = ENTRYPOINTS if entrypoints is None else entrypoints
    entries = {name: _record(name, build(device=device))
               for name, build in sorted(entrypoints.items())}
    return {"torch_version": torch.__version__, "entrypoints": entries}


def hard_problems(name: str, cur: dict) -> List[str]:
    """The hard invariants of one entry's record."""
    out = []
    if cur["host_sites"]:
        out.append(f"{name}: host sync or transfer site(s) in the step: "
                   f"{cur['host_sites']}")
    if cur["f64_sites"]:
        out.append(f"{name}: float64 site(s) in the step: "
                   f"{cur['f64_sites']}")
    if "flag_reads" in cur and \
            cur["crossings"].get(FLAG, 0) != cur["flag_reads"]:
        out.append(f"{name}: {cur['crossings'].get(FLAG, 0)} counted flag "
                   f"reads for the {cur['flag_reads']} the loop reports")
    return out


def _kernels(ops: dict) -> dict:
    return {k: v for k, v in ops.items() if k.startswith("kernel:")}


def check_manifest(manifest: dict,
                   entrypoints: Optional[Dict[str, Callable]] = None,
                   device="cpu") -> List[str]:
    """Gate the current entry points against a committed manifest.
    Returns hard failures; op drift under another torch version is
    reported to stderr as a warning instead."""
    fresh = build_manifest(entrypoints, device=device)
    problems: List[str] = []
    on_cpu = torch.device(device).type == "cpu"
    same_torch = on_cpu and \
        manifest.get("torch_version") == fresh["torch_version"]
    old_entries = manifest.get("entrypoints", {})
    for name, cur in fresh["entrypoints"].items():
        problems += hard_problems(name, cur)
        old = old_entries.get(name)
        if old is None:
            problems.append(
                f"{name}: not in the manifest — run `python -m "
                f"repro_torch.analysis.audit --update` and review the diff")
            continue
        if old["signature"] != cur["signature"]:
            problems.append(
                f"{name}: input signature drift\n"
                + "\n".join(_sig_diff(old["signature"], cur["signature"])))
        if on_cpu and old.get("crossings") != cur["crossings"]:
            problems.append(
                f"{name}: choke-point crossing drift\n"
                + _op_diff(old.get("crossings", {}), cur["crossings"]))
        if same_torch:
            if old["ops"] != cur["ops"]:
                problems.append(f"{name}: op-count drift\n"
                                + _op_diff(old["ops"], cur["ops"]))
        elif not on_cpu:
            if _kernels(old["ops"]) != _kernels(cur["ops"]):
                problems.append(
                    f"{name}: kernel-call drift on {device}\n"
                    + _op_diff(_kernels(old["ops"]), _kernels(cur["ops"])))
        elif old["ops"] != cur["ops"]:
            print(f"audit: {name}: op counts differ from the manifest but "
                  f"the torch version changed ({manifest.get('torch_version')}"
                  f" -> {fresh['torch_version']}): "
                  f"{_op_diff(old['ops'], cur['ops'])}", file=sys.stderr)
    for name in old_entries:
        if name not in fresh["entrypoints"]:
            problems.append(
                f"{name}: in the manifest but no longer audited — run "
                f"`python -m repro_torch.analysis.audit --update`")
    return problems


def _op_diff(old: dict, new: dict) -> str:
    """A histogram delta grouped into added / removed / count-changed,
    so that a reviewer sees what entered the step."""
    added, removed, changed = [], [], []
    for k in sorted(set(old) | set(new)):
        a, b = old.get(k, 0), new.get(k, 0)
        if a == b:
            continue
        if a == 0:
            added.append(f"{k} x{b}")
        elif b == 0:
            removed.append(f"{k} (was x{a})")
        else:
            changed.append(f"{k}: {a} -> {b}")
    out = []
    if added:
        out.append(f"  added:   {', '.join(added)}")
    if removed:
        out.append(f"  removed: {', '.join(removed)}")
    if changed:
        out.append(f"  changed: {', '.join(changed)}")
    return "\n".join(out)


def _sig_diff(old: list, new: list) -> List[str]:
    """Positional signature delta: only the argument slots that drifted,
    `<absent>` marking arity changes."""
    out = []
    for i in range(max(len(old), len(new))):
        a = old[i] if i < len(old) else "<absent>"
        b = new[i] if i < len(new) else "<absent>"
        if a != b:
            out.append(f"  [{i}] {a} -> {b}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="op-level dispatch audit of the device step")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the golden manifest (hard invariants "
                         "still enforced)")
    ap.add_argument("--manifest", type=Path, default=None,
                    help="manifest path override")
    ap.add_argument("--device", default="cpu",
                    help="where the entry points run (the manifest is "
                         "the CPU's; on a card the hard invariants, "
                         "signatures and kernel calls are checked)")
    args = ap.parse_args(argv)
    path = args.manifest or default_manifest_path()
    if args.update:
        if torch.device(args.device).type != "cpu":
            print("audit: the manifest is blessed on the CPU",
                  file=sys.stderr)
            return 1
        manifest = build_manifest()
        hard = [p for name, cur in manifest["entrypoints"].items()
                for p in hard_problems(name, cur)]
        if hard:
            for p in hard:
                print(f"audit: REFUSING to bless: {p}", file=sys.stderr)
            return 1
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(manifest, indent=2, sort_keys=True)
                        + "\n")
        print(f"audit: wrote {path}", file=sys.stderr)
        return 0
    if not path.exists():
        print(f"audit: no manifest at {path} — run `python -m "
              f"repro_torch.analysis.audit --update` and commit it",
              file=sys.stderr)
        return 1
    manifest = json.loads(path.read_text())
    problems = check_manifest(manifest, device=args.device)
    for p in problems:
        print(f"audit: {p}")
    if problems:
        print(f"audit: {len(problems)} problem(s) — review the diff above, "
              f"then bless intended drift with `python -m "
              f"repro_torch.analysis.audit --update`", file=sys.stderr)
        return 1
    print(f"audit: {len(manifest['entrypoints'])} entrypoints clean "
          f"(torch {torch.__version__}, {args.device})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
