"""The two figure drivers outside the suite runner, each with lanes on
both planes, against the JAX package on the CPU at a tiny fabric (see
`tests/test_torch_figures.py` for the sizes, the spy and the bars): the
oversubscription sweep on `LeafSpine(4, oversub)` and the sampling
lanes (known, learned, Aalo), gates as written.
"""
from tests.test_torch_figures import _bench, drivers, \
    hold_to_reference  # noqa: F401  (drivers is a fixture)


def test_fig_oversub(drivers):
    """Both lanes of both planes degrade at 4:1 (the gate); the torch
    lane's fleet replays the default greedy fill."""
    from benchmarks import torch_fig_oversub as drv

    rows = drv.run(_bench())
    assert len(rows) == 12
    assert {sc.topology.wc_fill for sc, _ in drivers} == {"greedy"}
    assert {len(sc.traces) for sc, _ in drivers
            if sc.engine == "torch"} == {2}
    assert hold_to_reference(drivers) == {"numpy": 6, "torch": 6}


def test_fig_sampling(drivers):
    """Learned Saath beats `aalo-like` on the torch engine and `aalo` on
    the numpy engine (the gate)."""
    from benchmarks import torch_fig_sampling as drv

    rows = drv.run(_bench())
    assert [(r["engine"], r["lane"]) for r in rows] == [
        ("torch", "known"), ("torch", "learned"), ("torch", "aalo-like"),
        ("numpy", "known"), ("numpy", "learned"), ("numpy", "aalo")]
    assert hold_to_reference(drivers) == {"numpy": 3, "torch": 3}
