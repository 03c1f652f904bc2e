"""The port's figure drivers with several Saath lanes against the JAX
package on the CPU, at a tiny fabric (see `tests/test_torch_figures.py`
for the sizes, the spy and the bars): Fig. 10's ablations and Fig. 14's
sweep and contention axis, gates as written. The two drivers the suite
runner does not run are in `tests/test_torch_figures_planes.py`.
"""
from tests.test_torch_figures import _bench, drivers, \
    hold_to_reference  # noqa: F401  (drivers is a fixture)


def test_fig10_breakdown(drivers):
    from benchmarks import torch_fig10_breakdown as drv

    rows = drv.run(_bench(), engine="torch")
    assert [r["variant"] for r in rows] == ["A/N", "A/N+PF", "SAATH"]
    assert hold_to_reference(drivers) == {"numpy": 1, "torch": 3}
    assert [sc.mechanisms for sc, _ in drivers[1:]] == [
        m for _, m in drv.VARIANTS]


def test_fig14_sensitivity(drivers):
    """The 16-setting grid as one batched sweep on the torch engine, and
    the arrival-speedup axis against the Aalo host baseline."""
    from benchmarks import torch_fig14_sensitivity as drv

    rows = drv.run(_bench(), engine="torch")
    assert [r["knob"] for r in rows].count("A") == 3
    sweep = drivers[0][0]
    assert sweep.engine == "torch" and len(sweep.sweep) == 16
    assert drivers[0][1].batch == 16
    assert hold_to_reference(drivers) == {"numpy": 3, "torch": 4}
