"""The port's interleaving explorer (`repro_torch.analysis.explore`):
schedule determinism and validity, divergence reporting, a small
in-process race check of the async pool against every tenant run alone,
and parity with the reference's explorer: the same schedules give the
same observations bit for bit."""
import io

import numpy as np

import repro_torch.analysis.explore as ex


def test_schedules_are_deterministic_and_valid():
    a = ex.make_schedule(7, 40)
    b = ex.make_schedule(7, 40)
    assert a == b
    assert a != ex.make_schedule(8, 40)
    live = set()
    for op in a:
        kind = op[0]
        if kind == "admit":
            live.add(op[1])
            assert len(live) <= ex.MAX_SESSIONS
        elif kind == "release":
            live.remove(op[1])
        elif kind in ("submit", "advance_one", "poll_one", "snapshot"):
            assert op[1] in live
        else:
            assert kind in ("advance", "poll")
    assert any(op[0] == "submit" for op in a)
    assert any(op[0] == "advance" for op in a)


def test_first_divergence():
    assert ex.first_divergence([(1,), (2,)], [(1,), (2,)]) is None
    assert ex.first_divergence([(1,), (2,)], [(1,), (3,)]) == \
        (1, (2,), (3,))
    assert ex.first_divergence([(1,)], [(1,), (2,)]) == \
        (1, "<end>", (2,))


def test_norm_is_exact_and_nan_safe():
    assert ex._norm(np.float32(1.5)) == 1.5
    assert ex._norm(float("nan")) == "nan"
    assert ex._norm({"b": [1, 2], "a": np.arange(2)}) == \
        (("a", (0, 1)), ("b", (1, 2)))


def test_async_pool_matches_tenants_alone_in_process():
    """The race check proper: one fuzzed schedule, the async pool
    against every tenant alone, every observation bitwise-equal."""
    out = io.StringIO()
    rc = ex.explore(schedules=1, n_ops=16, seed=3, out=out)
    assert rc == 0, out.getvalue()
    assert "no divergences" in out.getvalue()


def test_explorer_reports_a_divergence(monkeypatch):
    """Force the candidate run to observe something the oracle did
    not: the explorer must exit nonzero and name the observation."""
    real = ex.run_schedule

    def crooked(ops, **kw):
        obs = real(ops, **kw)
        if not kw.get("standalone"):     # leave the oracle run alone
            obs[-1] = ("final", "corrupted")
        return obs

    monkeypatch.setattr(ex, "run_schedule", crooked)
    out = io.StringIO()
    rc = ex.explore(schedules=1, n_ops=12, seed=0, out=out)
    assert rc == 1
    assert "RACE" in out.getvalue()
    assert "corrupted" in out.getvalue()


def test_oracle_recycles_rows_like_the_pool():
    ops = [("admit", 0), ("admit", 1), ("release", 0), ("admit", 2),
           ("submit", 2, 2, 5, 0), ("advance", 0.7), ("poll",)]
    a = ex.run_schedule(ops, standalone=True)
    b = ex.run_schedule(ops)
    assert a == b
    assert [o[3] for o in a if o[1] in ("admit", "release")] == [1, 2, 1, 2]


def test_observations_equal_the_reference_explorer():
    """Parity: the same schedules through the reference's blocking
    1-shard pool and through the port's async pool (known tenants) give
    equal observations, CCT bits and snapshots included."""
    import repro.analysis.explore as ref

    for seed, n_ops in ((0, 24), (3, 16), (7, 30)):
        ops = ex.make_schedule(seed, n_ops)
        assert ops == ref.make_schedule(seed, n_ops)
        want = ref.run_schedule(ops, shards=1, async_dispatch=False)
        got = ex.run_schedule(ops)
        assert ex.first_divergence(want, got) is None, (seed, n_ops)
        assert got == want
