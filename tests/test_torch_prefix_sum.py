"""The port's prefix sums (`ops.prefix_sum`, kernel K6 on the card)
against the JAX package's `jnp.cumsum`, on the CPU.

The JAX engine's segment sums (`repro.fabric.jax_engine._segment_sum`)
are `jnp.cumsum` plus two gathers; XLA's CPU backend scans in blocks of
16, recursively. `ref.prefix_sum_ref` writes that order out as explicit
adds, so the port's float segment sums (the Aalo-queue ablation's total
bytes, the pilot estimate's byte sum) round as the reference's. If a
later jax changes XLA's order, the first test here says so first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import prefix_sum as k6
from repro_torch.kernels.ref import prefix_sum_ref

from tests.test_torch_cuda import prefix_rows

LENGTHS = [1, 15, 16, 17, 255, 256, 257, 4097, 30016]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("F", LENGTHS)
def test_plain_prefix_sum_equals_jnp_cumsum_bitwise(F):
    """Under `jit(vmap(cumsum))`, the engine's setting, with a leading
    zero column as the segment sums gather from."""
    x = prefix_rows(4, F, seed=F)
    want = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(x))
    got = prefix_sum_ref(torch.from_numpy(x)).numpy()
    assert got.shape == (4, F + 1)
    np.testing.assert_array_equal(_bits(got[:, 0]), 0)
    np.testing.assert_array_equal(_bits(got[:, 1:]), _bits(want))


@pytest.mark.parametrize("F", [17, 4097, 30016])
def test_plain_prefix_sum_differs_from_jnp_only_on_leading_negative_zeros(F):
    """ROADMAP C11: on rows of both signs with many -0.0, XLA's cumsum
    gives +0.0 over a row's leading run of zeros where the plain version
    (and K6) keeps -0.0; every other element agrees bit for bit. The
    engine's inputs are never -0.0."""
    rng = np.random.default_rng(F)
    x = rng.lognormal(0.0, 3.0, (64, F)) * rng.choice([-1.0, 1.0], (64, F))
    x[rng.uniform(size=x.shape) < 0.5] = -0.0
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(x))
    got = prefix_sum_ref(torch.from_numpy(x)).numpy()[:, 1:]
    diff = _bits(got) != _bits(want)
    assert diff.any()
    leading = np.cumsum(x != 0, axis=1) == 0    # only zeros up to here
    assert not (diff & ~leading).any()
    np.testing.assert_array_equal(_bits(got[diff]), _bits(np.float32(-0.0)))
    np.testing.assert_array_equal(_bits(want[diff]), 0)


def test_plain_prefix_sum_order_is_not_torch_cumsum():
    """The order matters at these magnitudes: a sequential scan
    (`torch.cumsum` on this CPU) rounds elsewhere, so an equality above
    is no accident of the data."""
    x = prefix_rows(4, 4097, seed=4097)
    seq = torch.from_numpy(x).cumsum(-1).numpy()
    got = prefix_sum_ref(torch.from_numpy(x)).numpy()[:, 1:]
    assert (_bits(seq) != _bits(got)).any()


def test_plain_prefix_sum_leaves_its_input_alone():
    x = torch.from_numpy(prefix_rows(3, 64, seed=1))
    keep = x.clone()
    prefix_sum_ref(x)
    prefix_sum_ref(x[:, ::2])
    assert torch.equal(x, keep)


def test_ops_prefix_sum_on_the_cpu_takes_the_plain_version():
    """A CPU tensor takes `prefix_sum_ref` and launches nothing, with or
    without force="ref"; an empty row gives the zero column alone."""
    x = torch.from_numpy(prefix_rows(2, 40, seed=2))
    before = k6.launches
    for kw in ({}, {"force": "ref"}):
        assert torch.equal(ops.prefix_sum(x, **kw), prefix_sum_ref(x))
    assert k6.launches == before
    assert torch.equal(ops.prefix_sum(torch.zeros(3, 0)),
                       torch.zeros(3, 1))
    with pytest.raises(ValueError):
        ops.prefix_sum(x, force="kernel")


def test_prefix_sum_cuda_rejects_a_cpu_tensor():
    """The kernel's wrapper never falls back: a CPU tensor raises before
    any build is tried."""
    with pytest.raises(ValueError):
        k6.prefix_sum_cuda(torch.ones(2, 8))


def test_segment_sums_equal_the_reference_segment_sums():
    """The engine's `_segment_sum` against the JAX package's on the same
    data and ranges: float bytes bit for bit."""
    from repro.fabric import jax_engine
    from repro_torch.fabric import engine

    rng = np.random.default_rng(0)
    F, C = 3000, 200
    x = prefix_rows(1, F, seed=5)[0]
    cuts = np.sort(rng.choice(np.arange(1, F), C - 1, replace=False))
    lo = np.concatenate([[0], cuts]).astype(np.int32)
    hi = np.concatenate([cuts, [F]]).astype(np.int32)
    want = np.asarray(jax.jit(jax_engine._segment_sum)(x, lo, hi))
    got = engine._segment_sum(torch.from_numpy(x)[None],
                              torch.from_numpy(lo).long()[None],
                              torch.from_numpy(hi).long()[None])[0]
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
