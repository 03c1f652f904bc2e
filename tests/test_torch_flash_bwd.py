"""The gradient of the port's attention on the CPU: the plain version of
kernel K7 (`ref.flash_attention_bwd_ref`) against `torch.autograd.grad`
through the forward's plain version (`ref.flash_attention_ref`) and
against `jax.vjp` of the JAX package's `jnp_flash`, on the same seeded
numpy inputs: G = H / Hkv > 1, MLA-like widths (D, Dv) = (24, 16),
causal and not, a query chunk at q_offset > 0 against T > S; f32 to
atol 1e-5 plus rtol 1e-4. `attention.FlashAttention` passes
`torch.autograd.gradcheck` in f64; `attend` takes it only when autograd
records, and its backward is a `kernel:flash_attention_bwd` boundary of
`ops` that launches nothing on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import jnp_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.models.attention import FlashAttention, attend

ATOL, RTOL = 1e-5, 1e-4
# (B, H, Hkv, S, T, D, Dv, q_offset)
CASES = [(2, 4, 2, 33, 33, 16, 16, 0), (1, 6, 2, 40, 40, 24, 16, 0),
         (2, 4, 1, 17, 50, 24, 16, 33), (1, 3, 3, 20, 29, 8, 8, 9)]


def _inputs(case, seed=0, dtype=np.float32):
    B, H, Hkv, S, T, D, Dv, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv), (B, H, S, Dv))]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_equals_autograd_of_the_forward(case, causal):
    q, k, v, do = (torch.tensor(a) for a in _inputs(case))
    qo = case[-1]
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    o = flash_attention_ref(q, k, v, causal=causal, q_offset=qo, block=16)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                  o.detach(), do, causal=causal,
                                  q_offset=qo)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w.numpy())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_equals_jax_vjp_of_jnp_flash(case, causal):
    q, k, v, do = _inputs(case, seed=1)
    qo = case[-1]
    # jnp_flash takes (B, S, H, D)
    tr = (0, 2, 1, 3)
    o, vjp = jax.vjp(lambda a, b, c: jnp_flash(a, b, c, causal=causal,
                                               q_offset=qo, block=16),
                     *(jnp.asarray(x.transpose(tr)) for x in (q, k, v)))
    want = vjp(jnp.asarray(do.transpose(tr)))
    got = flash_attention_bwd_ref(
        *(torch.tensor(x) for x in (q, k, v)),
        torch.tensor(np.asarray(o).transpose(tr)), torch.tensor(do),
        causal=causal, q_offset=qo)
    for g, w in zip(got, want):
        _close(g, np.asarray(w).transpose(tr))


@pytest.mark.parametrize("case", [(1, 4, 2, 5, 5, 4, 3, 0),
                                  (2, 2, 1, 3, 7, 6, 6, 4)], ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_passes_gradcheck_in_f64(case, causal):
    q, k, v, _ = (torch.tensor(a, requires_grad=True)
                  for a in _inputs(case, seed=2, dtype=np.float64))
    qo = case[-1]
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttention.apply(a, b, c, causal, qo, None),
        (q, k, v))


class _Seen:
    def __init__(self):
        self.names = []

    def kernel_enter(self, name):
        self.names.append(name)

    def kernel_exit(self, name):
        pass


def test_attend_records_a_gradient_only_when_asked(monkeypatch):
    """Under `no_grad` (serving) `attend` is the plain call; with inputs
    that require a gradient the backward goes through the
    `flash_attention_bwd` boundary, a plain version on the CPU (no
    launch), and equals autograd through the forward's plain version."""
    q, k, v, do = (torch.tensor(a) for a in _inputs(CASES[0], seed=3))
    seen = _Seen()
    monkeypatch.setattr(ops, "observers", [seen])
    before = ops.launch_counts()
    with torch.no_grad():
        o0 = attend(q, k, v)
    assert o0.grad_fn is None and seen.names == ["flash_attention"]
    for t in (q, k, v):
        t.requires_grad_()
    o = attend(q, k, v)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(o, (q, k, v), do)
    assert seen.names == ["flash_attention", "flash_attention",
                          "flash_attention_bwd"]
    assert ops.launch_counts() == before
    o_ref = flash_attention_ref(q, k, v, causal=True)
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    for g, w in zip(got, want):
        _close(g, w.numpy())


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v, do = (torch.tensor(a) for a in _inputs(CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, do, do)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention_bwd(q, k, v, do, do, q_offset=-1)
