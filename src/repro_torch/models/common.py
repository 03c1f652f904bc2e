"""Shared model machinery of the port: the reference's RMS norm, RoPE,
activations, plain-MLP FFN and parameter initialiser.

The counterpart of `repro.models.common` for the parts the serve paths
run: the plain MLP of StarCoder2 and the gated FFN (`glu_ffn`) of the
SwiGLU models and of every MoE expert. Sharding rules stay out until a
slice needs them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's `dtype` field."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; available: "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The reference's RMS norm: f32 internals and a (1 + w) scale, so a
    zero-initialised weight is the identity scale (not
    `torch.nn.RMSNorm`, which scales by w). Returns x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * (1.0 + w.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split: x (..., S, H, D), positions
    broadcastable to (..., S). Angles and products in f32, the result
    in x's dtype (the reference's `rope`)."""
    half = x.shape[-1] // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freq   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# the reference's activations by name; its "gelu" is the tanh
# approximation (`jax.nn.gelu(approximate=True)`), not PyTorch's default
# erf form
ACTIVATIONS = {"silu": F.silu, "relu": F.relu,
               "gelu": lambda x: F.gelu(x, approximate="tanh")}


def activation(name: str):
    """The activation `name` of `ACTIVATIONS`."""
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; available: "
                         f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def mlp_ffn(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
            act: str) -> torch.Tensor:
    """Plain 2-matrix FFN: act(x W_i) W_o (StarCoder2, Seamless)."""
    return activation(act)(x @ wi) @ wo


def glu_ffn(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
            wo: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU / GeGLU: act(x W_g) * (x W_u) W_o, with `act` "silu" or
    "gelu" (the reference's `glu_ffn`)."""
    return (activation(act)(x @ wi_gate) * (x @ wi_up)) @ wo


def glu_activation(cfg) -> str:
    """The activation of a config's gated FFNs: "silu" for SwiGLU, else
    the tanh "gelu" (the reference's rule for its MoE experts and, for
    "swiglu" and "geglu", its dense FFNs)."""
    return "silu" if cfg.activation == "swiglu" else "gelu"


class ParamInit:
    """The reference `ParamFactory`'s scheme on a `torch.Generator`:
    fan-in-scaled normal for dense weights, unit normal for the
    embedding, zeros for norms and the SSM's `a_log`, `dt_bias` and
    `d_skip`. Draws are f32 on the generator's device, then cast to
    `dtype`; tensors are drawn in call order. The numbers differ from
    `jax.random`'s for the same seed (compare through
    `lm.numpy_params` + `lm.from_reference` instead)."""

    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _normal(self, shape, std: float) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return (t * std).to(self.dtype)

    def dense(self, shape, fan_in: int) -> torch.Tensor:
        return self._normal(shape, 1.0 / math.sqrt(max(fan_in, 1)))

    def embed(self, shape) -> torch.Tensor:
        return self._normal(shape, 1.0)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


__all__ = ["ACTIVATIONS", "ParamInit", "activation", "compute_dtype",
           "glu_activation", "glu_ffn", "mlp_ffn", "rms_norm", "rope"]
