"""Top-level language model of the port: embedding, the layer stack,
head; prefill and decode for serving.

The counterpart of `repro.models.lm` for the pure-Mamba stack
(Mamba2-1.3B): every layer is (mixer "mamba", ffn "none", no cross
attention). A layer plan with attention, MLA, MoE or cross attention
raises `NotImplementedError` naming the ROADMAP item that brings it.

Differences of form from the reference, none of substance:
* the stack is an `nn.ModuleList` run by a Python loop, not a
  `lax.scan` over layer groups; caches are a list with one dict per
  layer;
* the weights live in the compute dtype (bf16 for the published
  config), cast once when the model is built, where the reference keeps
  f32 masters and casts them on every call;
* decode takes no `kv_len`: a Mamba layer reads no positions.

`numpy_params` and `from_reference` carry weights across packages: the
first fills the reference's parameter tree from numpy, the second loads
such a tree (from either) into the port.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models import mamba as mb
from repro_torch.models.common import ParamInit, compute_dtype, rms_norm

_NOT_PORTED = {
    "attn": "11b (B3 through an attention model's serve path)",
    "mla": "11c (MoE; MLA comes with DeepSeek-V2)",
    "moe": "11c (MoE)",
    "dense": "11b (B3 through an attention model's serve path)",
    "cross": "11b (B3 through an attention model's serve path)",
}


# ------------------------------------------------------------- layer plan
def layer_plan(cfg, L: int, decoder: bool):
    """[(mixer, ffn, cross)] per layer. mixer: attn|mla|mamba; ffn:
    dense|moe|none (the reference's `layer_plan`)."""
    sigs = []
    for l in range(L):
        if cfg.ssm_inner and not cfg.is_attn_layer(l):
            mixer = "mamba"
        else:
            mixer = "mla" if cfg.mla else "attn"
        if cfg.is_moe_layer(l):
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "dense"
        else:
            ffn = "none"
        sigs.append((mixer, ffn, cfg.enc_dec and decoder))
    return sigs


def _require_pure_mamba(cfg, sigs) -> None:
    for mixer, ffn, cross in sigs:
        part = ("cross" if cross else mixer if mixer != "mamba"
                else ffn if ffn != "none" else None)
        if part is not None:
            raise NotImplementedError(
                f"{cfg.name}: layers with {part!r} are not ported yet "
                f"(ROADMAP queue A item {_NOT_PORTED[part]}); the port "
                f"runs pure-Mamba stacks")
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP queue A item {_NOT_PORTED['cross']})")


# ------------------------------------------------------------------ model
class MambaLayer(nn.Module):
    """Pre-norm residual block: x + mixer(rms_norm(x, ln1))."""

    def __init__(self, cfg, ln1: torch.Tensor, mixer: dict):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.mamba = mb.Mamba2Mixer(cfg, mixer)

    def forward(self, x, cache=None, *, force=None):
        o, new_cache = self.mamba(rms_norm(x, self.ln1), cache, force=force)
        return x + o, new_cache


class MambaLM(nn.Module):
    """Embedding, `num_layers` Mamba layers, final norm and head, with
    every weight in the config's compute dtype."""

    def __init__(self, cfg, embed, ln_f, head, layers):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.ln_f = nn.Parameter(ln_f, requires_grad=False)
        self.head = (None if head is None
                     else nn.Parameter(head, requires_grad=False))
        self.layers = nn.ModuleList(
            MambaLayer(cfg, ln1, mixer) for ln1, mixer in layers)


def init_model(cfg, *, seed: int = 0, device="cpu") -> MambaLM:
    """A randomly initialised model (the reference's `ParamFactory`
    scales) drawn from a `torch.Generator` seeded with `seed` on
    `device`, in the config's compute dtype."""
    _require_pure_mamba(cfg, layer_plan(cfg, cfg.num_layers, False))
    init = ParamInit(seed, device, compute_dtype(cfg.dtype))
    d = cfg.d_model
    embed = init.embed((cfg.vocab_size, d))
    ln_f = init.zeros((d,))
    head = None if cfg.tie_embeddings else init.dense((d, cfg.vocab_size),
                                                      fan_in=d)
    layers = [(init.zeros((d,)), mb.mamba_init(init, cfg))
              for _ in range(cfg.num_layers)]
    return MambaLM(cfg, embed, ln_f, head, layers)


# ------------------------------------------------------ weights across
def numpy_params(cfg, seed: int = 0):
    """(params, meta) in the reference's layout — the tree and side table
    that `repro.models.lm.init_model` returns for a pure-Mamba config —
    filled from `np.random.default_rng(seed)` with the reference's
    scales (fan-in-scaled normal, unit-normal embedding, zeros) as f32
    numpy arrays. The same weights then reach the JAX package
    (`jnp.asarray`) and the port (`from_reference`) with no jax on the
    card."""
    sigs = layer_plan(cfg, cfg.num_layers, False)
    _require_pure_mamba(cfg, sigs)
    rng = np.random.default_rng(seed)
    L, d = cfg.num_layers, cfg.d_model
    di, H = cfg.ssm_inner, cfg.ssm_heads
    G, N, kconv = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    c_conv = di + 2 * G * N

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def zeros(shape):
        return np.zeros(shape, np.float32)

    params = {"embed": normal((cfg.vocab_size, d), 1.0),
              "ln_f": zeros((d,))}
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size), 1 / math.sqrt(d))
    mamba = {
        "in_proj": normal((L, d, 2 * di + 2 * G * N + H), 1 / math.sqrt(d)),
        "conv_w": normal((L, kconv, c_conv), 1 / math.sqrt(kconv)),
        "conv_b": zeros((L, c_conv)),
        "a_log": zeros((L, H)),
        "dt_bias": zeros((L, H)),
        "d_skip": zeros((L, H)),
        "norm": zeros((L, di)),
        "out_proj": normal((L, di, d), 1 / math.sqrt(di)),
    }
    params["decoder"] = {"prefix": [], "offsets": [
        {"ln1": zeros((L, d)), "mamba": mamba}]}
    meta = {"decoder": {"sigs": sigs, "period": 1, "groups": L,
                        "pre_n": 0}}
    return params, meta


def from_reference(params, meta, cfg, *, device="cpu") -> MambaLM:
    """The port's model holding the weights of a reference parameter
    tree (`repro.models.lm.init_model`'s or `numpy_params`'s; leaves as
    numpy arrays or anything `np.asarray` takes), cast once to the
    config's compute dtype on `device`. Layer l of the stack is group
    l // period of `params["decoder"]["offsets"][l % period]`, whose
    leaves carry a leading (groups,) axis (a pure-Mamba stack has no
    prefix layers)."""
    md = meta["decoder"]
    _require_pure_mamba(cfg, md["sigs"])
    dtype = compute_dtype(cfg.dtype)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32)).to(device, dtype)

    offsets = params["decoder"]["offsets"]
    layers = []
    for l in range(len(md["sigs"])):
        g, o = divmod(l, md["period"])
        w = offsets[o]
        layers.append((t(w["ln1"][g]),
                       {k: t(w["mamba"][k][g]) for k in mb.PARAM_NAMES}))
    head = params.get("head")
    return MambaLM(cfg, t(params["embed"]), t(params["ln_f"]),
                   None if head is None else t(head), layers)


# ------------------------------------------------------------ entry points
def embed_tokens(model: MambaLM, tokens: torch.Tensor) -> torch.Tensor:
    x = model.embed[tokens]
    if model.cfg.scale_embed:
        x = x * math.sqrt(model.cfg.d_model)
    return x


def lm_logits(model: MambaLM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.ln_f)
    return x @ (model.embed.T if model.head is None else model.head)


def init_cache(cfg, B: int, *, device="cpu"):
    """Zero decode caches, one dict per layer: the conv window in the
    compute dtype, the SSD state in f32 (the reference's layout)."""
    c_conv = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return [{"conv": torch.zeros(B, cfg.ssm_conv - 1, c_conv,
                                 dtype=compute_dtype(cfg.dtype),
                                 device=device),
             "ssd": torch.zeros(B, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state, dtype=torch.float32,
                                device=device)}
            for _ in range(cfg.num_layers)]


def forward_prefill(model: MambaLM, tokens: torch.Tensor, cache, *,
                    force: Optional[str] = None):
    """Runs the prompt tokens (B, S) through the stack, filling a new
    cache from `cache`'s template; returns (last-token logits (B, 1, V),
    cache). `force` pins the SSD scan's path (`ops.ssd_scan`)."""
    x = embed_tokens(model, tokens)
    new = []
    for layer, c in zip(model.layers, cache):
        x, nc = layer(x, c, force=force)
        new.append(nc)
    return lm_logits(model, x[:, -1:]), new


def forward_decode(model: MambaLM, tokens: torch.Tensor, cache):
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V),
    cache)."""
    x = embed_tokens(model, tokens)
    new = []
    for layer, c in zip(model.layers, cache):
        x, nc = layer(x, c)
        new.append(nc)
    return lm_logits(model, x), new


__all__ = ["MambaLM", "embed_tokens", "forward_decode", "forward_prefill",
           "from_reference", "init_cache", "init_model", "layer_plan",
           "lm_logits", "numpy_params"]
