"""Top-level language model of the port: embedding, the layer stack,
head; prefill and decode for serving.

The counterpart of `repro.models.lm` for two kinds of stack: pure Mamba
(Mamba2-1.3B, every layer (mixer "mamba", ffn "none")) and dense
attention (StarCoder2-3B, every layer (mixer "attn", ffn "dense") with
the plain MLP). `layer_plan` picks each layer's parts and
`DecoderLayer` applies them as the reference's `_apply_layer` does. A
plan with anything else (a stack mixing Mamba and attention, MLA, MoE, a
gated FFN, a Mamba layer with an FFN, cross attention) raises
`NotImplementedError` naming the ROADMAP item that brings it.

Differences of form from the reference, none of substance:
* the stack is an `nn.ModuleList` run by a Python loop, not a
  `lax.scan` over layer groups; caches are a list with one dict per
  layer;
* the weights live in the compute dtype (bf16 for the published
  configs), cast once when the model is built, where the reference
  keeps f32 masters and casts them on every call;
* the attention layers update their KV cache in place
  (`models.attention`); decode takes `kv_len` as a Python int.

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

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.common import (ACTIVATIONS, ParamInit,
                                       compute_dtype, mlp_ffn, rms_norm)

_HYBRID = "11d (the Mamba/attention hybrid)"
_MOE = "11c (MoE)"
_DENSE = "11f (the catalog's other dense and encoder-decoder models)"


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


def _unported(cfg, sig) -> Optional[tuple]:
    """(what, ROADMAP item) of a layer the port cannot run, else None."""
    mixer, ffn, cross = sig
    if cross or cfg.enc_dec:
        return "encoder-decoder cross attention", _DENSE
    if mixer == "mla":
        return "MLA", "11c (MoE; MLA comes with DeepSeek-V2)"
    if ffn == "moe":
        return "MoE FFNs", _MOE
    if mixer == "mamba" and ffn != "none":
        return "Mamba layers with an FFN", _HYBRID
    if mixer == "mamba":
        return None
    if ffn != "dense":
        return "attention layers without an FFN", _DENSE
    if cfg.activation not in ACTIVATIONS:
        return f"the gated {cfg.activation} FFN", _DENSE
    return None


def _check_plan(cfg, sigs) -> None:
    """Raise `NotImplementedError` unless the stack is pure Mamba or pure
    attention and every layer of `sigs` is one the port runs."""
    if len({mixer for mixer, _, _ in sigs}) > 1:
        raise NotImplementedError(
            f"{cfg.name}: stacks mixing Mamba and attention layers are not "
            f"ported yet (ROADMAP queue A item {_HYBRID})")
    for sig in sigs:
        bad = _unported(cfg, sig)
        if bad is not None:
            raise NotImplementedError(
                f"{cfg.name}: {bad[0]} are not ported yet (ROADMAP queue A "
                f"item {bad[1]}); the port runs pure-Mamba and "
                f"dense-attention stacks")


# ------------------------------------------------------------------ model
def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseFFN(nn.Module):
    """The plain 2-matrix FFN (`mlp_ffn`) over fixed weights wi (d, d_ff)
    and wo (d_ff, d)."""

    def __init__(self, cfg, weights: dict):
        super().__init__()
        self.act = cfg.activation
        self.wi = _frozen(weights["wi"])
        self.wo = _frozen(weights["wo"])

    def forward(self, x):
        return mlp_ffn(x, self.wi, self.wo, self.act)


class DecoderLayer(nn.Module):
    """One layer of the reference's `_apply_layer`: x + mixer(rms_norm(x,
    ln1)), then, with a dense FFN, x + ffn(rms_norm(x, ln2)). `w` holds
    the layer's weights in the reference tree's names: ln1 and "mamba"
    or "attn", plus ln2 and "ffn" with a dense FFN."""

    def __init__(self, cfg, sig, w: dict):
        super().__init__()
        mixer, ffn, _ = sig
        self.ln1 = _frozen(w["ln1"])
        self.is_attn = mixer == "attn"
        if self.is_attn:
            self.attn = attn.GQAAttention(cfg, w["attn"])
        else:
            self.mamba = mb.Mamba2Mixer(cfg, w["mamba"])
        self.has_ffn = ffn == "dense"
        if self.has_ffn:
            self.ln2 = _frozen(w["ln2"])
            self.ffn = DenseFFN(cfg, w["ffn"])

    def forward(self, x, cache=None, *, positions=None,
                kv_len: Optional[int] = None, force: Optional[str] = None):
        h = rms_norm(x, self.ln1)
        if self.is_attn:
            o, cache = self.attn(h, positions, cache, kv_len=kv_len,
                                 force=force)
        else:
            o, cache = self.mamba(h, cache, force=force)
        x = x + o
        if self.has_ffn:
            x = x + self.ffn(rms_norm(x, self.ln2))
        return x, cache


class DecoderLM(nn.Module):
    """Embedding, `num_layers` decoder layers, final norm and head, with
    every weight in the config's compute dtype. `layers` holds one
    weight dict per layer (see `DecoderLayer`)."""

    def __init__(self, cfg, embed, ln_f, head, layers):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.ln_f = _frozen(ln_f)
        self.head = None if head is None else _frozen(head)
        sigs = layer_plan(cfg, len(layers), False)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, sig, w) for sig, w in zip(sigs, layers))


def _dense_ffn_shapes(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": ((d, f), d), "wo": ((f, d), f)}


def init_model(cfg, *, seed: int = 0, device="cpu") -> DecoderLM:
    """A randomly initialised model (the reference's `ParamFactory`
    scales) drawn from a `torch.Generator` seeded with `seed` on
    `device`, in the config's compute dtype."""
    sigs = layer_plan(cfg, cfg.num_layers, False)
    _check_plan(cfg, sigs)
    init = ParamInit(seed, device, compute_dtype(cfg.dtype))
    d = cfg.d_model
    embed = init.embed((cfg.vocab_size, d))
    ln_f = init.zeros((d,))
    head = None if cfg.tie_embeddings else init.dense((d, cfg.vocab_size),
                                                      fan_in=d)
    layers = []
    for mixer, ffn, _ in sigs:
        w = {"ln1": init.zeros((d,))}
        if mixer == "attn":
            w["attn"] = attn.gqa_init(init, cfg)
        else:
            w["mamba"] = mb.mamba_init(init, cfg)
        if ffn == "dense":
            w["ln2"] = init.zeros((d,))
            w["ffn"] = {k: init.dense(shape, fan_in=fan)
                        for k, (shape, fan) in _dense_ffn_shapes(cfg).items()}
        layers.append(w)
    return DecoderLM(cfg, embed, ln_f, head, layers)


# ------------------------------------------------------ weights across
def numpy_params(cfg, seed: int = 0):
    """(params, meta) in the reference's layout — the tree and side table
    that `repro.models.lm.init_model` returns for a pure-Mamba or
    dense-attention config — filled from `np.random.default_rng(seed)`
    with the reference's scales (fan-in-scaled normal, unit-normal
    embedding, zeros) as f32 numpy arrays. The same weights then reach
    the JAX package (`jnp.asarray`) and the port (`from_reference`) with
    no jax on the card."""
    sigs = layer_plan(cfg, cfg.num_layers, False)
    _check_plan(cfg, sigs)
    rng = np.random.default_rng(seed)
    L, d = cfg.num_layers, cfg.d_model

    def normal(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            1 / math.sqrt(fan_in))

    def zeros(shape):
        return np.zeros(shape, np.float32)

    params = {"embed": normal((cfg.vocab_size, d), 1), "ln_f": zeros((d,))}
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size), d)
    layer = {"ln1": zeros((L, d))}
    if sigs[0][0] == "attn":
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        layer["attn"] = {"wq": normal((L, d, H, Dh), d),
                         "wk": normal((L, d, Hkv, Dh), d),
                         "wv": normal((L, d, Hkv, Dh), d),
                         "wo": normal((L, H, Dh, d), H * Dh)}
        if cfg.qk_norm:
            layer["attn"]["qnorm"] = zeros((L, Dh))
            layer["attn"]["knorm"] = zeros((L, Dh))
        layer["ln2"] = zeros((L, d))
        layer["ffn"] = {k: normal((L,) + shape, fan)
                        for k, (shape, fan) in _dense_ffn_shapes(cfg).items()}
    else:
        di, H = cfg.ssm_inner, cfg.ssm_heads
        G, N, kconv = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
        c_conv = di + 2 * G * N
        layer["mamba"] = {
            "in_proj": normal((L, d, 2 * di + 2 * G * N + H), d),
            "conv_w": normal((L, kconv, c_conv), kconv),
            "conv_b": zeros((L, c_conv)),
            "a_log": zeros((L, H)),
            "dt_bias": zeros((L, H)),
            "d_skip": zeros((L, H)),
            "norm": zeros((L, di)),
            "out_proj": normal((L, di, d), di),
        }
    params["decoder"] = {"prefix": [], "offsets": [layer]}
    meta = {"decoder": {"sigs": sigs, "period": 1, "groups": L,
                        "pre_n": 0}}
    return params, meta


def from_reference(params, meta, cfg, *, device="cpu") -> DecoderLM:
    """The port's model holding the weights of a reference parameter
    tree (`repro.models.lm.init_model`'s or `numpy_params`'s; leaves as
    numpy arrays or anything `np.asarray` takes), cast once to the
    config's compute dtype on `device`. Layer l of the stack is group
    l // period of `params["decoder"]["offsets"][l % period]`, whose
    leaves carry a leading (groups,) axis (the stacks the port runs have
    no prefix layers)."""
    md = meta["decoder"]
    _check_plan(cfg, md["sigs"])
    dtype = compute_dtype(cfg.dtype)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32)).to(device, dtype)

    def take(tree, g):
        if isinstance(tree, dict):
            return {k: take(v, g) for k, v in tree.items()}
        return t(tree[g])

    offsets = params["decoder"]["offsets"]
    layers = [take(offsets[l % md["period"]], l // md["period"])
              for l in range(len(md["sigs"]))]
    head = params.get("head")
    return DecoderLM(cfg, t(params["embed"]), t(params["ln_f"]),
                     None if head is None else t(head), layers)


# ------------------------------------------------------------ entry points
def embed_tokens(model: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
    x = model.embed[tokens]
    if model.cfg.scale_embed:
        x = x * math.sqrt(model.cfg.d_model)
    return x


def lm_logits(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.ln_f)
    return x @ (model.embed.T if model.head is None else model.head)


def init_cache(cfg, B: int, max_len: int, *, device="cpu"):
    """Zero decode caches, one dict per layer, in the reference's layout:
    an attention layer's k and v (B, max_len, Hkv, Dh) in the compute
    dtype; a Mamba layer's conv window in the compute dtype and SSD
    state in f32 (`max_len` does not apply to them)."""
    dt = compute_dtype(cfg.dtype)
    caches = []
    for mixer, _, _ in layer_plan(cfg, cfg.num_layers, False):
        if mixer == "attn":
            shape = (B, max_len, cfg.num_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=dt, device=device),
                           "v": torch.zeros(shape, dtype=dt, device=device)})
            continue
        c_conv = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        caches.append({
            "conv": torch.zeros(B, cfg.ssm_conv - 1, c_conv, dtype=dt,
                                device=device),
            "ssd": torch.zeros(B, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state, dtype=torch.float32,
                               device=device)})
    return caches


def forward_prefill(model: DecoderLM, tokens: torch.Tensor, cache, *,
                    force: Optional[str] = None):
    """Runs the prompt tokens (B, S) at positions 0..S-1 through the
    stack, filling the cache (attention layers write rows [0, S) of
    theirs in place, Mamba layers return new ones); returns (last-token
    logits (B, 1, V), cache). `force` pins the path of the prefill
    kernels (`ops.ssd_scan`, `ops.flash_attention`)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    x = embed_tokens(model, tokens)
    new = []
    for layer, c in zip(model.layers, cache):
        x, nc = layer(x, c, positions=positions, force=force)
        new.append(nc)
    return lm_logits(model, x[:, -1:]), new


def forward_decode(model: DecoderLM, tokens: torch.Tensor, cache,
                   kv_len: int):
    """One decode step of tokens (B, 1) at position `kv_len`, the number
    of tokens the cache holds. Returns (logits (B, 1, V), cache)."""
    positions = torch.full((tokens.shape[0], 1), kv_len,
                           device=tokens.device)
    x = embed_tokens(model, tokens)
    new = []
    for layer, c in zip(model.layers, cache):
        x, nc = layer(x, c, positions=positions, kv_len=kv_len)
        new.append(nc)
    return lm_logits(model, x), new


__all__ = ["DecoderLM", "embed_tokens", "forward_decode",
           "forward_prefill", "from_reference", "init_cache", "init_model",
           "layer_plan", "lm_logits", "numpy_params"]
