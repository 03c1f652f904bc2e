"""Top-level language model of the port: embedding, the layer stack,
head; prefill and decode for serving.

The counterpart of `repro.models.lm` for decoder-only stacks: each
layer a mixer ("attn" GQA, "mla" DeepSeek-V2's latent attention, or
"mamba") and an FFN ("dense", gated SwiGLU/GeGLU or the plain MLP;
"moe"; or "none"), in any mix: pure Mamba (Mamba2-1.3B), dense attention
(StarCoder2-3B), MoE on every layer (Qwen3-MoE), MLA with a leading
dense layer (DeepSeek-V2), and the Mamba/attention hybrid with MoE every
other layer (Jamba). `layer_plan` picks each layer's parts and
`DecoderLayer` applies them as the reference's `_apply_layer` does. A
plan with cross attention or an encoder-decoder stack raises
`NotImplementedError` naming the ROADMAP item that brings it.

Differences of form from the reference, none of substance:
* the stack is an `nn.ModuleList` run by a Python loop, not a
  `lax.scan` over layer groups; caches are a list with one dict per
  layer;
* the weights live in the compute dtype (bf16 for the published
  configs), cast once when the model is built, where the reference
  keeps f32 masters and casts them on every call;
* the attention layers update their caches in place
  (`models.attention`); decode takes `kv_len` as a Python int.

`numpy_params` and `from_reference` carry weights across packages: the
first fills the reference's parameter tree (leading dense layers under
"prefix", the periodic layers stacked by their offset in the period
under "offsets") from numpy, the second loads such a tree (from either)
into the port.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe
from repro_torch.models.common import (ParamInit, compute_dtype,
                                       glu_activation, glu_ffn, mlp_ffn,
                                       rms_norm)

_DENSE = "11f (the catalog's other dense and encoder-decoder models)"
GATED = ("swiglu", "geglu")   # activations whose dense FFN is `glu_ffn`


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


def period(cfg) -> int:
    """Layers in one repeat of the plan after the leading dense layers:
    the attention period, widened to a multiple of the MoE period (the
    reference's `_period`; 8 for Jamba)."""
    p = cfg.attn_period or 1
    if cfg.num_experts and cfg.moe_period > 1:
        p = math.lcm(p, cfg.moe_period)
    return p


def _check_plan(cfg, sigs) -> None:
    """Raise `NotImplementedError` for a plan with cross attention or an
    encoder-decoder stack, which the port does not run yet."""
    if cfg.enc_dec or any(cross for _, _, cross in sigs):
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder stacks and cross attention are "
            f"not ported yet (ROADMAP queue A item {_DENSE}); the port runs "
            f"decoder-only stacks")


# ------------------------------------------------------------------ model
def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseFFN(nn.Module):
    """The dense FFN over fixed weights: gated (`glu_ffn` over wi_gate
    and wi_up (d, d_ff) and wo (d_ff, d)) for a SwiGLU or GeGLU config,
    else the plain 2-matrix `mlp_ffn` over wi (d, d_ff) and wo."""

    def __init__(self, cfg, weights: dict):
        super().__init__()
        self.cfg = cfg
        self.gated = cfg.activation in GATED
        for name, w in weights.items():
            self.register_parameter(name, _frozen(w))

    def forward(self, x):
        if self.gated:
            return glu_ffn(x, self.wi_gate, self.wi_up, self.wo,
                           glu_activation(self.cfg))
        return mlp_ffn(x, self.wi, self.wo, self.cfg.activation)


class DecoderLayer(nn.Module):
    """One layer of the reference's `_apply_layer`: x + mixer(rms_norm(x,
    ln1)), then, with an FFN, x + ffn(rms_norm(x, ln2)). `w` holds the
    layer's weights in the reference tree's names: ln1 and "attn" (GQA or
    MLA) or "mamba", plus ln2 and "ffn" (dense) or "moe"."""

    def __init__(self, cfg, sig, w: dict):
        super().__init__()
        mixer, ffn, _ = sig
        self.mixer, self.ffn_kind = mixer, ffn
        self.ln1 = _frozen(w["ln1"])
        self.is_attn = mixer != "mamba"
        if mixer == "attn":
            self.attn = attn.GQAAttention(cfg, w["attn"])
        elif mixer == "mla":
            self.attn = attn.MLAAttention(cfg, w["attn"])
        else:
            self.mamba = mb.Mamba2Mixer(cfg, w["mamba"])
        self.has_ffn = ffn == "dense"
        if ffn != "none":
            self.ln2 = _frozen(w["ln2"])
        if ffn == "dense":
            self.ffn = DenseFFN(cfg, w["ffn"])
        elif ffn == "moe":
            self.moe = moe.MoEFFN(cfg, w["moe"])

    def forward(self, x, cache=None, *, positions=None,
                kv_len: Optional[int] = None, force: Optional[str] = None):
        h = rms_norm(x, self.ln1)
        if self.is_attn:
            o, cache = self.attn(h, positions, cache, kv_len=kv_len,
                                 force=force)
        else:
            o, cache = self.mamba(h, cache, force=force)
        x = x + o
        if self.ffn_kind == "dense":
            x = x + self.ffn(rms_norm(x, self.ln2))
        elif self.ffn_kind == "moe":
            x = x + self.moe(rms_norm(x, self.ln2))
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


def _init_layer(init, cfg, sig) -> dict:
    """One layer's weights for `sig`, drawn through `init` (a `ParamInit`
    or `_NumpyDraws`) at the reference's fan-ins, in its tree's names."""
    mixer, ffn, _ = sig
    d, f = cfg.d_model, cfg.d_ff
    w = {"ln1": init.zeros((d,))}
    if mixer == "attn":
        w["attn"] = attn.gqa_init(init, cfg)
    elif mixer == "mla":
        w["attn"] = attn.mla_init(init, cfg)
    else:
        w["mamba"] = mb.mamba_init(init, cfg)
    if ffn == "dense":
        w["ln2"] = init.zeros((d,))
        if cfg.activation in GATED:
            w["ffn"] = {"wi_gate": init.dense((d, f), fan_in=d),
                        "wi_up": init.dense((d, f), fan_in=d),
                        "wo": init.dense((f, d), fan_in=f)}
        else:
            w["ffn"] = {"wi": init.dense((d, f), fan_in=d),
                        "wo": init.dense((f, d), fan_in=f)}
    elif ffn == "moe":
        w["ln2"] = init.zeros((d,))
        w["moe"] = moe.moe_init(init, cfg)
    return w


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
    layers = [_init_layer(init, cfg, sig) for sig in sigs]
    return DecoderLM(cfg, embed, ln_f, head, layers)


# ------------------------------------------------------ weights across
_CHUNK = 1 << 22   # elements of a leaf drawn from one numpy generator


class _NumpyDraws:
    """`ParamInit`'s interface over numpy, for `numpy_params`: f32 arrays
    with the leading axis `lead` in front of each shape. Leaf i (in draw
    order) is drawn in chunks of `_CHUNK` elements, chunk c from
    `np.random.default_rng([seed, i, c])`, on the threads of `pool` (the
    draws of the published widths run to billions of normals)."""

    def __init__(self, seed: int, pool: ThreadPoolExecutor):
        self.seed, self.pool = seed, pool
        self.lead: tuple = ()
        self.leaves = 0

    def _normal(self, shape, std: float) -> np.ndarray:
        out = np.empty(self.lead + tuple(shape), np.float32)
        flat, leaf = out.reshape(-1), self.leaves
        self.leaves += 1

        def fill(c):
            part = flat[c * _CHUNK:(c + 1) * _CHUNK]
            np.random.default_rng([self.seed, leaf, c]).standard_normal(
                out=part, dtype=np.float32)
            part *= np.float32(std)

        list(self.pool.map(fill, range(-(-flat.size // _CHUNK))))
        return out

    def dense(self, shape, fan_in: int) -> np.ndarray:
        return self._normal(shape, 1.0 / math.sqrt(max(fan_in, 1)))

    def embed(self, shape) -> np.ndarray:
        return self._normal(shape, 1.0)

    def zeros(self, shape) -> np.ndarray:
        return np.zeros(self.lead + tuple(shape), np.float32)


def numpy_params(cfg, seed: int = 0):
    """(params, meta) in the reference's layout — the tree and side table
    that `repro.models.lm.init_model` returns for a decoder-only config:
    "embed", "ln_f", "head" and "decoder" = {"prefix": the
    `first_dense_layers` leading layers, each leaf with a leading axis
    of 1; "offsets": one tree per offset o in the period, each leaf
    stacked over the groups of layers pre_n + o + g period} — filled
    with the reference's scales (fan-in-scaled normal, unit-normal
    embedding, zeros) as f32 numpy arrays (see `_NumpyDraws` for the
    draws). The same weights then reach the JAX package (`jnp.asarray`)
    and the port (`from_reference`) with no jax on the card."""
    sigs = layer_plan(cfg, cfg.num_layers, False)
    _check_plan(cfg, sigs)
    p, pre_n = period(cfg), cfg.first_dense_layers
    groups, rest = divmod(cfg.num_layers - pre_n, p)
    if rest:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers after "
                         f"{pre_n} leading ones is no multiple of the "
                         f"period {p}")
    d = cfg.d_model
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        draws = _NumpyDraws(seed, pool)
        params = {"embed": draws.embed((cfg.vocab_size, d)),
                  "ln_f": draws.zeros((d,))}
        if not cfg.tie_embeddings:
            params["head"] = draws.dense((d, cfg.vocab_size), fan_in=d)
        draws.lead = (1,)
        prefix = [_init_layer(draws, cfg, sigs[l]) for l in range(pre_n)]
        draws.lead = (groups,)
        offsets = [_init_layer(draws, cfg, sigs[pre_n + o])
                   for o in range(p)]
    params["decoder"] = {"prefix": prefix, "offsets": offsets}
    meta = {"decoder": {"sigs": sigs, "period": p, "groups": groups,
                        "pre_n": pre_n}}
    return params, meta


def from_reference(params, meta, cfg, *, device="cpu") -> DecoderLM:
    """The port's model holding the weights of a reference parameter
    tree (`repro.models.lm.init_model`'s or `numpy_params`'s; leaves as
    numpy arrays or anything `np.asarray` takes), cast once to the
    config's compute dtype on `device`. Layer l < pre_n is
    `params["decoder"]["prefix"][l]` (leaves with a leading axis of 1);
    layer l >= pre_n is group (l - pre_n) // period of
    `params["decoder"]["offsets"][(l - pre_n) % period]`, whose leaves
    carry a leading (groups,) axis."""
    md = meta["decoder"]
    _check_plan(cfg, md["sigs"])
    dtype = compute_dtype(cfg.dtype)
    pre_n, p = md["pre_n"], md["period"]

    def t(x):
        return torch.tensor(np.asarray(x, np.float32)).to(device, dtype)

    def take(tree, g):
        if isinstance(tree, dict):
            return {k: take(v, g) for k, v in tree.items()}
        return t(tree[g])

    dec = params["decoder"]
    layers = [take(dec["prefix"][l], 0) for l in range(pre_n)]
    layers += [take(dec["offsets"][(l - pre_n) % p], (l - pre_n) // p)
               for l in range(pre_n, len(md["sigs"]))]
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
    a GQA layer's k and v (B, max_len, Hkv, Dh) and an MLA layer's ckv
    (B, max_len, kv_lora_rank) and krope (B, max_len, rope_head_dim) in
    the compute dtype; a Mamba layer's conv window in the compute dtype
    and SSD state in f32 (`max_len` does not apply to them)."""
    dt = compute_dtype(cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    caches = []
    for mixer, _, _ in layer_plan(cfg, cfg.num_layers, False):
        if mixer == "attn":
            shape = (B, max_len, cfg.num_kv_heads, cfg.head_dim)
            caches.append({"k": zeros(*shape), "v": zeros(*shape)})
            continue
        if mixer == "mla":
            caches.append({"ckv": zeros(B, max_len, cfg.kv_lora_rank),
                           "krope": zeros(B, max_len, cfg.rope_head_dim)})
            continue
        c_conv = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        caches.append({
            "conv": zeros(B, cfg.ssm_conv - 1, c_conv),
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
           "layer_plan", "lm_logits", "numpy_params", "period"]
