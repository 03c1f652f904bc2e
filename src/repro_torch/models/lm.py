"""Top-level language model of the port: embedding, the layer stack,
head; prefill and decode for serving.

The counterpart of `repro.models.lm`: each layer a mixer ("attn" GQA,
"mla" DeepSeek-V2's latent attention, or "mamba") and an FFN ("dense",
gated SwiGLU/GeGLU or the plain MLP; "moe"; or "none"), in any mix:
pure Mamba (Mamba2-1.3B), dense attention (StarCoder2-3B, Gemma-7B,
DeepSeek-7B, DeepSeek-Coder-33B, Chameleon-34B), MoE on every layer
(Qwen3-MoE), MLA with a leading dense layer (DeepSeek-V2), and the
Mamba/attention hybrid with MoE every other layer (Jamba). `layer_plan`
picks each layer's parts and `DecoderLayer` applies them as the
reference's `_apply_layer` does.

An encoder-decoder config (SeamlessM4T) adds an encoder: `enc_layers`
attention layers, non-causal, over the caller's frame embeddings
(`src_embeds`, the audio front end's stub) at positions 0..S_src-1,
then the norm `ln_enc` (`encode`); each decoder layer applies
`ln_cross` and cross attention to the encoder output between its mixer
and its FFN. A prefill encodes once and fills each decoder layer's
"cross_k" and "cross_v" cache (the reference's `_fill_cross`); decode
steps read them.

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
into the port; `reference_leaves` maps any tree of that shape (weights,
gradients, AdamW's moments) to the port's leaf names.

Training (`forward_train_loss`, the reference's `forward_train_loss`)
keeps the weights as f32 masters, an ordered dict by the names of the
model's parameters (`init_masters`, `masters_from_reference`), and
casts them to the compute dtype inside the loss (the reference's
`cast_params`), so that the gradients reach the masters through the
cast. The layers run through `torch.func.functional_call` on a model
skeleton whose own parameters are never read (`skeleton`, on the meta
device); the serving model, its frozen parameters and its forward stay
as they are.
"""
from __future__ import annotations

import dataclasses
import math
import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe
from repro_torch.models.common import (ParamInit, compute_dtype,
                                       glu_activation, glu_ffn, mlp_ffn,
                                       rms_norm)

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


def stack_meta(cfg, decoder: bool) -> dict:
    """The reference's side table of one stack: its plan ("sigs"), the
    period (1 for an encoder), the groups and the leading dense layers
    ("pre_n"); the decoder stack, or with `decoder` False an
    encoder-decoder config's encoder (`enc_layers` layers)."""
    L = cfg.num_layers if decoder else cfg.enc_layers
    p = period(cfg) if decoder else 1
    pre_n = cfg.first_dense_layers
    groups, rest = divmod(L - pre_n, p)
    if rest:
        raise ValueError(f"{cfg.name}: {L} layers after {pre_n} leading "
                         f"ones is no multiple of the period {p}")
    return {"sigs": layer_plan(cfg, L, decoder), "period": p,
            "groups": groups, "pre_n": pre_n}


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
    ln1)), then, with cross attention, x + cross(rms_norm(x, ln_cross)),
    then, with an FFN, x + ffn(rms_norm(x, ln2)). `w` holds the layer's
    weights in the reference tree's names: ln1 and "attn" (GQA or MLA)
    or "mamba", ln_cross and "cross" (GQA) for a cross-attending layer,
    plus ln2 and "ffn" (dense) or "moe". An encoder's layers are this
    class too, run with `causal=False`."""

    def __init__(self, cfg, sig, w: dict):
        super().__init__()
        mixer, ffn, cross = sig
        self.mixer, self.ffn_kind, self.has_cross = mixer, ffn, cross
        self.ln1 = _frozen(w["ln1"])
        self.is_attn = mixer != "mamba"
        if mixer == "attn":
            self.attn = attn.GQAAttention(cfg, w["attn"])
        elif mixer == "mla":
            self.attn = attn.MLAAttention(cfg, w["attn"])
        else:
            self.mamba = mb.Mamba2Mixer(cfg, w["mamba"])
        if cross:
            self.ln_cross = _frozen(w["ln_cross"])
            self.cross = attn.GQAAttention(cfg, w["cross"])
        self.has_ffn = ffn == "dense"
        if ffn != "none":
            self.ln2 = _frozen(w["ln2"])
        if ffn == "dense":
            self.ffn = DenseFFN(cfg, w["ffn"])
        elif ffn == "moe":
            self.moe = moe.MoEFFN(cfg, w["moe"])

    def forward(self, x, cache=None, *, positions=None,
                kv_len: Optional[int] = None, force: Optional[str] = None,
                causal: bool = True, cross_kv=None):
        """`causal` False makes an attention mixer's prefill non-causal
        (an encoder's); a cross-attending layer reads the "cross_k" and
        "cross_v" of its `cache`, or `cross_kv` = (k, v) when given (the
        train loss, which runs without caches)."""
        h = rms_norm(x, self.ln1)
        if self.mixer == "attn":
            o, cache = self.attn(h, positions, cache, kv_len=kv_len,
                                 force=force, causal=causal)
        elif self.is_attn:
            o, cache = self.attn(h, positions, cache, kv_len=kv_len,
                                 force=force)
        else:
            o, cache = self.mamba(h, cache, force=force)
        x = x + o
        if self.has_cross:
            k, v = cross_kv if cross_kv is not None else (
                cache["cross_k"], cache["cross_v"])
            x = x + self.cross.cross(rms_norm(x, self.ln_cross), k, v,
                                     decode=kv_len is not None, force=force)
        if self.ffn_kind == "dense":
            x = x + self.ffn(rms_norm(x, self.ln2))
        elif self.ffn_kind == "moe":
            x = x + self.moe(rms_norm(x, self.ln2))
        return x, cache


class DecoderLM(nn.Module):
    """Embedding, `num_layers` decoder layers, final norm and head, with
    every weight in the config's compute dtype; for an encoder-decoder
    config also the encoder's layers and its norm `ln_enc`. `layers`
    (and `encoder`) hold one weight dict per layer (see
    `DecoderLayer`)."""

    def __init__(self, cfg, embed, ln_f, head, layers, encoder=(),
                 ln_enc=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.ln_f = _frozen(ln_f)
        self.head = None if head is None else _frozen(head)
        sigs = layer_plan(cfg, len(layers), True)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, sig, w) for sig, w in zip(sigs, layers))
        if cfg.enc_dec:
            esigs = layer_plan(cfg, len(encoder), False)
            self.encoder = nn.ModuleList(
                DecoderLayer(cfg, sig, w) for sig, w in zip(esigs, encoder))
            self.ln_enc = _frozen(ln_enc)


def _init_layer(init, cfg, sig) -> dict:
    """One layer's weights for `sig`, drawn through `init` (a `ParamInit`
    or `_NumpyDraws`) at the reference's fan-ins, in its tree's names."""
    mixer, ffn, cross = sig
    d, f = cfg.d_model, cfg.d_ff
    w = {"ln1": init.zeros((d,))}
    if mixer == "attn":
        w["attn"] = attn.gqa_init(init, cfg)
    elif mixer == "mla":
        w["attn"] = attn.mla_init(init, cfg)
    else:
        w["mamba"] = mb.mamba_init(init, cfg)
    if cross:
        w["ln_cross"] = init.zeros((d,))
        w["cross"] = attn.gqa_init(init, cfg)
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
    return _build(cfg, ParamInit(seed, device, compute_dtype(cfg.dtype)))


def _build(cfg, init) -> DecoderLM:
    """The model with every weight drawn through `init`, in the
    reference's order: embed, ln_f, head, the encoder's layers, the
    decoder's, ln_enc."""
    d = cfg.d_model
    embed = init.embed((cfg.vocab_size, d))
    ln_f = init.zeros((d,))
    head = None if cfg.tie_embeddings else init.dense((d, cfg.vocab_size),
                                                      fan_in=d)
    encoder = [_init_layer(init, cfg, sig) for sig in
               layer_plan(cfg, cfg.enc_layers, False)] if cfg.enc_dec else []
    layers = [_init_layer(init, cfg, sig)
              for sig in layer_plan(cfg, cfg.num_layers, True)]
    ln_enc = init.zeros((d,)) if cfg.enc_dec else None
    return DecoderLM(cfg, embed, ln_f, head, layers, encoder, ln_enc)


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
    that `repro.models.lm.init_model` returns: "embed", "ln_f", "head"
    and "decoder" = {"prefix": the `first_dense_layers` leading layers,
    each leaf with a leading axis of 1; "offsets": one tree per offset o
    in the period, each leaf stacked over the groups of layers pre_n + o
    + g period}, and for an encoder-decoder config "encoder" (the same
    layout, period 1) and "ln_enc" — filled with the reference's scales
    (fan-in-scaled normal, unit-normal embedding, zeros) as f32 numpy
    arrays (see `_NumpyDraws` for the draws). The same weights then
    reach the JAX package (`jnp.asarray`) and the port
    (`from_reference`) with no jax on the card."""
    stacks = (("encoder", False), ("decoder", True)) if cfg.enc_dec \
        else (("decoder", True),)
    meta = {name: stack_meta(cfg, dec) for name, dec in stacks}
    d = cfg.d_model
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        draws = _NumpyDraws(seed, pool)
        params = {"embed": draws.embed((cfg.vocab_size, d)),
                  "ln_f": draws.zeros((d,))}
        if not cfg.tie_embeddings:
            params["head"] = draws.dense((d, cfg.vocab_size), fan_in=d)
        for name, _ in stacks:
            md = meta[name]
            sigs, pre_n = md["sigs"], md["pre_n"]
            draws.lead = (1,)
            prefix = [_init_layer(draws, cfg, sigs[l]) for l in range(pre_n)]
            draws.lead = (md["groups"],)
            offsets = [_init_layer(draws, cfg, sigs[pre_n + o])
                       for o in range(md["period"])]
            params[name] = {"prefix": prefix, "offsets": offsets}
        draws.lead = ()
        if cfg.enc_dec:
            params["ln_enc"] = draws.zeros((d,))
    return params, meta


def from_reference(params, meta, cfg, *, device="cpu") -> DecoderLM:
    """The port's model holding the weights of a reference parameter
    tree (`repro.models.lm.init_model`'s or `numpy_params`'s; leaves as
    numpy arrays or anything `np.asarray` takes), cast once to the
    config's compute dtype on `device`. Layer l < pre_n is
    `params["decoder"]["prefix"][l]` (leaves with a leading axis of 1);
    layer l >= pre_n is group (l - pre_n) // period of
    `params["decoder"]["offsets"][(l - pre_n) % period]`, whose leaves
    carry a leading (groups,) axis; an encoder-decoder config's encoder
    layers come from `params["encoder"]` alike."""
    dtype = compute_dtype(cfg.dtype)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32)).to(device, dtype)

    def take(tree, g):
        if isinstance(tree, dict):
            return {k: take(v, g) for k, v in tree.items()}
        return t(tree[g])

    def stack(name):
        md, st = meta[name], params[name]
        pre_n, p = md["pre_n"], md["period"]
        out = [take(st["prefix"][l], 0) for l in range(pre_n)]
        return out + [take(st["offsets"][(l - pre_n) % p], (l - pre_n) // p)
                      for l in range(pre_n, len(md["sigs"]))]

    head = params.get("head")
    enc = cfg.enc_dec
    return DecoderLM(cfg, t(params["embed"]), t(params["ln_f"]),
                     None if head is None else t(head), stack("decoder"),
                     stack("encoder") if enc else (),
                     t(params["ln_enc"]) if enc else None)


# ---------------------------------------------------------------- training
class _MetaInit:
    """`ParamInit`'s interface on the meta device: shapes, no storage."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def embed(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=self.dtype, device="meta")

    def dense(self, shape, fan_in: int) -> torch.Tensor:
        return self.embed(shape)

    zeros = embed


def skeleton(cfg) -> DecoderLM:
    """The model's structure on the meta device (no storage): what
    `forward_train_loss` runs its layers through, with the parameters
    it is given."""
    return _build(cfg, _MetaInit(compute_dtype(cfg.dtype)))


def param_names(cfg) -> list:
    """The model's parameter names in order ("embed", "ln_f", "head",
    "layers.<l>.<sub>.<leaf>", then "encoder.<l>.<sub>.<leaf>" and
    "ln_enc" for an encoder-decoder config)."""
    return [n for n, _ in skeleton(cfg).named_parameters()]


def init_masters(cfg, *, seed: int = 0, device="cpu") -> OrderedDict:
    """f32 master weights drawn as `init_model` draws them (a
    `torch.Generator` seeded with `seed` on `device`), by parameter
    name, each requiring its gradient."""
    model = init_model(dataclasses.replace(cfg, dtype="float32"), seed=seed,
                       device=device)
    return OrderedDict((n, p.detach().requires_grad_(True))
                       for n, p in model.named_parameters())


def _reference_slot(cfg, name: str):
    """(path of keys into the reference tree, index along the stacked
    leaf or None) of port leaf `name`."""
    parts = name.split(".")
    if parts[0] not in ("layers", "encoder"):
        return parts, None
    stack = "decoder" if parts[0] == "layers" else "encoder"
    l, pre_n = int(parts[1]), cfg.first_dense_layers
    p = period(cfg) if stack == "decoder" else 1
    if l < pre_n:
        return [stack, "prefix", l] + parts[2:], 0
    return ([stack, "offsets", (l - pre_n) % p] + parts[2:],
            (l - pre_n) // p)


def reference_leaves(tree, cfg, names=None) -> OrderedDict:
    """Any tree shaped like the reference's parameters (its weights,
    their gradients, AdamW's "m" or "v"; `numpy_params`' layout) as the
    port's leaves: {name: the slice of the reference leaf that holds
    it}, in the order of `param_names(cfg)` (or `names`)."""
    out = OrderedDict()
    for n in names or param_names(cfg):
        path, g = _reference_slot(cfg, n)
        leaf = tree
        for key in path:
            leaf = leaf[key]
        out[n] = leaf if g is None else leaf[g]
    return out


def reference_groups(cfg, names=None) -> OrderedDict:
    """{reference leaf path ("decoder.offsets.0.ln1", ...): the port
    leaves stacked along its leading axis, in order}, for every layer
    leaf: what Adafactor factors together (`optim.adafactor`)."""
    groups = OrderedDict()
    for n in names or param_names(cfg):
        path, g = _reference_slot(cfg, n)
        if g is not None:
            groups.setdefault(".".join(map(str, path)), []).append(n)
    return groups


def masters_from_reference(params, cfg, *, device="cpu") -> OrderedDict:
    """f32 masters holding a reference parameter tree's weights
    (`numpy_params`' or `repro.models.lm.init_model`'s), each requiring
    its gradient."""
    return OrderedDict(
        (n, torch.tensor(np.asarray(a, np.float32), device=device)
         .requires_grad_(True))
        for n, a in reference_leaves(params, cfg).items())


def _layer(layer, w, x, positions, force, causal=True, cross_kv=None):
    return torch.func.functional_call(
        layer, w, (x,), {"positions": positions, "force": force,
                         "causal": causal, "cross_kv": cross_kv},
        strict=True)[0]


def _stack_weights(w, prefix: str) -> dict:
    """{leaf name inside the layer: tensor} of the masters under
    `prefix` ("layers.<l>." or "encoder.<l>.")."""
    return {n[len(prefix):]: t for n, t in w.items() if n.startswith(prefix)}


def _head_chunk(x, head, labels):
    """(sum of -log p(label), sum of logz^2) over a chunk of rows: the
    head product in the compute dtype, the softmax in f32."""
    logits = (x @ head).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (logz - gold).sum(), (logz * logz).sum()


def _train_chunk(cfg, B: int, S: int, chunk: int = 512) -> int:
    """Rows of one head chunk: the reference's adaptive rule on one
    device (an f32 logits chunk of at most ~256 MB, at least 16 rows,
    the nearest divisor of S at or below)."""
    per_tok = B * cfg.vocab_size * 4
    chunk = max(16, min(chunk, int(256e6 // max(per_tok, 1))))
    nchunk = max(1, S // chunk)
    while S % nchunk:
        nchunk += 1
    return S // nchunk


def forward_train_loss(model: DecoderLM, params, batch, *,
                       force: Optional[str] = None, chunk: int = 512):
    """The train loss of batch {"tokens", "labels"} (B, S): the stack,
    the final norm, then the head and softmax cross-entropy per chunk of
    `_train_chunk` rows, never the whole (B, S, V) logits; mean NLL plus
    the z-loss 1e-4 mean(logz^2). `params` are the f32 masters (any
    dict by `param_names`), cast to the compute dtype here; `model` any
    model of the config (its own parameters are not read: `skeleton`).
    An encoder-decoder config first encodes `batch["src_embeds"]` (B,
    S_src, d_model) through its encoder layers, non-causal, then
    `ln_enc`, and projects the result once per decoder layer through that
    layer's cross.wk and cross.wv into its cross k and v (the reference's
    `_make_cross_caches`). Under `cfg.remat` other than "none" each
    layer (the encoder's too) and each head chunk runs under
    `torch.utils.checkpoint` (non-reentrant), recomputed in the
    backward. The attention runs through `attention.attend` (K5
    forward, K7 backward on the card), the Mamba scan through
    `mamba.scan` (K4 forward, K8 backward); `force` pins the plain
    versions."""
    cfg = model.cfg
    dt = compute_dtype(cfg.dtype)
    w = {n: p.to(dt) if p.is_floating_point() else p
         for n, p in params.items()}
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None]
    remat = cfg.remat != "none"

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)

    cross = [None] * len(model.layers)
    if cfg.enc_dec:
        e = batch["src_embeds"].to(dt)
        epos = torch.arange(e.shape[1], device=e.device)[None]
        for l, layer in enumerate(model.encoder):
            e = run(_layer, layer, _stack_weights(w, f"encoder.{l}."), e,
                    epos, force, False)
        e = rms_norm(e, w["ln_enc"])
        kv_shape = (B, e.shape[1], cfg.num_kv_heads, cfg.head_dim)
        cross = [tuple((e @ w[f"layers.{l}.cross.{n}"].flatten(1))
                       .view(kv_shape) for n in ("wk", "wv"))
                 for l in range(len(model.layers))]
    x = _scale_embed(cfg, w["embed"][tokens])
    for l, layer in enumerate(model.layers):
        x = run(_layer, layer, _stack_weights(w, f"layers.{l}."), x,
                positions, force, True, cross[l])
    x = rms_norm(x, w["ln_f"])
    head = w["embed"].T if cfg.tie_embeddings else w["head"]
    chunk = _train_chunk(cfg, B, S, chunk)
    nll = zl = 0.0
    for c0 in range(0, S, chunk):
        a, b = run(_head_chunk, x[:, c0:c0 + chunk], head,
                   labels[:, c0:c0 + chunk])
        nll, zl = nll + a, zl + b
    n = B * S
    return nll / n + 1e-4 * zl / n


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, mask=None):
    """Mean softmax cross-entropy of full logits (B, S, V) against
    targets (B, S), plus the z-loss, over the positions where `mask`
    (default all) is nonzero; the reference's `lm_loss`."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    zloss = 1e-4 * ((logz * mask) ** 2).sum() / denom
    return loss + zloss


# ------------------------------------------------------------ entry points
def _scale_embed(cfg, x: torch.Tensor) -> torch.Tensor:
    """x times sqrt(d_model) under `scale_embed`, the factor rounded to
    x's dtype first, as the reference's `embed_tokens` does (in bf16,
    55.5 for Gemma's 55.43), so both give the same bits."""
    if not cfg.scale_embed:
        return x
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def embed_tokens(model: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
    return _scale_embed(model.cfg, model.embed[tokens])


def lm_logits(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.ln_f)
    return x @ (model.embed.T if model.head is None else model.head)


def init_cache(cfg, B: int, max_len: int, *, src_len: int = 0,
               device="cpu"):
    """Zero decode caches, one dict per layer, in the reference's layout:
    a GQA layer's k and v (B, max_len, Hkv, Dh) and an MLA layer's ckv
    (B, max_len, kv_lora_rank) and krope (B, max_len, rope_head_dim) in
    the compute dtype; a Mamba layer's conv window in the compute dtype
    and SSD state in f32 (`max_len` does not apply to them); a
    cross-attending layer's cross_k and cross_v (B, src_len, Hkv, Dh)
    in the compute dtype besides."""
    dt = compute_dtype(cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    caches = []
    for mixer, _, cross in layer_plan(cfg, cfg.num_layers, True):
        if mixer == "attn":
            shape = (B, max_len, cfg.num_kv_heads, cfg.head_dim)
            c = {"k": zeros(*shape), "v": zeros(*shape)}
        elif mixer == "mla":
            c = {"ckv": zeros(B, max_len, cfg.kv_lora_rank),
                 "krope": zeros(B, max_len, cfg.rope_head_dim)}
        else:
            c_conv = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            c = {"conv": zeros(B, cfg.ssm_conv - 1, c_conv),
                 "ssd": torch.zeros(B, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state, dtype=torch.float32,
                                    device=device)}
        if cross:
            shape = (B, src_len, cfg.num_kv_heads, cfg.head_dim)
            c["cross_k"], c["cross_v"] = zeros(*shape), zeros(*shape)
        caches.append(c)
    return caches


def encode(model: DecoderLM, src_embeds: torch.Tensor, *,
           force: Optional[str] = None) -> torch.Tensor:
    """The encoder of an encoder-decoder model (the reference's
    `encode`): `src_embeds` (B, S_src, d_model) in the compute dtype
    through its layers, non-causal, at positions 0..S_src-1, then
    `ln_enc`. `force` pins the attention's path."""
    x = src_embeds.to(model.embed.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for layer in model.encoder:
        x, _ = layer(x, positions=positions, force=force, causal=False)
    return rms_norm(x, model.ln_enc)


def forward_prefill(model: DecoderLM, tokens: torch.Tensor, cache, *,
                    src_embeds: Optional[torch.Tensor] = None,
                    force: Optional[str] = None):
    """Runs the prompt tokens (B, S) at positions 0..S-1 through the
    stack, filling the cache (attention layers write rows [0, S) of
    theirs in place, Mamba layers return new ones); returns (last-token
    logits (B, 1, V), cache). An encoder-decoder model first encodes
    `src_embeds` (B, S_src, d_model; required) and writes each decoder
    layer's cross_k and cross_v (`init_cache(..., src_len=S_src)`) in
    place. `force` pins the path of the prefill kernels
    (`ops.ssd_scan`, `ops.flash_attention`)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    if model.cfg.enc_dec:
        if src_embeds is None:
            raise ValueError(f"{model.cfg.name} is an encoder-decoder "
                             f"model: its prefill takes src_embeds")
        enc = encode(model, src_embeds, force=force)
        for layer, c in zip(model.layers, cache):
            if c["cross_k"].shape[1] != enc.shape[1]:
                raise ValueError(f"src_embeds of {enc.shape[1]} frames for "
                                 f"a cache of src_len "
                                 f"{c['cross_k'].shape[1]}")
            k, v = layer.cross.cross_kv(enc)
            c["cross_k"].copy_(k)
            c["cross_v"].copy_(v)
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


__all__ = ["DecoderLM", "embed_tokens", "encode",
           "forward_decode", "forward_prefill", "forward_train_loss",
           "from_reference", "init_cache", "init_masters", "init_model",
           "layer_plan", "lm_logits", "lm_loss", "masters_from_reference",
           "numpy_params", "param_names", "period", "reference_groups",
           "reference_leaves", "skeleton", "stack_meta"]
