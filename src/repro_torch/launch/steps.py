"""Serve steps of the port: build the model, prefill, decode.

The counterpart of the serving part of `repro.launch.steps`
(`materialize_model`, `make_prefill_step`, `make_decode_step`). There is
no sharding and no `jit`: PyTorch runs the steps eagerly on one device,
for every decoder-only stack `models.lm` builds (Mamba, GQA and MLA
mixers; dense, MoE or no FFN).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.fabric.engine import resolve_device
from repro_torch.models import lm


def materialize_model(cfg, seed: int = 0, device=None) -> lm.DecoderLM:
    """A randomly initialised model on `device` (default CUDA; raises
    without a card), weights in the config's compute dtype."""
    return lm.init_model(cfg, seed=seed, device=resolve_device(device))


def make_prefill_step(model: lm.DecoderLM, *, force: Optional[str] = None):
    """prefill_step(tokens (B, S), cache) -> (last-token logits
    (B, 1, V), cache). `force="ref"` runs the plain versions of the
    prefill kernels (SSD scan, attention, GQA's and MLA's) on any device
    (for holding the kernels against them)."""
    def prefill_step(tokens, cache):
        return lm.forward_prefill(model, tokens, cache, force=force)
    return prefill_step


def make_decode_step(model: lm.DecoderLM):
    """decode_step(tokens (B, 1), cache, kv_len) -> (logits (B, 1, V),
    cache); kv_len is the number of tokens the cache holds."""
    def decode_step(tokens, cache, kv_len):
        return lm.forward_decode(model, tokens, cache, kv_len)
    return decode_step


__all__ = ["materialize_model", "make_prefill_step", "make_decode_step"]
