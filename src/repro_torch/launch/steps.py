"""Steps of the port: build the model, prefill, decode, and the train
step.

The counterpart of `repro.launch.steps` (`materialize_model`,
`make_prefill_step`, `make_decode_step`, `make_train_step`). There is no
sharding and no `jit`: PyTorch runs the steps eagerly on one device, for
every stack `models.lm` builds (Mamba, GQA and MLA mixers; dense, MoE or
no FFN; an encoder-decoder's encoder and cross attention), the train
step included.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from repro_torch.fabric.engine import resolve_device
from repro_torch.models import lm


def materialize_model(cfg, seed: int = 0, device=None) -> lm.DecoderLM:
    """A randomly initialised model on `device` (default CUDA; raises
    without a card), weights in the config's compute dtype."""
    return lm.init_model(cfg, seed=seed, device=resolve_device(device))


def make_prefill_step(model: lm.DecoderLM, *, force: Optional[str] = None):
    """prefill_step(tokens (B, S), cache, src_embeds=None) -> (last-token
    logits (B, 1, V), cache); an encoder-decoder model takes the frame
    embeddings `src_embeds` (B, S_src, d_model). `force="ref"` runs the
    plain versions of the prefill kernels (SSD scan, attention, GQA's
    and MLA's) on any device (for holding the kernels against them)."""
    def prefill_step(tokens, cache, src_embeds=None):
        return lm.forward_prefill(model, tokens, cache,
                                  src_embeds=src_embeds, force=force)
    return prefill_step


def make_decode_step(model: lm.DecoderLM):
    """decode_step(tokens (B, 1), cache, kv_len) -> (logits (B, 1, V),
    cache); kv_len is the number of tokens the cache holds."""
    def decode_step(tokens, cache, kv_len):
        return lm.forward_decode(model, tokens, cache, kv_len)
    return decode_step


def make_train_step(cfg, optimizer, *, force: Optional[str] = None):
    """train_step(params, opt_state, step, batch) -> (params, opt_state,
    {"loss", "grad_norm", "step"}): the loss and the gradients of the
    f32 masters `params` (`lm.forward_train_loss` under
    `torch.autograd`), then `optimizer.update` (which writes params and
    opt_state in place). With `cfg.train_microbatches` k > 1 the batch
    splits into k row blocks; the gradients accumulate as the
    reference's scan does (zeros, plus each microbatch's in turn) and
    the loss and gradients are divided by k. `force="ref"` pins the
    plain attention and SSD scan, forward and backward."""
    k = max(cfg.train_microbatches, 1)
    model = lm.skeleton(cfg)

    def value_and_grad(params, batch):
        loss = lm.forward_train_loss(model, params, batch, force=force)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), OrderedDict(zip(params, grads))

    def train_step(params, opt_state, step, batch):
        if k == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            loss = 0.0
            grads = OrderedDict((n, torch.zeros_like(p, requires_grad=False))
                                for n, p in params.items())
            for i in range(k):
                mb = {n: t.reshape((k, t.shape[0] // k) + t.shape[1:])[i]
                      for n, t in batch.items()}
                l_i, g_i = value_and_grad(params, mb)
                loss = loss + l_i
                for n, g in g_i.items():
                    grads[n].add_(g)
            loss = loss / k
            for g in grads.values():
                g.div_(k)
        params, opt_state, info = optimizer.update(grads, opt_state, params,
                                                   step)
        return params, opt_state, {"loss": loss,
                                   "grad_norm": info["grad_norm"],
                                   "step": step + 1}

    return train_step


__all__ = ["materialize_model", "make_prefill_step", "make_decode_step",
           "make_train_step"]
