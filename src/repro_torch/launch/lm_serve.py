"""Serving driver of the port: batched prefill + greedy decode with a
KV cache (GQA layers), a latent cache (MLA layers) or the conv window
and SSD state (Mamba layers) as the cache.

The counterpart of `repro.launch.lm_serve` for the ten architectures of
`configs.ARCH_IDS`: Mamba2-1.3B, StarCoder2-3B, Gemma-7B, DeepSeek-7B,
DeepSeek-Coder-33B, Chameleon-34B, Qwen3-MoE-235B-A22B,
DeepSeek-V2-236B, Jamba-v0.1-52B and SeamlessM4T-medium (an
encoder-decoder: each batch brings `src_embeds` (B, src_len, d_model),
the frame embeddings the audio front end's stub stands for, encoded
once in the prefill). A fixed batch of requests is prefilled at once
(on the card the prefill of every Mamba layer runs the SSD scan kernel
K4, of every GQA or MLA layer, encoder and cross attention included,
the attention kernel K5), then greedy decode steps run until the asked
number of tokens, position by position after the prompt. Tokens stay on
the device until the end (the reference pulls each one to the host).

Usage (the smoke config, on the card; `--device cpu` runs the plain
PyTorch path; `ServeSession(arch, smoke=False)` serves the published
config: every dense model and SeamlessM4T fit one 80 GB card whole in
bf16, the three MoE models do not: serve a depth-cut model at full width
with `ServeSession(arch, model=lm.init_model(dataclasses.replace(
get_config(arch), num_layers=n), device="cuda"))`):
  python -m repro_torch.launch.lm_serve --arch starcoder2-3b --requests 4 \
      --tokens 16
  python -m repro_torch.launch.lm_serve --arch mamba2-1.3b
  python -m repro_torch.launch.lm_serve --arch seamless-m4t-medium
DeepSeek-V2's SMOKE widths (MLA's q.k 24, values 16) have no instance of
K5, which is built for the published (192, 128): its smoke config
serves on the CPU only.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.fabric.engine import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import lm


class ServeSession:
    """A model of `arch` (its reduced smoke config unless `smoke=False`)
    with random weights from `seed`, serving batches of `batch` requests
    of up to `max_len` tokens (prompt and continuation) on `device`
    (default CUDA; raises without a card). `dtype` overrides the
    config's compute dtype ("float32" or "bfloat16"); `force="ref"` runs
    the prefill kernels' plain versions instead of the kernels (for
    holding one against the other). `model` serves a prebuilt model of `arch` as it
    is, e.g. `lm.from_reference(*lm.numpy_params(cfg, seed), cfg,
    device=...)` for weights shared with the JAX package; `smoke`,
    `seed`, `dtype` and `device` then do not apply: the session runs on
    the model's device. An encoder-decoder arch encodes `src_len`
    frames a request (0 for the others, as the reference keeps it)."""

    def __init__(self, arch: str, *, smoke: bool = True, batch: int = 4,
                 max_len: int = 128, device=None, seed: int = 0,
                 dtype: Optional[str] = None, force: Optional[str] = None,
                 model: Optional[lm.DecoderLM] = None, src_len: int = 16):
        if model is None:
            cfg = get_smoke_config(arch) if smoke else get_config(arch)
            self.cfg = cfg if dtype is None else dataclasses.replace(
                cfg, dtype=dtype)
            self.device = resolve_device(device)
            self.model = ST.materialize_model(self.cfg, seed, self.device)
        else:
            if model.cfg.name != arch:
                raise ValueError(f"a {model.cfg.name} model for arch "
                                 f"{arch!r}")
            self.cfg, self.model = model.cfg, model
            self.device = model.embed.device
        self.batch = batch
        self.max_len = max_len
        self.src_len = src_len if self.cfg.enc_dec else 0
        self.prefill_fn = ST.make_prefill_step(self.model, force=force)
        self.decode_fn = ST.make_decode_step(self.model)

    @torch.inference_mode()
    def stream(self, prompts, n_tokens: int, src_embeds=None):
        """Greedy decoding of `prompts` (B, P) ints (array or tensor):
        yields n_tokens pairs (token (B,) int64, the logits (B, V) it was
        chosen from), both on the device; the first comes from the
        prefill. An encoder-decoder arch takes `src_embeds` (B, src_len,
        d_model) floats (array or tensor)."""
        tokens = torch.as_tensor(prompts, dtype=torch.int64,
                                 device=self.device)
        B, P = tokens.shape
        if B != self.batch:
            raise ValueError(f"{B} prompts for a batch of {self.batch}")
        if P + n_tokens > self.max_len:
            raise ValueError(f"{P} prompt + {n_tokens} new tokens exceed "
                             f"max_len {self.max_len}")
        if self.cfg.enc_dec:
            if src_embeds is None or tuple(src_embeds.shape) != (
                    B, self.src_len, self.cfg.d_model):
                raise ValueError(
                    f"{self.cfg.name} takes src_embeds of shape "
                    f"{(B, self.src_len, self.cfg.d_model)}, not "
                    f"{None if src_embeds is None else tuple(src_embeds.shape)}")
            src_embeds = torch.as_tensor(src_embeds, device=self.device)
        cache = lm.init_cache(self.cfg, B, self.max_len,
                              src_len=self.src_len, device=self.device)
        logits, cache = self.prefill_fn(tokens, cache, src_embeds)
        for i in range(n_tokens):
            tok = logits[:, -1].argmax(-1)
            yield tok, logits[:, -1]
            if i + 1 < n_tokens:
                logits, cache = self.decode_fn(tok[:, None], cache, P + i)

    def generate(self, prompts, n_tokens: int,
                 src_embeds=None) -> np.ndarray:
        """prompts: (B, P) ints (and `src_embeds` for an encoder-decoder
        arch, see `stream`). Greedy-decodes n_tokens continuations;
        returns them as a (B, n_tokens) int32 array."""
        toks = [tok for tok, _ in self.stream(prompts, n_tokens,
                                              src_embeds)]
        if not toks:
            return np.zeros((self.batch, 0), np.int32)
        return torch.stack(toks, 1).cpu().numpy().astype(np.int32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    sess = ServeSession(args.arch, batch=args.requests, device=args.device,
                        max_len=args.prompt_len + args.tokens)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, sess.cfg.vocab_size,
                           (args.requests, args.prompt_len))
    src = rng.normal(size=(args.requests, sess.src_len, sess.cfg.d_model)
                     ).astype(np.float32) if sess.cfg.enc_dec else None
    t0 = time.perf_counter()
    toks = sess.generate(prompts, args.tokens, src_embeds=src)
    dt = time.perf_counter() - t0
    print(f"generated {toks.shape} tokens on {sess.device} in {dt:.2f}s "
          f"({args.requests * args.tokens / dt:.1f} tok/s, first call "
          f"included)")
    print(toks[:, :12])


if __name__ == "__main__":
    main()
