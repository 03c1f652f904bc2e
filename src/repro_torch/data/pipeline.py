"""Deterministic synthetic LM data of the port.

The counterpart of `repro.data.pipeline.SyntheticLMData`: `batch(step)`
is a pure function of (seed, step), drawn by numpy with the reference's
generators and in its order (the Zipf unigram draw, the motif splices,
then `src_embeds` for an encoder-decoder config), so its arrays equal
the reference's bit for bit and a resumed run replays the same stream.
The batch lands on one explicit device (the reference's mesh placement
belongs to the sharded pool, ROADMAP queue A item 8).
"""
from __future__ import annotations

import numpy as np
import torch


class SyntheticLMData:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, src_len: int = 0, d_model: int = 0,
                 device="cpu"):
        self.V = vocab_size
        self.S = seq_len
        self.B = global_batch
        self.seed = seed
        self.src_len = src_len
        self.d_model = d_model
        self.device = torch.device(device)
        # fixed Zipf unigram distribution + motif table
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, min(vocab_size, 4096) + 1)
        p = 1.0 / ranks ** 1.1
        self.probs = p / p.sum()
        self.motifs = rng.integers(0, min(vocab_size, 4096), size=(64, 16))

    def arrays(self, step: int) -> dict:
        """The batch of `step` as numpy arrays: tokens (B, S + 1) int32
        (and src_embeds (B, src_len, d_model) f32)."""
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(len(self.probs), p=self.probs,
                          size=(self.B, self.S + 1)).astype(np.int32)
        # splice in motifs to create learnable structure
        n_motifs = (self.S + 1) // 32
        for b in range(min(self.B, 64)):
            ids = rng.integers(0, 64, n_motifs)
            pos = rng.integers(0, self.S + 1 - 16, n_motifs)
            for i, p0 in zip(ids, pos):
                toks[b, p0:p0 + 16] = self.motifs[i]
        out = {"tokens": toks}
        if self.src_len:
            out["src_embeds"] = rng.normal(
                size=(self.B, self.src_len, self.d_model)).astype(
                    np.float32)
        return out

    def batch(self, step: int) -> dict:
        """`arrays(step)` as tensors on the data's device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.arrays(step).items()}


__all__ = ["SyntheticLMData"]
