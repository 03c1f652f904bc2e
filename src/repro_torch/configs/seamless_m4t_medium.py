"""SeamlessM4T-medium [arXiv:2308.11596; hf]: enc-dec, multimodal;
audio frontend = stub (the caller supplies precomputed frame
embeddings, `src_embeds`). 12L encoder + 12L decoder. A copy of the
JAX package's config, field for field."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=256206,
    activation="gelu", rope_theta=1e4,
    enc_dec=True, enc_layers=12, frontend="audio", scale_embed=True,
    train_microbatches=4,
)

SMOKE = dataclasses.replace(
    CONFIG, train_microbatches=1, num_layers=2, enc_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
