"""Optimizers of the port (the counterpart of `repro.optim`)."""
from repro_torch.optim.optimizers import (adafactor, adamw,
                                          clip_by_global_norm,
                                          cosine_schedule, make_optimizer)

__all__ = ["adamw", "adafactor", "make_optimizer", "cosine_schedule",
           "clip_by_global_norm"]
