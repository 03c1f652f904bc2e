"""Checkpoints of the port (the counterpart of `repro.checkpoint`)."""
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         read_metadata, restore, save)

__all__ = ["save", "restore", "latest_step", "read_metadata",
           "CheckpointManager"]
