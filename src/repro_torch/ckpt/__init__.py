"""Checkpoints in the JAX package's on-disk format (numpy only).
Counterpart of ``repro.ckpt``."""
from repro_torch.ckpt.checkpoint import (ArraySpec, CheckpointCorruptionError,
                                         CheckpointManager, latest_step,
                                         restore, save)

__all__ = ["ArraySpec", "CheckpointCorruptionError", "CheckpointManager",
           "latest_step", "restore", "save"]
