"""Checkpoint store (port of `repro.checkpoint`): atomic, crc32-checked
step directories in the JAX package's on-disk format."""
from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointCorruptError,
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_steps",
           "CheckpointCorruptError"]
