"""Fault-tolerant checkpointing (counterpart of ``repro.checkpointing``)."""

from .checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
