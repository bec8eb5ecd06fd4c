"""Crash-safe checkpoints of the port's trees (``ckpt``)."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointCorruptError, CheckpointDtypeError, CheckpointError,
    CheckpointKeyError, CheckpointShapeError, available_steps,
    latest_step, load_metadata, restore_checkpoint, save_checkpoint)
