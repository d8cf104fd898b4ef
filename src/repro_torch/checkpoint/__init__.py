"""Checkpointing of the port's states in the reference's npz format."""
from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               latest_step,
                                               latest_valid_step,
                                               record_steps, restore, save,
                                               verify)

__all__ = ["save", "restore", "latest_step", "latest_valid_step",
           "record_steps", "verify", "CheckpointCorruptError"]
