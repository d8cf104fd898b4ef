"""Checkpointing of the port's states in the reference's npz format."""
from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               crc32_concat, latest_step,
                                               latest_valid_step,
                                               read_manifest, read_rows,
                                               record_steps, restore, save,
                                               save_streamed, verify)

__all__ = ["save", "restore", "latest_step", "latest_valid_step",
           "record_steps", "verify", "CheckpointCorruptError",
           "save_streamed", "read_manifest", "read_rows", "crc32_concat"]
