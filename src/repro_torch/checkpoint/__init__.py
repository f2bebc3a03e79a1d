"""Checkpointing of the port: `repro_torch.checkpoint.checkpointer`
(atomic, async saves in the reference's layout)."""

from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step

__all__ = ["Checkpointer", "latest_step"]
