"""Optimizers of the port: `repro_torch.optim.adamw` (AdamW and its
learning-rate schedules)."""

from repro_torch.optim.adamw import AdamW, constant_schedule, cosine_schedule

__all__ = ["AdamW", "constant_schedule", "cosine_schedule"]
