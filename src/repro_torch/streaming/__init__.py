"""Streaming scheduler service (port of `repro.streaming`): online
arrivals, rolling re-solves.

Coflows are admitted by release time (in arrival batches) into a
ring-buffer slot pool; each arrival batch triggers a warm-started re-solve
over the residual demands of the active set on the device, and circuits
already in flight are carried into the next calendar -- preempted (paying
the reconfiguration delta again) or committed as phantom busy circuits.

  * `repro_torch.streaming.pool` -- `SlotPool`, the bounded ring buffer of
    scheduler slots with its admission policies (``"fifo"``,
    ``"weighted"``, ``"size_aware"``);
  * `repro_torch.streaming.service` -- `stream()` (the event loop) and the
    `StreamResult` / `EpochRecord` result types.
"""

from repro_torch.streaming.pool import ADMISSION_POLICIES, SlotPool
from repro_torch.streaming.service import EpochRecord, StreamResult, stream

__all__ = [
    "ADMISSION_POLICIES",
    "SlotPool",
    "EpochRecord",
    "StreamResult",
    "stream",
]
