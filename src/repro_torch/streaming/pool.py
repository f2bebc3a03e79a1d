"""Ring-buffer slot pool for the streaming scheduler (host copy of
`repro.streaming.pool`: the same ring order and the same three policies).

The pool bounds the scheduler's working set: at most `size` coflows are
*active* (hold a slot and participate in re-solves) at any time; the
rest wait in an admission queue.  Slots are assigned in ring order
(a rotating next-slot pointer, so slot ids churn through the buffer
instead of piling up at index 0) and freed when a coflow's residual
demand reaches zero.  Slot ids are the key for per-pair warm-start
memory (`repro_torch.streaming.service._WarmState`): bounded state for an unbounded stream.

Admission is **pluggable** (ROADMAP streaming follow-on b): when slots
are scarce the ``policy`` decides which queued coflow is admitted next —

  * ``"fifo"``       — arrival order (the default, and the only policy
    that preserves offline-replay parity);
  * ``"weighted"``   — highest weight first: under contention the
    scheduler works on the coflows the Sum w_m T_m objective charges
    most for waiting;
  * ``"size_aware"`` — smallest total demand first (shortest-job-first
    flavored): small coflows drain slots quickly, cutting queue waits.

Ties (equal weight / size) fall back to arrival order, so every policy
is deterministic.  Policies reorder only the queue→slot assignment;
slot accounting, ring rotation and warm-start semantics are identical.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["ADMISSION_POLICIES", "SlotPool"]

ADMISSION_POLICIES = ("fifo", "weighted", "size_aware")


class SlotPool:
    """Bounded slot pool with ring-order assignment and a policy queue.

    ``weights`` / ``sizes`` index by *global coflow id* and are required
    by the ``"weighted"`` / ``"size_aware"`` policies respectively (the
    streaming service passes the instance's weight vector and per-coflow
    total demands).
    """

    def __init__(
        self,
        size: int,
        policy: str = "fifo",
        weights=None,
        sizes=None,
    ):
        if size <= 0:
            raise ValueError(f"pool size must be positive, got {size}")
        if policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; "
                f"choose from {ADMISSION_POLICIES}"
            )
        if policy == "weighted" and weights is None:
            raise ValueError("policy='weighted' needs per-coflow weights")
        if policy == "size_aware" and sizes is None:
            raise ValueError("policy='size_aware' needs per-coflow sizes")
        self.size = size
        self.policy = policy
        self._weights = weights
        self._sizes = sizes
        self._slot_coflow = [-1] * size  # slot -> global coflow id
        self._slot_of: dict[int, int] = {}  # global coflow id -> slot
        self._next = 0  # ring pointer: first slot probed on admission
        self.queue: deque[int] = deque()  # arrived, waiting for a slot

    @property
    def num_active(self) -> int:
        return len(self._slot_of)

    @property
    def num_free(self) -> int:
        return self.size - len(self._slot_of)

    def slot_of(self, coflow: int) -> int:
        return self._slot_of[coflow]

    def active_ids(self) -> list[int]:
        """Active global coflow ids in ASCENDING id order.

        Ascending-id order (not slot order) is the pool's dense-instance
        convention: epoch instances list coflows by global id, so stable
        tie-breaks in ordering stages match the offline oracle bit for
        bit, and dense pair (i, j), i<j always maps to the same global
        pair orientation across epochs.
        """
        return sorted(self._slot_of)

    def push(self, coflows) -> None:
        """Enqueue newly arrived coflows (arrival order, caller supplies)."""
        self.queue.extend(int(m) for m in coflows)

    def _pick(self) -> int:
        """Queue position of the next coflow to admit under the policy."""
        if self.policy == "fifo":
            return 0
        if self.policy == "weighted":
            # max weight; tie -> earliest arrival (first queue position).
            best = max(range(len(self.queue)),
                       key=lambda i: (self._weights[self.queue[i]], -i))
            return best
        # size_aware: min total demand; tie -> earliest arrival.
        return min(range(len(self.queue)),
                   key=lambda i: (self._sizes[self.queue[i]], i))

    def admit_waiting(self) -> list[int]:
        """Assign queued coflows to free slots in ring order.

        Returns the admitted global ids, in admission order (which is
        the policy's order, not necessarily arrival order).  Stops when
        the queue or the free slots run out.
        """
        admitted = []
        while self.queue and self.num_free:
            pos = self._pick()
            m = self.queue[pos]
            del self.queue[pos]
            s = self._next
            while self._slot_coflow[s] != -1:
                s = (s + 1) % self.size
            self._slot_coflow[s] = m
            self._slot_of[m] = s
            self._next = (s + 1) % self.size
            admitted.append(m)
        return admitted

    def active_array(self) -> np.ndarray:
        """`active_ids` as an i64 array (the vectorized drain/epoch path)."""
        return np.fromiter(sorted(self._slot_of), dtype=np.int64,
                           count=len(self._slot_of))

    def slots_of(self, coflows) -> np.ndarray:
        """(n,) i64 slot ids for the given global coflow ids."""
        return np.fromiter((self._slot_of[int(m)] for m in coflows),
                           dtype=np.int64, count=len(coflows))

    def release(self, coflow: int) -> int:
        """Free the slot held by `coflow`; returns the freed slot id."""
        s = self._slot_of.pop(coflow)
        self._slot_coflow[s] = -1
        return s

    def release_many(self, coflows) -> np.ndarray:
        """Free every listed coflow's slot in one call.

        Returns the freed slot ids as an i64 array (aligned with the
        input order) — the batched drain path: one `release_many` +
        one `_WarmState.forget_slots` per epoch instead of a Python
        release/forget round-trip per drained coflow.
        """
        coflows = [int(m) for m in coflows]
        slots = np.fromiter((self._slot_of.pop(m) for m in coflows),
                            dtype=np.int64, count=len(coflows))
        for s in slots:
            self._slot_coflow[s] = -1
        return slots
