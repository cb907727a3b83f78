"""Shared slot-table machinery for the batched serve engines
(counterpart of ``repro.serve.slots``; pure Python, kept as the port's
own copy).

A :class:`SlotTable` is the Python-side bookkeeping of iteration-level
(continuous) batching (DESIGN.md §7.1 / §9): a fixed number of
shape-stable slots, a FIFO queue of submitted requests, admission of
queued requests into free slots, and immediate slot reuse when a request
finishes.  The batched forwards stay whole-batch and shape-stable;
this table only decides WHICH rows are live.  ``serve.cnn.CnnServeEngine``
(batched CNN inference, where every admitted request completes in one
forward) and ``serve.engine.ServeEngine`` (LM decode) use it.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, List, Optional, Tuple

__all__ = ["SlotTable"]


class SlotTable:
    """Fixed-size request staging: ``req[s] is None`` == slot ``s`` free.

    ``req`` (a plain list) and ``queue`` (a :class:`collections.deque` —
    the FIFO drain is O(1) per admission, where ``list.pop(0)`` was O(n)
    and made a deep-queue drain O(n²) under load) are mutable on
    purpose: engines alias them (``self.slot_req = table.req``,
    ``self.queue = table.queue``) so row-level bookkeeping keeps working
    against the shared state.  Code that used to filter the queue with
    slice assignment must use :meth:`retain` (deques don't slice).
    """

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.slots = slots
        self.req: List[Optional[Any]] = [None] * slots
        self.queue: Deque[Any] = deque()

    def submit(self, req: Any) -> None:
        self.queue.append(req)

    def retain(self, keep: Callable[[Any], bool]) -> List[Any]:
        """Drop queued requests failing ``keep`` (IN PLACE, preserving
        order and the ``queue`` alias); returns the dropped ones."""
        dropped = [r for r in self.queue if not keep(r)]
        if dropped:
            kept = [r for r in self.queue if keep(r)]
            self.queue.clear()
            self.queue.extend(kept)
        return dropped

    def admit_one(self) -> Optional[Tuple[int, Any]]:
        """Admit ONE queued request into the lowest free slot.

        Returns ``(slot, request)`` or None when the queue is empty or
        every slot is occupied.  Engines that do per-admission work (the
        LM engine's cache-row reset) interleave it between ``admit_one``
        calls, preserving admission-order semantics.
        """
        if not self.queue:
            return None
        for s in range(self.slots):
            if self.req[s] is None:
                r = self.queue.popleft()
                self.req[s] = r
                return s, r
        return None

    def admit(self) -> List[int]:
        """Fill every free slot from the queue; newly admitted slot ids."""
        out: List[int] = []
        while (adm := self.admit_one()) is not None:
            out.append(adm[0])
        return out

    def free(self, s: int) -> None:
        self.req[s] = None

    def active(self) -> List[int]:
        return [s for s in range(self.slots) if self.req[s] is not None]

    def pending(self) -> int:
        """Number of queued + in-flight requests (0 == drained; truthy
        while work remains, so ``while table.pending():`` still drives)."""
        return len(self.queue) + sum(r is not None for r in self.req)
