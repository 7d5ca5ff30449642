"""Bounded request queue with same-cell batch extraction.

The admission side is strict (``put`` raises :class:`QueueFullError` when
the bound is hit — the engine wraps it with a retry-after estimate) and the
consumer side pops *micro-batches*: the oldest request seeds a batch and
later requests from the same shape cell join it, up to ``max_batch``,
optionally waiting a short batch window for stragglers.  Requests from
other cells keep their FIFO order — extracting a batch never reorders the
remainder.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

from .batching import form_batches
from .errors import EngineStoppedError, QueueFullError


class BoundedServeQueue:
    """Thread-safe bounded FIFO of items carrying a ``.cell`` attribute."""

    def __init__(self, bound: int):
        if bound < 1:
            raise ValueError("queue bound must be >= 1")
        self.bound = int(bound)
        self._dq: deque = deque()
        self._cv = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)

    def cell_depth(self, cell) -> int:
        """Queued requests in ``cell`` — the fleet router's batch-join
        signal (a replica with a *forming* same-cell batch, 0 < depth <
        max_batch, is preferred so the lane axis fills before load spills
        to the next device)."""
        with self._cv:
            return sum(1 for r in self._dq if r.cell == cell)

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def put(self, item, force: bool = False) -> None:
        """Admit one request; raises :class:`QueueFullError` at the bound
        and :class:`EngineStoppedError` after :meth:`close`.

        ``force`` bypasses the bound — the journal replay
        re-enqueues work that was ADMITTED by the dead process, so the
        admission decision was already made once; bounding the replay
        would lose accepted requests, the one thing the journal exists
        to prevent (serve/journal.py)."""
        with self._cv:
            if self._closed:
                raise EngineStoppedError("queue closed; engine is draining")
            if not force and len(self._dq) >= self.bound:
                raise QueueFullError()
            self._dq.append(item)
            # Stamp the depth observed at admission: the
            # request-trace admit event records how deep in line this
            # request started, which the post-hoc dossier correlates with
            # its measured queue wait.
            if hasattr(item, "queue_position"):
                item.queue_position = len(self._dq)
            self._cv.notify_all()

    def pop_batch(self, max_batch: int, window_s: float = 0.0,
                  gate=None) -> Optional[List]:
        """Block until a request is available, then return a same-cell batch.

        The head request's cell seeds the batch; if fewer than ``max_batch``
        same-cell requests are queued, waits up to ``window_s`` for more to
        arrive before dispatching.  Returns ``None`` exactly once the queue
        is closed *and* drained (the graceful-shutdown termination signal).

        ``gate``: an optional ``threading.Event`` — while it is
        cleared no batch is extracted, so ``PartitionEngine.pause`` holds
        work IN the queue (where a fleet drain can requeue it and a burst
        accumulates to full batches) instead of merely delaying the batch
        after extraction.  Ignored once the queue closes (drain proceeds);
        setters must call :meth:`poke` to wake the consumer.
        """
        max_batch = max(1, int(max_batch))
        with self._cv:
            while True:
                while not self._dq or (
                    gate is not None and not gate.is_set()
                    and not self._closed
                ):
                    if self._closed and not self._dq:
                        return None
                    self._cv.wait()
                cell = self._dq[0].cell
                deadline = time.monotonic() + max(0.0, float(window_s))
                while not self._closed:
                    if sum(1 for r in self._dq if r.cell == cell) >= max_batch:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                if not self._dq:
                    # drain_items emptied the queue while the batch window
                    # waited (a fleet drain requeuing this replica's work,
                    # ) — go back to blocking for fresh work.
                    continue
                if (
                    gate is not None and not gate.is_set()
                    and not self._closed
                ):
                    # pause() landed during the batch window: hold the
                    # work IN the queue (the documented pause contract —
                    # a drain can still requeue it) instead of extracting
                    # a batch for a paused dispatcher.
                    continue
                # One batching policy for the whole runtime: the head-seeded
                # same-cell selection lives in batching.form_batches.
                batch = form_batches(self._dq, max_batch)[0]
                taken = set(map(id, batch))
                self._dq = deque(r for r in self._dq if id(r) not in taken)
                return batch

    def poke(self) -> None:
        """Wake blocked consumers to re-check external state (the pause
        gate) — called by ``PartitionEngine.resume``."""
        with self._cv:
            self._cv.notify_all()

    def close(self) -> None:
        """Stop admissions; consumers drain the remainder then get None."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def drain_items(self) -> List:
        """Remove and return everything still queued (non-draining
        shutdown resolves these with :class:`EngineStoppedError`)."""
        with self._cv:
            items = list(self._dq)
            self._dq.clear()
            self._cv.notify_all()
            return items
