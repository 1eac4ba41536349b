"""Host→device prefetch (port of ``litemkd_tpu/data/prefetch.py:28-151``).

A background thread assembles the next episode batches and copies them to
the device (``transfer``: the port's ``to_device``, pinned memory and
non-blocking copies) while the current step runs, so the card does not wait
on JPEG decode or ``np.load``; :class:`DeferredHostSync` reads a step's
results on the host one step late, after the next step is enqueued.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class DeferredHostSync:
    """One-deep deferral of host-side result absorption.

    ``push(item)`` absorbs the previous item and stores this one;
    ``flush()`` absorbs whatever is pending. Push right after enqueueing
    step k+1, so that step k's host reads wait while the device is busy;
    flush at every barrier that needs the stream complete (a checkpoint, an
    eval, the end of the loop). One item at most is pending."""

    def __init__(self, absorb: Callable):
        self._absorb = absorb
        self._pending = None

    def push(self, *item) -> None:
        prev, self._pending = self._pending, item
        if prev is not None:
            self._absorb(*prev)

    def flush(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._absorb(*prev)


class Prefetcher:
    """A batch-producing callable behind a bounded background queue.

    ``produce(i)`` returns the i-th host batch (None ends early) and
    ``transfer`` moves it to the device on the same background thread;
    one batch waits staged ahead of the consumer. An error in either
    is raised in the consumer. When iteration ends for any reason,
    :meth:`close` stops the producer and drops the staged batches, so an
    abandoned loop keeps no device batch alive."""

    _DONE = object()

    def __init__(self, produce: Callable[[int], Optional[object]],
                 n_batches: int, *, transfer: Callable):
        self.q: "queue.Queue" = queue.Queue(maxsize=1)
        self.n = n_batches
        self.transfer = transfer
        self._err: Optional[BaseException] = None
        self._stop = False
        self.thread = threading.Thread(target=self._run, args=(produce,),
                                       daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self._stop:
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, produce):
        try:
            for i in range(self.n):
                if self._stop:
                    break
                batch = produce(i)
                if batch is None:
                    break
                if not self._put(self.transfer(batch)):
                    break
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            self._put(self._DONE)
            if self._stop:
                # a put that was blocked when close() drained can land after
                # that drain; the producer is the last writer, so it drains
                # once more on its way out
                self._drain()

    def _drain(self) -> None:
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break

    def close(self) -> None:
        """Stop production and drop the staged batches (idempotent)."""
        self._stop = True
        self._drain()

    def __iter__(self) -> Iterator:
        try:
            while True:
                try:
                    # a timed get: a close() from another thread drains the
                    # DONE sentinel too, and an untimed get would then block
                    item = self.q.get(timeout=0.2)
                except queue.Empty:
                    if self._stop:
                        if self._err is not None:
                            raise self._err
                        return
                    continue
                if item is self._DONE:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()
