"""Pipelined host→device batch prefetching.

The reference's trainers block on ark reads + GPU staging between
minibatches (reference: aslp-nnet-train-simple.cc:165-251 — the outer
loop reads tables, fixes lengths, then AddData copies host→device
before any compute can start; CUDA overlap exists only inside cuBLAS).
Here the idiomatic form is a double-buffered loader: a worker thread
assembles the next host batch and starts its ``jax.device_put`` while
the device is still executing the current step, so the input pipeline
cost disappears behind compute (the gap between corpus-fed and
synthetic-batch throughput is the measure — bench.py reports both)."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional


class _Stop:
    pass


class _Err:
    def __init__(self, exc):
        self.exc = exc


class DevicePrefetcher:
    """Iterate ``source`` on a worker thread, ``depth`` batches ahead.

    ``transform`` runs on the worker (use it for numpy assembly +
    jax.device_put — device_put is async and thread-safe, so transfers
    overlap the main thread's dispatched computation)."""

    def __init__(self, source: Iterable[Any], depth: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._transform = transform
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator[Any]) -> None:
        try:
            for item in it:
                if self._transform is not None:
                    item = self._transform(item)
                self._q.put(item)
        except BaseException as e:  # propagate to consumer
            self._q.put(_Err(e))
            return
        self._q.put(_Stop())

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _Stop):
            raise StopIteration
        if isinstance(item, _Err):
            raise item.exc
        return item
