"""Device-resident epoch cache: upload each batch once, replay every epoch.

The reference re-reads and re-stages its ark tables from disk every
epoch (train_scheduler.sh re-runs the trainer binary per iteration; the
binary's outer loop is a fresh SequentialBaseFloatMatrixReader pass —
aslp-nnet-train-simple.cc:165-251).  Where host→device staging is on
the critical path (bench.py `pipeline_efficiency_pct`), a cache removes
it after the first epoch.  Newbob training makes 10-20 passes over
the SAME data, so the JAX-native design keeps the transported batches
(bf16/int8 payloads — see data/transport.py) resident in HBM after the
first pass and replays device references afterwards: epoch 2+ runs at
device speed with zero host→device traffic.

Memory: a cached hour of 40-dim bf16 features is ~29 MB (int8: ~14 MB),
so tens of training hours fit alongside the model on one chip;
``max_bytes`` bounds the cache — batches past the bound stay streamed,
so behavior degrades gracefully to the pure-streaming pipeline.

Shuffling: batch ORDER is re-permuted per epoch (host-side index
shuffle, free); within-batch composition is fixed after the first pass,
matching the reference's once-shuffled scp lists (train_scheduler.sh
uses a fixed shuffled copy of the training list across iterations).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Iterable, Iterator, List, Optional


def _nbytes(tree: Any) -> int:
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif hasattr(x, "nbytes"):
            total += int(x.nbytes)
    return total


class DeviceEpochCache:
    """Wraps an upload function (host batch → device pytree).

    First ``epoch()`` streams batches through ``upload`` and remembers
    the device references (up to ``max_bytes``); later epochs yield the
    cached references directly — no host work, no transfer.
    """

    def __init__(self, upload: Callable[[Any], Any],
                 max_bytes: Optional[int] = None,
                 shuffle: bool = True, seed: int = 777):
        self._upload = upload
        self._max_bytes = max_bytes
        self._shuffle = shuffle
        self._rng = random.Random(seed)
        self._cached: List[Any] = []        # device batches, fill order
        self._cached_pos: set = set()       # their positions in the stream
        self._filled = False
        self.bytes_cached = 0
        self.num_streamed_tail = 0  # batches past max_bytes (never cached)

    @property
    def filled(self) -> bool:
        return self._filled

    def epoch(self, batches: Optional[Iterable[Any]] = None) -> Iterator[Any]:
        """Iterate one epoch of device batches.

        ``batches`` (host batches) is required for the first epoch and
        for the streamed tail of partially-cached datasets; replay-only
        epochs may omit it.  An aborted fill pass (exception or an
        abandoned iterator) rolls the cache back to empty so a retry
        cannot duplicate the prefix."""
        if not self._filled:
            if batches is None:
                raise ValueError("first epoch needs the host batch source")
            try:
                for pos, b in enumerate(batches):
                    dev = self._upload(b)
                    if (self._max_bytes is None
                            or self.bytes_cached + _nbytes(dev)
                            <= self._max_bytes):
                        self._cached.append(dev)
                        self._cached_pos.add(pos)
                        self.bytes_cached += _nbytes(dev)
                    else:
                        self.num_streamed_tail += 1
                    yield dev
                self._filled = True  # reached only on full consumption
            finally:
                # an aborted fill (exception, or the generator dropped
                # mid-epoch) must not leave a half-built cache: a retry
                # would append the whole stream again
                if not self._filled:
                    self.clear()
            return
        order = list(range(len(self._cached)))
        if self._shuffle:
            self._rng.shuffle(order)
        for i in order:
            yield self._cached[i]
        if self.num_streamed_tail:
            if batches is None:
                raise ValueError(
                    f"{self.num_streamed_tail} batches exceeded max_bytes "
                    "on the first pass; replay epochs must pass the host "
                    "batch source so the streamed tail is not dropped")
            for pos, b in enumerate(batches):
                if pos in self._cached_pos:
                    continue  # cached ones already replayed above
                yield self._upload(b)

    def clear(self) -> None:
        self._cached = []
        self._cached_pos = set()
        self._filled = False
        self.bytes_cached = 0
        self.num_streamed_tail = 0
