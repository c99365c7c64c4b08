"""Cross-session acoustic batching for the online server.

JAX-native generalization of the reference's per-session
``max_nnet_batch_size`` batching (reference:
src/aslp-online/online-nnet-decoder.h:30-45 DecodeOptions — the
reference batches frames WITHIN one session's forward; here concurrent
sessions' feature chunks are coalesced into ONE padded device forward,
which is what actually fills the device when many small streams are
active).

Usage: wrap the batched model forward (``fn([B, T, D], mask [B, T]) →
[B, T, P]``) in an AcousticBatcher and give each DecodeSession
``batcher.compute`` as its acoustic_fn.  Requests arriving within
``max_wait_ms`` (or until ``max_batch`` is reached) share one device
call; shapes are padded to T buckets so one XLA compile serves all
chunk lengths."""

from __future__ import annotations

import asyncio
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np


class AcousticBatcher:
    """Coalesce concurrent acoustic-forward requests into one call."""

    def __init__(self, batched_forward: Callable, max_batch: int = 16,
                 max_wait_ms: float = 5.0, t_bucket: int = 32):
        self.batched_forward = batched_forward
        self.max_batch = int(max_batch)
        self.max_wait_s = max_wait_ms / 1000.0
        self.t_bucket = int(t_bucket)
        self._pending: List[Tuple[np.ndarray, asyncio.Future]] = []
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self.num_batches = 0       # diagnostics
        self.num_requests = 0

    async def compute(self, feats: np.ndarray) -> np.ndarray:
        """[T, D] features → [T, P] scores, batched across callers."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((np.asarray(feats, np.float32), fut))
        self.num_requests += 1
        if len(self._pending) >= self.max_batch:
            self._flush()
        elif self._flush_handle is None:
            self._flush_handle = loop.call_later(
                self.max_wait_s, self._flush)
        return await fut

    def _flush(self) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        if not self._pending:
            return
        batch = self._pending[:self.max_batch]
        self._pending = self._pending[self.max_batch:]
        feats = [f for f, _ in batch]
        B = len(feats)
        Tmax = max(len(f) for f in feats)
        Tp = max(self.t_bucket,
                 ((Tmax + self.t_bucket - 1) // self.t_bucket)
                 * self.t_bucket)
        D = feats[0].shape[1]
        x = np.zeros((B, Tp, D), np.float32)
        mask = np.zeros((B, Tp), np.float32)
        for i, f in enumerate(feats):
            x[i, :len(f)] = f
            mask[i, :len(f)] = 1.0
        try:
            out = np.asarray(self.batched_forward(x, mask))
        except Exception as e:      # propagate to every waiter
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            return
        self.num_batches += 1
        for i, (f, fut) in enumerate(batch):
            if not fut.done():
                fut.set_result(out[i, :len(f)])
        if self._pending:
            self._flush()


class BatchedSessionMixin:
    """Async accept_samples for sessions whose acoustic_fn awaits the
    batcher (DecodeSession's sync loop, awaitable)."""

    async def accept_samples_async(self, samples: np.ndarray):
        events = []
        frames = self.features.accept_waveform(samples)
        if len(frames):
            self._pending = np.concatenate([self._pending, frames])
        while len(self._pending) >= self.chunk_frames:
            chunk = self._pending[:self.chunk_frames]
            self._pending = self._pending[self.chunk_frames:]
            scores = await self.acoustic_fn(chunk)
            self.decoder.advance_decoding(scores)
            partial = self.decoder.get_partial_path()
            events.append({"type": "partial",
                           "text": self._words_to_text(partial)})
            from kaldi_aslp_tpu.online.endpoint import endpoint_detected
            trailing = self.decoder.trailing_silence_frames(self.sil_tids)
            if endpoint_detected(
                self.endpoint_config, self.decoder.num_frames_decoded,
                trailing,
                final_relative_cost=self.decoder.final_relative_cost(),
            ):
                events.append(self.finalize_sync())
        return events

    async def finalize_async(self):
        if len(self._pending):
            scores = await self.acoustic_fn(self._pending)
            self.decoder.advance_decoding(scores)
            self._pending = np.zeros((0, self.features.dim), np.float32)
        return self.finalize_sync()

    def finalize_sync(self):
        if self.decoder.num_frames_decoded == 0:
            return {"type": "final", "text": ""}
        words, _, _ = self.decoder.finalize_decoding()
        text = self._words_to_text(words)
        if getattr(self, "punctuation", None) is not None:
            text = self.punctuation.process(text)
        self.finals.append(text)
        self.decoder.reset()
        self.features.reset()
        return {"type": "final", "text": text}


from kaldi_aslp_tpu.online.server import DecodeSession  # noqa: E402


class BatchedDecodeSession(BatchedSessionMixin, DecodeSession):
    """DecodeSession whose acoustic_fn is an AcousticBatcher.compute
    coroutine; use accept_samples_async/finalize_async."""

    def accept_samples(self, samples):  # pragma: no cover - guard
        raise RuntimeError(
            "BatchedDecodeSession is async; use accept_samples_async")

    def finalize(self):  # pragma: no cover - guard
        raise RuntimeError(
            "BatchedDecodeSession is async; use finalize_async")
