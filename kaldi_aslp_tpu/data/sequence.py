"""Sequence data readers: multi-stream truncated-BPTT chunks and
whole-utterance CTC stream batches.

JAX-native equivalents of the reference sequence path (reference:
src/aslp-nnet/data-reader.{h,cc} SequenceDataReader — N parallel utterance
streams, truncated-BPTT chunks of batch_size frames with per-stream
cursors, new_utt_flags for state reset, target delay, frame skipping,
drop_len/frame_limit guards, padding + frame_mask; defaults batch_size=20
num_stream=100 targets_delay=5 at data-reader.h:58-60; and the stream
filling loop of aslp-nnetbin/aslp-nnet-train-ctc-streams.cc:118-204).

Layout difference: chunks are [S, T_chunk, D] batch-major (not the
reference's interleaved t*S+s rows) to match the scan-based recurrent
components."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from kaldi_aslp_tpu.utils.config import Config


@dataclasses.dataclass
class SequenceReaderOptions(Config):
    batch_size: int = 20        # BPTT chunk length
    num_streams: int = 100
    targets_delay: int = 5
    skip_width: int = 1         # take every k-th frame (1 = none)
    skip_offset: int = 0
    drop_len: int = 0           # drop utts longer than this (0 = off)


@dataclasses.dataclass
class SequenceChunk:
    feats: np.ndarray        # [S, T, D]
    targets: np.ndarray      # [S, T] int32
    frame_mask: np.ndarray   # [S, T] float32
    new_utt_flags: np.ndarray  # [S] int32, 1 = stream restarted


class _Stream:
    def __init__(self):
        self.feats: Optional[np.ndarray] = None
        self.targets: Optional[np.ndarray] = None
        self.pos = 0
        self.fresh = False

    @property
    def remaining(self) -> int:
        return 0 if self.feats is None else len(self.feats) - self.pos


def _apply_skip(feats, targets, width, offset):
    """Frame skipping (reference: data-reader.cc:240-250)."""
    if width <= 1:
        return feats, targets
    idx = np.arange(offset, len(feats), width)
    return feats[idx], (targets[idx] if targets is not None else None)


def _apply_delay(feats, targets, delay):
    """Target delay: prediction at t targets label t-delay
    (reference: data-reader.cc target_delay handling).  Implemented by
    extending the utterance with `delay` copies of the last frame and
    shifting labels right."""
    if delay <= 0:
        return feats, targets
    ext = np.concatenate([feats, np.repeat(feats[-1:], delay, axis=0)])
    tgt = np.concatenate([np.full(delay, targets[0], targets.dtype),
                          targets])
    return ext, tgt


class SequenceDataReader:
    """Truncated-BPTT chunk iterator over an utterance source.

    source: iterator of (key, feats [T,D], targets [T]) tuples."""

    def __init__(
        self,
        source: Iterator[Tuple[str, np.ndarray, np.ndarray]],
        opts: Optional[SequenceReaderOptions] = None,
    ):
        self.opts = opts or SequenceReaderOptions()
        self._source = iter(source)
        self._streams = [_Stream() for _ in range(self.opts.num_streams)]
        self._exhausted = False
        self.num_dropped = 0

    def _refill(self) -> None:
        """AddNewUtt (reference: data-reader.cc:200)."""
        for s in self._streams:
            while s.remaining == 0 and not self._exhausted:
                try:
                    key, feats, targets = next(self._source)
                except StopIteration:
                    self._exhausted = True
                    break
                if self.opts.drop_len > 0 and len(feats) > self.opts.drop_len:
                    self.num_dropped += 1
                    continue
                n = min(len(feats), len(targets))
                if n == 0:
                    continue
                feats, targets = feats[:n], targets[:n]
                feats, targets = _apply_skip(
                    feats, targets, self.opts.skip_width,
                    self.opts.skip_offset,
                )
                feats, targets = _apply_delay(
                    feats, targets, self.opts.targets_delay
                )
                s.feats, s.targets, s.pos, s.fresh = feats, targets, 0, True

    def __iter__(self) -> Iterator[SequenceChunk]:
        T = self.opts.batch_size
        while True:
            self._refill()
            active = [s for s in self._streams if s.remaining > 0]
            if not active:
                return
            S = len(self._streams)
            dim = active[0].feats.shape[1]
            feats = np.zeros((S, T, dim), np.float32)
            targets = np.zeros((S, T), np.int32)
            mask = np.zeros((S, T), np.float32)
            flags = np.zeros((S,), np.int32)
            for i, s in enumerate(self._streams):
                if s.remaining == 0:
                    continue
                if s.fresh:
                    flags[i] = 1
                    s.fresh = False
                n = min(T, s.remaining)
                feats[i, :n] = s.feats[s.pos:s.pos + n]
                targets[i, :n] = s.targets[s.pos:s.pos + n]
                mask[i, :n] = 1.0
                s.pos += n
            yield SequenceChunk(feats, targets, mask, flags)


@dataclasses.dataclass
class CtcBatcherOptions(Config):
    num_streams: int = 16
    frame_limit: int = 25000    # max total frames per batch
    drop_len: int = 0
    skip_width: int = 1
    bucket_time: int = 64       # pad T to a multiple (bucketed compilation)
    bucket_labels: int = 16     # pad U to a multiple
    sort_by_length: bool = True


@dataclasses.dataclass
class CtcBatch:
    keys: List[str]
    feats: np.ndarray          # [S, T_max, D]
    labels: np.ndarray         # [S, U_max] int32
    input_lengths: np.ndarray  # [S]
    label_lengths: np.ndarray  # [S]
    frame_mask: np.ndarray     # [S, T_max]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class CtcBatcher:
    """Whole-utterance batches for CTC training (reference:
    aslp-nnet-train-ctc-streams.cc:118-204 stream filling, plus shape
    bucketing: T and U are padded to multiples so XLA compiles a small
    number of shapes instead of one per batch)."""

    def __init__(self, source, opts: Optional[CtcBatcherOptions] = None):
        self.opts = opts or CtcBatcherOptions()
        self._source = iter(source)
        self.num_dropped = 0

    def __iter__(self) -> Iterator[CtcBatch]:
        opts = self.opts
        pending: List[Tuple[str, np.ndarray, np.ndarray]] = []
        frames = 0

        def make_batch(items):
            if opts.sort_by_length:
                items = sorted(items, key=lambda kv: -len(kv[1]))
            S = len(items)
            T = _round_up(max(len(f) for _, f, _ in items),
                          opts.bucket_time)
            U = _round_up(max(max(len(l) for _, _, l in items), 1),
                          opts.bucket_labels)
            D = items[0][1].shape[1]
            # feature padding via the native single-pass assembler when
            # available (the data-reader.cc stream-fill role,
            # native/batch_pack.cc); numpy loop otherwise
            from kaldi_aslp_tpu import native
            packed = native.pad_pack([f for _, f, _ in items], T, "f32")
            feats = packed[0] if packed is not None else None
            if feats is None:
                feats = np.zeros((S, T, D), np.float32)
                for i, (_, f, _) in enumerate(items):
                    feats[i, :len(f)] = f
            labels = np.zeros((S, U), np.int32)
            in_lens = np.zeros((S,), np.int32)
            lab_lens = np.zeros((S,), np.int32)
            mask = np.zeros((S, T), np.float32)
            keys = []
            for i, (k, f, l) in enumerate(items):
                keys.append(k)
                labels[i, :len(l)] = l
                in_lens[i] = len(f)
                lab_lens[i] = len(l)
                mask[i, :len(f)] = 1.0
            return CtcBatch(keys, feats, labels, in_lens, lab_lens, mask)

        for key, f, l in self._source:
            if opts.drop_len > 0 and len(f) > opts.drop_len:
                self.num_dropped += 1
                continue
            if opts.skip_width > 1:
                f, _ = _apply_skip(f, None, opts.skip_width, 0)
            if len(f) < 2 * len(l) + 1 or len(l) == 0:
                self.num_dropped += 1  # unalignable (too few frames)
                continue
            pending.append((key, f, np.asarray(l, np.int32)))
            frames += len(f)
            if len(pending) >= opts.num_streams or frames >= opts.frame_limit:
                yield make_batch(pending)
                pending, frames = [], 0
        if pending:
            yield make_batch(pending)
