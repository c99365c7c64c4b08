"""Streaming feature pipeline: incremental fbank/MFCC + online CMVN.

JAX-native equivalent of the reference online feature stack (reference:
src/aslp-online/online-feature-pipeline.h:159 OnlineFeaturePipeline,
OnlineVadFeaturePipeline; src/itf/online-feature-itf.h:49).

Samples buffer host-side; whenever enough arrive, the finished frames
are computed with the batched extractor (identical values to offline —
frames depend only on their own samples), then sliding-window CMN is
applied over frames seen so far."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.feats import (
    Fbank,
    FbankOptions,
    FrameExtractionOptions,
    MelBanksOptions,
    Mfcc,
    MfccOptions,
)


@dataclasses.dataclass
class OnlineFeatureOptions(Config):
    feature_type: str = "fbank"  # fbank|mfcc
    samp_freq: float = 16000.0
    num_mel_bins: int = 40
    num_ceps: int = 13
    cmn_window: int = 600
    min_cmn_window: int = 100
    apply_cmn: bool = True


class OnlineFeaturePipeline:
    def __init__(self, opts: Optional[OnlineFeatureOptions] = None):
        self.opts = opts or OnlineFeatureOptions()
        frame_opts = FrameExtractionOptions(
            samp_freq=self.opts.samp_freq, dither=0.0
        )
        if self.opts.feature_type == "fbank":
            self._extractor = Fbank(
                frame_opts, MelBanksOptions(num_bins=self.opts.num_mel_bins),
                FbankOptions(),
            )
        else:
            self._extractor = Mfcc(
                frame_opts, MelBanksOptions(),
                MfccOptions(num_ceps=self.opts.num_ceps),
            )
        self._frame_opts = frame_opts
        self.reset()

    def reset(self) -> None:
        self._samples = np.zeros(0, np.float32)
        self._consumed_frames = 0
        self._raw_frames: list = []
        self._cmn_sum = np.zeros(self.dim, np.float64)
        self._cmn_frames: list = []

    @property
    def dim(self) -> int:
        return self._extractor.dim

    def accept_waveform(self, samples: np.ndarray) -> np.ndarray:
        """Append samples; return the newly finished post-CMN frames."""
        self._samples = np.concatenate(
            [self._samples, np.asarray(samples, np.float32)]
        )
        opts = self._frame_opts
        total = (1 + (len(self._samples) - opts.window_size)
                 // opts.window_shift
                 if len(self._samples) >= opts.window_size else 0)
        if total <= self._consumed_frames:
            return np.zeros((0, self.dim), np.float32)
        # recompute from the first un-consumed frame's samples
        start_sample = self._consumed_frames * opts.window_shift
        feats = np.asarray(self._extractor(self._samples[start_sample:]))
        new = feats[: total - self._consumed_frames]
        self._consumed_frames = total
        return self._apply_cmn(new)

    def _apply_cmn(self, frames: np.ndarray) -> np.ndarray:
        if not self.opts.apply_cmn:
            return frames
        out = np.empty_like(frames)
        for i, f in enumerate(frames):
            self._cmn_frames.append(f)
            self._cmn_sum += f
            if len(self._cmn_frames) > self.opts.cmn_window:
                self._cmn_sum -= self._cmn_frames.pop(0)
            n = len(self._cmn_frames)
            if n >= self.opts.min_cmn_window:
                out[i] = f - self._cmn_sum / n
            else:
                # warm-up: normalize by what we have (the reference uses
                # global stats fallback; mean-so-far is the stable choice)
                out[i] = f - self._cmn_sum / max(n, 1)
        return out
