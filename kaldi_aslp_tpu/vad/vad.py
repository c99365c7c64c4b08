"""Voice activity detection: frame FSM + energy / NN detectors.

JAX-native equivalent of the reference VAD stack (reference:
src/aslp-vad/vad.h:16-55 options + kSilence↔kSpeech FSM at vad.cc:34-80,
VadAll :81, Lookback :87; energy-vad.h:27 EnergyVad; nnet-vad.cc:9-69
NnetVad silence-posterior thresholding).

Per-frame scores are computed batched on device (energy or NN
posteriors); the tiny state machine smoothing runs on host numpy."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config


@dataclasses.dataclass
class VadOptions(Config):
    frame_length_ms: int = 10
    speech_trigger_ms: int = 50     # consecutive voiced → enter speech
    silence_trigger_ms: int = 200   # consecutive silence → leave speech
    lookback_ms: int = 100          # mark frames before trigger as speech
    energy_threshold: float = 9.0   # log-energy threshold (EnergyVad)
    sil_posterior_threshold: float = 0.5  # NnetVad
    sil_pdf_ids: str = "0"          # silence pdf columns, colon-separated


class Vad:
    """FSM smoothing over per-frame voicing decisions
    (reference: vad.cc:34-80)."""

    SILENCE, SPEECH = 0, 1

    def __init__(self, opts: Optional[VadOptions] = None):
        self.opts = opts or VadOptions()
        f = self.opts.frame_length_ms
        self._speech_trigger = max(1, self.opts.speech_trigger_ms // f)
        self._sil_trigger = max(1, self.opts.silence_trigger_ms // f)
        self._lookback = max(0, self.opts.lookback_ms // f)

    def is_speech_frame(self, frame) -> bool:  # detector hook
        raise NotImplementedError

    def smooth(self, raw: np.ndarray) -> np.ndarray:
        """Raw per-frame booleans → smoothed speech mask (VadAll)."""
        raw = np.asarray(raw, bool)
        out = np.zeros(len(raw), bool)
        state = self.SILENCE
        run = 0
        for t, voiced in enumerate(raw):
            if state == self.SILENCE:
                run = run + 1 if voiced else 0
                if run >= self._speech_trigger:
                    state = self.SPEECH
                    start = max(0, t - run + 1 - self._lookback)
                    out[start:t + 1] = True
                    run = 0
            else:
                out[t] = True
                run = run + 1 if not voiced else 0
                if run >= self._sil_trigger:
                    state = self.SILENCE
                    out[t - run + 1:t + 1] = False
                    run = 0
        return out

    def vad_all(self, frames) -> np.ndarray:
        raw = np.array([self.is_speech_frame(f) for f in frames], bool)
        return self.smooth(raw)


class EnergyVad(Vad):
    """(reference: energy-vad.h:27) — log-energy threshold."""

    def frame_scores(self, waveform_frames: np.ndarray) -> np.ndarray:
        """[T, window] → [T] log energies (device)."""
        e = jnp.log(jnp.maximum(
            jnp.sum(jnp.asarray(waveform_frames) ** 2, axis=-1), 1e-10
        ))
        return np.asarray(e)

    def is_speech_frame(self, frame) -> bool:
        e = float(np.log(max(np.sum(np.square(frame)), 1e-10)))
        return e > self.opts.energy_threshold

    def detect(self, waveform_frames: np.ndarray) -> np.ndarray:
        return self.smooth(
            self.frame_scores(waveform_frames) > self.opts.energy_threshold
        )


class NnetVad(Vad):
    """(reference: nnet-vad.cc:9-69) — speech if silence posterior sum
    below threshold."""

    def __init__(self, opts: Optional[VadOptions] = None):
        super().__init__(opts)
        self.sil_ids = [int(i) for i in
                        str(self.opts.sil_pdf_ids).split(":")]

    def detect_from_posteriors(self, post: np.ndarray) -> np.ndarray:
        """[T, P] posteriors → speech mask."""
        sil = np.asarray(post)[:, self.sil_ids].sum(axis=1)
        return self.smooth(sil < self.opts.sil_posterior_threshold)


def select_frames(feats: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(reference: aslp-vadbin/aslp-select-frames.cc)."""
    return np.asarray(feats)[np.asarray(mask, bool)]


def ali_to_sil_targets(ali_pdfs: np.ndarray, sil_pdfs) -> np.ndarray:
    """(reference: aslp-vadbin/aslp-ali-to-sil.cc) — 0=sil, 1=speech."""
    sil = np.isin(np.asarray(ali_pdfs), np.asarray(list(sil_pdfs)))
    return (~sil).astype(np.int32)
