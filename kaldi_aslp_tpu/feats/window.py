"""Frame extraction: dither, DC removal, preemphasis, windowing.

JAX-native re-design of the reference frame pipeline (reference:
src/feat/feature-functions.h:73-132, feature-window semantics of
FrameExtractionOptions in src/feat/feature-mfcc.h / feature-fbank.h).
Instead of a per-frame loop, all frames of a (batch of) waveform(s) are
materialized as one [num_frames, frame_length] matrix and every step is a
batched elementwise/matmul op so XLA fuses the chain and the mel projection
is one matmul.

Option defaults mirror the reference exactly (frame_shift 10ms, length 25ms,
dither 1.0, preemph 0.97, remove_dc_offset, povey window, snip_edges,
round_to_power_of_two) so features are comparable bit-for-bit when
dither=0 (dither uses JAX PRNG, not Kaldi's RandGauss, hence not
bit-matching when enabled).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_aslp_tpu.utils.config import Config


@dataclasses.dataclass
class FrameExtractionOptions(Config):
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular|blackman
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return 1 << (self.window_size - 1).bit_length()
        return self.window_size


def num_frames(num_samples: int, opts: FrameExtractionOptions) -> int:
    """Frame count (reference: feature-window.cc NumFrames, snip_edges path)."""
    if opts.snip_edges:
        if num_samples < opts.window_size:
            return 0
        return 1 + (num_samples - opts.window_size) // opts.window_shift
    return (num_samples + opts.window_shift // 2) // opts.window_shift


def window_function(opts: FrameExtractionOptions) -> np.ndarray:
    """The window vector (reference: feature-window.cc FeatureWindowFunction)."""
    M = opts.window_size
    n = np.arange(M, dtype=np.float64)
    a = 2 * math.pi / (M - 1)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(M)
    elif opts.window_type == "blackman":
        w = (opts.blackman_coeff - 0.5 * np.cos(a * n)
             + (0.5 - opts.blackman_coeff) * np.cos(2 * a * n))
    else:
        raise ValueError(f"unknown window type {opts.window_type!r}")
    return w.astype(np.float32)


def extract_frames(
    waveform: jnp.ndarray, opts: FrameExtractionOptions
) -> jnp.ndarray:
    """[num_samples] → [num_frames, window_size] strided frame matrix."""
    n = num_frames(waveform.shape[-1], opts)
    shift, size = opts.window_shift, opts.window_size
    if n == 0:
        return jnp.zeros((0, size), waveform.dtype)
    if opts.snip_edges:
        starts = jnp.arange(n) * shift
        idx = starts[:, None] + jnp.arange(size)[None, :]
        return waveform[idx]
    # reflect-pad so each frame is centered on its shift window
    # (reference: feature-window.cc ExtractWindow, snip_edges=false)
    centers = jnp.arange(n) * shift + shift // 2
    starts = centers - size // 2
    idx = starts[:, None] + jnp.arange(size)[None, :]
    num_samples = waveform.shape[-1]
    idx = jnp.where(idx < 0, -idx - 1, idx)
    idx = jnp.where(idx >= num_samples, 2 * num_samples - idx - 1, idx)
    return waveform[idx]


def process_window(
    frames: jnp.ndarray,
    opts: FrameExtractionOptions,
    window: jnp.ndarray,
    key: jax.Array | None = None,
    raw_energy: bool = True,
):
    """Dither → DC removal → (raw log-energy) → preemphasis → window.

    Returns (processed_frames, log_energy).  Order matches the reference
    (feature-window.cc ProcessWindow): energy is computed pre-preemphasis
    when raw_energy (the default in MfccOptions/FbankOptions).
    """
    if opts.dither != 0.0 and key is not None:
        frames = frames + opts.dither * jax.random.normal(
            key, frames.shape, frames.dtype
        )
    if opts.remove_dc_offset:
        frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    eps = jnp.finfo(jnp.float32).tiny
    log_energy = jnp.log(
        jnp.maximum(jnp.sum(frames * frames, axis=-1), eps)
    )
    if opts.preemphasis_coefficient != 0.0:
        c = opts.preemphasis_coefficient
        shifted = jnp.concatenate([frames[..., :1], frames[..., :-1]], axis=-1)
        frames = frames - c * shifted
    frames = frames * window
    if not raw_energy:
        log_energy = jnp.log(
            jnp.maximum(jnp.sum(frames * frames, axis=-1), eps)
        )
    return frames, log_energy


def compute_power_spectrum(
    frames: jnp.ndarray, opts: FrameExtractionOptions
) -> jnp.ndarray:
    """Zero-pad to padded_window_size, rfft, |.|^2.

    [num_frames, window_size] → [num_frames, padded/2+1].
    (reference: srfft + ComputePowerSpectrum, feature-functions.cc)
    """
    pad = opts.padded_window_size - opts.window_size
    if pad > 0:
        frames = jnp.pad(frames, [(0, 0)] * (frames.ndim - 1) + [(0, pad)])
    spec = jnp.fft.rfft(frames, axis=-1)
    return (spec.real ** 2 + spec.imag ** 2).astype(jnp.float32)
