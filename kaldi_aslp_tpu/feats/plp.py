"""Spectrogram and PLP features (reference: src/feat/feature-spectrogram.
{h,cc}, feature-plp.{h,cc} — mel/bark filterbank, equal-loudness
preemphasis, intensity-to-loudness compression, autocorrelation → LPC via
Levinson-Durbin, cepstral recursion)."""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.feats.window import (
    FrameExtractionOptions,
    compute_power_spectrum,
    extract_frames,
    num_frames,
    process_window,
    window_function,
)
from kaldi_aslp_tpu.feats.mel import MelBanksOptions, mel_banks_matrix
from kaldi_aslp_tpu.feats.mfcc import lifter_coeffs


class Spectrogram:
    """Log power spectrogram (reference: feature-spectrogram.cc)."""

    def __init__(self, frame_opts: FrameExtractionOptions | None = None):
        self.frame_opts = frame_opts or FrameExtractionOptions()
        # host numpy (HLO literal), not a device array: a jit must not
        # close over a device array (tests/test_no_device_consts.py)
        self._window = np.asarray(window_function(self.frame_opts),
                                  np.float32)

    @property
    def dim(self) -> int:
        return self.frame_opts.padded_window_size // 2 + 1

    def __call__(self, waveform, key=None) -> jnp.ndarray:
        wav = np.asarray(waveform, np.float32)
        n_true = num_frames(len(wav), self.frame_opts)
        bucket = int(self.frame_opts.samp_freq)
        padded = int(np.ceil(max(len(wav), 1) / bucket)) * bucket
        if padded > len(wav):
            wav = np.pad(wav, (0, padded - len(wav)))
        return self._compute(jnp.asarray(wav), key)[:n_true]

    @partial(jax.jit, static_argnums=0)
    def _compute(self, waveform, key):
        frames = extract_frames(waveform, self.frame_opts)
        frames, log_energy = process_window(
            frames, self.frame_opts, self._window, key
        )
        power = compute_power_spectrum(frames, self.frame_opts)
        out = jnp.log(jnp.maximum(power, jnp.finfo(jnp.float32).tiny))
        return out.at[:, 0].set(log_energy)


@dataclasses.dataclass
class PlpOptions(Config):
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False


def equal_loudness_curve(mel_opts: MelBanksOptions,
                         frame_opts: FrameExtractionOptions,
                         vtln_warp: float = 1.0) -> np.ndarray:
    """Per-mel-bin equal loudness weights over the (possibly warped)
    bin center frequencies (reference: feature-functions.cc
    GetEqualLoudnessVector over MelBanks::GetCenterFreqs)."""
    from kaldi_aslp_tpu.feats.mel import (inverse_mel_scale, mel_scale,
                                          vtln_warp_freq)

    nyquist = 0.5 * frame_opts.samp_freq
    low = mel_opts.low_freq
    high = mel_opts.high_freq if mel_opts.high_freq > 0 else \
        nyquist + mel_opts.high_freq
    vtln_high = mel_opts.vtln_high
    if vtln_high < 0:
        vtln_high += nyquist
    mel_low = mel_scale(low)
    mel_high = mel_scale(high)
    delta = (mel_high - mel_low) / (mel_opts.num_bins + 1)
    out = np.zeros(mel_opts.num_bins)
    for b in range(mel_opts.num_bins):
        center_mel = mel_low + (b + 1) * delta
        if vtln_warp != 1.0:
            center_mel = mel_scale(vtln_warp_freq(
                mel_opts.vtln_low, vtln_high, low, high, vtln_warp,
                inverse_mel_scale(center_mel)))
        fsq = inverse_mel_scale(center_mel) ** 2
        fsub = fsq / (fsq + 1.6e5)
        out[b] = fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))
    return out.astype(np.float32)


def _durbin(autocorr: np.ndarray, order: int):
    """Batched Durbin recursion, mirroring the reference's sign
    convention — predicted s_n = sum a_i s_{n-i} with stored pLP = -a
    and the 1e-5 floor on (1-k^2) (reference: mel-computations.cc:262
    Durbin).  [T, order+1] → (pLP [T, order], residual E [T])."""
    T = autocorr.shape[0]
    lp = np.zeros((T, order))
    E = autocorr[:, 0].copy()
    for i in range(order):
        ki = autocorr[:, i + 1].copy()
        for j in range(i):
            ki += lp[:, j] * autocorr[:, i - j]
        ki = ki / E
        c = np.maximum(1.0 - ki * ki, 1.0e-5)
        E = E * c
        new = lp.copy()
        new[:, i] = -ki
        for j in range(i):
            new[:, j] = lp[:, j] - ki * lp[:, i - j - 1]
        lp = new
    return lp, E


def _lpc_to_cepstrum(lp: np.ndarray, order: int) -> np.ndarray:
    """LPC → raw cepstrum, C0 not included (reference:
    mel-computations.cc:295 Lpc2Cepstrum)."""
    T = lp.shape[0]
    c = np.zeros((T, order))
    for i in range(order):
        acc = np.zeros(T)
        for j in range(i):
            acc += (i - j) * lp[:, j] * c[:, i - j - 1]
        c[:, i] = -lp[:, i] - acc / (i + 1)
    return c


class Plp:
    """PLP features (reference: feature-plp.cc Plp::Compute).

    Filterbank/compression run batched on device; the tiny LPC solve is
    host numpy per utterance."""

    def __init__(self, frame_opts: FrameExtractionOptions | None = None,
                 mel_opts: MelBanksOptions | None = None,
                 plp_opts: PlpOptions | None = None,
                 vtln_warp: float = 1.0):
        self.frame_opts = frame_opts or FrameExtractionOptions()
        self.mel_opts = mel_opts or MelBanksOptions()
        self.opts = plp_opts or PlpOptions()
        if self.opts.num_ceps > self.opts.lpc_order + 1:
            raise ValueError("num_ceps must be <= lpc_order + 1")
        # host numpy (HLO literals), not device arrays: a jit must not
        # close over a device array (tests/test_no_device_consts.py)
        self._mel = np.asarray(
            mel_banks_matrix(self.mel_opts, self.frame_opts, vtln_warp),
            np.float32,
        )
        self._eql = np.asarray(
            equal_loudness_curve(self.mel_opts, self.frame_opts, vtln_warp),
            np.float32,
        )
        self._window = np.asarray(window_function(self.frame_opts),
                                  np.float32)
        self._lifter = lifter_coeffs(self.opts.cepstral_lifter,
                                     self.opts.num_ceps) \
            if self.opts.cepstral_lifter != 0 else None

    @property
    def dim(self) -> int:
        return self.opts.num_ceps

    def __call__(self, waveform, key=None) -> np.ndarray:
        wav = np.asarray(waveform, np.float32)
        n_true = num_frames(len(wav), self.frame_opts)
        bucket = int(self.frame_opts.samp_freq)
        padded = int(np.ceil(max(len(wav), 1) / bucket)) * bucket
        if padded > len(wav):
            wav = np.pad(wav, (0, padded - len(wav)))
        audspec, log_energy = self._device_part(jnp.asarray(wav), key)
        audspec = np.asarray(audspec, np.float64)[:n_true]
        log_energy = np.asarray(log_energy)[:n_true]
        # duplicate first/last bins, then autocorrelation via the IDFT
        # bases (reference: feature-plp.cc:215-224 + feature-functions.cc
        # InitIdftBases — the half-weighted end columns below expand to
        # exactly those bases)
        padded_spec = np.concatenate(
            [audspec[:, :1], audspec, audspec[:, -1:]], axis=1
        )
        M = padded_spec.shape[1]
        order = self.opts.lpc_order
        freqs = np.pi * np.arange(M) / (M - 1)
        idft = np.cos(np.outer(np.arange(order + 1), freqs))
        idft[:, 0] *= 0.5
        idft[:, -1] *= 0.5
        autocorr = padded_spec @ idft.T / (M - 1)
        # Durbin → residual energy forms C0 (reference:
        # feature-functions.cc ComputeLpc "-Log(1.0/ans)")
        lp, resid = _durbin(autocorr, order)
        energy = -np.log(1.0 / np.maximum(resid, np.finfo(np.float32).tiny))
        raw = _lpc_to_cepstrum(lp, order)
        ceps = np.concatenate(
            [energy[:, None], raw[:, :self.opts.num_ceps - 1]], axis=1
        )
        if self._lifter is not None:
            ceps = ceps * self._lifter
        if self.opts.cepstral_scale != 1.0:
            ceps = ceps * self.opts.cepstral_scale
        if self.opts.use_energy:
            e = log_energy
            if self.opts.energy_floor > 0:
                e = np.maximum(e, math.log(self.opts.energy_floor))
            ceps[:, 0] = e
        if self.opts.htk_compat:
            # C0/energy last; unlike MFCC no sqrt(2) rescale
            # (reference: feature-plp.cc:250-259)
            ceps = np.concatenate([ceps[:, 1:], ceps[:, :1]], axis=1)
        return ceps.astype(np.float32)

    @partial(jax.jit, static_argnums=0)
    def _device_part(self, waveform, key):
        frames = extract_frames(waveform, self.frame_opts)
        frames, log_energy = process_window(
            frames, self.frame_opts, self._window, key,
            raw_energy=self.opts.raw_energy,
        )
        power = compute_power_spectrum(frames, self.frame_opts)
        mel_energies = jnp.dot(power[:, :-1], self._mel,
                               preferred_element_type=jnp.float32)
        if self.mel_opts.htk_mode:
            mel_energies = jnp.maximum(mel_energies, 1.0)
        audspec = (mel_energies * self._eql) ** self.opts.compress_factor
        return audspec, log_energy
