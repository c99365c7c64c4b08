"""MFCC features (reference: src/feat/feature-mfcc.{h,cc}).

fbank pipeline + DCT-II + cepstral liftering, all batched; the DCT is a
second matmul."""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.feats.window import (
    FrameExtractionOptions,
    compute_power_spectrum,
    extract_frames,
    process_window,
    window_function,
)
from kaldi_aslp_tpu.feats.mel import MelBanksOptions, mel_banks_matrix


@dataclasses.dataclass
class MfccOptions(Config):
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    htk_compat: bool = False


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (reference: matrix-functions.cc ComputeDctMatrix)."""
    m = np.zeros((num_rows, num_cols), dtype=np.float64)
    m[0, :] = math.sqrt(1.0 / num_cols)
    for r in range(1, num_rows):
        for c in range(num_cols):
            m[r, c] = math.sqrt(2.0 / num_cols) * math.cos(
                math.pi / num_cols * (c + 0.5) * r
            )
    return m.astype(np.float32)


def lifter_coeffs(q: float, n: int) -> np.ndarray:
    """(reference: mel-computations.cc ComputeLifterCoeffs)."""
    i = np.arange(n, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


class Mfcc:
    """Compute MFCCs (reference: feature-mfcc.cc:94 Mfcc::Compute)."""

    def __init__(
        self,
        frame_opts: FrameExtractionOptions | None = None,
        mel_opts: MelBanksOptions | None = None,
        mfcc_opts: MfccOptions | None = None,
        vtln_warp: float = 1.0,
    ):
        self.frame_opts = frame_opts or FrameExtractionOptions()
        self.mel_opts = mel_opts or MelBanksOptions()
        self.opts = mfcc_opts or MfccOptions()
        # constants are kept as HOST numpy so the jitted _compute embeds
        # them as HLO literals: a jit must not close over a DEVICE array
        # (tests/test_no_device_consts.py)
        self._mel = np.asarray(
            mel_banks_matrix(self.mel_opts, self.frame_opts, vtln_warp),
            np.float32,
        )
        # full-size DCT then truncated to num_ceps, transposed for x @ D
        self._dct = np.asarray(
            dct_matrix(self.opts.num_ceps, self.mel_opts.num_bins).T,
            np.float32,
        )
        self._lifter = (
            np.asarray(lifter_coeffs(self.opts.cepstral_lifter,
                                     self.opts.num_ceps), np.float32)
            if self.opts.cepstral_lifter != 0.0 else None
        )
        self._window = np.asarray(window_function(self.frame_opts),
                                  np.float32)

    @property
    def dim(self) -> int:
        return self.opts.num_ceps

    def __call__(self, waveform, key: jax.Array | None = None) -> jnp.ndarray:
        # bucket-padded like Fbank.__call__ to bound compile count
        from kaldi_aslp_tpu.feats.window import num_frames as _nf

        wav = np.asarray(waveform, np.float32)
        n_true = _nf(len(wav), self.frame_opts)
        bucket = int(self.frame_opts.samp_freq)
        padded = int(np.ceil(max(len(wav), 1) / bucket)) * bucket
        if padded > len(wav):
            wav = np.pad(wav, (0, padded - len(wav)))
        out = self._compute(jnp.asarray(wav), key)
        return out[:n_true]

    @partial(jax.jit, static_argnums=0)
    def _compute(self, waveform: jnp.ndarray, key) -> jnp.ndarray:
        frames = extract_frames(waveform, self.frame_opts)
        frames, log_energy = process_window(
            frames, self.frame_opts, self._window, key,
            raw_energy=self.opts.raw_energy,
        )
        power = compute_power_spectrum(frames, self.frame_opts)
        mel_energies = jnp.dot(
            power[:, :-1], self._mel, preferred_element_type=jnp.float32
        )
        if self.mel_opts.htk_mode:
            # HTK-like energy floor (reference: mel-computations.cc
            # MelBanks::Compute "if (htk_mode_ && energy < 1.0)")
            mel_energies = jnp.maximum(mel_energies, 1.0)
        log_mel = jnp.log(
            jnp.maximum(mel_energies, jnp.finfo(jnp.float32).tiny)
        )
        feats = jnp.dot(log_mel, self._dct, preferred_element_type=jnp.float32)
        if self._lifter is not None:
            feats = feats * self._lifter
        if self.opts.use_energy:
            if self.opts.energy_floor > 0.0:
                log_energy = jnp.maximum(
                    log_energy, float(np.log(self.opts.energy_floor))
                )
            feats = feats.at[:, 0].set(log_energy)
        if self.opts.htk_compat:
            # energy/C0 moves to the last column; pure-C0 gets the
            # sqrt(2) rescale (reference: feature-mfcc.cc:174-181)
            first = feats[:, :1]
            if not self.opts.use_energy:
                first = first * math.sqrt(2.0)
            feats = jnp.concatenate([feats[:, 1:], first], axis=-1)
        return feats
