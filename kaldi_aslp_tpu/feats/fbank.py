"""Log-mel filterbank features (reference: src/feat/feature-fbank.{h,cc}).

Whole-utterance batched computation: one strided-frame gather, fused
window chain, one rfft, one matmul against the precomputed mel
matrix."""

from __future__ import annotations

import dataclasses
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
class FbankOptions(Config):
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True
    use_power: bool = True
    htk_compat: bool = False


class Fbank:
    """Compute fbank features (reference: feature-fbank.cc:80 Fbank::Compute)."""

    def __init__(
        self,
        frame_opts: FrameExtractionOptions | None = None,
        mel_opts: MelBanksOptions | None = None,
        fbank_opts: FbankOptions | None = None,
        vtln_warp: float = 1.0,
    ):
        self.frame_opts = frame_opts or FrameExtractionOptions()
        self.mel_opts = mel_opts or MelBanksOptions()
        self.opts = fbank_opts or FbankOptions()
        # host numpy, NOT device arrays: a jit must not close over a
        # device array (tests/test_no_device_consts.py)
        self._mel = np.asarray(
            mel_banks_matrix(self.mel_opts, self.frame_opts, vtln_warp),
            np.float32,
        )
        self._window = np.asarray(window_function(self.frame_opts),
                                  np.float32)

    @property
    def dim(self) -> int:
        return self.mel_opts.num_bins + (1 if self.opts.use_energy else 0)

    def __call__(self, waveform, key: jax.Array | None = None) -> jnp.ndarray:
        """[num_samples] → [num_frames, dim] on device.

        The waveform is zero-padded to a sample bucket so XLA compiles
        one kernel per bucket instead of one per utterance length; the
        true frame count is sliced out (identical values — padded
        samples only affect frames past the true count)."""
        from kaldi_aslp_tpu.feats.window import num_frames as _nf

        wav = np.asarray(waveform, np.float32)
        n_true = _nf(len(wav), self.frame_opts)
        bucket = int(self.frame_opts.samp_freq)  # 1 s
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
        if not self.opts.use_power:
            power = jnp.sqrt(power)
        # reference MelBanks covers bins [0, N/2); drop the nyquist bin
        mel_energies = jnp.dot(
            power[:, :-1], self._mel, preferred_element_type=jnp.float32
        )
        if self.mel_opts.htk_mode:
            # HTK-like energy floor (reference: mel-computations.cc
            # MelBanks::Compute "if (htk_mode_ && energy < 1.0)")
            mel_energies = jnp.maximum(mel_energies, 1.0)
        if self.opts.use_log_fbank:
            mel_energies = jnp.log(
                jnp.maximum(mel_energies, jnp.finfo(jnp.float32).tiny)
            )
        if self.opts.use_energy:
            if self.opts.energy_floor > 0.0:
                log_energy = jnp.maximum(
                    log_energy, float(np.log(self.opts.energy_floor))
                )
            col = log_energy[:, None]
            if self.opts.htk_compat:
                return jnp.concatenate([mel_energies, col], axis=-1)
            return jnp.concatenate([col, mel_energies], axis=-1)
        return mel_energies
