"""Mel filterbank matrix (reference: src/feat/mel-computations.{h,cc}).

Built once on host as a dense [num_fft_bins, num_mel_bins] matrix so the
mel projection is a single matmul per batch of frames (the reference
loops over bins per frame on CPU/GPU)."""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.feats.window import FrameExtractionOptions


@dataclasses.dataclass
class MelBanksOptions(Config):
    num_bins: int = 23  # reference default (mel-computations.h:43)
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 → nyquist + high_freq
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    # replicate two HTK quirks for golden-fixture parity (reference:
    # mel-computations.cc:131-133 zeroed first weight of bin 0, and
    # MelBanks::Compute's energy floor at 1.0)
    htk_mode: bool = False


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def vtln_warp_freq(
    vtln_low_cutoff, vtln_high_cutoff, low_freq, high_freq, warp_factor, freq
):
    """Piecewise-linear VTLN warp with F(low)=low, F(high)=high and
    slope 1/warp in the middle (reference: mel-computations.cc
    MelBanks::VtlnWarpFreq — inflection points l = vtln_low*max(1,warp)
    and h = vtln_high*min(1,warp) so no bin is ever empty).

    ``vtln_high_cutoff`` must already be resolved to a positive
    frequency (the caller adds nyquist to negative values, mirroring
    mel-computations.cc:73-75)."""
    if freq < low_freq or freq > high_freq:
        return freq
    if not (vtln_low_cutoff > low_freq and vtln_high_cutoff < high_freq):
        raise ValueError(
            "vtln cutoffs must satisfy low_freq < vtln_low and "
            "vtln_high < high_freq")
    l = vtln_low_cutoff * max(1.0, warp_factor)
    h = vtln_high_cutoff * min(1.0, warp_factor)
    scale = 1.0 / warp_factor
    Fl = scale * l
    Fh = scale * h
    scale_left = (Fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - Fh) / (high_freq - h)
    if freq < l:
        return low_freq + scale_left * (freq - low_freq)
    if freq < h:
        return scale * freq
    return high_freq + scale_right * (freq - high_freq)


def mel_banks_matrix(
    mel_opts: MelBanksOptions,
    frame_opts: FrameExtractionOptions,
    vtln_warp: float = 1.0,
) -> np.ndarray:
    """Return [num_fft_bins, num_bins] triangular filter matrix.

    num_fft_bins = padded_window_size/2 (the reference's MelBanks drops the
    nyquist bin; we keep that convention and the caller slices the power
    spectrum accordingly, or we pad a zero row for the nyquist bin).
    """
    num_fft_bins = frame_opts.padded_window_size // 2
    nyquist = 0.5 * frame_opts.samp_freq
    low_freq = mel_opts.low_freq
    high_freq = (mel_opts.high_freq if mel_opts.high_freq > 0
                 else nyquist + mel_opts.high_freq)
    if not (0 <= low_freq < high_freq <= nyquist):
        raise ValueError(f"bad mel frequency range [{low_freq},{high_freq}]")

    fft_bin_width = frame_opts.samp_freq / frame_opts.padded_window_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    num_bins = mel_opts.num_bins
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    vtln_low = mel_opts.vtln_low
    vtln_high = mel_opts.vtln_high
    if vtln_high < 0:
        vtln_high += nyquist

    bins = np.zeros((num_fft_bins, num_bins), dtype=np.float32)
    for b in range(num_bins):
        left_mel = mel_low + b * mel_delta
        center_mel = mel_low + (b + 1) * mel_delta
        right_mel = mel_low + (b + 2) * mel_delta
        if vtln_warp != 1.0:
            def warp_mel(mel):
                return mel_scale(
                    vtln_warp_freq(vtln_low, vtln_high, low_freq, high_freq,
                                   vtln_warp, inverse_mel_scale(mel))
                )
            left_mel, center_mel, right_mel = (
                warp_mel(left_mel), warp_mel(center_mel), warp_mel(right_mel)
            )
        for i in range(num_fft_bins):
            mel = mel_scale(fft_bin_width * i)
            if left_mel < mel < right_mel:
                if mel <= center_mel:
                    bins[i, b] = (mel - left_mel) / (center_mel - left_mel)
                else:
                    bins[i, b] = (right_mel - mel) / (right_mel - center_mel)
    if mel_opts.htk_mode and mel_low != 0.0:
        # replicate an HTK bug: the first active weight of bin 0 is
        # zeroed (reference: mel-computations.cc:131-133)
        nz = np.nonzero(bins[:, 0])[0]
        if len(nz):
            bins[nz[0], 0] = 0.0
    return bins
