"""Pitch features: NCCF + Viterbi pitch tracking.

JAX-native equivalent of the reference pitch extractor (reference:
src/feat/pitch-functions.{h,cc} compute-kaldi-pitch-feats, the
Ghahremani et al. 2014 algorithm): per-frame normalized cross-correlation
over the candidate lag range, Viterbi smoothing over lag trajectories
with an octave-jump penalty, and the standard 2-dim output
(POV feature, log-pitch) plus the post-processing used by recipes
(mean-subtracted log pitch, delta pitch).

The NCCF grid is one batched einsum on device; the tiny lag-Viterbi is a
lax.scan."""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config


@dataclasses.dataclass
class PitchOptions(Config):
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    penalty_factor: float = 0.1     # octave-jump transition cost
    lag_penalty: float = 0.05       # short-lag preference (kills
    # subharmonic octave errors; the soft_min_f0 role in the reference)
    nccf_ballast: float = 7000.0


def _nccf_grid(wave: jnp.ndarray, opts: PitchOptions):
    """[num_frames, num_lags] NCCF values + the lag array."""
    sr = opts.samp_freq
    shift = int(sr * opts.frame_shift_ms / 1000)
    window = int(sr * opts.frame_length_ms / 1000)
    min_lag = int(sr / opts.max_f0)
    max_lag = int(sr / opts.min_f0)
    lags = jnp.arange(min_lag, max_lag + 1)
    n = wave.shape[0]
    num_frames = max(0, 1 + (n - window - max_lag) // shift)
    starts = jnp.arange(num_frames) * shift
    win_idx = starts[:, None] + jnp.arange(window)[None, :]
    x1 = wave[win_idx]                              # [T, W]
    e1 = jnp.sum(x1 * x1, axis=1)                   # [T]
    mean_sq = jnp.mean(wave * wave)
    ballast = opts.nccf_ballast * mean_sq * window

    def per_lag(lag):
        x2 = wave[win_idx + lag]
        num = jnp.sum(x1 * x2, axis=1)
        e2 = jnp.sum(x2 * x2, axis=1)
        return num / jnp.sqrt(e1 * e2 + ballast + 1e-20)

    nccf = jax.vmap(per_lag, out_axes=1)(lags)      # [T, L]
    return nccf, np.arange(min_lag, max_lag + 1)


@partial(jax.jit, static_argnames=("penalty",))
def _lag_viterbi(nccf, log_lags, penalty: float):
    """Smoothed best lag per frame: maximize Σ nccf − penalty·Δlog-lag²."""
    L = nccf.shape[1]
    cost_mat = penalty * (log_lags[:, None] - log_lags[None, :]) ** 2

    def step(prev_score, nccf_t):
        # prev_score: [L]; transition to each new lag j
        trans = prev_score[:, None] - cost_mat      # [L_prev, L_new]
        best_prev = jnp.max(trans, axis=0)
        bp = jnp.argmax(trans, axis=0)
        score = best_prev + nccf_t
        return score, (score, bp)

    init = nccf[0]
    _, (scores, bps) = jax.lax.scan(step, init, nccf[1:])
    return init, scores, bps


def compute_pitch(wave: np.ndarray,
                  opts: PitchOptions | None = None) -> np.ndarray:
    """[n_samples] → [T, 2] features: (POV/NCCF feature, log-pitch)."""
    opts = opts or PitchOptions()
    wave = jnp.asarray(np.asarray(wave, np.float32))
    nccf, lags = _nccf_grid(wave, opts)
    nccf_np = np.asarray(nccf)
    T = nccf_np.shape[0]
    if T == 0:
        return np.zeros((0, 2), np.float32)
    log_lags_np = np.log(lags.astype(np.float64))
    log_lags = jnp.asarray(log_lags_np, jnp.float32)
    # local score: NCCF minus a mild long-lag penalty (subharmonics of a
    # periodic signal score equal NCCF; prefer the fundamental)
    local = nccf - opts.lag_penalty * jnp.asarray(
        log_lags_np - log_lags_np[0], jnp.float32
    )[None, :]
    init, scores, bps = _lag_viterbi(local, log_lags,
                                     float(opts.penalty_factor))
    scores = np.concatenate([np.asarray(init)[None], np.asarray(scores)])
    bps = np.asarray(bps)
    # backtrace
    best = np.zeros(T, np.int64)
    best[-1] = scores[-1].argmax()
    for t in range(T - 2, -1, -1):
        best[t] = bps[t, best[t + 1]]
    pitch = opts.samp_freq / lags[best]
    pov = nccf_np[np.arange(T), best]
    return np.stack([pov, np.log(pitch)], axis=1).astype(np.float32)


def _batched_pitch_program(waves: jnp.ndarray, true_lens: jnp.ndarray,
                           opts: PitchOptions):
    """[B, n] padded waves → [B, T_pad, 2] (pov, log-pitch), fully on
    device: FFT cross-correlation NCCF (no [L, T, W] materialization —
    the per-lag gather formulation is ~17 GB at B=64), lag-Viterbi as a
    lax.scan, and the backtrace as a reverse scan, so one fetch returns
    finished pitch for a whole bucket."""
    sr = opts.samp_freq
    shift = int(sr * opts.frame_shift_ms / 1000)
    window = int(sr * opts.frame_length_ms / 1000)
    min_lag = int(sr / opts.max_f0)
    max_lag = int(sr / opts.min_f0)
    lags = np.arange(min_lag, max_lag + 1)
    n = waves.shape[1]
    T = max(0, 1 + (n - window - max_lag) // shift)
    starts = jnp.arange(T) * shift
    ext = window + max_lag
    x2 = waves[:, starts[:, None] + jnp.arange(ext)[None, :]]  # [B,T,E]
    x1 = x2[..., :window]
    # num[b,t,l] = sum_w x1[b,t,w] * x2[b,t,w+l]: circular correlation
    # at N >= E never wraps for l <= max_lag
    nfft = 1 << int(np.ceil(np.log2(ext)))
    f1 = jnp.fft.rfft(x1, nfft)
    f2 = jnp.fft.rfft(x2, nfft)
    corr = jnp.fft.irfft(jnp.conj(f1) * f2, nfft)   # [B, T, nfft]
    num = corr[..., min_lag:max_lag + 1]
    e1 = jnp.sum(x1 * x1, axis=-1)                  # [B, T]
    cs = jnp.cumsum(x2 * x2, axis=-1)
    cs = jnp.concatenate([jnp.zeros_like(cs[..., :1]), cs], axis=-1)
    # e2[b,t,l] = sum of x2^2 over [l, l+window)
    e2 = cs[..., window + min_lag:window + max_lag + 1] \
        - cs[..., min_lag:max_lag + 1]
    mean_sq = jnp.sum(waves * waves, axis=1) / jnp.maximum(true_lens, 1)
    ballast = opts.nccf_ballast * mean_sq * window  # [B]
    nccf = num / jnp.sqrt(e1[..., None] * e2
                          + ballast[:, None, None] + 1e-20)
    log_lags_np = np.log(lags.astype(np.float64))
    local = nccf - opts.lag_penalty * jnp.asarray(
        log_lags_np - log_lags_np[0], jnp.float32)[None, None, :]
    cost_mat = opts.penalty_factor * jnp.asarray(
        (log_lags_np[:, None] - log_lags_np[None, :]) ** 2, jnp.float32)

    def step(prev_score, local_t):            # prev_score [B, L]
        trans = prev_score[:, :, None] - cost_mat[None]
        score = jnp.max(trans, axis=1) + local_t
        bp = jnp.argmax(trans, axis=1)
        return score, bp

    local_tm = jnp.swapaxes(local, 0, 1)      # [T, B, L]
    final_score, bps = jax.lax.scan(step, local_tm[0], local_tm[1:])

    def back(nxt, bp_t):                      # nxt [B]
        cur = jnp.take_along_axis(bp_t, nxt[:, None], axis=1)[:, 0]
        return cur, cur

    last = jnp.argmax(final_score, axis=1)
    _, rest = jax.lax.scan(back, last, bps, reverse=True)
    best = jnp.concatenate([rest, last[None]], axis=0)   # [T, B]
    best = jnp.swapaxes(best, 0, 1)                      # [B, T]
    pov = jnp.take_along_axis(nccf, best[..., None], axis=2)[..., 0]
    logp = jnp.log(sr) - jnp.asarray(log_lags_np, jnp.float32)[best]
    return jnp.stack([pov, logp], axis=-1)    # [B, T, 2]


def compute_pitch_batched(waves: dict, opts: PitchOptions | None = None,
                          batch_size: int = 32) -> dict:
    """{utt: [samples]} → {utt: [T, 2]} raw pitch via bucketed device
    batches (the compute_batched pattern of feats/batch.py: one compiled
    program per 1 s length bucket, one fetch per chunk — per-utterance
    ragged shapes would recompile per length)."""
    opts = opts or PitchOptions()
    sr = opts.samp_freq
    shift = int(sr * opts.frame_shift_ms / 1000)
    window = int(sr * opts.frame_length_ms / 1000)
    max_lag = int(sr / opts.min_f0)
    bucket = int(sr)
    program = jax.jit(partial(_batched_pitch_program, opts=opts))

    groups: dict = {}
    for u, w in waves.items():
        padded = int(np.ceil(max(len(w), 1) / bucket)) * bucket
        groups.setdefault(padded, []).append(u)
    out: dict = {}
    for padded, utts in sorted(groups.items()):
        for i in range(0, len(utts), batch_size):
            chunk = utts[i:i + batch_size]
            arr = np.zeros((batch_size, padded), np.float32)
            lens = np.full(batch_size, 1, np.float32)
            for j, u in enumerate(chunk):
                w = np.asarray(waves[u], np.float32)
                arr[j, :len(w)] = w
                lens[j] = len(w)
            feats = np.asarray(program(jnp.asarray(arr),
                                       jnp.asarray(lens)))
            for j, u in enumerate(chunk):
                t = max(0, 1 + (len(waves[u]) - window - max_lag)
                        // shift)
                out[u] = feats[j, :t]
    return out


def postprocess_pitch(raw: np.ndarray,
                      cmn_window: int = 151) -> np.ndarray:
    """3-dim recipe features (reference: process-kaldi-pitch-feats):
    (pov, mean-subtracted log pitch, delta log pitch)."""
    pov = raw[:, 0]
    logp = raw[:, 1]
    T = len(raw)
    half = cmn_window // 2
    norm = np.empty_like(logp)
    for t in range(T):
        s, e = max(0, t - half), min(T, t + half + 1)
        norm[t] = logp[t] - logp[s:e].mean()
    delta = np.gradient(logp)
    return np.stack([pov, norm, delta], axis=1).astype(np.float32)
