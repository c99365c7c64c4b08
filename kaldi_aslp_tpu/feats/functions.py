"""Post-processing feature transforms: deltas, splice, CMVN.

JAX-native re-design of the reference post-feature chain (reference:
src/feat/feature-functions.{h,cc} DeltaFeatures/SpliceFrames/
SlidingWindowCmn, src/transform/cmvn.{h,cc}).  All transforms are
whole-utterance batched array ops: deltas and splice are expressed as
gathers + weighted sums over a static context so XLA fuses them, CMVN
stats use the reference's 2 x (dim+1) accumulator layout so cmvn ark
files interoperate."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from kaldi_aslp_tpu.utils.config import Config


@dataclasses.dataclass
class DeltaFeaturesOptions(Config):
    order: int = 2
    window: int = 2  # context half-width per order


def delta_scales(opts: DeltaFeaturesOptions) -> list[np.ndarray]:
    """Per-order regression coefficient vectors.

    (reference: feature-functions.cc DeltaFeatures::DeltaFeatures — iterated
    autocorrelation-normalized linear slopes.)"""
    scales = [np.array([1.0], dtype=np.float64)]
    for _ in range(opts.order):
        prev = scales[-1]
        window = opts.window
        if window == 0:
            raise ValueError("delta window must be > 0")
        prev_offset = (len(prev) - 1) // 2
        cur_offset = prev_offset + window
        cur = np.zeros(len(prev) + 2 * window, dtype=np.float64)
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        cur /= normalizer
        scales.append(cur)
    return [s.astype(np.float32) for s in scales]


def add_deltas(feats: jnp.ndarray, opts: DeltaFeaturesOptions | None = None
               ) -> jnp.ndarray:
    """[T, D] → [T, D*(order+1)] with edge-replicated context."""
    opts = opts or DeltaFeaturesOptions()
    scales = delta_scales(opts)
    T = feats.shape[0]
    outputs = []
    for order, scale in enumerate(scales):
        offset = (len(scale) - 1) // 2
        acc = jnp.zeros_like(feats)
        for j in range(-offset, offset + 1):
            w = float(scale[j + offset])
            if w == 0.0:
                continue
            idx = jnp.clip(jnp.arange(T) + j, 0, T - 1)
            acc = acc + w * feats[idx]
        outputs.append(acc)
    return jnp.concatenate(outputs, axis=-1)


def splice_frames(feats: jnp.ndarray, left: int, right: int) -> jnp.ndarray:
    """[T, D] → [T, D*(left+1+right)] frame splicing with edge clamp.

    (reference: feature-functions.cc SpliceFrames; also the Splice
    component nnet-various.h:43.)"""
    T = feats.shape[0]
    cols = []
    for off in range(-left, right + 1):
        idx = jnp.clip(jnp.arange(T) + off, 0, T - 1)
        cols.append(feats[idx])
    return jnp.concatenate(cols, axis=-1)


# ---------------------------------------------------------------------------
# CMVN: stats accumulation + application (reference: src/transform/cmvn.cc)
# ---------------------------------------------------------------------------

def acc_cmvn_stats(feats: np.ndarray, stats: np.ndarray | None = None
                   ) -> np.ndarray:
    """Accumulate into the Kaldi 2x(dim+1) stats matrix.

    row 0: [sum_x..., count]; row 1: [sum_x2..., 0]."""
    feats = np.asarray(feats)
    dim = feats.shape[1]
    if stats is None:
        stats = np.zeros((2, dim + 1), dtype=np.float64)
    stats[0, :dim] += feats.sum(axis=0)
    stats[0, dim] += feats.shape[0]
    stats[1, :dim] += (feats ** 2).sum(axis=0)
    return stats


def apply_cmvn(feats: jnp.ndarray, stats: np.ndarray, norm_vars: bool = False
               ) -> jnp.ndarray:
    """(reference: transform/cmvn.cc ApplyCmvn)."""
    stats = np.asarray(stats, dtype=np.float64)
    dim = stats.shape[1] - 1
    count = stats[0, dim]
    if count < 1.0:
        raise ValueError("no frames in CMVN stats")
    mean = (stats[0, :dim] / count).astype(np.float32)
    out = feats - jnp.asarray(mean)
    if norm_vars:
        var = stats[1, :dim] / count - (stats[0, :dim] / count) ** 2
        scale = (1.0 / np.sqrt(np.maximum(var, 1e-20))).astype(np.float32)
        out = out * jnp.asarray(scale)
    return out


@dataclasses.dataclass
class SlidingWindowCmnOptions(Config):
    cmn_window: int = 600
    min_window: int = 100
    normalize_variance: bool = False
    center: bool = False


def sliding_window_cmn(
    feats: jnp.ndarray, opts: SlidingWindowCmnOptions | None = None
) -> jnp.ndarray:
    """Sliding-window CMN (reference: feature-functions.cc:311).

    Batched via cumulative sums: the window [s, e) mean for each frame is a
    difference of prefix sums — O(T·D) instead of the reference's per-frame
    window loop."""
    opts = opts or SlidingWindowCmnOptions()
    T = feats.shape[0]
    csum = jnp.cumsum(
        jnp.concatenate([jnp.zeros((1, feats.shape[1]), feats.dtype), feats]),
        axis=0,
    )
    t = jnp.arange(T)
    if opts.center:
        s = jnp.clip(t - opts.cmn_window // 2, 0)
        e = jnp.minimum(s + opts.cmn_window, T)
        s = jnp.maximum(jnp.minimum(s, e - opts.cmn_window), 0)
    else:
        # trailing window, but guarantee min_window frames at the start
        s = jnp.maximum(t + 1 - opts.cmn_window, 0)
        e = jnp.maximum(t + 1, jnp.minimum(opts.min_window, T))
    counts = (e - s).astype(feats.dtype)[:, None]
    means = (csum[e] - csum[s]) / counts
    out = feats - means
    if opts.normalize_variance:
        csum2 = jnp.cumsum(
            jnp.concatenate(
                [jnp.zeros((1, feats.shape[1]), feats.dtype), feats ** 2]
            ),
            axis=0,
        )
        var = (csum2[e] - csum2[s]) / counts - means ** 2
        out = out / jnp.sqrt(jnp.maximum(var, 1e-10))
    return out
