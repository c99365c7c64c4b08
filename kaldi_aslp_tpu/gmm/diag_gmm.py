"""Diagonal-covariance GMM acoustic models, batched on device.

JAX-native equivalent of the reference GMM layer (reference:
src/gmm/diag-gmm.{h,cc}, am-diag-gmm.{h,cc}, mle-am-diag-gmm.{h,cc}).

Design: the whole acoustic model (all pdfs) lives in ONE padded tensor
triple (weights [P, M], means [P, M, D], vars [P, M, D]) so per-frame
log-likelihoods for every pdf are a single fused einsum chain
([T, D] x [P*M, D] style), replacing the reference's per-pdf per-frame
loops.  MLE accumulation is device-side scatter-adds keyed by the
alignment; the update itself is tiny host numpy."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

LOG_2PI = float(np.log(2.0 * np.pi))


@dataclass
class AmDiagGmm:
    """All pdfs, gauss-padded to M_max (mask = weight > 0)."""

    weights: np.ndarray  # [P, M] (zero rows padded)
    means: np.ndarray    # [P, M, D]
    vars: np.ndarray     # [P, M, D] (padded entries = 1.0)

    @property
    def num_pdfs(self) -> int:
        return self.weights.shape[0]

    @property
    def max_gauss(self) -> int:
        return self.weights.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @property
    def num_gauss_per_pdf(self) -> np.ndarray:
        return (self.weights > 0).sum(axis=1)

    @classmethod
    def flat_init(cls, num_pdfs: int, dim: int,
                  glob_mean: np.ndarray, glob_var: np.ndarray
                  ) -> "AmDiagGmm":
        """One gaussian per pdf at the global stats (reference:
        gmm-init-mono.cc flat start)."""
        return cls(
            weights=np.ones((num_pdfs, 1), np.float32),
            means=np.tile(glob_mean.astype(np.float32)[None, None],
                          (num_pdfs, 1, 1)),
            vars=np.tile(glob_var.astype(np.float32)[None, None],
                         (num_pdfs, 1, 1)),
        )

    def pack(self):
        """Device tensors for scoring."""
        return (jnp.asarray(self.weights), jnp.asarray(self.means),
                jnp.asarray(self.vars))


def gmm_loglikes(feats, weights, means, variances):
    """[T, D] → [T, P]: per-frame log-likelihood of every pdf.

    One einsum chain (reference: DiagGmm::LogLikelihoods looped per pdf,
    decodable-am-diag-gmm.h per frame)."""
    inv_var = 1.0 / variances                           # [P, M, D]
    mean_iv = means * inv_var                           # [P, M, D]
    gconst = (
        jnp.log(jnp.maximum(weights, 1e-37))
        - 0.5 * (means.shape[-1] * LOG_2PI
                 + jnp.sum(jnp.log(variances), axis=-1)
                 + jnp.sum(means * mean_iv, axis=-1))
    )                                                    # [P, M]
    # per-gauss quadratic terms via two matmul contractions
    x2 = feats * feats                                   # [T, D]
    quad = jnp.einsum("td,pmd->tpm", x2, inv_var,
                      preferred_element_type=jnp.float32)
    lin = jnp.einsum("td,pmd->tpm", feats, mean_iv,
                     preferred_element_type=jnp.float32)
    ll = gconst[None] - 0.5 * quad + lin                 # [T, P, M]
    ll = jnp.where(weights[None] > 0, ll, -1e30)
    return jax.nn.logsumexp(ll, axis=-1)                 # [T, P]


_loglikes_jit = jax.jit(lambda f, w, m, v: gmm_loglikes(f, w, m, v))


def gmm_loglikes_bucketed(feats: np.ndarray, packed,
                          bucket: int = 512) -> np.ndarray:
    """gmm_loglikes with the frame count padded to a bucket so XLA
    compiles once per bucket, not once per utterance length."""
    w, mu, var = packed
    T = len(feats)
    padded = int(np.ceil(max(T, 1) / bucket)) * bucket
    f = np.zeros((padded, feats.shape[1]), np.float32)
    f[:T] = feats
    return np.asarray(_loglikes_jit(jnp.asarray(f), w, mu, var))[:T]


def corpus_loglikes(feats: dict, utts, packed,
                    block_frames: int = 512 * 1024) -> dict:
    """Per-utterance GMM loglikes over CONCATENATED frame blocks: one
    device program + one fetch per ~block_frames instead of one
    dispatch+fetch per utterance (at 1500 utterances per realignment
    pass a per-utt loop spends its time on round trips, not math).  Returns utt → [T, P]."""
    out = {}
    block, names = [], []
    n = 0

    def flush():
        nonlocal block, names, n
        if not names:
            return
        F = np.concatenate(block).astype(np.float32)
        ll = gmm_loglikes_bucketed(F, packed)
        off = 0
        for u, t in names:
            out[u] = ll[off:off + t]
            off += t
        block, names = [], []
        n = 0

    for u in utts:
        f = np.asarray(feats[u], np.float32)
        block.append(f)
        names.append((u, len(f)))
        n += len(f)
        if n >= block_frames:
            flush()
    flush()
    return out


def gmm_posteriors_for_alignment(feats, pdf_ids, weights, means, variances):
    """Per-frame gaussian posteriors within the aligned pdf.

    [T, D], [T] → [T, M] soft counts (reference:
    mle-am-diag-gmm.cc AccumulateForGmm)."""
    w = weights[pdf_ids]        # [T, M]
    mu = means[pdf_ids]         # [T, M, D]
    var = variances[pdf_ids]
    inv_var = 1.0 / var
    diff = feats[:, None, :] - mu
    ll = (
        jnp.log(jnp.maximum(w, 1e-37))
        - 0.5 * (mu.shape[-1] * LOG_2PI + jnp.sum(jnp.log(var), axis=-1))
        - 0.5 * jnp.sum(diff * diff * inv_var, axis=-1)
    )
    ll = jnp.where(w > 0, ll, -1e30)
    return jax.nn.softmax(ll, axis=-1)


@jax.jit
def accumulate_gmm_stats(feats, pdf_ids, frame_weights,
                         weights, means, variances,
                         occ, mean_acc, var_acc):
    """Scatter-add sufficient statistics (device-side).

    occ [P, M], mean_acc [P, M, D], var_acc [P, M, D];
    frame_weights [T] zeros out padding frames so many utterances can be
    concatenated/padded into one fixed-shape call (one XLA compile)."""
    gamma = gmm_posteriors_for_alignment(
        feats, pdf_ids, weights, means, variances
    )                                                    # [T, M]
    gamma = gamma * frame_weights[:, None]
    occ = occ.at[pdf_ids].add(gamma)
    mean_acc = mean_acc.at[pdf_ids].add(
        gamma[:, :, None] * feats[:, None, :]
    )
    var_acc = var_acc.at[pdf_ids].add(
        gamma[:, :, None] * (feats * feats)[:, None, :]
    )
    return occ, mean_acc, var_acc


class GmmStats:
    def __init__(self, am: AmDiagGmm):
        P, M, D = am.num_pdfs, am.max_gauss, am.dim
        # float32 accumulators (JAX's default; f64 is off); bootstrap-scale counts
        # stay well inside f32 range
        self.occ = jnp.zeros((P, M), jnp.float32)
        self.mean_acc = jnp.zeros((P, M, D), jnp.float32)
        self.var_acc = jnp.zeros((P, M, D), jnp.float32)

    def accumulate(self, am_packed, feats, pdf_ids, frame_weights=None):
        w, mu, var = am_packed
        if frame_weights is None:
            frame_weights = np.ones(len(np.asarray(pdf_ids)), np.float32)
        self.occ, self.mean_acc, self.var_acc = accumulate_gmm_stats(
            jnp.asarray(feats), jnp.asarray(pdf_ids),
            jnp.asarray(frame_weights), w, mu, var,
            self.occ, self.mean_acc, self.var_acc,
        )

    def to_numpy(self):
        return (np.asarray(self.occ), np.asarray(self.mean_acc),
                np.asarray(self.var_acc))


def mle_update(
    am: AmDiagGmm,
    occ: np.ndarray,
    mean_acc: np.ndarray,
    var_acc: np.ndarray,
    min_gaussian_occupancy: float = 10.0,
    variance_floor: float = 1e-3,
    weight_floor: float = 1e-5,
) -> AmDiagGmm:
    """MLE re-estimation (reference: mle-diag-gmm.cc MleDiagGmmUpdate)."""
    new = AmDiagGmm(am.weights.copy(), am.means.copy(), am.vars.copy())
    for p in range(am.num_pdfs):
        active = am.weights[p] > 0
        tot = occ[p, active].sum()
        if tot < 1e-8:
            continue
        for m in np.where(active)[0]:
            if occ[p, m] < min_gaussian_occupancy:
                continue  # keep old params for starved gaussians
            mean = mean_acc[p, m] / occ[p, m]
            var = var_acc[p, m] / occ[p, m] - mean * mean
            new.means[p, m] = mean
            new.vars[p, m] = np.maximum(var, variance_floor)
        w = np.maximum(occ[p] * active, 0.0)
        w = np.maximum(w / max(w.sum(), 1e-8), weight_floor * active)
        new.weights[p] = (w / w.sum() * active).astype(np.float32)
    return new


def split_gaussians(am: AmDiagGmm, target_total: int,
                    occ: Optional[np.ndarray] = None,
                    perturb: float = 0.01,
                    seed: int = 0) -> AmDiagGmm:
    """Mix up toward target total gaussians by splitting the
    highest-occupancy components (reference: am-diag-gmm.cc
    SplitByCount / diag-gmm.cc Split)."""
    rng = np.random.RandomState(seed)
    P, M, D = am.num_pdfs, am.max_gauss, am.dim
    counts = (occ if occ is not None
              else am.weights.astype(np.float64)).copy()
    num_g = am.num_gauss_per_pdf.sum()
    n_splits = max(0, target_total - int(num_g))
    # grow padding if needed
    need_m = M
    per_pdf = am.num_gauss_per_pdf.astype(np.int64).copy()
    flat = []
    for _ in range(n_splits):
        p, m = np.unravel_index(np.argmax(counts), counts.shape)
        per_pdf[p] += 1
        need_m = max(need_m, int(per_pdf[p]))
        counts[p, m] /= 2.0
        flat.append((int(p), int(m)))
    new = AmDiagGmm(
        weights=np.zeros((P, need_m), np.float32),
        means=np.zeros((P, need_m, D), np.float32),
        vars=np.ones((P, need_m, D), np.float32),
    )
    new.weights[:, :M] = am.weights
    new.means[:, :M] = am.means
    new.vars[:, :M] = am.vars
    next_slot = am.num_gauss_per_pdf.astype(np.int64).copy()
    for (p, m) in flat:
        s = int(next_slot[p])
        next_slot[p] += 1
        std = np.sqrt(new.vars[p, m])
        delta = perturb * std * rng.randn(D).astype(np.float32)
        new.weights[p, s] = new.weights[p, m] / 2
        new.weights[p, m] /= 2
        new.means[p, s] = new.means[p, m] - delta
        new.means[p, m] = new.means[p, m] + delta
        new.vars[p, s] = new.vars[p, m]
    return new
