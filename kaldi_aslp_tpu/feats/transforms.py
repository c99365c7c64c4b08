"""Feature-space transforms: LDA, MLLT (STC), fMLLR.

JAX-native equivalents of the reference transform layer (reference:
src/transform/lda-estimate.{h,cc}, mllt.{h,cc} MlltAccs, fmllr-diag-gmm.
{h,cc} FmllrDiagGmmAccs — used by steps/train_lda_mllt.sh and
steps/train_sat.sh / align_fmllr.sh).

Statistics are accumulated device-side (outer products batched over
frames); the small eigenvalue/row-update solves run in host numpy."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# LDA (reference: lda-estimate.cc LdaEstimate)
# ---------------------------------------------------------------------------

class LdaStats:
    """Per-class first/second order stats."""

    def __init__(self, num_classes: int, dim: int):
        self.counts = np.zeros(num_classes)
        self.first = np.zeros((num_classes, dim))
        self.total_second = np.zeros((dim, dim))

    def accumulate(self, feats: np.ndarray, classes: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        classes = np.asarray(classes)
        np.add.at(self.counts, classes, 1.0)
        np.add.at(self.first, classes, feats)
        self.total_second += feats.T @ feats


def estimate_lda(stats: LdaStats, target_dim: int,
                 within_class_factor: float = 1.0) -> np.ndarray:
    """Return the [target_dim, dim] LDA matrix (reference:
    lda-estimate.cc LdaEstimate::Estimate)."""
    total_count = stats.counts.sum()
    total_mean = stats.first.sum(0) / total_count
    # between-class scatter
    bc = np.zeros_like(stats.total_second)
    for c in range(len(stats.counts)):
        if stats.counts[c] == 0:
            continue
        mean_c = stats.first[c] / stats.counts[c]
        d = (mean_c - total_mean)[:, None]
        bc += stats.counts[c] * (d @ d.T)
    bc /= total_count
    total_cov = stats.total_second / total_count - np.outer(
        total_mean, total_mean
    )
    wc = total_cov - bc
    # solve generalized eigenproblem bc v = λ wc v via whitening
    w_eval, w_evec = np.linalg.eigh(wc)
    w_eval = np.maximum(w_eval, 1e-10)
    whiten = w_evec @ np.diag(w_eval ** -0.5) @ w_evec.T
    m = whiten @ bc @ whiten.T
    evals, evecs = np.linalg.eigh(m)
    order = np.argsort(evals)[::-1][:target_dim]
    proj = (evecs[:, order].T @ whiten) * within_class_factor
    return proj.astype(np.float32)


def apply_transform(feats, matrix: np.ndarray):
    """y = A x (+ b for affine [D, D+1] matrices)."""
    matrix = np.asarray(matrix)
    in_dim = feats.shape[-1]
    if matrix.shape[1] == in_dim + 1:
        return jnp.dot(jnp.asarray(feats), matrix[:, :in_dim].T) \
            + matrix[:, in_dim]
    return jnp.dot(jnp.asarray(feats), matrix.T)


# ---------------------------------------------------------------------------
# MLLT / STC (reference: transform/mllt.cc MlltAccs)
# ---------------------------------------------------------------------------

class MlltStats:
    """Per-class scatter in the current feature space, weighted by
    gaussian posteriors; classes here = gaussians of the current model."""

    def __init__(self, dim: int):
        self.dim = dim
        self.G: Optional[np.ndarray] = None  # [dim, dim, dim] G_i matrices
        self.beta = 0.0

    def accumulate(self, feats: np.ndarray, means: np.ndarray,
                   inv_vars: np.ndarray, gammas: np.ndarray) -> None:
        """feats [T, D]; means/inv_vars [T, M, D] for the aligned pdf's
        gaussians; gammas [T, M] posteriors."""
        feats = np.asarray(feats, np.float64)
        d = self.dim
        if self.G is None:
            self.G = np.zeros((d, d, d))
        diff = feats[:, None, :] - means           # [T, M, D]
        w = gammas[..., None] * inv_vars           # [T, M, D]
        # G_i += Σ_t,m γ (x−μ)(x−μ)^T / σ_i²  — einsum over t,m
        self.G += np.einsum("tmi,tmj,tmk->ijk", w, diff, diff,
                            optimize=True)
        self.beta += gammas.sum()


def estimate_mllt(stats: MlltStats, num_iters: int = 20) -> np.ndarray:
    """Row-wise iterative update (reference: mllt.cc MlltAccs::Update)."""
    d = stats.dim
    A = np.eye(d)
    for _ in range(num_iters):
        for i in range(d):
            Ginv = np.linalg.inv(stats.G[i] + 1e-6 * np.eye(d))
            # cofactor vector c_i: A_j · c_i = δ_ij det(A) → inv(A)[:, i]
            cof = np.linalg.inv(A)[:, i]
            scale = np.sqrt(stats.beta / max(cof @ Ginv @ cof, 1e-20))
            A[i] = scale * (Ginv @ cof)
    # normalize determinant to 1 like the reference
    det = np.linalg.det(A)
    A *= np.sign(det) * abs(det) ** (-1.0 / d)
    return A.astype(np.float32)


# ---------------------------------------------------------------------------
# fMLLR (reference: transform/fmllr-diag-gmm.cc)
# ---------------------------------------------------------------------------

class FmllrStats:
    """Speaker-level K and G_i accumulators for the affine transform
    W = [A; b] maximizing the GMM likelihood."""

    def __init__(self, dim: int):
        self.dim = dim
        self.K = np.zeros((dim, dim + 1))
        self.G = np.zeros((dim, dim + 1, dim + 1))
        self.beta = 0.0

    def accumulate(self, feats: np.ndarray, means: np.ndarray,
                   inv_vars: np.ndarray, gammas: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        xplus = np.concatenate(
            [feats, np.ones((len(feats), 1))], axis=1
        )  # [T, D+1]
        w = gammas[..., None] * inv_vars  # [T, M, D] = γ σ⁻²
        # K[i] += Σ γ σ_i⁻² μ_i x+^T  ;  G_i += Σ γ σ_i⁻² x+ x+^T
        self.K += np.einsum("tmi,tj->ij", w * means, xplus,
                            optimize=True)
        self.G += np.einsum("tmi,tj,tk->ijk", w, xplus, xplus,
                            optimize=True)
        self.beta += gammas.sum()


def estimate_fmllr(stats: FmllrStats, num_iters: int = 20) -> np.ndarray:
    """Row-wise update of W=[A b] (reference: fmllr-diag-gmm.cc
    ComputeFmllrMatrixDiagGmmFull, iterative row optimization)."""
    d = stats.dim
    W = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    for _ in range(num_iters):
        for i in range(d):
            Ginv = np.linalg.inv(stats.G[i] + 1e-6 * np.eye(d + 1))
            A = W[:, :d]
            cof = np.linalg.inv(A + 1e-10 * np.eye(d))[:, i]
            ext_cof = np.concatenate([cof, [0.0]])
            k = stats.K[i]
            # solve for row: w_i = Ginv (k + α ext_cof), α from quadratic
            a_coef = ext_cof @ Ginv @ ext_cof
            b_coef = ext_cof @ Ginv @ k
            # β/α relationship: α a + b = β/α... quadratic in α:
            # a α² + b α − β = 0
            disc = b_coef ** 2 + 4 * a_coef * stats.beta
            alpha = (-b_coef + np.sqrt(max(disc, 0.0))) / max(
                2 * a_coef, 1e-20
            )
            W[i] = Ginv @ (k + alpha * ext_cof)
    return W.astype(np.float32)


def gmm_gammas_for_alignment(am, feats: np.ndarray,
                             pdf_ids: np.ndarray):
    """Convenience: per-frame gaussian posteriors + per-frame gaussian
    params, for MLLT/fMLLR accumulation."""
    from kaldi_aslp_tpu.gmm.diag_gmm import gmm_posteriors_for_alignment

    w, mu, var = am.pack()
    gammas = np.asarray(gmm_posteriors_for_alignment(
        jnp.asarray(feats), jnp.asarray(pdf_ids), w, mu, var
    ))
    means = np.asarray(mu)[pdf_ids]
    inv_vars = 1.0 / np.asarray(var)[pdf_ids]
    return gammas, means, inv_vars
