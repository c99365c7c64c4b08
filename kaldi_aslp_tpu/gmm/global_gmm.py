"""Single "global" diagonal GMM: init-from-feats + EM.

Replaces (reference): src/gmmbin/gmm-global-init-from-feats.cc (random
frame-mean init, EM with progressive mixture growth) and the
gmm-global-acc-stats / gmm-global-est loop driven by
aslp_scripts/vad/train_diag_gmm.sh:44-75 — the class-conditional GMMs
behind the GMM VAD (run_gmm_vad.sh).

The reference stores per-frame Gaussian-selection indices on disk
(gmm-gselect) to cut the CPU E-step cost; here the E-step is two matmul
contractions over all Gaussians at once, so gselect pruning would slow
it down — the whole [T, M] responsibility matrix is computed batched
on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

LOG_2PI = float(np.log(2.0 * np.pi))


@dataclass
class GlobalGmm:
    """weights [M], means [M, D], vars [M, D]."""

    weights: np.ndarray
    means: np.ndarray
    vars: np.ndarray

    @property
    def num_gauss(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def save(self, path: str) -> None:
        np.savez(path, weights=self.weights, means=self.means,
                 vars=self.vars)

    @classmethod
    def load(cls, path: str) -> "GlobalGmm":
        z = np.load(path)
        return cls(z["weights"], z["means"], z["vars"])


@jax.jit
def global_gmm_loglikes(feats, weights, means, variances):
    """[T, D] -> [T] total log-likelihood per frame (logsumexp over
    mixture components); two einsum contractions like gmm_loglikes."""
    return jax.nn.logsumexp(
        _component_loglikes(feats, weights, means, variances), axis=-1)


def _component_loglikes(feats, weights, means, variances):
    inv_var = 1.0 / variances                       # [M, D]
    mean_iv = means * inv_var                       # [M, D]
    gconst = (
        jnp.log(jnp.maximum(weights, 1e-37))
        - 0.5 * (means.shape[-1] * LOG_2PI
                 + jnp.sum(jnp.log(variances), axis=-1)
                 + jnp.sum(means * mean_iv, axis=-1))
    )                                               # [M]
    quad = jnp.dot(feats * feats, inv_var.T,
                   preferred_element_type=jnp.float32)
    lin = jnp.dot(feats, mean_iv.T,
                  preferred_element_type=jnp.float32)
    ll = gconst[None] - 0.5 * quad + lin            # [T, M]
    return jnp.where(weights[None] > 0, ll, -1e30)


@jax.jit
def _em_stats(feats, frame_weights, weights, means, variances):
    """One E-step + sufficient stats, all on device:
    occ [M], mean_acc [M, D], var_acc [M, D], total loglike."""
    ll = _component_loglikes(feats, weights, means, variances)
    tot = jax.nn.logsumexp(ll, axis=-1)             # [T]
    gamma = jnp.exp(ll - tot[:, None]) * frame_weights[:, None]
    occ = jnp.sum(gamma, axis=0)
    mean_acc = jnp.dot(gamma.T, feats,
                       preferred_element_type=jnp.float32)
    var_acc = jnp.dot(gamma.T, feats * feats,
                      preferred_element_type=jnp.float32)
    loglike = jnp.sum(tot * frame_weights)
    return occ, mean_acc, var_acc, loglike


def em_update(gmm: GlobalGmm, occ, mean_acc, var_acc,
              min_gaussian_weight: float = 1e-4,
              var_floor: float = 1e-3,
              remove_low_count: bool = True) -> GlobalGmm:
    """M-step (reference: mle-diag-gmm.cc MleDiagGmmUpdate for the
    global model; low-count components dropped like
    remove-low-count-gaussians=true)."""
    occ = np.asarray(occ, np.float64)
    mean_acc = np.asarray(mean_acc, np.float64)
    var_acc = np.asarray(var_acc, np.float64)
    total = max(occ.sum(), 1e-10)
    w = occ / total
    keep = w > (min_gaussian_weight if remove_low_count else 0.0)
    if not keep.any():
        keep[np.argmax(w)] = True
    safe_occ = np.maximum(occ, 1e-10)[:, None]
    means = mean_acc / safe_occ
    variances = np.maximum(var_acc / safe_occ - means ** 2, var_floor)
    w = w[keep] / w[keep].sum()
    return GlobalGmm(w.astype(np.float32),
                     means[keep].astype(np.float32),
                     variances[keep].astype(np.float32))


def split_global(gmm: GlobalGmm, target: int, perturb: float = 0.01,
                 seed: int = 0) -> GlobalGmm:
    """Mix up by splitting highest-weight components
    (diag-gmm.cc Split)."""
    rng = np.random.RandomState(seed)
    w = list(gmm.weights.astype(np.float64))
    mu = list(gmm.means)
    var = list(gmm.vars)
    while len(w) < target:
        m = int(np.argmax(w))
        w[m] /= 2.0
        w.append(w[m])
        std = np.sqrt(var[m])
        delta = (perturb * std * rng.randn(gmm.dim)).astype(np.float32)
        mu.append(mu[m] + delta)
        mu[m] = mu[m] - delta
        var.append(var[m].copy())
    return GlobalGmm(np.asarray(w, np.float32), np.stack(mu),
                     np.stack(var))


def init_from_feats(
    feats: np.ndarray,
    num_gauss: int,
    num_iters: int = 20,
    num_gauss_init: int = 0,
    num_frames: int = 200000,
    min_gaussian_weight: float = 1e-4,
    seed: int = 0,
) -> GlobalGmm:
    """gmm-global-init-from-feats: subsample frames, seed means from
    random frames at half the target mixture count, EM while growing
    to num_gauss over the first half of the iterations."""
    rng = np.random.RandomState(seed)
    feats = np.asarray(feats, np.float32)
    if len(feats) > num_frames:
        feats = feats[rng.choice(len(feats), num_frames, replace=False)]
    if num_gauss_init <= 0:
        num_gauss_init = max(1, num_gauss // 2)
    num_gauss_init = min(num_gauss_init, len(feats), num_gauss)

    glob_var = np.maximum(feats.var(axis=0), 1e-3)
    pick = rng.choice(len(feats), num_gauss_init, replace=False)
    gmm = GlobalGmm(
        np.full(num_gauss_init, 1.0 / num_gauss_init, np.float32),
        feats[pick].copy(),
        np.tile(glob_var[None], (num_gauss_init, 1)).astype(np.float32),
    )

    dev_feats = jnp.asarray(feats)
    fw = jnp.ones(len(feats), jnp.float32)
    grow_iters = max(1, num_iters // 2)
    for it in range(num_iters):
        occ, macc, vacc, _ = _em_stats(
            dev_feats, fw, jnp.asarray(gmm.weights),
            jnp.asarray(gmm.means), jnp.asarray(gmm.vars))
        gmm = em_update(gmm, occ, macc, vacc,
                        min_gaussian_weight=min_gaussian_weight)
        if it < grow_iters and gmm.num_gauss < num_gauss:
            frac = (it + 1) / grow_iters
            target = min(num_gauss, max(
                gmm.num_gauss,
                int(round(num_gauss_init
                          + frac * (num_gauss - num_gauss_init)))))
            gmm = split_global(gmm, target, seed=seed + it + 1)
    return gmm


def avg_loglike(gmm: GlobalGmm, feats: np.ndarray) -> float:
    ll = global_gmm_loglikes(jnp.asarray(feats, jnp.float32),
                             jnp.asarray(gmm.weights),
                             jnp.asarray(gmm.means),
                             jnp.asarray(gmm.vars))
    return float(jnp.mean(ll))
