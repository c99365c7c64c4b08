"""Discriminative GMM re-estimation: Extended Baum-Welch (EBW/MMI).

JAX-native equivalent of the reference's EBW support (reference:
src/gmm/ebw-diag-gmm.{h,cc} — numerator stats from forced alignment,
denominator stats from recognition posteriors, per-gaussian D-smoothed
update mu = (num − den + D·mu₀)/(γnum − γden + D) with D chosen per
gaussian as max(E·γden, Dmin) to keep variances positive).

Denominator occupancies here come from frame-level pdf posteriors
(p(pdf|x) ∝ prior·likelihood over ALL pdfs — lattice-free MMI style);
full lattice-based denominators plug into the same accumulate API."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.gmm.diag_gmm import (
    AmDiagGmm,
    GmmStats,
    gmm_loglikes,
    gmm_posteriors_for_alignment,
)


@dataclasses.dataclass
class EbwOptions(Config):
    ebw_e: float = 2.0          # D = E * denominator occupancy
    min_d: float = 1.0
    variance_floor: float = 1e-3


def accumulate_denominator_stats(
    am: AmDiagGmm,
    feats: np.ndarray,
    pdf_log_priors: Optional[np.ndarray] = None,
    acoustic_scale: float = 1.0,
):
    """Frame-level denominator stats: posterior over all pdfs times
    per-pdf gaussian posteriors (lattice-free MMI denominator).

    Returns (occ [P, M], mean_acc [P, M, D], var_acc [P, M, D])."""
    w, mu, var = am.pack()
    f = jnp.asarray(feats, jnp.float32)
    ll = gmm_loglikes(f, w, mu, var) * acoustic_scale      # [T, P]
    if pdf_log_priors is not None:
        ll = ll + jnp.asarray(pdf_log_priors, jnp.float32)
    pdf_post = jax.nn.softmax(ll, axis=-1)                 # [T, P]
    P, M, D = am.num_pdfs, am.max_gauss, am.dim
    occ = np.zeros((P, M))
    mean_acc = np.zeros((P, M, D))
    var_acc = np.zeros((P, M, D))
    # per-pdf gaussian responsibilities, weighted by pdf posterior
    for p in range(P):
        gam = np.asarray(gmm_posteriors_for_alignment(
            f, jnp.full(len(feats), p, jnp.int32), w, mu, var
        ))                                                  # [T, M]
        wts = np.asarray(pdf_post[:, p])[:, None] * gam
        occ[p] = wts.sum(0)
        mean_acc[p] = wts.T @ np.asarray(feats)
        var_acc[p] = wts.T @ (np.asarray(feats) ** 2)
    return occ, mean_acc, var_acc


def ebw_update(
    am: AmDiagGmm,
    num: Tuple[np.ndarray, np.ndarray, np.ndarray],
    den: Tuple[np.ndarray, np.ndarray, np.ndarray],
    opts: Optional[EbwOptions] = None,
) -> AmDiagGmm:
    """(reference: ebw-diag-gmm.cc UpdateEbwDiagGmm)."""
    opts = opts or EbwOptions()
    n_occ, n_mean, n_var = num
    d_occ, d_mean, d_var = den
    new = AmDiagGmm(am.weights.copy(), am.means.copy(), am.vars.copy())
    for p in range(am.num_pdfs):
        for m in np.where(am.weights[p] > 0)[0]:
            D_s = max(opts.ebw_e * d_occ[p, m], opts.min_d)
            denom = n_occ[p, m] - d_occ[p, m] + D_s
            if denom <= 0:
                continue
            mu0 = am.means[p, m]
            var0 = am.vars[p, m]
            mu = (n_mean[p, m] - d_mean[p, m] + D_s * mu0) / denom
            var = ((n_var[p, m] - d_var[p, m]
                    + D_s * (var0 + mu0 ** 2)) / denom - mu ** 2)
            if (var <= opts.variance_floor).any():
                # grow D until variance is valid (reference doubling loop)
                ok = False
                for _ in range(10):
                    D_s *= 2.0
                    denom = n_occ[p, m] - d_occ[p, m] + D_s
                    mu = (n_mean[p, m] - d_mean[p, m] + D_s * mu0) / denom
                    var = ((n_var[p, m] - d_var[p, m]
                            + D_s * (var0 + mu0 ** 2)) / denom - mu ** 2)
                    if (var > opts.variance_floor).all():
                        ok = True
                        break
                if not ok:
                    continue
            new.means[p, m] = mu
            new.vars[p, m] = np.maximum(var, opts.variance_floor)
        # weights: EBW weight update (simplified single-iteration form)
        nw = n_occ[p] * (am.weights[p] > 0)
        dw = d_occ[p] * (am.weights[p] > 0)
        tot_n, tot_d = nw.sum(), dw.sum()
        if tot_n > 0:
            raw = am.weights[p] * np.maximum(
                1.0 + (nw / max(tot_n, 1e-8))
                - (dw / max(tot_d, 1e-8)), 0.1
            )
            raw *= (am.weights[p] > 0)
            new.weights[p] = (raw / raw.sum()).astype(np.float32)
    return new


def accumulate_numerator_stats(am: AmDiagGmm, feats: np.ndarray,
                               pdf_ids: np.ndarray):
    """Alignment (numerator) stats — same layout as denominator."""
    stats = GmmStats(am)
    stats.accumulate(am.pack(), jnp.asarray(feats, jnp.float32),
                     jnp.asarray(pdf_ids, jnp.int32))
    return stats.to_numpy()
