"""Speaker-adapted training (SAT) with fMLLR.

JAX-native equivalent of the reference SAT chain (reference:
egs/wsj/s5/steps/train_sat.sh + align_fmllr.sh — per-speaker fMLLR
transforms estimated from alignments, model re-estimated on transformed
features, iterating).

Wraps an existing trained system (mono or deltas): estimate per-speaker
W = [A b] from the current model + alignments, apply to features,
re-estimate the GMM, repeat."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.utils.log import get_logger
from kaldi_aslp_tpu.gmm.diag_gmm import AmDiagGmm, GmmStats, mle_update
from kaldi_aslp_tpu.feats.transforms import (
    FmllrStats,
    apply_transform,
    estimate_fmllr,
    gmm_gammas_for_alignment,
)

logger = get_logger("sat")


@dataclasses.dataclass
class SatOptions(Config):
    num_outer_iters: int = 2
    fmllr_min_count: float = 100.0
    min_gaussian_occupancy: float = 3.0


def estimate_speaker_transforms(
    am: AmDiagGmm,
    feats: Dict[str, np.ndarray],
    pdf_alignments: Dict[str, np.ndarray],
    utt2spk: Dict[str, str],
    min_count: float = 100.0,
) -> Dict[str, np.ndarray]:
    """Per-speaker fMLLR (reference: align_fmllr.sh / fmllr-diag-gmm).

    Returns spk → [D, D+1]; speakers below min_count get identity."""
    dim = am.dim
    stats: Dict[str, FmllrStats] = {}
    for utt, pdfs in pdf_alignments.items():
        if utt not in feats:
            continue
        spk = utt2spk.get(utt, utt)
        n = min(len(pdfs), len(feats[utt]))
        gammas, means, inv_vars = gmm_gammas_for_alignment(
            am, feats[utt][:n], np.asarray(pdfs[:n])
        )
        st = stats.setdefault(spk, FmllrStats(dim))
        st.accumulate(feats[utt][:n], means, inv_vars, gammas)
    out: Dict[str, np.ndarray] = {}
    identity = np.concatenate(
        [np.eye(dim), np.zeros((dim, 1))], axis=1
    ).astype(np.float32)
    for spk, st in stats.items():
        out[spk] = (estimate_fmllr(st) if st.beta >= min_count
                    else identity)
    return out


def apply_speaker_transforms(
    feats: Dict[str, np.ndarray],
    transforms: Dict[str, np.ndarray],
    utt2spk: Dict[str, str],
) -> Dict[str, np.ndarray]:
    out = {}
    for utt, f in feats.items():
        spk = utt2spk.get(utt, utt)
        W = transforms.get(spk)
        out[utt] = (np.asarray(apply_transform(f, W))
                    if W is not None else f)
    return out


class SatTrainer:
    """Outer SAT loop around an existing GMM system
    (reference: train_sat.sh stage order)."""

    def __init__(self, base_trainer, opts: Optional[SatOptions] = None):
        """base_trainer: MonophoneTrainer or DeltasTrainer (anything with
        .align(am, feats, transcripts) and .trans_model)."""
        self.base = base_trainer
        self.opts = opts or SatOptions()

    def train(
        self,
        am: AmDiagGmm,
        feats: Dict[str, np.ndarray],
        transcripts: Dict[str, List[str]],
        utt2spk: Dict[str, str],
    ) -> Tuple[AmDiagGmm, Dict[str, np.ndarray]]:
        tm = self.base.trans_model
        cur_feats = feats
        transforms: Dict[str, np.ndarray] = {}
        for it in range(self.opts.num_outer_iters):
            alis = self.base.align(am, cur_feats, transcripts)
            pdf_alis = {u: tm.alignment_to_pdfs(a)
                        for u, a in alis.items()}
            transforms = estimate_speaker_transforms(
                am, feats, pdf_alis, utt2spk,
                min_count=self.opts.fmllr_min_count,
            )
            cur_feats = apply_speaker_transforms(
                feats, transforms, utt2spk
            )
            # re-estimate on adapted features
            stats = GmmStats(am)
            packed = am.pack()
            for u, pdfs in pdf_alis.items():
                n = min(len(pdfs), len(cur_feats[u]))
                stats.accumulate(packed, cur_feats[u][:n].astype(
                    np.float32), np.asarray(pdfs[:n]))
            occ, mean_acc, var_acc = stats.to_numpy()
            am = mle_update(
                am, occ, mean_acc, var_acc,
                min_gaussian_occupancy=self.opts.min_gaussian_occupancy,
            )
            logger.info("SAT iter %d: %d speakers adapted", it + 1,
                        len(transforms))
        return am, transforms
