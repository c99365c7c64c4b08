"""Acoustic-score bridges: NN posteriors → decoder log-likelihoods.

JAX-native equivalents of the reference bridge layer (reference:
src/aslp-nnet/nnet-decodable.{h,cc} NnetDecodableBase — batched chunk-wise
Feedforward, log, prior subtraction, acoustic scale, skip-frame
copy/split modes at :70-79; src/aslp-nnet/nnet-pdf-prior.{h,cc} PdfPrior;
src/aslp-nnetbin/aslp-nnet-forward.cc flags --no-softmax --apply-log
--class-frame-counts --scale-blank --time-shift --skip-width).

Whole-utterance computation replaces the reference's frame-window
batching: the net runs once over [1, T, D] (recurrent state handled by
the scan), which is strictly more parallel than chunked evaluation."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.models.nnet import Nnet


@dataclasses.dataclass
class PdfPriorOptions(Config):
    class_frame_counts: str = ""
    prior_scale: float = 1.0
    prior_floor: float = 1e-10


class PdfPrior:
    """log-prior subtraction (reference: nnet-pdf-prior.h:57-63)."""

    def __init__(self, counts: np.ndarray, prior_scale: float = 1.0,
                 prior_floor: float = 1e-10):
        counts = np.asarray(counts, np.float64)
        rel = counts / max(counts.sum(), 1.0)
        # zero/low-count pdfs get a huge POSITIVE log-prior so the
        # subtraction drives their pseudo-loglike to -inf, removing them
        # from the search (reference: nnet-pdf-prior.cc sets 1e10)
        self.log_priors = np.where(
            rel < prior_floor, 1e10,
            np.log(np.maximum(rel, prior_floor)) * prior_scale,
        ).astype(np.float32)

    @classmethod
    def from_alignments(cls, alignments: Dict[str, np.ndarray],
                        num_pdfs: int, **kw) -> "PdfPrior":
        """analyze-counts equivalent (reference: bin/analyze-counts.cc)."""
        counts = np.zeros(num_pdfs, np.float64)
        for ali in alignments.values():
            np.add.at(counts, np.asarray(ali), 1.0)
        return cls(counts, **kw)

    def subtract(self, log_post: jnp.ndarray) -> jnp.ndarray:
        return log_post - jnp.asarray(self.log_priors)


@dataclasses.dataclass
class NnetForwardOptions(Config):
    apply_log: bool = True
    no_softmax: bool = False   # model output is already log-likelihood-ish
    acoustic_scale: float = 0.1
    blank_scale: float = 1.0   # CTC blank posterior scaling (--scale-blank)
    time_shift: int = 0
    skip_width: int = 1        # frame skipping
    skip_mode: str = "copy"    # copy|split (reference: nnet-decodable.cc:70)


def nnet_forward(
    net: Nnet,
    params,
    feats: np.ndarray,
    opts: Optional[NnetForwardOptions] = None,
    prior: Optional[PdfPrior] = None,
) -> np.ndarray:
    """aslp-nnet-forward equivalent: [T, D] → [T, P] scores for decoding.

    Returns log-posteriors minus log-priors (scaled pseudo
    log-likelihoods)."""
    opts = opts or NnetForwardOptions()
    T = len(feats)
    x = feats
    if opts.skip_width > 1:
        # copy mode: evaluate every k-th frame, replicate scores
        idx = np.arange(0, T, opts.skip_width)
        x = feats[idx]
    if opts.time_shift:
        x = np.concatenate(
            [x[opts.time_shift:], np.repeat(x[-1:], opts.time_shift, 0)]
        )
    y, _ = net.apply(params, jnp.asarray(x[None, ...], jnp.float32))
    y = y[0]
    if not opts.no_softmax:
        y = jax.nn.log_softmax(y, axis=-1)
    elif opts.apply_log:
        y = jnp.log(jnp.maximum(y, 1e-20))
    if opts.blank_scale != 1.0:
        y = y.at[:, 0].add(float(np.log(opts.blank_scale)))
    if prior is not None:
        y = prior.subtract(y)
    out = np.asarray(y)
    if opts.skip_width > 1:
        out = np.repeat(out, opts.skip_width, axis=0)[:T]
    return out
