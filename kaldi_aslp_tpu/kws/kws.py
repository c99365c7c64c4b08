"""Keyword spotting: keyword-filler token passing over posteriors.

JAX-native equivalent of the reference KWS stack (reference:
src/aslp-kws/keyword-spot.h:19-160 KeywordSpot — token passing over a
keyword-filler graph fed per-frame posteriors, confidence = best
keyword-path score; src/aslp-kws/fst.{h,cc} minimal FST;
aslp-kwsbin/aslp-kws-score.cc).

The DP over (filler + keyword-state) lanes is a vectorized numpy/jnp
recurrence — keyword graphs are tiny, utterance batching happens at the
caller."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_aslp_tpu.utils.config import Config


@dataclasses.dataclass
class KwsOptions(Config):
    confidence_threshold: float = 0.5
    filler_score_mode: str = "one_minus"  # one_minus | max_filler


@dataclasses.dataclass
class KeywordResult:
    keyword: str
    confidence: float
    end_frame: int
    start_frame: int


class KeywordSpotter:
    """Token passing for one or more keywords given unit posteriors.

    Each keyword is a sequence of posterior-column indices (e.g. phone
    or pdf ids).  A filler lane absorbs non-keyword frames; a keyword
    token advances through its unit lanes with self-loops.  Confidence
    of a completed keyword = exp(mean per-frame log posterior along its
    best path) (reference: keyword-spot.h confidence computation)."""

    def __init__(self, keywords: Dict[str, Sequence[int]],
                 opts: Optional[KwsOptions] = None):
        self.opts = opts or KwsOptions()
        self.keywords = {k: list(v) for k, v in keywords.items()}

    def _filler_logp(self, post: np.ndarray, kw_cols: List[int]
                     ) -> np.ndarray:
        if self.opts.filler_score_mode == "one_minus":
            p = 1.0 - post[:, kw_cols].sum(axis=1)
        else:
            mask = np.ones(post.shape[1], bool)
            mask[kw_cols] = False
            p = post[:, mask].max(axis=1)
        return np.log(np.maximum(p, 1e-10))

    def spot(self, posteriors: np.ndarray) -> List[KeywordResult]:
        """[T, P] posteriors → detections (best hit per keyword)."""
        post = np.asarray(posteriors, np.float64)
        T = len(post)
        results = []
        for name, cols in self.keywords.items():
            filler = self._filler_logp(post, cols)
            n = len(cols)
            unit_lp = np.log(np.maximum(post[:, cols], 1e-10))  # [T, n]
            NEG = -1e30
            # per-lane token: (cumulative path score incl. filler prefix,
            # entry frame, filler score at entry, frames in keyword)
            score = np.full(n, NEG)
            entry = np.full(n, -1)
            entry_fs = np.zeros(n)
            frames = np.zeros(n, np.int64)
            filler_score = 0.0
            best: Optional[KeywordResult] = None
            for t in range(T):
                new = [(NEG, -1, 0.0, 0)] * n
                for i in range(n):
                    # self-loop vs advance from previous lane vs enter
                    cands = [(score[i], entry[i], entry_fs[i], frames[i])]
                    if i == 0:
                        cands.append((filler_score, t, filler_score, 0))
                    else:
                        cands.append((score[i - 1], entry[i - 1],
                                      entry_fs[i - 1], frames[i - 1]))
                    s, e, fs, fr = max(cands, key=lambda c: c[0])
                    if s <= NEG:
                        continue
                    new[i] = (s + unit_lp[t, i], e, fs, fr + 1)
                score = np.array([c[0] for c in new])
                entry = np.array([c[1] for c in new])
                entry_fs = np.array([c[2] for c in new])
                frames = np.array([c[3] for c in new], np.int64)
                # keyword completion: confidence = geometric-mean unit
                # posterior along the keyword segment (reference:
                # keyword-spot.h confidence)
                if score[-1] > NEG and frames[-1] >= n:
                    kw_lp = score[-1] - entry_fs[-1]
                    conf = float(np.exp(kw_lp / max(frames[-1], 1)))
                    if conf >= self.opts.confidence_threshold and (
                        best is None or conf > best.confidence
                    ):
                        best = KeywordResult(name, conf, t,
                                             int(entry[-1]))
                filler_score += filler[t]
            if best is not None:
                results.append(best)
        return results

