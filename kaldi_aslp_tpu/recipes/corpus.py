"""Corpus-level recipe runner: Kaldi data dirs on disk → trained system.

The user-facing entry for real corpora (reference: the aslp_scripts
run_*.sh chain over egs/<corpus>/s5 data dirs): reads wav.scp/text/
utt2spk, extracts fbank features with per-speaker CMVN, and runs the
CTC or hybrid pipeline.  The reference's corpus configs (timit/rm/
hkust/librispeech) are invocations of this with their data dirs; corpora are
not downloadable in this environment, so CI exercises the same path on
the synthesized yesno corpus.

Usage:
    python -m kaldi_aslp_tpu.recipes.corpus \
        --pipeline=ctc --lexicon=lexicon.txt \
        data/train data/test exp/ctc
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config, parse_options
from kaldi_aslp_tpu.utils.log import get_logger, Timer
from kaldi_aslp_tpu.io import DataDir, read_wave
from kaldi_aslp_tpu.feats import (
    Fbank,
    FbankOptions,
    FrameExtractionOptions,
    MelBanksOptions,
    acc_cmvn_stats,
    apply_cmvn,
)
from kaldi_aslp_tpu.fst import Lang, Lexicon

logger = get_logger("corpus")


@dataclasses.dataclass
class CorpusRecipeOptions(Config):
    pipeline: str = "ctc"        # ctc | hybrid
    lexicon: str = ""            # lexicon.txt path (WORD ph1 ph2 ...)
    num_mel_bins: int = 40
    dither: float = 0.0
    norm_vars: bool = True
    max_utts: int = 0            # 0 = all (debug subsetting)


def extract_features(
    d: DataDir, opts: CorpusRecipeOptions
) -> Dict[str, np.ndarray]:
    """fbank + per-speaker CMVN for every utterance in a data dir
    (steps/make_fbank.sh + compute_cmvn_stats.sh + apply-cmvn)."""
    utts = sorted(d.wav_scp)
    if opts.max_utts:
        utts = utts[: opts.max_utts]
    fbank: Optional[Fbank] = None
    raw: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    for utt in utts:
        wav = read_wave(d.wav_scp[utt])
        if fbank is None:
            fbank = Fbank(
                FrameExtractionOptions(samp_freq=wav.samp_freq,
                                       dither=opts.dither),
                MelBanksOptions(num_bins=opts.num_mel_bins),
                FbankOptions(),
            )
        feats = np.asarray(fbank(wav.data[0]))
        raw[utt] = feats
        spk = d.utt2spk.get(utt, utt)
        stats[spk] = acc_cmvn_stats(feats, stats.get(spk))
    out = {}
    for utt, feats in raw.items():
        spk = d.utt2spk.get(utt, utt)
        out[utt] = np.asarray(
            apply_cmvn(jnp.asarray(feats), stats[spk],
                       norm_vars=opts.norm_vars)
        )
    return out


def run_corpus(
    train_dir: str,
    test_dir: str,
    work_dir: str,
    opts: Optional[CorpusRecipeOptions] = None,
    pipeline_opts=None,
):
    """Returns the final ErrorStats."""
    opts = opts or CorpusRecipeOptions()
    timer = Timer()
    train = DataDir.load(train_dir)
    test = DataDir.load(test_dir)
    problems = train.validate() + test.validate()
    for p in problems:
        logger.warning("data-dir issue: %s", p)

    with open(opts.lexicon) as f:
        lex = Lexicon.from_text(f.read())
    lang = Lang.build(lex)

    logger.info("extracting features (%d train / %d test utts)",
                len(train.wav_scp), len(test.wav_scp))
    train_feats = extract_features(train, opts)
    test_feats = extract_features(test, opts)
    train_texts = {u: t.split() for u, t in train.text.items()
                   if u in train_feats}
    test_texts = {u: t.split() for u, t in test.text.items()
                  if u in test_feats}

    if opts.pipeline == "ctc":
        from kaldi_aslp_tpu.recipes.ctc import CtcRecipe, \
            CtcRecipeOptions
        recipe = CtcRecipe(lang, pipeline_opts or CtcRecipeOptions())
    elif opts.pipeline == "hybrid":
        from kaldi_aslp_tpu.recipes.hybrid import HybridRecipe, \
            HybridRecipeOptions
        recipe = HybridRecipe(lang,
                              pipeline_opts or HybridRecipeOptions())
    else:
        raise ValueError(f"unknown pipeline {opts.pipeline!r}")
    stats = recipe.run(train_feats, train_texts, test_feats, test_texts,
                       work_dir=work_dir)
    logger.info("%s [total %.1fs]", stats.report(), timer.elapsed())
    return stats


def main(argv=None):
    opts = CorpusRecipeOptions()
    args = parse_options(
        argv if argv is not None else sys.argv[1:], [opts],
        "python -m kaldi_aslp_tpu.recipes.corpus --pipeline=ctc "
        "--lexicon=lex.txt data/train data/test exp/dir",
        3, 3,
    )
    stats = run_corpus(args[0], args[1], args[2], opts)
    print(stats.report())
    return 0 if stats.wer < 100.0 else 1


if __name__ == "__main__":
    sys.exit(main())
