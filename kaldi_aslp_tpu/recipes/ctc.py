"""Phone-CTC training recipe: the aslp_scripts/ctc chain.

JAX-native equivalent of the reference CTC pipeline (reference:
aslp_scripts/ctc/prepare_mono_phone_ctc.sh — phone labels shifted so
blank=0 (aslp-ali-minus-one); train_scheduler_ctc.sh per-epoch CTC
training; make_ctc_graph.sh TLG; Eesen-style decode).

Labels come straight from word transcripts through the lexicon (the
reference derives them from GMM alignments via ali-to-phones; with the
lexicon the phone sequence is identical up to silence, which CTC's
blank absorbs)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.utils.log import get_logger
from kaldi_aslp_tpu.fst import Lang, make_unigram_grammar
from kaldi_aslp_tpu.fst.fst import Fst
from kaldi_aslp_tpu.fst.ctc_graph import ctc_lut, make_ctc_decode_graph
from kaldi_aslp_tpu.models import Nnet
from kaldi_aslp_tpu.models.simple import AffineTransform
from kaldi_aslp_tpu.models.recurrent import BLstm, Lstm
from kaldi_aslp_tpu.train import (
    CtcTrainer,
    NewbobOptions,
    NewbobScheduler,
    NnetTrainOptions,
    init_velocity,
)
from kaldi_aslp_tpu.data.sequence import CtcBatcher, CtcBatcherOptions
from kaldi_aslp_tpu.decoder import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu.ops.edit_distance import ErrorStats, score_utterances

logger = get_logger("ctc-recipe")


@dataclasses.dataclass
class CtcRecipeOptions(Config):
    model_type: str = "blstm"   # lstm | blstm
    hidden_dim: int = 64
    num_layers: int = 2
    learn_rate: float = 0.01
    momentum: float = 0.9
    max_iters: int = 12
    keep_lr_iters: int = 0   # static hold (legacy; auto_saddle replaces)
    # automatic blank-saddle crossing (train/saddle.py): hold the lr
    # while greedy output is all-blank, escalate it if the saddle does
    # not yield, hand control to newbob after crossing.  Replaces
    # per-corpus keep_lr_iters / lr hand-tuning — every inventory size
    # runs the same policy.
    auto_saddle: bool = True
    saddle_blank_thresh: float = 0.90
    saddle_escalate_iters: int = 4
    saddle_lr_factor: float = 2.0
    saddle_max_lr: float = 0.8
    num_streams: int = 8
    acoustic_scale: float = 1.0
    # Eesen-style decode: divide posteriors by their training-set
    # average (reference: aslp-nnet-forward --class-frame-counts +
    # --scale-blank roles); 0 disables
    prior_scale: float = 1.0
    # feature bytes over the host->device link (data/transport.py):
    # f32 passthrough | bf16 | int8
    transport: str = "f32"
    # > 0: decode with the beam-pruned decoder at this beam instead of
    # the exact dense DP (mandatory when the TLG outgrows the dense
    # [T, S] table)
    decode_beam: float = 0.0
    decode_max_active: int = 2048
    # low frame rate: take every k-th frame in training AND decode
    # (reference: the --skip-width of aslp-nnet-train-ctc-streams;
    # fewer frames per label makes the CTC alignment tractable and cuts
    # compute 1/k)
    lfr_skip: int = 1
    # batch shape bucketing (one compiled program per bucket)
    bucket_time: int = 64
    bucket_labels: int = 16


class CtcRecipe:
    def __init__(self, lang: Lang,
                 opts: Optional[CtcRecipeOptions] = None):
        self.lang = lang
        self.opts = opts or CtcRecipeOptions()
        # CTC inventory: blank=0, outputs 1..N = phone ids (the
        # ali-minus-one convention with our 1-based phone symbols)
        self.num_outputs = len(lang.phones) + 1 - 1  # ids are 1..N; +blank

    def phone_labels(self, words: List[str]) -> np.ndarray:
        """Transcript → phone-id label sequence (blank-0 convention)."""
        seq: List[int] = []
        for w in words:
            pron = self.lang.lexicon.prons[w][0]
            seq.extend(self.lang.phones.id(p) for p in pron)
        return np.asarray(seq, np.int32)

    def run(
        self,
        train_feats: Dict[str, np.ndarray],
        train_texts: Dict[str, List[str]],
        test_feats: Dict[str, np.ndarray],
        test_texts: Dict[str, List[str]],
        grammar: Optional[Fst] = None,
        work_dir: str = "exp_ctc",
        dev_feats: Optional[Dict[str, np.ndarray]] = None,
        dev_texts: Optional[Dict[str, List[str]]] = None,
    ) -> ErrorStats:
        """When a dev set is given, (acoustic_scale, prior_scale) are
        swept on it and the test set is decoded once at the selection —
        the same dev/test discipline as the GMM/hybrid stages (the
        dev/test rows of egs/timit/s5/RESULTS; the swept quantities are
        the --acoustic-scale of decode.sh and the --class-frame-counts
        prior division of aslp-nnet-forward).  Without a dev set the
        recipe's fixed options apply (score_basic.sh-style)."""
        opts = self.opts
        V = len(self.lang.phones) + 1  # blank + phones (ids 1..N)
        dim = next(iter(train_feats.values())).shape[1]
        net = self._build_net(dim, V)
        params = net.init(jax.random.PRNGKey(777))
        velocity = init_velocity(params)
        trainer = CtcTrainer(net, NnetTrainOptions(momentum=opts.momentum),
                             transport=opts.transport)
        cache = trainer.make_cache()  # HBM replay from epoch 2 on
        # the CTC recipe checkpoints NO per-iteration model, so a
        # newbob schedule resumed from a dead run would drive a FRESH
        # init with a stale iter/lr/halving state (observed round 5:
        # the stale best-cv REJECTed every fresh epoch and the lr
        # collapsed at the blank saddle) — always start clean
        import os as _os0
        _stale = _os0.path.join(work_dir, "newbob_state.json")
        if _os0.path.exists(_stale):
            logger.warning("removing stale newbob state %s (no model "
                           "checkpoint to resume with)", _stale)
            _os0.remove(_stale)
        sched = NewbobScheduler(
            work_dir, initial_lr=opts.learn_rate,
            opts=NewbobOptions(max_iters=opts.max_iters,
                               keep_lr_iters=opts.keep_lr_iters),
        )

        utts = sorted(train_feats)
        cv_utts = utts[: max(1, len(utts) // 10)]
        tr_utts = utts[len(cv_utts):]

        def batches(utt_list):
            src = ((u, train_feats[u],
                    self.phone_labels(train_texts[u]))
                   for u in utt_list)
            return list(CtcBatcher(
                src, CtcBatcherOptions(num_streams=opts.num_streams,
                                       skip_width=opts.lfr_skip,
                                       bucket_time=opts.bucket_time,
                                       bucket_labels=opts.bucket_labels)
            ))

        tr_batches = batches(tr_utts)
        cv_batches = batches(cv_utts)

        from kaldi_aslp_tpu.train.saddle import SaddleDetector, \
            SaddleOptions
        saddle = SaddleDetector(SaddleOptions(
            enabled=opts.auto_saddle,
            blank_thresh=opts.saddle_blank_thresh,
            escalate_iters=opts.saddle_escalate_iters,
            lr_factor=opts.saddle_lr_factor,
            max_lr=opts.saddle_max_lr))

        @jax.jit
        def _blank_counts(p, feats, mask):
            y, _ = net.apply(p, feats, train=False, mask=mask)
            blanks = jnp.sum((y.argmax(-1) == 0) * mask)
            return jnp.stack([blanks, jnp.sum(mask)])

        probe = cv_batches[: 2]

        def blank_fraction(p) -> float:
            tot = np.zeros(2)
            for b in probe:
                tot += np.asarray(_blank_counts(
                    p, jnp.asarray(b.feats), jnp.asarray(b.frame_mask)))
            return float(tot[0] / max(tot[1], 1.0))

        best = params
        while not sched.done:
            params, velocity, rep = trainer.train_epoch(
                best, velocity, iter(tr_batches), sched.learn_rate,
                cache=cache,
            )
            cv = trainer.evaluate(params, cv_batches)
            hold = saddle.update(blank_fraction(params), cv.avg_loss,
                                 sched) if opts.auto_saddle else False
            accepted = sched.report(cv.avg_loss, hold=hold)
            logger.info("iter %d lr %.5f tr %.4f cv %.4f %s",
                        sched.state.iter, sched.learn_rate,
                        rep.avg_loss, cv.avg_loss,
                        "HOLD" if hold else
                        ("ACCEPT" if accepted else "REJECT"))
            if accepted:
                best = params

        if grammar is None:
            words = sorted({w for t in train_texts.values() for w in t})
            grammar = make_unigram_grammar(
                {w: 1.0 / len(words) for w in words}, self.lang.words
            )
        tlg = make_ctc_decode_graph(self.lang, grammar)
        # acoustic_scale lives OUTSIDE the decoder (scale the loglike
        # matrix instead): score = graph + s*(logp - p*prior) either
        # way, and one decoder instance serves the whole dev sweep
        # without recompiling
        if opts.decode_beam > 0:
            from kaldi_aslp_tpu.decoder.beam import (
                BeamSearchDecoder,
                CsrGraph,
            )
            dec = BeamSearchDecoder(
                CsrGraph.from_packed(PackedGraph.from_fst(tlg)),
                ctc_lut(V), acoustic_scale=1.0,
                beam=opts.decode_beam,
                max_active=opts.decode_max_active)
        else:
            dec = ViterbiDecoder(
                PackedGraph.from_fst(tlg), ctc_lut(V),
                acoustic_scale=1.0,
            )
        # padded single-shape forward (per-utterance ragged T would
        # recompile for every new length)
        bt = opts.bucket_time

        @jax.jit
        def _forward(p, feats, mask):
            y, _ = net.apply(p, feats, mask=mask)
            return jax.nn.log_softmax(y, axis=-1)

        def posteriors(feats: np.ndarray) -> np.ndarray:
            feats = feats[:: opts.lfr_skip]
            T = len(feats)
            Tp = ((T + bt - 1) // bt) * bt
            f = np.pad(feats, ((0, Tp - T), (0, 0)))[None]
            m = np.zeros((1, Tp), np.float32)
            m[0, :T] = 1.0
            y = _forward(best, jnp.asarray(f), jnp.asarray(m))
            return np.asarray(y[0][:T])

        # posterior priors over the training set for Eesen-style
        # prior-divided decoding (unscaled base; the applied prior is
        # prior_scale * base, with prior_scale dev-swept when possible)
        prior_base = np.zeros(V, np.float32)
        if opts.prior_scale > 0 or dev_feats:
            acc = np.zeros(V, np.float64)
            n = 0
            for u in sorted(train_feats)[:200]:
                p = np.exp(posteriors(train_feats[u]))
                acc += p.sum(0)
                n += len(p)
            prior_base = np.log(
                np.maximum(acc / n, 1e-10)).astype(np.float32)

        chosen_a = opts.acoustic_scale
        chosen_p = opts.prior_scale
        self.dev_wer = float("nan")
        if dev_feats:
            dev_logp = {u: posteriors(f) for u, f in dev_feats.items()}
            best_cfg = None
            for a_s in (0.7, 0.9, 1.1):
                for p_s in (0.5, 1.0):
                    hyps = {}
                    for u in sorted(dev_logp):
                        m = a_s * (dev_logp[u] - p_s * prior_base)
                        try:
                            w_out, _, _ = dec.decode(jnp.asarray(m))
                        except RuntimeError as e:
                            logger.warning("dev decode failed on %s "
                                           "(a=%.1f p=%.1f): %s",
                                           u, a_s, p_s, e)
                            w_out = []
                        hyps[u] = [self.lang.words.sym(w)
                                   for w in w_out]
                    st = score_utterances(dev_texts, hyps)
                    logger.info("dev sweep acoustic %.1f prior %.1f: "
                                "WER %.2f", a_s, p_s, st.wer)
                    if best_cfg is None or st.wer < best_cfg[0]:
                        best_cfg = (st.wer, a_s, p_s)
            self.dev_wer, chosen_a, chosen_p = best_cfg
            logger.info("dev-selected acoustic_scale %.1f prior_scale "
                        "%.1f (dev WER %.2f)", chosen_a, chosen_p,
                        self.dev_wer)
            # downstream probes (nn_budget_sweep) read the operating
            # point off the recipe
            self.opts.acoustic_scale = chosen_a
            self.opts.prior_scale = chosen_p
        log_priors = (chosen_p * prior_base).astype(np.float32)

        # greedy CTC phone error rate first: a model-quality signal
        # independent of the decode graph / pruning / LM (the
        # aslp-nnet-forward + best-path-collapse sanity check)
        hyp_ph, ref_ph = {}, {}
        test_logp = {}
        for u, feats in test_feats.items():
            logp = posteriors(feats)
            test_logp[u] = logp
            ids = logp.argmax(-1)
            col = [int(x) for x in ids]
            dedup = [x for i, x in enumerate(col)
                     if x != 0 and (i == 0 or x != col[i - 1])]
            hyp_ph[u] = [str(x) for x in dedup]
            ref_ph[u] = [str(x) for x in
                         self.phone_labels(test_texts[u])]
        per = score_utterances(ref_ph, hyp_ph)
        self.greedy_per = per.wer
        logger.info("greedy CTC PER %.2f%%", per.wer)

        hyps = {}
        for u in sorted(test_feats):
            m = chosen_a * (test_logp[u] - log_priors)
            try:
                words_out, _, _ = dec.decode(jnp.asarray(m))
            except RuntimeError as e:
                logger.warning("test decode failed on %s: %s", u, e)
                words_out = []
            hyps[u] = [self.lang.words.sym(w) for w in words_out]
        stats = score_utterances(test_texts, hyps)
        logger.info("%s", stats.report())
        # expose the trained system for follow-on probes (budget
        # sweeps, rescoring experiments) without retraining
        self.best_params = best
        self.net = net
        self.log_priors = log_priors
        self.tlg = tlg
        self.posteriors = posteriors
        # persist the final model so probes survive the process (the
        # reference keeps $dir/final.nnet for exactly this reason —
        # aslp_scripts train_scheduler.sh's final model link); newbob
        # only checkpoints its own schedule state
        import os as _os
        from kaldi_aslp_tpu.train import save_checkpoint
        _os.makedirs(work_dir, exist_ok=True)
        save_checkpoint(_os.path.join(work_dir, "final.ckpt"), best,
                        model_states={"log_priors": log_priors},
                        meta={"greedy_per": float(per.wer),
                              "wer": float(stats.wer)})
        return stats

    def _build_net(self, input_dim: int, num_outputs: int) -> Nnet:
        opts = self.opts
        net = Nnet()
        dim = input_dim
        for _ in range(opts.num_layers):
            if opts.model_type == "blstm":
                net.add(BLstm(dim, 2 * opts.hidden_dim))
                dim = 2 * opts.hidden_dim
            else:
                net.add(Lstm(dim, opts.hidden_dim))
                dim = opts.hidden_dim
        net.add(AffineTransform(dim, num_outputs, param_stddev=0.04,
                                bias_mean=0.0, bias_range=0.0))
        return net
