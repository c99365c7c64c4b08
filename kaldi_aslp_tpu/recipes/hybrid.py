"""Hybrid NN-HMM training recipe: the run_dnn.sh / run_lstm.sh chain.

JAX-native equivalent of the ASLP hybrid pipelines (reference:
aslp_scripts/aslp_nnet/run_dnn.sh, run_lstm.sh —
prepare_feats_ali.sh targets → proto → train_scheduler.sh newbob loop →
decode.sh with aslp-nnet-forward | latgen-faster-mapped →
score_basic.sh).

Operates on in-memory (feats, transcripts) dicts + a Lang; stages:
  1. GMM bootstrap (mono) for alignments          [train_mono.sh]
  2. targets = ali→pdf, priors = analyze-counts   [prepare_feats_ali.sh]
  3. NN training with newbob accept/reject        [train_scheduler.sh]
  4. decode: nnet_forward − priors → Viterbi/HCLG [decode.sh]
  5. WER                                           [score_basic.sh]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.utils.log import get_logger
from kaldi_aslp_tpu.fst import Lang, make_decode_graph, \
    make_unigram_grammar
from kaldi_aslp_tpu.fst.fst import Fst
from kaldi_aslp_tpu.gmm import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu.models import Nnet
from kaldi_aslp_tpu.train import (
    FrameTrainer,
    NewbobOptions,
    NewbobScheduler,
    NnetTrainOptions,
    init_velocity,
)
from kaldi_aslp_tpu.data.randomizer import FrameRandomizer, \
    RandomizerOptions
from kaldi_aslp_tpu.decoder import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu.decoder.decodable import PdfPrior, nnet_forward, \
    NnetForwardOptions
from kaldi_aslp_tpu.ops.edit_distance import ErrorStats, score_utterances

logger = get_logger("hybrid")


@dataclasses.dataclass
class HybridRecipeOptions(Config):
    model_type: str = "dnn"      # dnn | lstm
    hidden_dim: int = 128
    num_layers: int = 2
    splice_context: int = 2      # DNN input splicing (frames each side)
    learn_rate: float = 0.008
    momentum: float = 0.9
    minibatch_size: int = 256
    max_iters: int = 10
    acoustic_scale: float = 0.2
    mono_iters: int = 8
    mono_totgauss: int = 100
    # lattice scoring sweep (reference: score_basic.sh LMWT grid);
    # empty = 1-best at acoustic_scale only
    lmwt_sweep: str = ""         # e.g. "1 2 4 7 10"
    lattice_beam: float = 8.0
    # layer-wise discriminative pretraining (pretrain.sh): epochs to
    # train at each depth before growing; 0 = off (random full-depth
    # init).  DNN only, mirrors run_cfsmn_pre.sh-style two-phase runs.
    pretrain_iters: int = 0
    pretrain_learn_rate: float = 0.008
    # > 0: decode with the beam-pruned lattice decoder at this beam
    # instead of the exact dense DP (mandatory once the HCLG outgrows
    # the dense [T, S] table — the latgen-faster-mapped role proper)
    decode_beam: float = 0.0
    decode_max_active: int = 2048


class HybridRecipe:
    def __init__(self, lang: Lang,
                 opts: Optional[HybridRecipeOptions] = None):
        self.lang = lang
        self.opts = opts or HybridRecipeOptions()

    def run(
        self,
        train_feats: Dict[str, np.ndarray],
        train_texts: Dict[str, List[str]],
        test_feats: Dict[str, np.ndarray],
        test_texts: Dict[str, List[str]],
        grammar: Optional[Fst] = None,
        work_dir: str = "exp_hybrid",
        bootstrap: Optional[tuple] = None,
        dev_feats: Optional[Dict[str, np.ndarray]] = None,
        dev_texts: Optional[Dict[str, List[str]]] = None,
    ) -> ErrorStats:
        """``bootstrap`` (pdf_targets, num_pdfs, hclg, lut) injects
        externally-produced alignments + decode graph — the reference
        trains its hybrid DNN on TRIPHONE alignments and decodes over
        the triphone HCLG (run_dnn.sh on exp/tri* ali dirs), not on its
        own mono bootstrap.

        ``dev_feats``/``dev_texts``: when given together with
        ``lmwt_sweep``, the LMWT grid is swept on the DEV set and the
        test set is scored once at the dev-selected LMWT (the
        egs/timit/s5 dev/test discipline); without them the sweep
        selects on test, which is what score_basic.sh itself does."""
        opts = self.opts
        hclg = lut = None
        if bootstrap is not None:
            pdf_targets, num_pdfs, hclg, lut = bootstrap
            logger.info("external alignments: %d pdfs", num_pdfs)
        else:
            # 1. GMM bootstrap → alignments
            mono = MonophoneTrainer(
                self.lang,
                opts=MonoTrainOptions(
                    num_iters=opts.mono_iters,
                    totgauss=opts.mono_totgauss,
                    realign_iters=" ".join(
                        str(i) for i in range(1, opts.mono_iters)
                    ),
                ),
            )
            am, tm = mono.train(train_feats, train_texts)
            alis = mono.align(am, train_feats, train_texts)
            logger.info("GMM bootstrap done: %d pdfs", tm.num_pdfs)
            num_pdfs = tm.num_pdfs
            pdf_targets = {u: tm.alignment_to_pdfs(a) for u, a in
                           alis.items()}

        # 2. priors
        prior = PdfPrior.from_alignments(pdf_targets, num_pdfs)

        # 3. NN training
        dim = self._nn_feats(
            next(iter(train_feats.values()))[:1]
        ).shape[1]
        utts = sorted(u for u in train_feats if u in pdf_targets)
        cv_utts = utts[: max(1, len(utts) // 10)]
        tr_utts = utts[len(cv_utts):]

        def batches(utt_list, seed):
            r = FrameRandomizer(RandomizerOptions(
                minibatch_size=opts.minibatch_size,
                randomizer_seed=seed,
            ))
            for u in utt_list:
                feats = self._nn_feats(train_feats[u])
                n = min(len(feats), len(pdf_targets[u]))
                r.feed(feats[:n], pdf_targets[u][:n])
                if r.full():
                    yield from r.iterate_minibatches()
            yield from r.flush()

        if (opts.pretrain_iters > 0 and opts.model_type == "dnn"
                and opts.num_layers > 1):
            net, params = self._pretrain(dim, num_pdfs,
                                         batches, tr_utts)
        else:
            net = self._build_net(dim, num_pdfs)
            params = net.init(jax.random.PRNGKey(777))
        velocity = init_velocity(params)
        trainer = FrameTrainer(
            net, NnetTrainOptions(momentum=opts.momentum)
        )
        # a schedule state without its best-model checkpoint cannot be
        # resumed (fresh params + stale lr/halving state — the round-5
        # CTC footgun); drop it and start clean
        _stale = os.path.join(work_dir, "newbob_state.json")
        _best = os.path.join(work_dir, "nnet_best.knet")
        if os.path.exists(_stale) and not os.path.exists(_best):
            logger.warning("removing stale newbob state %s (no model "
                           "checkpoint to resume with)", _stale)
            os.remove(_stale)
        sched = NewbobScheduler(
            work_dir, initial_lr=opts.learn_rate,
            opts=NewbobOptions(max_iters=opts.max_iters),
        )

        from kaldi_aslp_tpu.train.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )
        best = params
        # resume: the scheduler restores its state from work_dir marker
        # files; the accepted model must come back with it (the
        # reference reloads $dir/.mlp_best, train_scheduler.sh:96)
        if os.path.exists(sched.best_model_path):
            best, vel_ck, _, _ = load_checkpoint(sched.best_model_path)
            if vel_ck is not None:
                velocity = vel_ck
            logger.info("resumed best model from %s",
                        sched.best_model_path)
        while not sched.done:
            params, velocity, rep = trainer.train_epoch(
                best, velocity, batches(tr_utts, sched.state.iter),
                sched.learn_rate,
            )
            cv = trainer.evaluate(params, batches(cv_utts, 0))
            accepted = sched.report(cv.avg_loss)
            logger.info(
                "iter %d lr %.5f tr %.4f cv %.4f acc %.1f%% %s",
                sched.state.iter, sched.learn_rate, rep.avg_loss,
                cv.avg_loss, cv.frame_accuracy,
                "ACCEPT" if accepted else "REJECT",
            )
            if accepted:
                best = params
                save_checkpoint(sched.best_model_path, best, velocity)

        # 4. decode
        if hclg is None:
            if grammar is None:
                words = sorted({w for t in train_texts.values()
                                for w in t})
                grammar = make_unigram_grammar(
                    {w: 1.0 / len(words) for w in words},
                    self.lang.words
                )
            hclg = make_decode_graph(self.lang, grammar, tm)
            lut = tm.alignment_to_pdfs(
                np.arange(tm.num_transition_ids + 1)
            )
        fwd_opts = NnetForwardOptions()
        packed = PackedGraph.from_fst(hclg)
        if opts.lmwt_sweep:
            # lattice generation + LMWT grid (score_basic.sh)
            from kaldi_aslp_tpu.decoder.lattice import (
                generate_lattice,
                score_lmwt_sweep,
            )
            from kaldi_aslp_tpu.decoder.beam import (
                BeamSearchDecoder,
                CsrGraph,
            )
            bdec = None
            if opts.decode_beam > 0:
                bdec = BeamSearchDecoder(
                    CsrGraph.from_packed(packed), lut,
                    acoustic_scale=opts.acoustic_scale,
                    beam=opts.decode_beam,
                    max_active=opts.decode_max_active)
            def lat_set(feats_set, texts_set):
                lats, refs = {}, {}
                for u, feats in feats_set.items():
                    scores = nnet_forward(net, best,
                                          self._nn_feats(feats),
                                          fwd_opts, prior)
                    if bdec is not None:
                        _, _, _, lats[u] = bdec.decode_lattice(
                            jnp.asarray(scores),
                            lattice_beam=opts.lattice_beam)
                    else:
                        lats[u] = generate_lattice(
                            packed, scores, lut,
                            acoustic_scale=opts.acoustic_scale,
                            beam=opts.lattice_beam,
                        )
                    refs[u] = [self.lang.words.id(w)
                               for w in texts_set[u]]
                return lats, refs

            lmwt_grid = [int(x) for x in opts.lmwt_sweep.split()]
            lats, refs = lat_set(test_feats, test_texts)
            if dev_feats:
                dev_lats, dev_refs = lat_set(dev_feats, dev_texts)
                dev_sweep = score_lmwt_sweep(dev_lats, dev_refs,
                                             lmwt_range=lmwt_grid,
                                             acoustic_scale_base=1.0)
                best_lmwt = min(dev_sweep,
                                key=lambda k: dev_sweep[k].wer)
                self.last_dev_wer = dev_sweep[best_lmwt].wer
                logger.info("dev-selected LMWT %d (dev WER %.2f)",
                            best_lmwt, self.last_dev_wer)
                lmwt_grid = [best_lmwt]
            sweep = score_lmwt_sweep(
                lats, refs, lmwt_range=lmwt_grid,
                acoustic_scale_base=1.0,
            )
            for lmwt, st in sweep.items():
                logger.info("LMWT %d: %s", lmwt, st.report())
            stats = min(sweep.values(), key=lambda st: st.wer)
            logger.info("best: %s", stats.report())
            return stats
        if opts.decode_beam > 0:
            from kaldi_aslp_tpu.decoder.beam import (
                BeamSearchDecoder,
                CsrGraph,
            )
            dec = BeamSearchDecoder(
                CsrGraph.from_packed(packed), lut,
                acoustic_scale=opts.acoustic_scale,
                beam=opts.decode_beam,
                max_active=opts.decode_max_active)
        else:
            dec = ViterbiDecoder(packed, lut,
                                 acoustic_scale=opts.acoustic_scale)
        hyps = {}
        for u, feats in test_feats.items():
            scores = nnet_forward(net, best, self._nn_feats(feats),
                                  fwd_opts, prior)
            words_out, _, _ = dec.decode(scores)
            hyps[u] = [self.lang.words.sym(w) for w in words_out]
        stats = score_utterances(test_texts, hyps)
        logger.info("%s", stats.report())
        return stats

    def _pretrain(self, input_dim: int, num_pdfs: int,
                  batches, tr_utts) -> Tuple[Nnet, Dict]:
        """Layer-wise discriminative pretraining (reference:
        aslp_scripts/aslp_nnet/pretrain.sh — momentum 0, fixed lr,
        grow one [Affine, Sigmoid] block before the output layer per
        epoch with the output affine re-randomized)."""
        from kaldi_aslp_tpu.models import AffineTransform, Sigmoid
        from kaldi_aslp_tpu.train.pretrain import pretrain_layerwise

        opts = self.opts

        def hidden_block(in_dim: int) -> List:
            return [
                AffineTransform(in_dim, opts.hidden_dim,
                                param_stddev=0.1,
                                bias_mean=0.0, bias_range=0.0),
                Sigmoid(opts.hidden_dim, opts.hidden_dim),
            ]

        initial = Nnet()
        for comp in hidden_block(input_dim):
            initial.add(comp)
        initial.add(AffineTransform(opts.hidden_dim, num_pdfs,
                                    param_stddev=0.04,
                                    bias_mean=0.0, bias_range=0.0))

        def hidden_factory(depth: int) -> Nnet:
            h = Nnet()
            for comp in hidden_block(opts.hidden_dim):
                h.add(comp)
            return h

        def train_fn(net, params, depth):
            trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.0))
            velocity = init_velocity(params)
            for it in range(opts.pretrain_iters):
                params, velocity, rep = trainer.train_epoch(
                    params, velocity,
                    batches(tr_utts, 1000 * depth + it),
                    opts.pretrain_learn_rate,
                )
                logger.info("pretrain depth %d iter %d tr %.4f",
                            depth, it, rep.avg_loss)
            return params

        return pretrain_layerwise(initial, hidden_factory,
                                  opts.num_layers, train_fn,
                                  key=jax.random.PRNGKey(777))

    def _build_net(self, input_dim: int, num_pdfs: int) -> Nnet:
        from kaldi_aslp_tpu.models import (
            AffineTransform, Lstm, Sigmoid, Splice,
        )
        opts = self.opts
        net = Nnet()
        dim = input_dim
        if opts.model_type == "dnn":
            for _ in range(opts.num_layers):
                net.add(AffineTransform(dim, opts.hidden_dim,
                                        param_stddev=0.1,
                                        bias_mean=0.0, bias_range=0.0))
                net.add(Sigmoid(opts.hidden_dim, opts.hidden_dim))
                dim = opts.hidden_dim
        elif opts.model_type == "lstm":
            for _ in range(opts.num_layers):
                net.add(Lstm(dim, opts.hidden_dim))
                dim = opts.hidden_dim
        else:
            raise ValueError(opts.model_type)
        net.add(AffineTransform(dim, num_pdfs, param_stddev=0.04,
                                bias_mean=0.0, bias_range=0.0))
        return net

    def _nn_feats(self, feats: np.ndarray) -> np.ndarray:
        """DNN input splicing (run_dnn.sh splice context)."""
        if self.opts.model_type != "dnn" or not self.opts.splice_context:
            return feats
        from kaldi_aslp_tpu.feats import splice_frames

        c = self.opts.splice_context
        return np.asarray(splice_frames(jnp.asarray(feats), c, c))
