"""Context-dependent (triphone) GMM training.

JAX-native equivalent of the reference second-pass training (reference:
egs/wsj/s5/steps/train_deltas.sh — acc-tree-stats → cluster-phones →
build-tree → gmm-init-model → convert-ali → align/acc/est loop).

Consumes monophone alignments; produces a decision tree, a CD
transition model, and a trained CD GMM, plus the graph compilers needed
to align and decode with it."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.utils.log import get_logger
from kaldi_aslp_tpu.hmm.topology import HmmTopology
from kaldi_aslp_tpu.hmm.transition_model import TransitionModel
from kaldi_aslp_tpu.gmm.diag_gmm import (
    AmDiagGmm,
    GmmStats,
    gmm_loglikes_bucketed,
    mle_update,
    split_gaussians,
)
from kaldi_aslp_tpu.tree.build_tree import (
    ContextDependency,
    build_tree,
    stats_from_alignment,
)
from kaldi_aslp_tpu.fst.fst import Fst
from kaldi_aslp_tpu.fst.lang import Lang, make_lexicon_fst, \
    make_linear_acceptor
from kaldi_aslp_tpu.fst.context import ContextWindows, compose_context
from kaldi_aslp_tpu.fst.hclg import expand_hmm_cd, triples_from_tree
from kaldi_aslp_tpu.decoder.viterbi import PackedGraph, ViterbiDecoder

logger = get_logger("deltas")


@dataclasses.dataclass
class DeltasTrainOptions(Config):
    num_iters: int = 25
    max_iter_inc: int = 15
    totgauss: int = 1000
    num_leaves: int = 200
    realign_iters: str = "5 10 15 20"
    min_gaussian_occupancy: float = 3.0
    tree_min_gain: float = 20.0


class CdGraphCompiler:
    """Per-utterance CD training graphs sharing one window table."""

    def __init__(self, lang: Lang, windows: ContextWindows,
                 sil_prob: float = 0.5):
        self.lang = lang
        self.windows = windows
        self.L = make_lexicon_fst(lang, sil_prob=sil_prob
                                  ).arc_sort("olabel")
        self._clg_cache: Dict[Tuple[int, ...], Fst] = {}

    def compile_clg(self, words: List[str]) -> Fst:
        wids = tuple(self.lang.words.id(w) for w in words)
        if wids not in self._clg_cache:
            lg = self.L.compose(make_linear_acceptor(wids))
            clg, _ = compose_context_shared(lg, self.windows)
            self._clg_cache[wids] = clg
        return self._clg_cache[wids]


def compose_context_shared(lg: Fst, table: ContextWindows):
    """compose_context but interning into an existing shared table."""
    from kaldi_aslp_tpu.fst import context as ctx_mod

    # reuse the implementation by temporarily injecting the table
    out, local = ctx_mod.compose_context(lg)
    # remap local window ids into the shared table
    remap = {0: 0}
    for wid in range(1, len(local) + 1):
        remap[wid] = table.id(local.window(wid))
    for s in range(out.num_states):
        for a in out.arcs[s]:
            if a.ilabel != 0:
                a.ilabel = remap[a.ilabel]
    return out, table


class DeltasTrainer:
    def __init__(self, lang: Lang, topo: HmmTopology,
                 opts: Optional[DeltasTrainOptions] = None):
        self.lang = lang
        self.topo = topo
        self.opts = opts or DeltasTrainOptions()
        self.windows = ContextWindows()
        self.tree: Optional[ContextDependency] = None
        self.trans_model: Optional[TransitionModel] = None

    def build_tree_from_alignments(
        self,
        feats: Dict[str, np.ndarray],
        mono_trans_model: TransitionModel,
        mono_alignments: Dict[str, np.ndarray],
    ) -> ContextDependency:
        """Stages: acc-tree-stats + cluster-phones + build-tree."""
        stats = None
        for u, ali in mono_alignments.items():
            if u not in feats:
                continue
            phones, pdf_classes = \
                mono_trans_model.alignment_to_phone_pdfclass(ali)
            n = min(len(phones), len(feats[u]))
            stats = stats_from_alignment(
                feats[u][:n], phones[:n], pdf_classes[:n], stats
            )
        phones = [self.lang.phones.id(p)
                  for p in self.lang.lexicon.phone_set()]
        pdf_classes_per_phone = {
            ph: self.topo.entry(ph).num_pdf_classes for ph in phones
        }
        self.tree = build_tree(
            stats, phones, pdf_classes_per_phone,
            max_leaves=self.opts.num_leaves,
            min_gain=self.opts.tree_min_gain,
        )
        self._tree_stats = stats
        logger.info("built tree with %d leaves", self.tree.num_pdfs)
        return self.tree

    def init_model(self) -> AmDiagGmm:
        """gmm-init-model: one gaussian per leaf from tree stats."""
        assert self.tree is not None
        dim = next(iter(self._tree_stats.values())).sum.shape[0]
        P = self.tree.num_pdfs
        counts = np.zeros(P)
        sums = np.zeros((P, dim))
        sqs = np.zeros((P, dim))
        for (window, pc), s in self._tree_stats.items():
            pdf = self.tree.compute(window, pc)
            counts[pdf] += s.count
            sums[pdf] += s.sum
            sqs[pdf] += s.sumsq
        glob_mean = sums.sum(0) / max(counts.sum(), 1.0)
        glob_var = sqs.sum(0) / max(counts.sum(), 1.0) - glob_mean ** 2
        means = np.where(counts[:, None] > 0,
                         sums / np.maximum(counts[:, None], 1.0),
                         glob_mean)
        varis = np.where(
            counts[:, None] > 0,
            np.maximum(sqs / np.maximum(counts[:, None], 1.0)
                       - means ** 2, 1e-3),
            glob_var + 1e-3,
        )
        return AmDiagGmm(
            weights=np.ones((P, 1), np.float32),
            means=means[:, None, :].astype(np.float32),
            vars=varis[:, None, :].astype(np.float32),
        )

    def make_transition_model(self) -> TransitionModel:
        """Enumerate triples over all windows seen so far."""
        triples = triples_from_tree(self.topo, self.tree, self.windows)
        self.trans_model = TransitionModel(self.topo, triples=triples)
        return self.trans_model

    def train(
        self,
        feats: Dict[str, np.ndarray],
        transcripts: Dict[str, List[str]],
        mono_trans_model: TransitionModel,
        mono_alignments: Dict[str, np.ndarray],
    ) -> Tuple[AmDiagGmm, TransitionModel]:
        opts = self.opts
        utts = [u for u in feats if u in transcripts]
        self.build_tree_from_alignments(
            feats, mono_trans_model, mono_alignments
        )
        compiler = CdGraphCompiler(self.lang, self.windows)
        clgs = {u: compiler.compile_clg(transcripts[u]) for u in utts}
        tm = self.make_transition_model()
        graphs = {u: expand_hmm_cd(clgs[u], tm, self.windows, self.tree)
                  for u in utts}
        self._tid_pdf_lut = tm.alignment_to_pdfs(
            np.arange(tm.num_transition_ids + 1)
        )

        am = self.init_model()
        alignments = self._align_all(am, graphs, feats, utts)
        am = self._reestimate(am, tm, feats, alignments, utts)

        realign = {int(i) for i in opts.realign_iters.split()}
        cur_gauss = self.tree.num_pdfs
        inc = max(1, (opts.totgauss - cur_gauss)
                  // max(opts.max_iter_inc, 1))
        for it in range(1, opts.num_iters):
            if it in realign:
                alignments = self._align_all(am, graphs, feats, utts)
            if it <= opts.max_iter_inc and cur_gauss < opts.totgauss:
                cur_gauss = min(cur_gauss + inc, opts.totgauss)
                am = split_gaussians(am, cur_gauss, self._last_occ,
                                     seed=it)
            am = self._reestimate(am, tm, feats, alignments, utts)
            # per-iteration progress line (train_deltas.sh "Pass N")
            logger.info("iter %d/%d: %d gauss%s", it,
                        opts.num_iters - 1, cur_gauss,
                        ", realigned (avg ll/frame %.3f)"
                        % self._last_align_ll
                        if it in realign else "")
        self._final_alignments = alignments
        return am, tm

    def _align_all(self, am, graphs, feats, utts):
        """Batched realignment (see MonophoneTrainer._align_all)."""
        from kaldi_aslp_tpu.decoder.viterbi import align_batched
        from kaldi_aslp_tpu.gmm.diag_gmm import corpus_loglikes
        packed = am.pack()
        lls = corpus_loglikes(feats, utts, packed)
        pgs = {u: PackedGraph.from_fst(graphs[u]) for u in utts}
        res = align_batched(pgs, self._tid_pdf_lut, lls,
                            acoustic_scale=1.0)
        nfr = sum(len(lls[u]) for u in utts)
        self._last_align_ll = (sum(res[u][2] for u in utts)
                               / max(nfr, 1))
        return {u: res[u][1] for u in utts}

    def _reestimate(self, am, tm, feats, alignments, utts):
        stats = GmmStats(am)
        packed = am.pack()
        tcounts = None
        all_f, all_p = [], []
        for u in utts:
            pdfs = tm.alignment_to_pdfs(alignments[u])
            n = min(len(pdfs), len(feats[u]))
            all_f.append(feats[u][:n])
            all_p.append(pdfs[:n])
            tcounts = tm.accumulate(alignments[u], tcounts)
        F = np.concatenate(all_f).astype(np.float32)
        Pids = np.concatenate(all_p).astype(np.int32)
        bucket = 16384
        padded = int(np.ceil(max(len(F), 1) / bucket)) * bucket
        wts = np.zeros(padded, np.float32)
        wts[:len(F)] = 1.0
        Fp = np.zeros((padded, F.shape[1]), np.float32)
        Fp[:len(F)] = F
        Pp = np.zeros(padded, np.int32)
        Pp[:len(F)] = Pids
        stats.accumulate(packed, Fp, Pp, wts)
        occ, mean_acc, var_acc = stats.to_numpy()
        self._last_occ = occ
        tm.mle_update(tcounts)
        return mle_update(
            am, occ, mean_acc, var_acc,
            min_gaussian_occupancy=self.opts.min_gaussian_occupancy,
        )


def make_cd_decode_graph(lang: Lang, G: Fst, trainer: DeltasTrainer,
                         sil_prob: float = 0.5, optimize: bool = True):
    """CD HCLG: det+min(L∘G) → C → H (reference: mkgraph.sh triphone
    path — fsttablecompose | fstdeterminizestar | fstminimizeencoded
    before fstcomposecontext).

    Two round-5 fixes from the tri-inversion diagnosis (a 0-split
    control tree decoded WORSE than the equivalent monophone system):
      * LG is determinized+minimized like the monophone path
        (make_decode_graph) — the raw compose carries duplicate-path
        states that eat frontier budget at a fixed max_active;
      * the freshly re-enumerated transition model COPIES the trained
        MLE transition probs from the training model instead of
        silently reverting to topology priors."""
    trained_tm = trainer.trans_model
    L = make_lexicon_fst(lang, sil_prob=sil_prob).arc_sort("olabel")
    lg = L.compose(G)
    if optimize:
        from kaldi_aslp_tpu.fst.determinize import (
            determinize,
            minimize_encoded,
        )
        try:
            lg = minimize_encoded(determinize(lg.remove_epsilon()))
        except RuntimeError:
            pass  # non-determinizable G (rare): keep the raw compose
    clg, _ = compose_context_shared(lg, trainer.windows)
    tm = trainer.make_transition_model()
    if trained_tm is not None:
        tm.copy_log_probs_from(trained_tm)
    return expand_hmm_cd(clg, tm, trainer.windows, trainer.tree), tm
