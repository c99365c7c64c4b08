"""Decoding/alignment graph compilation: H expansion of L∘G.

JAX-native equivalent of the reference graph chain (reference:
utils/mkgraph.sh — L∘G composition then make-h-transducer +
add-self-loops; src/decoder/training-graph-compiler.{h,cc} for per-utt
graphs; src/aslp-bin/aslp-make-ctc-transducer.cc:36-120 for the CTC "H"
with a blank self-loop state).

Monophone C is the identity, so HCLG = H(L∘G): every phone arc of LG is
expanded in place into its topology's emitting-state chain, arcs labeled
with transition-ids (ilabel) and words (olabel), self-loops included
(no separate add-self-loops pass needed).  Costs are -log probs."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_aslp_tpu.fst.fst import EPS, Arc, Fst
from kaldi_aslp_tpu.fst.lang import Lang, make_lexicon_fst, make_linear_acceptor
from kaldi_aslp_tpu.hmm.transition_model import TransitionModel


def expand_hmm(lg: Fst, trans_model: TransitionModel) -> Fst:
    """Replace each phone-labeled arc of LG by its HMM state graph.

    Result ilabels are transition-ids (0 = eps); olabels pass through."""
    out = Fst()
    state_map = [out.add_state() for _ in range(lg.num_states)]
    out.set_start(state_map[lg.start])
    for s, w in lg.finals.items():
        out.set_final(state_map[s], w)

    for s in range(lg.num_states):
        for arc in lg.arcs[s]:
            if arc.ilabel == EPS:
                out.add_arc(state_map[s],
                            Arc(EPS, arc.olabel, arc.weight,
                                state_map[arc.nextstate]))
                continue
            phone = arc.ilabel
            entry = trans_model.topo.entry(phone)
            n_emit = entry.num_emitting
            # internal states for emitting topology states
            internal = [out.add_state() for _ in range(n_emit)]

            def dest_state(topo_dest: int) -> int:
                if topo_dest < n_emit:
                    return internal[topo_dest]
                return state_map[arc.nextstate]  # final topo state

            # entry arc carries the word label + LM weight (eps input)
            out.add_arc(state_map[s],
                        Arc(EPS, arc.olabel, arc.weight, internal[0]))
            for i in range(n_emit):
                ts = trans_model.transition_state_of(phone, i)
                for ai, (dest, _p) in enumerate(trans_model.arcs_of(ts)):
                    tid = trans_model.pair_to_tid(ts, ai)
                    cost = -float(trans_model.log_probs[tid])
                    out.add_arc(internal[i],
                                Arc(tid, EPS, cost, dest_state(dest)))
    return out.connect()


def make_decode_graph(lang: Lang, G: Fst,
                      trans_model: TransitionModel,
                      sil_prob: float = 0.5,
                      optimize: bool = True) -> Fst:
    """HCLG (reference: utils/mkgraph.sh — fsttablecompose |
    fstdeterminizestar | fstminimizeencoded before H expansion)."""
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
    return expand_hmm(lg, trans_model)


def expand_hmm_cd(clg: Fst, trans_model: TransitionModel,
                  windows, tree) -> Fst:
    """H expansion for context-dependent graphs: CLG arcs carry context
    window ids; pdfs come from the decision tree
    (reference: make-h-transducer on the CLG side of mkgraph.sh).

    windows: ContextWindows table from compose_context; tree:
    ContextDependency."""
    out = Fst()
    state_map = [out.add_state() for _ in range(clg.num_states)]
    out.set_start(state_map[clg.start])
    for s, w in clg.finals.items():
        out.set_final(state_map[s], w)
    central = tree.central_position
    for s in range(clg.num_states):
        for arc in clg.arcs[s]:
            if arc.ilabel == EPS:
                out.add_arc(state_map[s],
                            Arc(EPS, arc.olabel, arc.weight,
                                state_map[arc.nextstate]))
                continue
            window = windows.window(arc.ilabel)
            phone = window[central]
            entry = trans_model.topo.entry(phone)
            n_emit = entry.num_emitting
            internal = [out.add_state() for _ in range(n_emit)]

            def dest_state(topo_dest: int) -> int:
                if topo_dest < n_emit:
                    return internal[topo_dest]
                return state_map[arc.nextstate]

            out.add_arc(state_map[s],
                        Arc(EPS, arc.olabel, arc.weight, internal[0]))
            for i in range(n_emit):
                pdf = tree.compute(window, entry.states[i].pdf_class)
                ts = trans_model.transition_state(phone, i, pdf)
                for ai, (dest, _p) in enumerate(trans_model.arcs_of(ts)):
                    tid = trans_model.pair_to_tid(ts, ai)
                    cost = -float(trans_model.log_probs[tid])
                    out.add_arc(internal[i],
                                Arc(tid, EPS, cost, dest_state(dest)))
    return out.connect()


def triples_from_tree(topo, tree, windows) -> list:
    """Enumerate (phone, hmm_state, pdf) triples the tree produces over
    the given context windows (reference: transition-model.cc
    ComputeTriples via GetPdfInfo)."""
    triples = set()
    central = tree.central_position
    for window in windows.all_windows():
        phone = window[central]
        entry = topo.entry(phone)
        for hmm_state, st in enumerate(entry.states):
            if st.pdf_class < 0:
                continue
            triples.add(
                (phone, hmm_state, tree.compute(window, st.pdf_class))
            )
    return sorted(triples)


class TrainingGraphCompiler:
    """Per-utterance alignment graphs (reference:
    src/decoder/training-graph-compiler.h).

    Caches L; compiles transcript → H(L∘linear(words))."""

    def __init__(self, lang: Lang, trans_model: TransitionModel,
                 sil_prob: float = 0.5):
        self.lang = lang
        self.trans_model = trans_model
        self.L = make_lexicon_fst(lang, sil_prob=sil_prob
                                  ).arc_sort("olabel")
        self._cache: Dict[Tuple[int, ...], Fst] = {}

    def compile(self, words: Sequence[str]) -> Fst:
        wids = tuple(self.lang.words.id(w) for w in words)
        if wids not in self._cache:
            acc = make_linear_acceptor(wids)
            lg = self.L.compose(acc)
            self._cache[wids] = expand_hmm(lg, self.trans_model)
        return self._cache[wids]
