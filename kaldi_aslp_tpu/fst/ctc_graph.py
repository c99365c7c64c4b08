"""CTC decoding graphs: blank-loop token transducer over L∘G.

JAX-native equivalent of the reference's Eesen-style CTC graph chain
(reference: src/aslp-bin/aslp-make-ctc-transducer.cc:36-120
MakeCtcLoopFst — an H transducer where each phone token requires one or
more consecutive frames of that token with optional surrounding blanks
and a blank self-loop state; aslp_scripts/ctc/make_ctc_graph.sh:56-80).

Output-graph arc ilabels are "ctc-ids": ctc_id = output_index + 1 so 0
stays epsilon; output_index 0 is the blank.  A LUT maps ctc-ids to
posterior columns for the Viterbi decoder."""

from __future__ import annotations

import numpy as np

from kaldi_aslp_tpu.fst.fst import EPS, Arc, Fst
from kaldi_aslp_tpu.fst.lang import Lang, make_lexicon_fst


def ctc_id_of_output(output_index: int) -> int:
    return output_index + 1


def ctc_lut(num_outputs: int) -> np.ndarray:
    """tid→posterior-column LUT for ViterbiDecoder (index 0 unused)."""
    lut = np.zeros(num_outputs + 1, np.int32)
    lut[1:] = np.arange(num_outputs)
    return lut


def expand_ctc(lg: Fst, phone_to_output) -> Fst:
    """Replace each phone arc of LG with the CTC token structure:

        junction --(blank*)--> [tok]+ --> next junction

    Every junction has a blank self-loop and each phone arc becomes a
    token state (self-loop = token repetition).  A token exit leading
    to a SAME-symbol token must pass through at least one blank
    (reference: aslp-make-ctc-transducer.cc MakeCtcLoopFst — otherwise
    two frames of the same unit could read as two tokens).  The exit
    therefore lands on a per-(junction, symbol) state whose entries
    skip that symbol, with a blank arc back to the full junction.

    phone_to_output: phone symbol id → CTC output index (blank=0)."""
    out = Fst()
    state_map = [out.add_state() for _ in range(lg.num_states)]
    out.set_start(state_map[lg.start])
    blank = ctc_id_of_output(0)
    for s, w in lg.finals.items():
        out.set_final(state_map[s], w)

    # first pass: create token states + entry specs per junction
    entries = {s: [] for s in range(lg.num_states)}
    # (tok_id, olabel, weight, tok_state, next_lg_state)
    for s in range(lg.num_states):
        for arc in lg.arcs[s]:
            if arc.ilabel == EPS:
                out.add_arc(state_map[s],
                            Arc(EPS, arc.olabel, arc.weight,
                                state_map[arc.nextstate]))
                continue
            tok = ctc_id_of_output(phone_to_output(arc.ilabel))
            tok_state = out.add_state()
            entries[s].append((tok, arc.olabel, arc.weight, tok_state))
            # token repetition
            out.add_arc(tok_state, Arc(tok, EPS, 0.0, tok_state))
            # exit handled in second pass (needs dest's entry specs)
            arc._tok_state = tok_state  # type: ignore[attr-defined]

    post_states = {}  # (lg_state, tok) → restricted-entry state

    def get_post(s, tok_sym):
        key = (s, tok_sym)
        if key not in post_states:
            ps = out.add_state()
            post_states[key] = ps
            # blank returns to the full junction
            out.add_arc(ps, Arc(blank, EPS, 0.0, state_map[s]))
            # direct entries to different-symbol tokens
            for (tok, ol, w, ts) in entries[s]:
                if tok != tok_sym:
                    out.add_arc(ps, Arc(tok, ol, w, ts))
            # eps pass-through arcs of the junction still apply
            for arc in lg.arcs[s]:
                if arc.ilabel == EPS:
                    out.add_arc(ps, Arc(EPS, arc.olabel, arc.weight,
                                        state_map[arc.nextstate]))
            if s in lg.finals:
                out.set_final(ps, lg.finals[s])
        return post_states[key]

    # second pass: junction blank loops, token entries and exits
    for s in range(lg.num_states):
        out.add_arc(state_map[s], Arc(blank, EPS, 0.0, state_map[s]))
        for (tok, ol, w, ts) in entries[s]:
            out.add_arc(state_map[s], Arc(tok, ol, w, ts))
        for arc in lg.arcs[s]:
            if arc.ilabel == EPS:
                continue
            tok = ctc_id_of_output(phone_to_output(arc.ilabel))
            ts = arc._tok_state  # type: ignore[attr-defined]
            out.add_arc(ts, Arc(EPS, EPS, 0.0,
                                get_post(arc.nextstate, tok)))
    return out.connect()


def make_ctc_decode_graph(lang: Lang, G: Fst,
                          phone_to_output=None,
                          sil_prob: float = 0.0) -> Fst:
    """TLG (reference: make_ctc_graph.sh): L∘G then CTC token expansion.

    Default phone→output mapping follows the ASLP convention
    (aslp-ali-minus-one): output_index = phone_id (phones are 1-based,
    blank takes index 0)."""
    if phone_to_output is None:
        phone_to_output = lambda ph: ph
    L = make_lexicon_fst(lang, sil_prob=sil_prob).arc_sort("olabel") \
        if sil_prob > 0 else make_lexicon_fst(lang, sil_prob=1e-7
                                              ).arc_sort("olabel")
    # det+min LG keeps blank routing deterministic in the expanded
    # graph: each labeling then has a unique path, which sum-based
    # lattice/MBR posteriors require (Viterbi alone wouldn't care)
    from kaldi_aslp_tpu.fst.determinize import (
        determinize,
        minimize_encoded,
    )
    lg = L.compose(G).remove_epsilon()
    try:
        lg = minimize_encoded(determinize(lg))
    except RuntimeError:
        pass
    return expand_ctc(lg, phone_to_output)
