"""Lexicon (L) and grammar (G) construction.

JAX-native equivalents of the reference lang-prep chain (reference:
egs/wsj/s5/utils/prepare_lang.sh + make_lexicon_fst.pl for L,
src/lmbin/arpa2fst for G).  Host-side; outputs our Fst type."""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from kaldi_aslp_tpu.fst.fst import EPS, Arc, Fst, SymbolTable


@dataclass
class Lexicon:
    """word → list of pronunciations (phone string lists)."""

    prons: Dict[str, List[List[str]]] = field(default_factory=dict)
    sil_phone: str = "SIL"

    @classmethod
    def from_text(cls, text: str, sil_phone: str = "SIL") -> "Lexicon":
        """Parse lexicon.txt lines: WORD ph1 ph2 ..."""
        lex = cls(sil_phone=sil_phone)
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            lex.prons.setdefault(parts[0], []).append(parts[1:])
        return lex

    def phone_set(self) -> List[str]:
        phones = {self.sil_phone}
        for prons in self.prons.values():
            for p in prons:
                phones.update(p)
        return sorted(phones)


@dataclass
class Lang:
    """The lang-dir equivalent: symbol tables + L (reference: data/lang)."""

    phones: SymbolTable
    words: SymbolTable
    lexicon: Lexicon
    sil_phone_id: int

    @classmethod
    def build(cls, lexicon: Lexicon) -> "Lang":
        phones = SymbolTable()
        for p in lexicon.phone_set():
            phones.add(p)
        words = SymbolTable()
        for w in sorted(lexicon.prons):
            words.add(w)
        return cls(phones, words, lexicon, phones.id(lexicon.sil_phone))


def make_lexicon_fst(lang: Lang, sil_prob: float = 0.5) -> Fst:
    """L: phone→word transducer with optional silence
    (reference: utils/make_lexicon_fst.pl)."""
    L = Fst()
    start = L.add_state()
    loop = L.add_state()
    L.set_start(start)
    L.set_final(loop)
    no_sil_cost = -math.log(max(1.0 - sil_prob, 1e-10))
    sil_cost = -math.log(max(sil_prob, 1e-10))
    sil = lang.sil_phone_id

    def sil_or_loop(src: int) -> None:
        """From src: go to loop directly (no sil) or via silence."""
        L.add_arc(src, Arc(EPS, EPS, no_sil_cost, loop))
        mid = L.add_state()
        L.add_arc(src, Arc(sil, EPS, sil_cost, mid))
        L.add_arc(mid, Arc(EPS, EPS, 0.0, loop))

    sil_or_loop(start)
    for word, prons in lang.lexicon.prons.items():
        wid = lang.words.id(word)
        for pron in prons:
            if not pron:
                continue
            cur = loop
            for i, ph in enumerate(pron):
                nxt = L.add_state()
                L.add_arc(cur, Arc(lang.phones.id(ph),
                                   wid if i == 0 else EPS, 0.0, nxt))
                cur = nxt
            sil_or_loop(cur)
    return L


def make_unigram_grammar(word_probs: Dict[str, float],
                         words: SymbolTable) -> Fst:
    """G: unigram loop acceptor (the yesno task.arpabo equivalent)."""
    G = Fst()
    s = G.add_state()
    G.set_start(s)
    G.set_final(s)
    for w, p in word_probs.items():
        G.add_arc(s, Arc(words.id(w), words.id(w),
                         -math.log(max(p, 1e-10)), s))
    return G


def make_linear_acceptor(word_ids: Sequence[int]) -> Fst:
    """Transcript acceptor for training-graph compilation
    (reference: compile-train-graphs.cc MakeLinearAcceptor)."""
    return Fst.linear([(w, w) for w in word_ids])


# ---------------------------------------------------------------------------
# ARPA language models (reference: src/lm/arpa-file-parser.cc, arpa2fst)
# ---------------------------------------------------------------------------

LOG10 = math.log(10.0)


def parse_arpa(text: str):
    """Parse an ARPA LM into {order: {ngram_tuple: (logp, backoff)}}
    (log10 scores as stored)."""
    grams: Dict[int, Dict[Tuple[str, ...], Tuple[float, float]]] = {}
    order = 0
    section = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("\\data"):
            section = "data"
            continue
        if line.startswith("\\end"):
            break
        if line.startswith("\\") and "-grams:" in line:
            order = int(line[1:line.index("-")])
            grams[order] = {}
            section = "grams"
            continue
        if section == "grams" and order > 0:
            parts = line.split()
            logp = float(parts[0])
            ngram = tuple(parts[1:1 + order])
            backoff = (float(parts[1 + order])
                       if len(parts) > 1 + order else 0.0)
            grams[order][ngram] = (logp, backoff)
    return grams


def arpa_to_fst(text: str, words: SymbolTable,
                bos: str = "<s>", eos: str = "</s>",
                unk: str = "<unk>") -> Fst:
    """Backoff n-gram acceptor (reference: arpa2fst).

    States = n-gram histories; backoff via epsilon arcs; <s>/</s> are
    not emitted as symbols (start state = <s> history, </s> folds into
    final weights)."""
    grams = parse_arpa(text)
    max_order = max(grams)
    G = Fst()
    state_of: Dict[Tuple[str, ...], int] = {}

    def get_state(hist: Tuple[str, ...]) -> int:
        while hist and hist not in state_of and not _hist_known(hist):
            hist = hist[1:]
        if hist not in state_of:
            state_of[hist] = G.add_state()
        return state_of[hist]

    def _hist_known(hist: Tuple[str, ...]) -> bool:
        return len(hist) in grams and hist in grams[len(hist)]

    start = get_state((bos,) if max_order > 1 else ())
    G.set_start(start)
    backoff_added = set()

    for order in sorted(grams):
        for ngram, (logp, backoff) in grams[order].items():
            hist, word = ngram[:-1], ngram[-1]
            cost = -logp * LOG10
            src = get_state(hist)
            if word == eos:
                G.set_final(src, cost)
                continue
            if word == bos:
                # <s> is never emitted, but its history state still backs
                # off to the unigram state (reference: arpa2fst)
                if order == 1 and max_order > 1:
                    bo_src = get_state((bos,))
                    bo_dst = get_state(())
                    if bo_src != bo_dst and bo_src not in backoff_added:
                        backoff_added.add(bo_src)
                        G.add_arc(bo_src, Arc(EPS, EPS, -backoff * LOG10,
                                              bo_dst))
                continue
            if word not in words:
                if word == unk:
                    continue
                words.add(word)
            new_hist = (ngram if order < max_order else ngram[1:])
            dst = get_state(new_hist)
            wid = words.id(word)
            G.add_arc(src, Arc(wid, wid, cost, dst))
            # backoff arc from the n-gram's own history state (once)
            if new_hist and order < max_order:
                bo_src = get_state(new_hist)
                bo_dst = get_state(new_hist[1:])
                if bo_src != bo_dst and bo_src not in backoff_added:
                    backoff_added.add(bo_src)
                    G.add_arc(bo_src, Arc(EPS, EPS, -backoff * LOG10,
                                          bo_dst))
    return G.connect()
