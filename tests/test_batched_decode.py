"""Batched decoder tests."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.fst import Lang, Lexicon, make_unigram_grammar
from kaldi_aslp_tpu.fst.ctc_graph import ctc_lut, make_ctc_decode_graph
from kaldi_aslp_tpu.decoder import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu.decoder.batched import BatchedViterbiDecoder
from kaldi_aslp_tpu.models import Nnet


def _setup():
    lex = Lexicon.from_text("YES Y\nNO N\n<SIL> SIL\n")
    lang = Lang.build(lex)
    G = make_unigram_grammar({"YES": 0.5, "NO": 0.5}, lang.words)
    tlg = make_ctc_decode_graph(lang, G)
    return lang, PackedGraph.from_fst(tlg), ctc_lut(len(lang.phones))


def test_batched_matches_single(rng):
    lang, packed, lut = _setup()
    y, n = lang.phones.id("Y"), lang.phones.id("N")
    V = len(lang.phones)
    utts = []
    for i in range(5):
        seq = [0] + [y if rng.rand() < 0.5 else n] * (2 + i) + [0, 0]
        ll = np.full((len(seq), V), np.log(0.02), np.float32)
        for t, s in enumerate(seq):
            ll[t, s] = np.log(0.9)
        utts.append(ll)
    single = ViterbiDecoder(packed, lut, acoustic_scale=1.0)
    batched = BatchedViterbiDecoder(packed, lut, acoustic_scale=1.0)
    got = batched.decode_batch(utts, bucket=16)
    for ll, (words_b, ali_b, score_b) in zip(utts, got):
        words_s, ali_s, score_s = single.decode(ll)
        assert words_b == words_s
        np.testing.assert_array_equal(ali_b, ali_s)
        assert score_b == pytest.approx(score_s, rel=1e-5)

