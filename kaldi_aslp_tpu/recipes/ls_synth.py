"""LibriSpeech-shaped synthetic recipe: the egs/librispeech/s5 chain
shape at reduced scale on synthesized audio, with the flagship
BLSTM-CTC acoustic model and beam-lattice decoding.

The real LibriSpeech corpus is unobtainable here (no network), so this
follows the published protocol SHAPE (reference: egs/librispeech/s5 —
fbank front end for the NN stage, lattice decode with a small LM, then
lattice LM rescoring with a bigger LM, RESULTS:17/40 "fglarge"
rescoring rows; the ASLP CTC chain aslp_scripts/ctc/ provides the
phone-CTC variant): a 1000-word vocabulary over 25 phones, a bigram
decode LM estimated from a 10x external text pool (the protocol trains
decode LMs on text far larger than the transcripts; see the LM comment
in run()), a "large" LM from a 40x pool for rescoring, formant-
synthesized audio, the 3x640 BLSTMP CTC flagship (bf16 matmuls on the
GPU), TLG beam-lattice decoding with an LMWT sweep
(score_basic.sh role) and lattice-lmrescore with the large LM.

Run: python -m kaldi_aslp_tpu.recipes.ls_synth [workdir] [--small]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.log import get_logger
from kaldi_aslp_tpu.feats import (
    Fbank,
    FrameExtractionOptions,
    MelBanksOptions,
    acc_cmvn_stats,

)
from kaldi_aslp_tpu.fst import Lang, Lexicon
from kaldi_aslp_tpu.fst.lang import arpa_to_fst
from kaldi_aslp_tpu.fst.ctc_graph import ctc_lut, make_ctc_decode_graph
from kaldi_aslp_tpu.decoder import PackedGraph
from kaldi_aslp_tpu.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu.decoder.lattice import score_lmwt_sweep
from kaldi_aslp_tpu.models import Nnet
from kaldi_aslp_tpu.models.recurrent import BLstmProjectedStreams
from kaldi_aslp_tpu.models.simple import AffineTransform
from kaldi_aslp_tpu.train import (
    CtcTrainer,
    NewbobOptions,
    NewbobScheduler,
    NnetTrainOptions,
    init_velocity,
)
from kaldi_aslp_tpu.data.sequence import CtcBatcher, CtcBatcherOptions
from kaldi_aslp_tpu.ops.edit_distance import score_utterances
from kaldi_aslp_tpu.recipes.rm_synth import (
    PHONES,
    SAMP_FREQ,
    bigram_arpa,
    make_lexicon,
    make_sentences,
    synthesize,
)

logger = get_logger("ls_synth")

BUCKET_T = 192  # one XLA shape: utterances < 5.1 s at the 30ms LFR rate


def extract_fbank(waves: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """40-dim fbank + global CMVN (the NN front end of the reference
    chain, make_feats.sh fbank variant).  Batched extraction: one
    device program per length bucket instead of two ~50 ms round trips
    per utterance (feats/batch.py), and the global CMVN subtract runs
    on host."""
    from kaldi_aslp_tpu.feats.batch import compute_batched

    fbank = Fbank(FrameExtractionOptions(samp_freq=SAMP_FREQ, dither=0.0),
                  MelBanksOptions(num_bins=40))
    raw = compute_batched(fbank, waves)
    stats = None
    for u in sorted(raw):
        stats = acc_cmvn_stats(raw[u], stats)
    dim = stats.shape[1] - 1
    mean = (stats[0, :dim] / stats[0, dim]).astype(np.float32)
    return {u: f - mean for u, f in raw.items()}


def phone_labels(lang: Lang, words: List[str]) -> np.ndarray:
    seq = []
    for w in words:
        for p in lang.lexicon.prons[w][0]:
            seq.append(lang.phones.id(p))
    return np.asarray(seq, np.int32)


def run(root: str = "exp_ls_synth", num_words: int = 1000,
        num_train: int = 1200, num_test: int = 100,
        layers: int = 3, proj: int = 320, cell: int = 512,
        num_streams: int = 64, max_iters: int = 48,
        rescore_text_mult: int = 40, lm_text_mult: int = 10,
        bucket_t: int = BUCKET_T,
        max_len: int = 8, lattice_beam: float = 8.0,
        learn_rate: float = 0.01, lfr_skip: int = 3,
        keep_lr: int = 4, bf16=None):
    """``bf16``: bf16 matmuls in the BLSTMP layers (and bf16 feature
    transport, numerically free for such a model); default on the GPU."""
    os.makedirs(root, exist_ok=True)
    t_start = time.time()
    if bf16 is None:
        bf16 = jax.default_backend() == "gpu"

    # ---- data prep (data/prepare stage) ----
    lex = Lexicon.from_text(make_lexicon(num_words))
    lang = Lang.build(lex)
    words = sorted(w for w in lex.prons if w != "<SIL>")
    train_sents = make_sentences(words, num_train, seed=11, max_len=max_len)
    test_sents = make_sentences(words, num_test, seed=99, max_len=max_len)
    logger.info("%d words, %d train / %d test sentences",
                len(words), len(train_sents), len(test_sents))
    train_waves = synthesize(lex, train_sents, seed=3)
    test_waves = synthesize(lex, test_sents, seed=4)
    train_feats = extract_fbank(train_waves)
    test_feats = extract_fbank(test_waves)
    dim = next(iter(train_feats.values())).shape[1]
    tot_audio = sum(len(w) for w in train_waves.values()) / SAMP_FREQ
    logger.info("features ready: %d-dim fbank, %.0f s train audio "
                "(%.0fs elapsed)", dim, tot_audio, time.time() - t_start)

    # ---- LMs.  The reference protocol estimates decode LMs from
    # EXTERNAL text far larger than the acoustic transcripts
    # (egs/librispeech: 800M-word corpus vs 960h of transcripts); the
    # synthetic analogue samples more text from the same word-pair
    # grammar.  Measured: a decode bigram from the 1200 transcripts
    # alone leaves most of the grammar's successor pairs unseen and the
    # oracle (ideal-posterior) WER is ~58%; from a 10x pool it is 0%. ----
    lm_text = make_sentences(words, lm_text_mult * num_train,
                             seed=7, max_len=max_len)
    arpa_small = bigram_arpa(lm_text, words)
    big_text = make_sentences(words, rescore_text_mult * num_train,
                              seed=123, max_len=max_len)
    arpa_large = bigram_arpa(big_text, words)
    G_small = arpa_to_fst(arpa_small, lang.words)
    G_large = arpa_to_fst(arpa_large, lang.words)

    # ---- flagship BLSTMP-CTC model ----
    V = len(lang.phones) + 1  # blank=0 + phone ids 1..N
    net = Nnet()
    d = dim
    for _ in range(layers):
        net.add(BLstmProjectedStreams(d, 2 * proj, cell_dim=cell,
                                      bf16=bf16))
        d = 2 * proj
    net.add(AffineTransform(d, V, param_stddev=0.04, bias_mean=0.0,
                            bias_range=0.0))
    params = net.init(jax.random.PRNGKey(777))
    velocity = init_velocity(params)
    # the device epoch cache replays the (fixed) batch set at device
    # speed from epoch 2
    trainer = CtcTrainer(net, NnetTrainOptions(momentum=0.9),
                         transport="bf16" if bf16 else "f32")
    cache = trainer.make_cache()
    sched = NewbobScheduler(
        os.path.join(root, "train"),
        initial_lr=learn_rate,
        opts=NewbobOptions(max_iters=max_iters, keep_lr_iters=keep_lr),
    )

    utts = sorted(train_feats)
    # CV pool must fill at least one full stream batch
    cv_utts = utts[: max(num_streams, len(utts) // 20)]
    tr_utts = utts[len(cv_utts):]
    bopts = CtcBatcherOptions(num_streams=num_streams,
                              frame_limit=10 ** 9,
                              bucket_time=bucket_t, bucket_labels=64,
                              skip_width=lfr_skip,
                              drop_len=bucket_t * lfr_skip, sort_by_length=False)

    def batches(utt_list):
        src = ((u, train_feats[u], phone_labels(lang, train_sents[
            int(u[3:])])) for u in utt_list)
        out = []
        for b in CtcBatcher(src, bopts):
            if len(b.keys) == num_streams:   # keep ONE compiled shape
                out.append(b)
        return out

    tr_batches = batches(tr_utts)
    cv_batches = batches(cv_utts)
    logger.info("%d train / %d cv batches of %d streams x %d frames",
                len(tr_batches), len(cv_batches), num_streams, bucket_t)

    best = params
    frames_done = 0
    t_train = time.time()
    while not sched.done:
        params, velocity, rep = trainer.train_epoch(
            best, velocity, iter(tr_batches), sched.learn_rate,
            cache=cache)
        cv = trainer.evaluate(params, cv_batches)
        accepted = sched.report(cv.avg_loss)
        frames_done += sum(int(b.input_lengths.sum())
                           for b in tr_batches)
        logger.info("iter %d lr %.5f tr %.4f cv %.4f %s",
                    sched.state.iter, sched.learn_rate, rep.avg_loss,
                    cv.avg_loss, "ACCEPT" if accepted else "REJECT")
        if accepted:
            best = params
    train_s = time.time() - t_train
    train_speed = frames_done * 0.01 / max(train_s, 1e-9)
    logger.info("training: %.0f audio-s in %.0f s wall "
                "(%.0f audio-s/s incl. pipeline + CV + newbob)",
                frames_done * 0.01, train_s, train_speed)

    # ---- decode: TLG beam lattices + LMWT sweep + fglarge rescore ----
    tlg = make_ctc_decode_graph(lang, G_small)
    packed = PackedGraph.from_fst(tlg)
    logger.info("TLG: %d states %d arcs", tlg.num_states, tlg.num_arcs)
    dec = BeamSearchDecoder(CsrGraph.from_packed(packed), ctc_lut(V),
                            acoustic_scale=1.0, beam=14.0,
                            max_active=2048, chunk=128)

    @jax.jit
    def forward(p, feats, mask):
        y, _ = net.apply(p, feats, mask=mask)
        return jax.nn.log_softmax(y, axis=-1)

    def posteriors(feats):
        feats = feats[::lfr_skip]   # low frame rate, as in training
        T = len(feats)
        pad = bucket_t - T
        f = np.pad(feats, ((0, pad), (0, 0)))[None]
        m = np.zeros((1, bucket_t), np.float32)
        m[0, :T] = 1.0
        y = forward(best, jnp.asarray(f), jnp.asarray(m))
        return np.asarray(y[0][:T])

    # Eesen prior division from a sample of training utterances
    acc = np.zeros(V, np.float64)
    n = 0
    for u in tr_utts[:100]:
        p = np.exp(posteriors(train_feats[u]))
        acc += p.sum(0)
        n += len(p)
    log_priors = np.log(np.maximum(acc / n, 1e-10)).astype(np.float32)

    refs = {f"utt{i:04d}": [lang.words.id(w) for w in s]
            for i, s in enumerate(test_sents)}
    refs_sym = {f"utt{i:04d}": s for i, s in enumerate(test_sents)}

    # greedy CTC phone error rate FIRST: model-quality signal before
    # the (lattice-size-sensitive) decode stage runs
    hyp_phones = {}
    ref_phones = {}
    for u in sorted(test_feats):
        ids = posteriors(test_feats[u]).argmax(-1)
        col = [int(x) for x in ids]
        dedup = [x for i, x in enumerate(col)
                 if x != 0 and (i == 0 or x != col[i - 1])]
        hyp_phones[u] = [str(x) for x in dedup]
        ref_phones[u] = [str(x) for x in
                         phone_labels(lang, refs_sym[u])]
    per_stats = score_utterances(ref_phones, hyp_phones)
    logger.info("greedy CTC PER %.2f%%", per_stats.wer)

    lats = {}
    t_dec = t_audio = 0.0
    for u in sorted(test_feats):
        ll = posteriors(test_feats[u]) - log_priors
        t0 = time.time()
        _, _, _, lat = dec.decode_lattice(ll, lattice_beam=lattice_beam)
        t_dec += time.time() - t0
        t_audio += len(test_feats[u]) * 0.01
        lats[u] = lat
    rtf = t_dec / t_audio
    # persist the lattices (reference: decode.sh writes lat.JOB.gz)
    from kaldi_aslp_tpu.decoder.compact import lattice_to_state
    from kaldi_aslp_tpu.io import lattice_writer
    with lattice_writer(
            f"ark:{os.path.join(root, 'lat.1.ark')}") as lw:
        for u in sorted(lats):
            lw[u] = lattice_to_state(lats[u])
    sweep = score_lmwt_sweep(lats, refs, lmwt_range=range(1, 16),
                             acoustic_scale_base=1.0)
    best_lmwt = min(sweep, key=lambda k: sweep[k].wer)
    wer_small = sweep[best_lmwt].wer
    logger.info("decode RTF %.3f; small-LM WER %.2f%% @LMWT %d",
                rtf, wer_small, best_lmwt)

    # fglarge role (reference: egs/librispeech lattice rescoring —
    # lattice-lmrescore with -1 x old G then +1 x new G): determinize
    # to word-sequence CompactLattices, swap LM scores, re-sweep
    from kaldi_aslp_tpu.decoder import (
        DeterminizeFailed,
        compact_lattice_best_path,
        compact_lattice_lmrescore,
        determinize_lattice_pruned,
    )

    wer_large = None
    best_big = None
    sweep_big: Dict[int, object] = {}
    # subset determinization is exponential in the worst case (badly
    # trained models emit near-uniform lattices); bound the work per
    # utterance (the reference's max_mem role) and keep the small-LM
    # hypothesis for the stragglers
    clats = {}
    skipped = []
    t_det = t_res = 0.0
    for ui, (u, lat) in enumerate(lats.items()):
        if ui % 10 == 0:
            logger.info("rescoring lattice %d/%d (det %.1fs res %.1fs)",
                        ui, len(lats), t_det, t_res)
        try:
            t0 = time.time()
            c = determinize_lattice_pruned(lat, prune=lattice_beam)
            t_det += time.time() - t0
            t0 = time.time()
            c = compact_lattice_lmrescore(c, G_small, lm_scale=-1.0)
            clats[u] = compact_lattice_lmrescore(c, G_large,
                                                 lm_scale=1.0)
            t_res += time.time() - t0
        except DeterminizeFailed:
            skipped.append(u)
    logger.info("rescore: determinize %.1fs, lmrescore %.1fs "
                "over %d lattices", t_det, t_res, len(lats))
    if skipped:
        logger.warning("rescore exceeded work budget on %d lattices",
                       len(skipped))
    from kaldi_aslp_tpu.decoder import lattice_best_path
    for lmwt in range(1, 16):
        hyps = {}
        for u, c in clats.items():
            w, _, _ = compact_lattice_best_path(
                c, lm_scale=1.0, acoustic_scale=1.0 / lmwt)
            hyps[u] = w
        for u in skipped:
            w, _ = lattice_best_path(
                lats[u], acoustic_scale=1.0 / lmwt, lm_scale=1.0)
            hyps[u] = w
        sweep_big[lmwt] = score_utterances(refs, hyps)
    best_big = min(sweep_big, key=lambda k: sweep_big[k].wer)
    wer_large = sweep_big[best_big].wer
    logger.info("large-LM rescored WER %.2f%% @LMWT %d",
                wer_large, best_big)

    logger.info("==== ls_synth results ====")
    logger.info("  greedy PER        %.2f%%", per_stats.wer)
    logger.info("  WER (decode LM)   %.2f%%", wer_small)
    logger.info("  WER (large LM)    %.2f%%", wer_large)
    logger.info("  decode RTF        %.3f", rtf)
    logger.info("  train audio-s/s   %.0f (end-to-end, incl. pipeline)", train_speed)
    logger.info("total %.0f s", time.time() - t_start)
    print(f"LS_SYNTH per={per_stats.wer:.2f} wer_small={wer_small:.2f} "
          f"wer_large={wer_large:.2f} rtf={rtf:.3f} "
          f"train_audio_s_per_s={train_speed:.0f}")
    return {"per": per_stats.wer, "wer_small": wer_small,
            "wer_large": wer_large, "rtf": rtf,
            "train_speed": train_speed}


if __name__ == "__main__":
    # --cpu: run on the CPU backend (same as JAX_PLATFORMS=cpu)
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    small = "--small" in sys.argv
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = args[0] if args else "exp_ls_synth"
    if small:
        run(root, num_words=20, num_train=48, num_test=8, layers=1,
            proj=32, cell=48, num_streams=8, max_iters=45,
            rescore_text_mult=8, lm_text_mult=4, bucket_t=128, max_len=4,
            lattice_beam=4.0, learn_rate=0.06, keep_lr=45)
    else:
        run(root)
