"""Benchmark harness: prints ONE JSON line with the primary metric.

Primary metric: audio-seconds/s/card for flagship BLSTMP-CTC *training*
(forward+CTC+backward+update) at 10ms frame shift.

Secondary fields in the same JSON object:
  - mfu_pct: counted model FLOPs / wall / the card's bf16 peak, taken
    from ``PEAKS`` by ``device_kind`` (an unknown device is an error)
  - decode_rtf: beam-search decode real-time factor on a synthesized
    ~500k-state/1.1M-arc word-loop HCLG (the aslp-latgen-faster-rtf
    role, reference: src/aslp-onlinebin/aslp-latgen-faster-rtf.cc)
  - ctc_*: the flagship step and the CTC loss+grad with the GPU kernel
    (ops/ctc_pallas.py) and with the scan (ops/ctc.py), in one process
  - blstmp_layer_*: one flagship BLSTMP layer, forward and backward

vs_baseline: the reference publishes no throughput numbers
(BASELINE.md); the denominator remains the round-1 ESTIMATE of 25
audio-s/s for a K40-era GPU LSTM trainer (~2.5k frames/s per the
reference's own fps logs, aslp-nnet-train-simple.cc:246-249).  Treat
mfu_pct as the honest measure.

    python bench.py                          # every section
    python bench.py --sections train,ctc     # a subset (see SECTIONS)

Needs a GPU; any section that raises ends the run with its traceback
and a nonzero exit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

REF_AUDIO_SECONDS_PER_SEC = 25.0  # estimated reference GPU throughput
FRAME_SHIFT_S = 0.01

# Published dense peaks per device_kind (NVIDIA H100 SXM data sheet; the
# rates assume the card's full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peak_for(device_kind: str) -> dict:
    """The peak rates of ``device_kind``; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {device_kind!r}; add it to "
            "bench.PEAKS with its source") from None


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def model_flops_per_frame(layers, D, C, P, V):
    """Counted matmul FLOPs per frame, fwd + ~2x bwd (training)."""
    per_dir = 0
    dim = D
    for _ in range(layers):
        per_dir += 2 * (dim * 4 * C + P * 4 * C + C * P)
        dim = 2 * P
    fwd = 2 * per_dir + 2 * (2 * P * V)
    return 3 * fwd


BENCH_S, BENCH_T, BENCH_U, BENCH_D, BENCH_V = 128, 400, 40, 40, 72


def _build_flagship(recursion=None):
    """Jitted flagship train step, its params and velocity; the CTC
    recursion is ops/ctc.py's ``default_recursion()`` unless given."""
    import jax

    from kaldi_aslp_tpu.models.flagship import build_blstm_ctc
    from kaldi_aslp_tpu.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu.train import (
        NnetTrainOptions,
        init_velocity,
        make_sgd_update,
    )

    net = build_blstm_ctc(bf16=True)
    params = net.init(jax.random.PRNGKey(0))
    velocity = init_velocity(params)
    update = make_sgd_update(net, NnetTrainOptions(momentum=0.9))
    # python float, NOT jnp.asarray: jits must not close over device
    # arrays (tests/test_no_device_consts.py; CLAUDE.md invariant)
    lr = 0.0001

    @jax.jit
    def step(params, velocity, feats, labels, in_lens, lab_lens, mask):
        def loss_fn(p):
            y, _ = net.apply(p, feats, train=True, mask=mask)
            return ctc_batch_loss(y, labels, in_lens, lab_lens,
                                  recursion=recursion)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params, velocity = update(params, grads, velocity, lr)
        return params, velocity, loss

    return step, params, velocity


def _fixed_batch(S=BENCH_S, T=BENCH_T, U=BENCH_U, D=BENCH_D, V=BENCH_V):
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    return (jnp.asarray(rs.randn(S, T, D).astype(np.float32)),
            jnp.asarray(rs.randint(1, V, (S, U)).astype(np.int32)),
            jnp.asarray(np.full(S, T, np.int32)),
            jnp.asarray(np.full(S, U, np.int32)),
            jnp.ones((S, T), jnp.float32))


def _time_calls(fn, n_iters):
    """Seconds per call of ``fn`` over ``n_iters`` calls, after one."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_iters


def bench_train():
    import jax

    S, T, D, V = BENCH_S, BENCH_T, BENCH_D, BENCH_V
    C, P = 512, 320
    step, params, velocity = _build_flagship()
    batch = _fixed_batch()
    dt = _time_calls(lambda: step(params, velocity, *batch), 20)
    frames_per_s = S * T / dt
    flops = frames_per_s * model_flops_per_frame(3, D, C, P, V)
    peak = peak_for(jax.devices()[0].device_kind)["bf16_flops"]
    return frames_per_s * FRAME_SHIFT_S, 100.0 * flops / peak


def bench_ctc_recursions(n_iters: int = 30, rounds: int = 2) -> dict:
    """The flagship train step, and the CTC loss+grad alone at its
    shape, with the GPU kernel and with the scan, in one process and in
    turns (kernel, scan, scan, kernel per round): the measurement that
    decides whether ops/ctc_pallas.py stays.  Milliseconds per call,
    one entry per turn."""
    import jax
    import jax.numpy as jnp

    from kaldi_aslp_tpu.ops.ctc import alpha_beta_scan, ctc_loss
    from kaldi_aslp_tpu.ops.ctc_pallas import ctc_alpha_beta_pallas

    batch = _fixed_batch()
    _, labels, in_lens, lab_lens, _ = batch
    logits = jnp.asarray(np.random.RandomState(5).randn(
        BENCH_S, BENCH_T, BENCH_V).astype(np.float32))
    runs = {}
    for name, rec in (("kernel", ctc_alpha_beta_pallas),
                      ("scan", alpha_beta_scan)):
        step, params, velocity = _build_flagship(recursion=rec)
        grad = jax.jit(jax.grad(lambda lg, r=rec: ctc_loss(
            lg, labels, in_lens, lab_lens, 0, r).sum()))
        runs[name] = (lambda s=step, p=params, v=velocity:
                      s(p, v, *batch)[2], lambda g=grad: g(logits))
    out = {}
    for name in ("kernel", "scan", "scan", "kernel") * rounds:
        step_fn, grad_fn = runs[name]
        out.setdefault(f"ctc_{name}_train_step_ms", []).append(
            _time_calls(step_fn, n_iters) * 1e3)
        out.setdefault(f"ctc_{name}_loss_grad_ms", []).append(
            _time_calls(grad_fn, n_iters) * 1e3)
    return out


def bench_lstmp_layer(n_iters: int = 20) -> dict:
    """One flagship BLSTMP layer (640 -> 2 x 320, 512 cells, bf16
    matmuls) on a [128, 400, 640] batch through the ``lax.scan`` path:
    forward, and forward+backward, in milliseconds per call."""
    import jax
    import jax.numpy as jnp

    from kaldi_aslp_tpu.models.recurrent import BLstmProjectedStreams

    layer = BLstmProjectedStreams(640, 640, cell_dim=512, bf16=True)
    params = layer.init_params(jax.random.PRNGKey(0))
    rs = np.random.RandomState(3)
    x = jnp.asarray(rs.randn(BENCH_S, BENCH_T, 640).astype(np.float32))
    w = jnp.asarray(rs.randn(BENCH_S, BENCH_T, 640).astype(np.float32))
    mask = jnp.ones((BENCH_S, BENCH_T), jnp.float32)

    def fwd(p, xx):
        return layer.apply(p, xx, train=True, mask=mask)[0]
    f = jax.jit(fwd)
    fb = jax.jit(jax.grad(lambda p, xx: jnp.sum(fwd(p, xx) * w),
                          argnums=(0, 1)))
    return {
        "blstmp_layer_fwd_ms": _time_calls(lambda: f(params, x),
                                           n_iters) * 1e3,
        "blstmp_layer_fwd_bwd_ms": _time_calls(lambda: fb(params, x),
                                               n_iters) * 1e3,
    }


def synth_ctc_utterances(n_utts, seed=1, T=BENCH_T, U=BENCH_U, D=BENCH_D,
                         V=BENCH_V):
    """Seed-generated (key, feats [t, D], labels [u]) utterances with
    lengths uniform in [0.6 T, T] frames and [U/2, U] labels."""
    rs = np.random.RandomState(seed)
    utts = []
    for u in range(n_utts):
        tl = int(rs.randint(int(0.6 * T), T + 1))
        ul = int(rs.randint(U // 2, U + 1))
        utts.append((f"u{u}", rs.randn(tl, D).astype(np.float32),
                     rs.randint(1, V, ul).astype(np.int32)))
    return utts


def ctc_batches(utts, S=BENCH_S, T=BENCH_T, U=BENCH_U, repeats=1):
    """Full length-bucketed CtcBatcher batches of ``utts`` (a ragged
    tail would trigger a recompile, so it is dropped)."""
    from kaldi_aslp_tpu.data.sequence import CtcBatcher, CtcBatcherOptions

    opts = CtcBatcherOptions(num_streams=S, frame_limit=10 ** 9,
                             bucket_time=T, bucket_labels=U,
                             sort_by_length=False)
    for _ in range(repeats):
        for b in CtcBatcher(iter(utts), opts):
            if len(b.keys) == S:
                yield b


def bench_train_corpus_fed(n_utts=512, repeats=2,
                           transport="bf16", measure_cached=True):
    """Corpus-fed throughput: variable-length utterances through the
    REAL training loop (CtcBatcher bucketing → CtcTrainer.train_epoch
    with feature transport + DevicePrefetcher) — the number next to the
    fixed-batch one (reference role: the trainers' table-reading outer
    loop, aslp-nnet-train-ctc-streams.cc:118-204).  Features cross as
    ``transport`` (data/transport.py)."""
    import itertools

    import jax

    from kaldi_aslp_tpu.models.flagship import build_blstm_ctc
    from kaldi_aslp_tpu.train import NnetTrainOptions, init_velocity
    from kaldi_aslp_tpu.train.trainer import CtcTrainer

    utts = synth_ctc_utterances(n_utts)
    net = build_blstm_ctc(bf16=True)
    trainer = CtcTrainer(net, NnetTrainOptions(momentum=0.9),
                         transport=transport)
    params = net.init(jax.random.PRNGKey(0))
    velocity = init_velocity(params)

    # warmup one batch (compiles the transported step)
    params, velocity, rep = trainer.train_epoch(
        params, velocity, itertools.islice(ctc_batches(utts), 1), 1e-4)
    jax.block_until_ready(params)

    t0 = time.perf_counter()
    params, velocity, rep = trainer.train_epoch(
        params, velocity, ctc_batches(utts, repeats=repeats), 1e-4)
    jax.block_until_ready(params)
    frames = rep.frames
    streaming = frames * FRAME_SHIFT_S / (time.perf_counter() - t0)
    if not measure_cached:
        return streaming, None

    # steady-state epochs with the device-resident cache (epoch 2+ of
    # real newbob training: same data, zero host->device traffic —
    # data/device_cache.py)
    cache = trainer.make_cache()
    params, velocity, rep = trainer.train_epoch(
        params, velocity, ctc_batches(utts, repeats=repeats), 1e-4,
        cache=cache)
    jax.block_until_ready(params)
    t0 = time.perf_counter()
    reps = []
    for _ in range(4):
        params, velocity, rep = trainer.train_epoch(
            params, velocity, None, 1e-4, cache=cache)
        reps.append(rep)
    jax.block_until_ready(params)
    dt = time.perf_counter() - t0
    cached = sum(r.frames for r in reps) * FRAME_SHIFT_S / dt
    return streaming, cached


def synth_decode_graph(num_words=30000, phones_per_word=6,
                       num_pdfs=1024, seed=0):
    """Word-loop HCLG-shaped graph (see tests/test_beam_decode.py)."""
    from kaldi_aslp_tpu.decoder import PackedGraph

    rng = np.random.RandomState(seed)
    spw = 3 * phones_per_word
    S = 1 + num_words * spw
    pdf = rng.randint(0, num_pdfs, size=(num_words, spw)).astype(np.int32)
    lm_cost = rng.uniform(2.0, 8.0, size=num_words).astype(np.float32)
    base = 1 + np.arange(num_words, dtype=np.int64)[:, None] * spw \
        + np.arange(spw, dtype=np.int64)[None, :]
    tid = (pdf + 1).astype(np.int32)
    sl_src = base.reshape(-1)
    fw_src = base.reshape(-1)
    fw_dst = (base + 1).reshape(-1)
    fw_dst[spw - 1::spw] = 0
    fw_ol = np.zeros(fw_src.shape, np.int32)
    fw_ol[spw - 1::spw] = np.arange(1, num_words + 1)
    src = np.concatenate([sl_src, fw_src,
                          np.zeros(num_words, np.int64)]).astype(np.int32)
    dst = np.concatenate([sl_src, fw_dst, base[:, 0]]).astype(np.int32)
    il = np.concatenate([tid.reshape(-1), tid.reshape(-1),
                         np.zeros(num_words, np.int32)])
    ol = np.concatenate([np.zeros(sl_src.shape, np.int32), fw_ol,
                         np.zeros(num_words, np.int32)])
    w = np.concatenate([
        np.full(sl_src.shape, 0.693, np.float32),
        np.full(fw_src.shape, 0.693, np.float32), lm_cost,
    ]).astype(np.float32)
    final = np.full(S, np.inf, np.float32)
    final[0] = 0.0
    g = PackedGraph(src=src, dst=dst, ilabel=il, olabel=ol, weight=w,
                    final=final, start=0, num_states=S, eps_diameter=1)
    lut = np.arange(-1, num_pdfs, dtype=np.int32)
    lut[0] = 0
    return g, lut, num_pdfs


def seed_loglikes(T, num_pdfs, rng):
    """[T, num_pdfs] seed log-likelihoods: uniform in [-12, -10] with
    one -0.5 winner per frame (``rng``: a numpy RandomState)."""
    ll = rng.uniform(-12.0, -10.0, size=(T, num_pdfs)).astype(np.float32)
    ll[np.arange(T), rng.randint(0, num_pdfs, T)] = -0.5
    return ll


_DECODE_STATE: dict = {}
_DECODE5M_STATE: dict = {}


def bench_decode_rtf_5m():
    """Best-path beam decode RTF on a ≥5M-state / ≥10M-arc word-loop
    HCLG (the egs/librispeech graph scale: ~200k-word vocabulary).
    Memory budget, device-resident: em_pack [10.1M,3] + ep_pack
    [0.28M,2] int32 ≈ 124 MB, row tables 2×[5.04M,2] int32 ≈ 81 MB,
    backpointer planes [Tp, 2, K] ×2 int32 ≈ 100 MB at T=6000 — ~305 MB
    HBM total, frontier K=2048 / arc budget unchanged from the 540k
    graph (per-frame cost is budget-bound, not graph-bound)."""
    from kaldi_aslp_tpu.decoder.beam import BeamSearchDecoder, CsrGraph

    if not _DECODE5M_STATE:
        g, lut, num_pdfs = synth_decode_graph(num_words=280_000)
        assert g.num_states >= 5_000_000 and len(g.src) >= 10_000_000
        dec = BeamSearchDecoder(CsrGraph.from_packed(g), lut,
                                acoustic_scale=1.0, beam=14.0,
                                max_active=2048, chunk=128)
        T = 6000
        ll = seed_loglikes(T, num_pdfs, np.random.RandomState(2))
        import jax.numpy as jnp
        _DECODE5M_STATE.update(dec=dec, ll=jnp.asarray(ll), T=T)
    dec, ll_dev, T = (_DECODE5M_STATE["dec"], _DECODE5M_STATE["ll"],
                      _DECODE5M_STATE["T"])
    dec.decode(ll_dev)     # warmup at the real shape (compile)
    t0 = time.perf_counter()
    dec.decode(ll_dev)
    return (time.perf_counter() - t0) / (T * FRAME_SHIFT_S)


def bench_decode_rtf(lattice: bool):
    """Beam decode RTF on the big synthetic HCLG (one utterance of
    60 s, the RTF-tool role).  ``lattice=False`` → (best-path RTF,
    None); ``lattice=True`` → (None, lattice RTF), where the lattice
    number includes the on-device fwd-bwd record prune + host lattice
    build (the latgen-faster role proper)."""
    from kaldi_aslp_tpu.decoder.beam import BeamSearchDecoder, CsrGraph

    if not _DECODE_STATE:
        g, lut, num_pdfs = synth_decode_graph()
        dec = BeamSearchDecoder(CsrGraph.from_packed(g), lut,
                                acoustic_scale=1.0, beam=14.0,
                                max_active=2048, chunk=128)
        T = 6000  # 60 s of audio
        ll = seed_loglikes(T, num_pdfs, np.random.RandomState(1))
        import jax.numpy as jnp
        # scores live on device, as the AM makes them
        _DECODE_STATE.update(dec=dec, ll=jnp.asarray(ll), T=T)
    dec, ll_dev, T = (_DECODE_STATE["dec"], _DECODE_STATE["ll"],
                      _DECODE_STATE["T"])
    if not lattice:
        dec.decode(ll_dev)     # warmup at the REAL shape (compile)
        t0 = time.perf_counter()
        dec.decode(ll_dev)
        return (time.perf_counter() - t0) / (T * FRAME_SHIFT_S), None
    dec.decode_lattice(ll_dev, lattice_beam=8.0)  # warmup (compile)
    t0 = time.perf_counter()
    dec.decode_lattice(ll_dev, lattice_beam=8.0)
    return None, (time.perf_counter() - t0) / (T * FRAME_SHIFT_S)


def bench_decode_throughput(B: int = 8, T: int = 1024,
                            max_active: int = 2048):
    """Offline decode THROUGHPUT at realistic utterance length (~10 s):
    aggregate audio-s/s for (a) naive sequential decode, (b) pipelined
    decode_many (fetch hidden behind the next utterance's dispatch),
    (c) lockstep decode_batch.  The reference scales offline decode by
    run.pl ark-sharding (aslp_scripts/aslp_nnet/decode.sh:129-134);
    on one chip the equivalents are (b)/(c).

    ``max_active``: per-frame cost is frontier-budget-bound (A = 4K),
    so the tuned operating point uses the budget the corpus evidence
    supports (recipes/decode_budget_sweep.py: dev WER vs K on the hard
    corpus), not the 60 s-stress default."""
    from kaldi_aslp_tpu.decoder.beam import BatchedBeamDecoder, CsrGraph

    if not _DECODE_STATE:
        bench_decode_rtf(lattice=False)   # builds graph + decoder
    dec0 = _DECODE_STATE["dec"]
    dec = BatchedBeamDecoder(dec0.graph, dec0.tid_to_pdf,
                             acoustic_scale=1.0, beam=14.0,
                             max_active=max_active, chunk=128)
    rng = np.random.RandomState(3)
    num_pdfs = int(np.max(dec0.tid_to_pdf)) + 1
    import jax.numpy as jnp
    lls = [jnp.asarray(seed_loglikes(T, num_pdfs, rng)) for _ in range(B)]
    audio_s = B * T * FRAME_SHIFT_S

    dec.decode_many(lls)         # warmup/compile (shares decode jits)
    t0 = time.perf_counter()
    dec.decode_many(lls)
    many = audio_s / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    for x in lls:
        dec.decode(x)
    seq = audio_s / (time.perf_counter() - t0)

    dec.decode_batch(lls)        # warmup/compile
    t0 = time.perf_counter()
    dec.decode_batch(lls)
    batch = audio_s / (time.perf_counter() - t0)
    return seq, many, batch


_CPU_REF_SRC = r'''
import json, sys, time
import jax
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, ".")
import bench

S = 8
step, params, velocity = bench._build_flagship()
batch = bench._fixed_batch(S=S)
dt = bench._time_calls(lambda: step(params, velocity, *batch), 3)
train_fps = S * bench.BENCH_T / dt

# decode reference: the SAME 540k-state word-loop graph as
# bench_decode_rtf, 5 s utterance, identical decoder settings
from kaldi_aslp_tpu.decoder.beam import BeamSearchDecoder, CsrGraph
g, lut, num_pdfs = bench.synth_decode_graph()
dec = BeamSearchDecoder(CsrGraph.from_packed(g), lut,
                        acoustic_scale=1.0, beam=14.0,
                        max_active=2048, chunk=128)
Td = 500
lld = jnp.asarray(bench.seed_loglikes(Td, num_pdfs,
                                      np.random.RandomState(1)))
dec.decode(lld)
t0 = time.perf_counter()
dec.decode(lld)
rtf = (time.perf_counter() - t0) / (Td * bench.FRAME_SHIFT_S)
print(json.dumps({"frames_per_s": train_fps, "decode_rtf": rtf}))
'''


def bench_cpu_reference():
    """Measured single-core host-CPU frames/s on the SAME flagship
    BLSTMP-CTC train step, and the decode RTF on the same graph.
    Anchors ``vs_baseline`` as a measurement instead of the round-1
    K40 estimate.  The reference's own throughput log role:
    src/aslp-nnetbin/aslp-nnet-train-simple.cc:246-249.

    Runs in a subprocess pinned to one core (taskset) and to the CPU
    backend (JAX_PLATFORMS=cpu, so it never opens the card this
    process holds).  Batch is reduced to S=8 (wall-clock) and
    normalized per-frame — CPU time is linear in S at these sizes."""
    from kaldi_aslp_tpu.utils.jax_setup import cpu_only_env

    r = subprocess.run(
        ["taskset", "-c", "0", sys.executable, "-c", _CPU_REF_SRC],
        capture_output=True, text=True, timeout=1200, cwd=".",
        env=cpu_only_env(), check=True)
    d = json.loads(r.stdout.strip().splitlines()[-1])
    return float(d["frames_per_s"]), float(d["decode_rtf"])


def _section_decode_throughput():
    seq_tp, many_tp, batch_tp = bench_decode_throughput()
    # tuned operating point: frontier budget sized by the hard-corpus
    # dev-WER sweep (recipes/decode_budget_sweep.py) instead of the
    # 60 s-stress K=2048 — per-frame cost is budget-bound, so this is
    # the bulk-decode configuration (decode.sh nj-sharding role)
    tuned = bench_decode_throughput(max_active=512)
    out = {
        "decode10s_seq_audio_s_per_s": round(seq_tp, 1),
        "decode10s_pipelined_audio_s_per_s": round(many_tp, 1),
        "decode10s_batch8_audio_s_per_s": round(batch_tp, 1),
        "decode10s_tuned_seq_audio_s_per_s": round(tuned[0], 1),
        "decode10s_tuned_pipelined_audio_s_per_s": round(tuned[1], 1),
        "decode10s_tuned_batch8_audio_s_per_s": round(tuned[2], 1),
        # measured WER license for the K=512 operating point: NN-side
        # frontier-budget dev sweeps on trained hard-ladder CTC
        # systems (recipes/decode_budget_sweep.nn_budget_sweep).  Two
        # measurements: fixed-scale decode (NN_BUDGET_SWEEP_DEV
        # 2048=27.77 1024=27.77 512=27.98 256=28.63 -> +0.21) and the
        # dev-swept 0.7/0.5 operating point (2048=24.95 1024=25.16
        # 512=25.81 256=25.60 -> +0.86); the worse of the two is
        # quoted
        "decode10s_tuned_dev_wer_delta": 0.86,
    }
    return out


def _section_train():
    throughput, mfu = bench_train()
    _section_train.throughput = throughput
    return {"metric": "audio-seconds/s/card (BLSTMP-CTC train)",
            "value": round(throughput, 2), "unit": "audio-s/s",
            "mfu_pct": round(mfu, 2)}


def _section_corpus():
    corpus_fed, corpus_cached = bench_train_corpus_fed()
    corpus_fed_int8, _ = bench_train_corpus_fed(
        transport="int8", measure_cached=False)
    return {"corpus_fed_audio_s_per_s": round(corpus_fed, 2),
            "corpus_cached_epoch_audio_s_per_s": round(corpus_cached, 2),
            "corpus_fed_int8_audio_s_per_s": round(corpus_fed_int8, 2)}


def _section_cpu_reference():
    cpu_ref_fps, cpu_ref_rtf = bench_cpu_reference()
    out = {"cpu_ref_frames_per_s": round(cpu_ref_fps, 1),
           "cpu_ref_decode_rtf": round(cpu_ref_rtf, 3)}
    throughput = getattr(_section_train, "throughput", None)
    if throughput is not None:
        # MEASURED: same train step, single host-CPU core (scan path),
        # ratio of frames/s — see bench_cpu_reference
        out["vs_baseline"] = round(
            throughput / FRAME_SHIFT_S / cpu_ref_fps, 2)
        out["vs_baseline_is_estimate"] = False
    return out


SECTIONS = {
    "train": _section_train,
    "ctc": bench_ctc_recursions,
    "lstmp": bench_lstmp_layer,
    "corpus": _section_corpus,
    "decode": lambda: {"decode_rtf_500k_state_graph": round(
        bench_decode_rtf(lattice=False)[0], 4)},
    "lattice": lambda: {"lattice_rtf_500k_state_graph": round(
        bench_decode_rtf(lattice=True)[1], 4)},
    "decode5m": lambda: {"decode_rtf_5m_state_graph": round(
        bench_decode_rtf_5m(), 4)},
    "decode_throughput": _section_decode_throughput,
    "cpu_reference": _section_cpu_reference,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated subset of: "
                    + ", ".join(SECTIONS))
    args = ap.parse_args(argv)
    names = [n for n in args.sections.split(",") if n]
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        ap.error(f"unknown sections {unknown}")

    import jax

    from kaldi_aslp_tpu.utils.jax_setup import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    peak_for(dev.device_kind)
    print(card_name_and_power_limit(), flush=True)

    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    for name in names:
        out.update(SECTIONS[name]())
    if "vs_baseline" not in out and "value" in out:
        # fallback: the round-1 ESTIMATE of 25 audio-s/s for the
        # reference's K40-era GPU trainer (no published figure exists)
        out["vs_baseline"] = round(
            out["value"] / REF_AUDIO_SECONDS_PER_SEC, 2)
        out["vs_baseline_is_estimate"] = True
    print(json.dumps(out))


if __name__ == "__main__":
    main()
