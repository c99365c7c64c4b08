#!/usr/bin/env python3
"""Smoke run on the GPU: the BLSTMP-CTC trainer and the WFST beam decoder
at the flagship's full width, each checked against its plain reference.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # BSP and BMUF on four cards

One card runs four phases in order:

1. device: JAX's platform must be ``gpu``; prints the card's name and
   power limit as nvidia-smi gives them.
2. ctc: the CTC kernel (ops/ctc_pallas.py) against the scan (ops/ctc.py)
   at the flagship's shape and at the reference's longest utterances,
   alpha, beta, NLL and logits gradient; then the tests marked ``gpu``.
3. train: a few CtcTrainer steps of the bf16 flagship on seed-generated,
   length-bucketed utterances (the loss must be finite and fall), and
   the first-step losses and gradient norm of an f32 copy against the
   same computation on the CPU.
4. decode: BeamSearchDecoder, best path and lattice, on the 540k-state
   word-loop graph, against the same decoder on the CPU.

``--four-cards`` runs the device check and data-parallel training only:
BSP on a 4-card ('data',) mesh and BMUF on a 2x2 ('block', 'data') mesh,
each against the same update computed on one card over the same streams
(the whole global batch for BSP, each block's streams for BMUF).

Every comparison prints its tolerance, precision and worst error, and
every phase its compile and steady times.  The script exits nonzero, and
prints no result line, when JAX finds no GPU or any check fails; else its
last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# the flagship (bench.py): 3 x BLSTMP 640/512, 72 outputs, 40-dim input
FLAGSHIP = dict(S=128, T=400, U=40, D=40, V=72, layers=3, cell=512,
                proj=320)
# CTC shapes: the flagship batch, and the reference's max_frames=3000
CTC_SHAPES = {"flagship": dict(S=128, T=400, U=40, V=72),
              "long": dict(S=16, T=3000, U=300, V=72)}
TRAIN_STEPS = 6
TRAIN_LR = 0.01
CPU_STREAMS = 8
DECODE = dict(num_words=30000, T=1000, beam=14.0, max_active=2048,
              chunk=128, lattice_beam=8.0)


class CheckFailed(Exception):
    pass


def say(*args):
    print(*args, flush=True)


def check(name, worst, tol, precision):
    """Print one comparison and fail unless ``worst <= tol``."""
    ok = bool(np.isfinite(worst) and worst <= tol)
    say(f"  check {name}: worst {worst:.3e} <= tol {tol:.1e} "
        f"[{precision}] {'ok' if ok else 'FAILED'}")
    if not ok:
        raise CheckFailed(name)


def require(name, ok, detail=""):
    say(f"  check {name}: {'ok' if ok else 'FAILED'} {detail}".rstrip())
    if not ok:
        raise CheckFailed(name)


def timed(fn, reps=0):
    """(result, first-call seconds, steady seconds per call) — the first
    call includes compilation; ``reps`` more calls give the steady
    time."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    steady = float("nan")
    if reps:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = jax.block_until_ready(fn())
        steady = (time.perf_counter() - t0) / reps
    return out, first, steady


def say_time(what, first, steady):
    say(f"  time {what}: first call (compile included) {first:.2f} s, "
        f"steady {steady * 1e3:.3f} ms")


# ---------------------------------------------------------------- device

def phase_device(n_cards):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU: JAX found platform "
                 f"{devs[0].platform!r}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: {n_cards} cards needed, JAX found "
                 f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        say(f"card: {line.strip()}")
    say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    return devs


# ------------------------------------------------------------------- ctc

def ctc_case(S, T, U, V, seed=0):
    """Logits and labels with ragged input and label lengths, a
    zero-length label sequence and repeated labels."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(S, T, V).astype(np.float32)
    labels = rs.randint(1, V, (S, U)).astype(np.int32)
    labels[2::3, 1::2] = labels[2::3, 0::2][:, :U // 2]   # repeats
    in_lens = rs.randint(T // 2, T + 1, S).astype(np.int32)
    in_lens[0] = T
    lab_lens = rs.randint(1, U + 1, S).astype(np.int32)
    lab_lens[0] = U
    lab_lens[1] = 0
    return logits, labels, in_lens, lab_lens


def log_space_errors(x, y, neg_inf):
    """(worst |x - y| over entries reachable in both, worst of it
    relative to max(1, |y|), whether the reachable sets and the
    unreachable entries are equal)."""
    x, y = np.asarray(x), np.asarray(y)
    rx, ry = x > neg_inf / 2, y > neg_inf / 2
    same = bool((rx == ry).all()) and bool(
        np.array_equal(x[~rx], y[~ry]))
    both = rx & ry
    d = np.abs(x[both] - y[both])
    rel = d / np.maximum(1.0, np.abs(y[both]))
    return (float(d.max(initial=0.0)), float(rel.max(initial=0.0)), same)


def phase_ctc(shapes=CTC_SHAPES, kernel=None, run_gpu_tests=True):
    import jax
    import jax.numpy as jnp

    from kaldi_aslp_tpu.ops.ctc import (
        NEG_INF,
        alpha_beta_scan,
        ctc_alpha_beta,
        ctc_loss,
    )
    from kaldi_aslp_tpu.ops.ctc_pallas import ctc_alpha_beta_pallas

    kernel = kernel or ctc_alpha_beta_pallas
    for name, shp in shapes.items():
        say(f"  shape {name}: {shp}")
        logits, labels, in_lens, lab_lens = (
            jnp.asarray(a) for a in ctc_case(**shp))
        log_probs = jax.nn.log_softmax(logits, -1)
        outs = {}
        for impl, rec in (("scan", alpha_beta_scan), ("kernel", kernel)):
            fwd = jax.jit(lambda lp, r=rec: ctc_alpha_beta(
                lp, labels, in_lens, lab_lens, 0, r)[:3])
            grad = jax.jit(jax.grad(lambda lg, r=rec: ctc_loss(
                lg, labels, in_lens, lab_lens, 0, r).sum()))
            (nll, a, b), f1, fs = timed(lambda: fwd(log_probs), reps=5)
            say_time(f"{impl} alpha+beta", f1, fs)
            g, g1, gs = timed(lambda: grad(logits), reps=5)
            say_time(f"{impl} loss+grad", g1, gs)
            outs[impl] = [np.asarray(v) for v in (nll, a, b, g)]
        (n0, a0, b0, g0), (n1, a1, b1, g1) = outs["scan"], outs["kernel"]
        for what, x, y in (("alpha", a1, a0), ("beta", b1, b0)):
            d, rel, same = log_space_errors(x, y, NEG_INF)
            require(f"{name} {what} unreachable entries equal", same)
            check(f"{name} {what} |kernel-scan| / max(1,|scan|)", rel,
                  1e-6, "f32")
            say(f"    ({what} worst absolute {d:.3e})")
        check(f"{name} nll |kernel-scan| / max(1,|scan|)", float(np.max(
            np.abs(n1 - n0) / np.maximum(1.0, np.abs(n0)))), 1e-6, "f32")
        check(f"{name} logits grad absolute",
              float(np.abs(g1 - g0).max()), 1e-4, "f32")
    if run_gpu_tests:
        import pytest

        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          str(HERE / "tests" / "test_ctc_pallas.py")])
        require("pytest -m gpu", rc == 0, f"(exit {int(rc)})")


# ----------------------------------------------------------------- train

def flagship(sz, bf16):
    from kaldi_aslp_tpu.models.flagship import build_blstm_ctc

    return build_blstm_ctc(input_dim=sz["D"], num_layers=sz["layers"],
                           proj_dim=sz["proj"], cell_dim=sz["cell"],
                           num_targets=sz["V"], bf16=bf16)


def first_step_fn(net, recursion=None):
    """Per-utterance CTC losses and the global gradient norm of one
    step at ``params``; ``recursion`` as in ops/ctc.py."""
    import jax
    import jax.numpy as jnp

    from kaldi_aslp_tpu.models.losses import ctc_batch_loss

    def fn(params, feats, labels, in_lens, lab_lens, mask):
        def loss_fn(p):
            y, _ = net.apply(p, feats, train=True, mask=mask)
            loss, aux = ctc_batch_loss(y, labels, in_lens, lab_lens,
                                       recursion=recursion)
            return loss, aux["per_seq_nll"]
        (_, nll), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        norm = jnp.sqrt(sum(jnp.sum(jnp.square(x))
                            for x in jax.tree_util.tree_leaves(g)))
        return nll, norm
    return jax.jit(fn)


def phase_train(sz=FLAGSHIP, steps=TRAIN_STEPS, lr=TRAIN_LR,
                cpu_streams=CPU_STREAMS):
    import jax

    import bench
    from kaldi_aslp_tpu.ops.ctc import alpha_beta_scan
    from kaldi_aslp_tpu.train import NnetTrainOptions, init_velocity
    from kaldi_aslp_tpu.train.trainer import CtcTrainer

    S, T, U = sz["S"], sz["T"], sz["U"]
    utts = bench.synth_ctc_utterances(2 * S, seed=1, T=T, U=U, D=sz["D"],
                                      V=sz["V"])
    batches = list(bench.ctc_batches(utts, S=S, T=T, U=U))
    require("two full length-bucketed batches", len(batches) == 2,
            f"(shape {batches[0].feats.shape if batches else None})")

    net = flagship(sz, bf16=True)
    params0 = net.init(jax.random.PRNGKey(0))
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(params0))
    say(f"  flagship: {n_params} parameters, bf16 matmuls")
    trainer = CtcTrainer(net, NnetTrainOptions(momentum=0.9))
    params, velocity = params0, init_velocity(params0)
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, velocity, rep = trainer.train_epoch(
            params, velocity, [batches[i % 2]], lr)
        jax.block_until_ready(params)
        times.append(time.perf_counter() - t0)
        losses.append(rep.avg_loss)
    say(f"  losses per step: {[round(x, 5) for x in losses]}")
    say_time("CtcTrainer step", times[0], float(np.mean(times[2:])))
    require("loss finite", bool(np.all(np.isfinite(losses))))
    require("loss falling on a revisited batch",
            losses[steps - 2] < losses[0],
            f"({losses[0]:.5f} -> {losses[steps - 2]:.5f})")

    # f32 copy, card against CPU, first step on a slice of the streams
    b = batches[0]
    sl = slice(0, cpu_streams)
    args = (b.feats[sl], b.labels[sl], b.input_lengths[sl],
            b.label_lengths[sl], b.frame_mask[sl])
    net32 = flagship(sz, bf16=False)
    cpu = jax.devices("cpu")[0]
    step_card = first_step_fn(net32)
    with jax.default_matmul_precision("highest"):
        (nll_g, norm_g), t1, ts = timed(
            lambda: step_card(params0, *args), reps=3)
        say_time(f"f32 first step on the card ({cpu_streams} streams)",
                 t1, ts)
        # the CPU computation takes the CPU's CTC recursion, the scan
        (nll_c, norm_c), t1, _ = timed(lambda: first_step_fn(
            net32, alpha_beta_scan)(jax.device_put(params0, cpu),
                                    *jax.device_put(args, cpu)))
        say(f"  time f32 first step on the CPU: {t1:.2f} s")
    nll_g, nll_c = np.asarray(nll_g), np.asarray(nll_c)
    say(f"  f32 per-utterance losses (card): {np.round(nll_g, 4)}")
    check("f32 per-utterance loss, card vs CPU, relative",
          float(np.max(np.abs(nll_g - nll_c) / np.abs(nll_c))), 1e-5,
          "f32, matmul precision highest")
    check("f32 global gradient norm, card vs CPU, relative",
          float(abs(norm_g - norm_c) / abs(norm_c)), 1e-4,
          "f32, matmul precision highest")
    nll_16, _ = first_step_fn(net)(params0, *args)
    say("  bf16 flagship vs f32 copy, per-utterance loss: worst relative "
        f"{float(np.max(np.abs(np.asarray(nll_16) - nll_g) / nll_g)):.3e}"
        " (reported, not checked)")


# ---------------------------------------------------------------- decode

def _decode_both(dec, ll, lattice_beam, reps):
    from kaldi_aslp_tpu.decoder.lattice import lattice_best_path

    (words, _, score), f1, fs = timed(lambda: dec.decode(ll), reps)
    out = {"words": words, "score": score, "time": (f1, fs)}
    res, f1, fs = timed(lambda: dec.decode_lattice(
        ll, lattice_beam=lattice_beam), reps)
    words_l, _, score_l, lat = res
    bp_words, bp_cost = lattice_best_path(lat)
    out.update(lat_words=words_l, lat_score=score_l, lat_time=(f1, fs),
               lat_arcs=lat.num_arcs(), bp_words=bp_words,
               bp_cost=bp_cost)
    return out


def phase_decode(cfg=DECODE):
    import jax

    import bench
    from kaldi_aslp_tpu import native
    from kaldi_aslp_tpu.decoder.beam import BeamSearchDecoder, CsrGraph

    g, lut, num_pdfs = bench.synth_decode_graph(num_words=cfg["num_words"])
    graph = CsrGraph.from_packed(g)
    say(f"  graph: {g.num_states} states, {len(g.src)} arcs; utterance "
        f"{cfg['T']} frames; native lattice builder "
        f"{'loaded' if native.get_lib() is not None else 'MISSING'}")
    kw = dict(acoustic_scale=1.0, beam=cfg["beam"],
              max_active=cfg["max_active"], chunk=cfg["chunk"])
    ll = bench.seed_loglikes(cfg["T"], num_pdfs, np.random.RandomState(1))
    card = _decode_both(BeamSearchDecoder(graph, lut, **kw), ll,
                        cfg["lattice_beam"], reps=2)
    say_time("best-path decode, card", *card["time"])
    say_time("lattice decode, card", *card["lat_time"])
    with jax.default_device(jax.devices("cpu")[0]):
        ref = _decode_both(BeamSearchDecoder(graph, lut, **kw), ll,
                           cfg["lattice_beam"], reps=0)
    say(f"  time best-path decode, CPU: {ref['time'][0]:.2f} s; "
        f"lattice decode, CPU: {ref['lat_time'][0]:.2f} s")
    say(f"  card: {len(card['words'])} words, score {card['score']:.4f}, "
        f"lattice {card['lat_arcs']} arcs; CPU lattice "
        f"{ref['lat_arcs']} arcs")
    require("best-path words, card == CPU", card["words"] == ref["words"])
    check("best-path score |card - CPU| / |CPU|",
          abs(card["score"] - ref["score"]) / abs(ref["score"]), 1e-5,
          "f32")
    require("lattice-mode words, card == CPU",
            card["lat_words"] == ref["lat_words"])
    require("lattice best path words, card == CPU",
            card["bp_words"] == ref["bp_words"])
    check("lattice best path cost |card - CPU| / |CPU|",
          abs(card["bp_cost"] - ref["bp_cost"]) / abs(ref["bp_cost"]),
          1e-5, "f32")
    require("lattice best path words == best-path words",
            card["bp_words"] == card["words"])


# ------------------------------------------------------------ four cards

def _tree_rel_err(a, b):
    """max |a - b| / max(|b|) over the leaves of two pytrees."""
    import jax

    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        worst = max(worst, float(np.abs(x - y).max()
                                 / max(np.abs(y).max(), 1e-30)))
    return worst


def phase_four_cards(devs, sz=FLAGSHIP, lr=TRAIN_LR, reps=10):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from kaldi_aslp_tpu.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu.parallel.bmuf import (
        BmufOptions,
        make_bmuf_block_step,
        stack_block_states,
    )
    from kaldi_aslp_tpu.parallel.bsp import make_bsp_train_step, shard_batch
    from kaldi_aslp_tpu.parallel.mesh import make_mesh
    from kaldi_aslp_tpu.train import (
        NnetTrainOptions,
        init_velocity,
        make_sgd_update,
    )

    devs = devs[:4]
    S, T, U = sz["S"], sz["T"], sz["U"]
    utts = bench.synth_ctc_utterances(4 * S, seed=2, T=T, U=U, D=sz["D"],
                                      V=sz["V"])
    b = next(bench.ctc_batches(utts, S=4 * S, T=T, U=U))
    batch = (b.feats, b.labels, b.input_lengths, b.label_lengths,
             b.frame_mask)
    lr = jnp.float32(lr)

    def make(bf16):
        net = flagship(sz, bf16)

        def loss_fn(params, bt):
            feats, labels, in_lens, lab_lens, mask = bt
            y, _ = net.apply(params, feats, train=True, mask=mask)
            loss, aux = ctc_batch_loss(y, labels, in_lens, lab_lens)
            return loss, {"frames": aux["frames"]}
        update = make_sgd_update(net, NnetTrainOptions(momentum=0.9))
        params = net.init(jax.random.PRNGKey(0))
        return loss_fn, update, params

    def shards(bt, n):
        """``bt`` cut into ``n`` equal runs of streams, on one card."""
        m = bt[0].shape[0] // n
        return [jax.tree_util.tree_map(
            lambda x: jax.device_put(x[k * m:(k + 1) * m], devs[0]), bt)
            for k in range(n)]

    loss_fn, update, params = make(bf16=False)
    velocity = init_velocity(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bt: loss_fn(p, bt)[0]))
    upd = jax.jit(update)

    # ---- BSP on a ('data',) mesh of four cards
    mesh = make_mesh(("data",), devices=devs)
    dev_batch = shard_batch(batch, mesh)
    placed = {s.device for s in dev_batch[0].addressable_shards}
    rows = {s.data.shape[0] for s in dev_batch[0].addressable_shards}
    require("BSP batch: one shard of S streams on each card",
            placed == set(devs) and rows == {S},
            f"({len(placed)} cards, shard rows {sorted(rows)})")
    with jax.default_matmul_precision("highest"):
        step = make_bsp_train_step(loss_fn, update, mesh)
        (p4, v4, loss4, _), t1, _ = timed(
            lambda: step(params, velocity, dev_batch, lr))
        say(f"  time BSP f32 step, 4 cards: first call (compile "
            f"included) {t1:.2f} s")
        # reference: one step on one card over the whole global batch
        (whole,) = shards(batch, 1)
        loss1, g1 = grad_fn(params, whole)
        p1, v1 = upd(params, g1, velocity, lr)
    frames = np.asarray(b.input_lengths).reshape(4, S).sum(1)
    say(f"  frames per card: {frames.tolist()}")
    check("BSP loss, 4 cards vs 1 card, relative",
          abs(float(loss4) - float(loss1)) / abs(float(loss1)), 1e-5,
          "f32, matmul precision highest")
    check("BSP updated parameters, max |4 - 1| / max |1| per leaf",
          _tree_rel_err(p4, p1), 1e-5, "f32, matmul precision highest")
    check("BSP velocity, max |4 - 1| / max |1| per leaf",
          _tree_rel_err(v4, v1), 1e-4, "f32, matmul precision highest")

    # ---- BMUF on a 2x2 ('block', 'data') mesh
    inner = 2
    opts = BmufOptions()
    mesh2 = make_mesh(("block", "data"), shape=(2, 2), devices=devs)
    bsh = jax.tree_util.tree_map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh2, P(("block", "data")))), batch)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    with jax.default_matmul_precision("highest"):
        bstep = make_bmuf_block_step(loss_fn, update, mesh2, opts,
                                     inner_steps=inner)
        out4, t1, _ = timed(lambda: bstep(
            params, params, zeros, stack_block_states(velocity, 2), bsh,
            lr))
        say(f"  time BMUF f32 block step, 4 cards: first call (compile "
            f"included) {t1:.2f} s")
        # reference, block by block on one card: block k trains on the
        # streams of cards 2k and 2k+1 (the mesh's block-major order)
        blocks, last = [], []
        for blk in shards(batch, 2):
            p, v = params, velocity
            for _ in range(inner):
                loss_k, g = grad_fn(p, blk)
                p, v = upd(p, g, v, lr)
            blocks.append((p, v))
            last.append(loss_k)
    m, blr = opts.bmuf_momentum, opts.bmuf_learn_rate
    tm = jax.tree_util.tree_map
    p_avg = tm(lambda a, c: (a + c) / 2, blocks[0][0], blocks[1][0])
    delta = tm(lambda a, w: (1.0 - m) * blr * (a - w), p_avg, params)
    w_prev = tm(lambda w, d: w + d, params, delta)
    w_new = tm(lambda w, d: w + m * d, w_prev, delta) if opts.nesterov \
        else w_prev
    w4, prev4, delta4, opt4, loss_b4 = out4
    check("BMUF loss, 4 cards vs block-by-block on 1 card, relative",
          abs(float(loss_b4) - float(sum(last) / 2))
          / abs(float(sum(last) / 2)), 1e-5,
          "f32, matmul precision highest")
    check("BMUF new parameters, max |4 - 1| / max |1| per leaf",
          _tree_rel_err(w4, w_new), 1e-5, "f32, matmul precision highest")
    check("BMUF block snapshot, max |4 - 1| / max |1| per leaf",
          _tree_rel_err(prev4, w_prev), 1e-5,
          "f32, matmul precision highest")
    check("BMUF block-local velocities, max |4 - 1| / max |1| per leaf",
          _tree_rel_err(opt4, tm(lambda a, c: jnp.stack([a, c]),
                                 blocks[0][1], blocks[1][1])), 1e-4,
          "f32, matmul precision highest")

    # ---- steps/s per card: the bf16 flagship, S streams per card
    loss_fn, update, params = make(bf16=True)
    velocity = init_velocity(params)
    rates = {}
    for n in (1, 4):
        mesh_n = make_mesh(("data",), devices=devs[:n])
        step = make_bsp_train_step(loss_fn, update, mesh_n)
        bt = shard_batch(tuple(x[:n * S] for x in batch), mesh_n)
        # replicated on the mesh from the start, as the step returns
        # them: otherwise the second call compiles again
        state = jax.device_put({"p": params, "v": velocity},
                               NamedSharding(mesh_n, P()))

        def run():
            state["p"], state["v"], loss, _ = step(
                state["p"], state["v"], bt, lr)
            return loss
        _, t1, ts = timed(run, reps)
        say_time(f"BSP bf16 step on {n} card(s), {S} streams per card",
                 t1, ts)
        rates[n] = 1.0 / ts
    say(f"  steps/s per card: 1 card {rates[1]:.3f}, 4 cards "
        f"{rates[4]:.3f} (scaling efficiency "
        f"{rates[4] / rates[1]:.3f})")


# ------------------------------------------------------------------ main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the device check and BSP/BMUF on "
                    "four cards")
    args = ap.parse_args(argv)

    from kaldi_aslp_tpu.utils.jax_setup import configure_compile_cache

    cache = configure_compile_cache()
    n_cards = 4 if args.four_cards else 1
    t0 = time.perf_counter()
    devs = phase_device(n_cards)
    say(f"phase device: ok; compile cache {cache}")
    phases = ([("four_cards", lambda: phase_four_cards(devs))]
              if args.four_cards else
              [("ctc", phase_ctc), ("train", phase_train),
               ("decode", phase_decode)])
    for name, fn in phases:
        t1 = time.perf_counter()
        say(f"phase {name}:")
        try:
            fn()
        except Exception as e:
            say(f"phase {name}: FAILED ({type(e).__name__}: {e})")
            raise
        say(f"phase {name}: ok ({time.perf_counter() - t1:.1f} s)")
    say(f"all phases ok ({time.perf_counter() - t0:.1f} s)")
    dev = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
