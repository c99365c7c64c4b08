"""Lattice generation, rescoring and sweep scoring.

JAX-native equivalent of the reference lattice chain (reference:
src/decoder/lattice-faster-decoder.h:96 LatticeFasterDecoder with
ForwardLink records + PruneActiveTokens/GetRawLattice;
src/lat/kaldi-lattice.h CompactLattice with separate graph/acoustic
costs; src/latbin/lattice-best-path.cc; scoring sweep
aslp_scripts/score_basic.sh:49-80 — best path per LMWT then compute-wer).

Instead of pruning tokens online, the lattice falls out of a *full*
forward-backward pass over the dense Viterbi DP: an arc at frame t
survives if α[t−1, src] + score(arc, t) + β[t, dst] is within `beam` of
the global best path — an exact posterior-style pruning the sequential
reference can only approximate.  α comes from the existing Viterbi scan;
β is one more reverse scan.  Graph and acoustic costs are kept separate
so LMWT rescoring works exactly like the reference's."""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.decoder.viterbi import (
    NEG_INF,
    PackedGraph,
    _eps_relax_host,
    _round_up,
    _viterbi_scan,
)
from kaldi_aslp_tpu.ops.edit_distance import ErrorStats, score_utterances
from kaldi_aslp_tpu.utils.log import get_logger


# ---------------------------------------------------------------------------
# eps-free expansion: fold eps prefixes into emitting arcs
# ---------------------------------------------------------------------------

def _eps_closure(graph: PackedGraph):
    """Per-state list of (reachable state, weight, words tuple) via eps
    arcs (bounded by eps diameter; graphs are constructed acyclic in
    eps)."""
    n = graph.num_states
    closure: List[Dict[int, Tuple[float, Tuple[int, ...]]]] = [
        {s: (0.0, ())} for s in range(n)
    ]
    eps_arcs = [[] for _ in range(n)]
    for a in range(len(graph.src)):
        if graph.ilabel[a] == 0:
            eps_arcs[graph.src[a]].append(a)
    for _ in range(max(graph.eps_diameter, 1)):
        changed = False
        for s in range(n):
            for dst0, (w0, words0) in list(closure[s].items()):
                for a in eps_arcs[dst0]:
                    d = int(graph.dst[a])
                    w = w0 + float(graph.weight[a])
                    words = words0 + (
                        (int(graph.olabel[a]),)
                        if graph.olabel[a] > 0 else ()
                    )
                    cur = closure[s].get(d)
                    if cur is None or w < cur[0]:
                        closure[s][d] = (w, words)
                        changed = True
        if not changed:
            break
    return closure


@dataclass
class EpsFreeArc:
    src: int
    dst: int
    tid: int
    words: Tuple[int, ...]
    graph_cost: float   # eps prefix + emitting arc weight


def epsfree_arcs(graph: PackedGraph) -> List[EpsFreeArc]:
    closure = _eps_closure(graph)
    out: List[EpsFreeArc] = []
    for a in range(len(graph.src)):
        if graph.ilabel[a] == 0:
            continue
        src = int(graph.src[a])
        # any eps path u→src can precede this arc
        for u in range(graph.num_states):
            hit = closure[u].get(src)
            if hit is None:
                continue
            w0, words = hit
            if graph.olabel[a] > 0:  # word on the emitting arc itself
                words = words + (int(graph.olabel[a]),)
            out.append(EpsFreeArc(
                u, int(graph.dst[a]), int(graph.ilabel[a]), words,
                w0 + float(graph.weight[a]),
            ))
    return out


# ---------------------------------------------------------------------------
# lattice type
# ---------------------------------------------------------------------------

@dataclass
class LatticeArc:
    t: int                   # frame consumed (arc goes t-1 → t)
    src: int                 # graph state at t-1
    dst: int                 # graph state at t
    tid: int
    words: Tuple[int, ...]
    graph_cost: float
    acoustic_cost: float     # -loglike, UNscaled


@dataclass
class Lattice:
    num_frames: int
    arcs: List[LatticeArc]
    start: int
    final_costs: Dict[int, float]   # graph final costs at t = T

    def num_arcs(self) -> int:
        return len(self.arcs)


@partial(jax.jit, static_argnames=("num_states",))
def _backward_scan(loglikes, final_scores, src, dst, pdf, w,
                   acoustic_scale, num_states: int):
    """β[t, s] = best score from state s at frame t to the end
    (before consuming frame t)."""

    def step(beta_next, ll_t):
        acoustic = acoustic_scale * ll_t[pdf]
        cand = beta_next[dst] - w + acoustic
        beta = jax.ops.segment_max(cand, src, num_segments=num_states)
        beta = jnp.maximum(beta, NEG_INF)
        return beta, beta

    beta_T = final_scores
    _, betas = jax.lax.scan(step, beta_T, loglikes[::-1])
    return betas[::-1]  # betas[t] = β before frame t


def generate_lattice(
    graph: PackedGraph,
    loglikes: np.ndarray,
    tid_to_pdf: np.ndarray,
    acoustic_scale: float = 1.0,
    beam: float = 10.0,
) -> Lattice:
    """Forward-backward pruned lattice (reference: GetRawLattice +
    determinization role; exact at the given beam)."""
    T = len(loglikes)
    ef = epsfree_arcs(graph)
    S = graph.num_states
    src = np.asarray([a.src for a in ef], np.int32)
    dst = np.asarray([a.dst for a in ef], np.int32)
    tid = np.asarray([a.tid for a in ef], np.int32)
    gw = np.asarray([a.graph_cost for a in ef], np.float32)
    pdf = np.asarray(tid_to_pdf)[tid]

    # α: forward best scores BEFORE each frame (α[0] = init)
    init = np.full(S, NEG_INF, np.float32)
    init[graph.start] = 0.0
    ll = jnp.asarray(loglikes, jnp.float32)
    scale = jnp.asarray(acoustic_scale, jnp.float32)

    def fwd_step(alpha, ll_t):
        acoustic = scale * ll_t[jnp.asarray(pdf)]
        cand = alpha[jnp.asarray(src)] - jnp.asarray(gw) + acoustic
        new = jax.ops.segment_max(cand, jnp.asarray(dst),
                                  num_segments=S)
        return jnp.maximum(new, NEG_INF), alpha

    alpha_T, alphas = jax.lax.scan(fwd_step, jnp.asarray(init), ll)
    # alphas[t] = α before frame t; alpha_T = after last frame
    final_scores = np.full(S, NEG_INF, np.float32)
    for s, c in enumerate(graph.final):
        if np.isfinite(c):
            final_scores[s] = -c
    betas = _backward_scan(
        ll, jnp.asarray(final_scores), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(pdf), jnp.asarray(gw), scale, S,
    )
    alphas = np.asarray(alphas)
    betas = np.asarray(betas)
    alpha_T = np.asarray(alpha_T)
    best = float((alpha_T + final_scores).max())
    if not np.isfinite(best) or best <= NEG_INF / 2:
        raise RuntimeError("no complete path; cannot build lattice")

    arcs: List[LatticeArc] = []
    ll_np = np.asarray(loglikes)
    for t in range(T):
        a_t = alphas[t]
        # β after consuming frame t = betas[t+1] conceptually; our
        # betas[t] is "before frame t", so path score =
        # α[t][src] + arc + β[t+1 → betas] ... β before frame t+1:
        beta_next = betas[t + 1] if t + 1 < T else final_scores
        score = (a_t[src] - gw
                 + acoustic_scale * ll_np[t, pdf] + beta_next[dst])
        keep = score >= best - beam
        for i in np.where(keep)[0]:
            arcs.append(LatticeArc(
                t + 1, int(src[i]), int(dst[i]), int(tid[i]),
                ef[i].words, float(gw[i]), float(-ll_np[t, pdf[i]]),
            ))
    finals = {s: float(c) for s, c in enumerate(graph.final)
              if np.isfinite(c)}
    return Lattice(T, arcs, graph.start, finals)


def lattice_best_path(
    lat: Lattice, acoustic_scale: float = 1.0, lm_scale: float = 1.0
) -> Tuple[List[int], float]:
    """(reference: lattice-best-path.cc) — DP over the lattice with
    rescaled costs; returns (words, total cost)."""
    NEG = -1e30
    # nodes indexed (t, state) sparsely
    score: Dict[Tuple[int, int], float] = {(0, lat.start): 0.0}
    back: Dict[Tuple[int, int], Tuple] = {}
    arcs_by_t: Dict[int, List[LatticeArc]] = {}
    for a in lat.arcs:
        arcs_by_t.setdefault(a.t, []).append(a)
    for t in range(1, lat.num_frames + 1):
        for a in arcs_by_t.get(t, ()):  # consume frame t-1
            prev = score.get((t - 1, a.src))
            if prev is None:
                continue
            s = prev - lm_scale * a.graph_cost \
                - acoustic_scale * a.acoustic_cost
            key = (t, a.dst)
            if s > score.get(key, NEG):
                score[key] = s
                back[key] = a
    best_key, best_val = None, NEG
    for s, c in lat.final_costs.items():
        v = score.get((lat.num_frames, s), NEG) - lm_scale * c
        if v > best_val:
            best_key, best_val = (lat.num_frames, s), v
    if best_key is None:
        raise RuntimeError("lattice has no complete path")
    words_rev: List[int] = []
    key = best_key
    while key in back:
        a = back[key]
        words_rev.extend(reversed(a.words))
        key = (key[0] - 1, a.src)
    return list(reversed(words_rev)), -best_val


def score_lmwt_sweep(
    lattices: Dict[str, Lattice],
    refs: Dict[str, List[int]],
    lmwt_range=range(5, 16),
    acoustic_scale_base: float = 1.0,
) -> Dict[int, ErrorStats]:
    """(reference: score_basic.sh) — best-path per LMWT, WER each."""
    out: Dict[int, ErrorStats] = {}
    warned: set = set()
    for lmwt in lmwt_range:
        hyps = {}
        for utt, lat in lattices.items():
            try:
                words, _ = lattice_best_path(
                    lat, acoustic_scale=acoustic_scale_base / lmwt,
                    lm_scale=1.0,
                )
            except RuntimeError:
                # empty/path-less lattice: score an empty hypothesis
                # instead of aborting the whole sweep (the reference's
                # lattice-best-path warns "No output for utterance" and
                # the scoring counts every ref word as a deletion)
                words = []
                if utt not in warned:
                    warned.add(utt)
                    get_logger("lattice").warning(
                        "no complete path in lattice for %s; "
                        "scoring empty hypothesis", utt)
            hyps[utt] = words
        out[lmwt] = score_utterances(refs, hyps)
    return out
