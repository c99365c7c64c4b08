"""Device-side Viterbi over packed WFST arc arrays.

JAX-native re-design of the reference's token-passing decoders
(reference: src/decoder/faster-decoder.h:61 FasterDecoder with hashed
active states, ProcessEmitting/ProcessNonemitting; align use via
gmm-align-compiled / decoder-wrappers.cc).

Instead of a hash map of active tokens, the DP is dense over graph
states: per frame one segment-max over the emitting arcs (a gather +
scatter-max, executed as vector ops) followed by K rounds of
epsilon relaxation (K = the graph's eps diameter, computed at pack
time).  Backpointers are arc indices; backtrace is host-side.  Dense DP
is exact (no beam) and is the right trade for bootstrap-scale graphs;
beam-pruned batched search for large HCLGs lives in
decoder/batched.py."""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.fst.fst import Fst

NEG_INF = -1e30


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass
class PackedGraph:
    """Host-side packed form of an Fst for device DP."""

    src: np.ndarray
    dst: np.ndarray
    ilabel: np.ndarray   # transition-ids; 0 = eps
    olabel: np.ndarray
    weight: np.ndarray   # costs (-log prob)
    final: np.ndarray    # [S] final costs (inf = non-final)
    start: int
    num_states: int
    eps_diameter: int

    @classmethod
    def from_fst(cls, fst: Fst) -> "PackedGraph":
        arrs = fst.to_arrays()
        eps_mask = arrs["ilabel"] == 0
        diameter = _eps_diameter(
            arrs["src"][eps_mask], arrs["dst"][eps_mask],
            arrs["num_states"],
        )
        return cls(
            src=arrs["src"], dst=arrs["dst"], ilabel=arrs["ilabel"],
            olabel=arrs["olabel"], weight=arrs["weight"],
            final=arrs["final"], start=arrs["start"],
            num_states=arrs["num_states"], eps_diameter=diameter,
        )


def _eps_diameter(src: np.ndarray, dst: np.ndarray, n: int) -> int:
    """Longest eps-arc chain.  The scan does exactly this many
    relaxation rounds per frame, so under-estimating it silently
    produces wrong scores — eps cycles (which have no finite diameter)
    are a hard error; run remove-eps/determinize on the graph first."""
    if len(src) == 0:
        return 0
    depth = np.zeros(n, np.int32)
    for _ in range(n + 1):
        new = depth.copy()
        np.maximum.at(new, dst, depth[src] + 1)
        if (new == depth).all():
            return int(depth.max())
        depth = new
    raise ValueError(
        "epsilon-cycle detected in decode graph: epsilon relaxation does "
        "not converge; remove epsilon cycles (determinize/rmepsilon) "
        "before packing")


def _split(graph: PackedGraph):
    em = graph.ilabel > 0
    ep = ~em
    return (
        (graph.src[em], graph.dst[em], graph.ilabel[em],
         graph.weight[em], np.where(em)[0]),
        (graph.src[ep], graph.dst[ep], graph.weight[ep], np.where(ep)[0]),
    )


def _eps_relax_host(scores: np.ndarray, bp: np.ndarray,
                    eps_arcs, iters: int):
    """Host epsilon relaxation for the initial state distribution."""
    src, dst, w, idx = eps_arcs
    for _ in range(max(iters, 1)):
        if len(src) == 0:
            break
        cand = scores[src] - w
        for a in range(len(src)):
            if cand[a] > scores[dst[a]]:
                scores[dst[a]] = cand[a]
                bp[dst[a]] = idx[a]
    return scores, bp


@partial(jax.jit, static_argnames=("num_states", "eps_iters"))
def _viterbi_scan(
    loglikes,          # [T, P] acoustic log-likelihoods
    init_scores,       # [S]
    em_src, em_dst, em_pdf, em_w, em_idx,
    ep_src, ep_dst, ep_w, ep_idx,
    acoustic_scale,
    num_states: int,
    eps_iters: int,
    valid_mask=None,
):
    """Returns (final_scores [S], bp [T, S] int32 arc ids)."""

    def seg_max_arg(cand, dst, arc_ids, cur, cur_bp):
        best = jax.ops.segment_max(cand, dst, num_segments=num_states)
        best = jnp.maximum(best, NEG_INF)
        improved = best > cur
        new_scores = jnp.where(improved, best, cur)
        # winning arc id per state
        is_best = cand >= best[dst] - 1e-6
        winner = jax.ops.segment_max(
            jnp.where(is_best, arc_ids, -1), dst,
            num_segments=num_states,
        )
        new_bp = jnp.where(improved, winner, cur_bp)
        return new_scores, new_bp

    def frame(carry, inp):
        ll_t, valid_t = inp
        scores = carry
        acoustic = acoustic_scale * ll_t[em_pdf]           # [A_em]
        cand = scores[em_src] - em_w + acoustic
        new_scores = jax.ops.segment_max(
            cand, em_dst, num_segments=num_states
        )
        new_scores = jnp.maximum(new_scores, NEG_INF)
        is_best = cand >= new_scores[em_dst] - 1e-6
        bp = jax.ops.segment_max(
            jnp.where(is_best, em_idx, -1), em_dst,
            num_segments=num_states,
        )
        bp = jnp.where(new_scores > NEG_INF, bp, -1)
        # epsilon relaxation to fixed point
        def relax(_i, sb):
            s, b = sb
            cand_e = s[ep_src] - ep_w
            return seg_max_arg(cand_e, ep_dst, ep_idx, s, b)
        if len(ep_src) > 0:
            new_scores, bp = jax.lax.fori_loop(
                0, eps_iters, relax, (new_scores, bp)
            )
        # padding frames (valid=0) are no-ops so T can be bucketed
        new_scores = jnp.where(valid_t, new_scores, scores)
        bp = jnp.where(valid_t, bp, -1)
        return new_scores, (new_scores, bp)

    T = loglikes.shape[0]
    valid = valid_mask[:, None] if valid_mask is not None else jnp.ones(
        (T, 1), jnp.float32
    )
    final_scores, (all_scores, bps) = jax.lax.scan(
        frame, init_scores, (loglikes, valid > 0)
    )
    return final_scores, bps, all_scores


class ViterbiDecoder:
    """Exact Viterbi decode/align over a packed graph.

    decode(loglikes) → (words, alignment, score); loglikes are [T, P]
    per-pdf acoustic log-likelihoods (tid→pdf mapping supplied as a
    LUT, reference: DecodableAmDiagGmmScaled / DecodableMatrixScaledMapped
    semantics)."""

    def __init__(self, graph: PackedGraph, tid_to_pdf: np.ndarray,
                 acoustic_scale: float = 1.0,
                 word_ins_penalty: float = 0.0):
        self.graph = graph
        self.tid_to_pdf = np.asarray(tid_to_pdf, np.int32)
        self.acoustic_scale = float(acoustic_scale)
        if word_ins_penalty:
            # extra cost on every word-emitting arc (reference:
            # --word-ins-penalty in the scoring sweep)
            graph = PackedGraph(
                graph.src, graph.dst, graph.ilabel, graph.olabel,
                graph.weight + word_ins_penalty * (graph.olabel > 0),
                graph.final, graph.start, graph.num_states,
                graph.eps_diameter,
            )
            self.graph = graph
        self._em, self._ep = _split(graph)
        # bucket arc counts and state count so graphs of similar size
        # share one XLA compile (padding arcs have huge cost → no-ops)
        self._em = self._pad_em(self._em)
        self._ep = self._pad_ep(self._ep)
        self._num_states_padded = _round_up(max(graph.num_states, 1), 64)

    @staticmethod
    def _pad_em(em, bucket: int = 256):
        src, dst, il, w, idx = em
        n = _round_up(max(len(src), 1), bucket)
        pad = n - len(src)
        if pad == 0:
            return em
        return (
            np.concatenate([src, np.zeros(pad, src.dtype)]),
            np.concatenate([dst, np.zeros(pad, dst.dtype)]),
            np.concatenate([il, np.zeros(pad, il.dtype)]),
            np.concatenate([w, np.full(pad, 1e30, w.dtype)]),
            np.concatenate([idx, np.full(pad, -1, idx.dtype)]),
        )

    @staticmethod
    def _pad_ep(ep, bucket: int = 64):
        src, dst, w, idx = ep
        n = _round_up(max(len(src), 1), bucket)
        pad = n - len(src)
        if pad == 0:
            return ep
        return (
            np.concatenate([src, np.zeros(pad, src.dtype)]),
            np.concatenate([dst, np.zeros(pad, dst.dtype)]),
            np.concatenate([w, np.full(pad, 1e30, w.dtype)]),
            np.concatenate([idx, np.full(pad, -1, idx.dtype)]),
        )

    def _init(self) -> Tuple[np.ndarray, np.ndarray]:
        """Start-state scores + host eps closure backpointers."""
        g = self.graph
        S = self._num_states_padded
        init = np.full(S, NEG_INF, np.float32)
        init[g.start] = 0.0
        init_bp = np.full(S, -1, np.int64)
        return _eps_relax_host(init, init_bp, self._ep, g.eps_diameter)

    def decode(self, loglikes: np.ndarray
               ) -> Tuple[List[int], np.ndarray, float]:
        g = self.graph
        T = loglikes.shape[0]
        em_src, em_dst, em_il, em_w, em_idx = self._em
        ep_src, ep_dst, ep_w, ep_idx = self._ep

        S = self._num_states_padded
        init, init_bp = self._init()

        if T > 0:
            # bucket T so one compile serves many utterance lengths
            bucket = 128
            Tp = int(np.ceil(T / bucket)) * bucket
            ll = np.zeros((Tp, loglikes.shape[1]), np.float32)
            ll[:T] = loglikes
            valid = np.zeros(Tp, np.float32)
            valid[:T] = 1.0
            final_scores, bps, _alphas = _viterbi_scan(
                jnp.asarray(ll), jnp.asarray(init),
                jnp.asarray(em_src), jnp.asarray(em_dst),
                jnp.asarray(self.tid_to_pdf[em_il]),
                jnp.asarray(em_w), jnp.asarray(em_idx),
                jnp.asarray(ep_src), jnp.asarray(ep_dst),
                jnp.asarray(ep_w), jnp.asarray(ep_idx),
                jnp.asarray(self.acoustic_scale, jnp.float32),
                S, max(g.eps_diameter, 1),
                jnp.asarray(valid),
            )
            final_scores = np.asarray(final_scores)
            bps = np.asarray(bps)[:T]
        else:
            final_scores, bps = init, np.zeros((0, S), np.int64)
        return self._finish(final_scores, bps, T, init_bp)

    def _finish(self, final_scores: np.ndarray, bps: np.ndarray,
                T: int, init_bp: np.ndarray
                ) -> Tuple[List[int], np.ndarray, float]:
        """Final-state selection + host backtrace through arc-id
        backpointers (shared by :meth:`decode` and
        :func:`align_batched`)."""
        g = self.graph
        S = self._num_states_padded
        final_cost = np.full(S, np.inf, np.float32)
        final_cost[:g.num_states] = g.final
        total = final_scores - np.where(
            np.isinf(final_cost), np.inf, final_cost
        )
        end_state = int(np.argmax(total))
        if not np.isfinite(total[end_state]) or total[end_state] <= NEG_INF:
            raise RuntimeError("no complete path found (empty decode)")

        ali = np.zeros(T, np.int32)
        words_rev: List[int] = []
        s = end_state
        t = T - 1
        while t >= 0:
            a = int(bps[t, s]) if t >= 0 else -1
            if a < 0:
                raise RuntimeError(f"broken backpointer at t={t} s={s}")
            if self.graph.olabel[a] > 0:
                words_rev.append(int(self.graph.olabel[a]))
            if self.graph.ilabel[a] > 0:
                ali[t] = self.graph.ilabel[a]
                t -= 1
            s = int(self.graph.src[a])
        # initial epsilon chain (before frame 0)
        while s != self.graph.start:
            a = int(init_bp[s])
            if a < 0:
                break
            if self.graph.olabel[a] > 0:
                words_rev.append(int(self.graph.olabel[a]))
            s = int(self.graph.src[a])
        return list(reversed(words_rev)), ali, float(total[end_state])


@partial(jax.jit, static_argnames=("num_states", "eps_iters"))
def _viterbi_scan_batched(loglikes, init_scores,
                          em_src, em_dst, em_pdf, em_w, em_idx,
                          ep_src, ep_dst, ep_w, ep_idx,
                          acoustic_scale,
                          num_states: int, eps_iters: int, valid_mask):
    """[B, ...]-stacked :func:`_viterbi_scan`: B utterances with B
    DIFFERENT (bucketed-same-shape) training graphs in one program."""
    def one(ll, ini, es, ed, epf, ew, ei, ps, pd, pw, pi, v):
        fs, bp, _alphas = _viterbi_scan(
            ll, ini, es, ed, epf, ew, ei, ps, pd, pw, pi,
            acoustic_scale, num_states, eps_iters, v)
        return fs, bp

    return jax.vmap(one)(loglikes, init_scores, em_src, em_dst, em_pdf,
                         em_w, em_idx, ep_src, ep_dst, ep_w, ep_idx,
                         valid_mask)


def align_batched(graphs: dict, tid_to_pdf: np.ndarray,
                  loglikes: dict, acoustic_scale: float = 1.0,
                  batch: int = 16) -> dict:
    """Exact Viterbi alignment of MANY utterances, each over its OWN
    per-utterance training graph, batched into one device program per
    shape bucket (the gmm-align-compiled role at corpus granularity —
    reference: steps/align_si.sh driving one process per job).

    Per-utterance alignment dispatches leave the device idle between
    a handful of round trips per utterance.  Batching amortizes the
    dispatch+fetch over ``batch`` utterances and lets the [B, T, S] DP
    fill the device.

    ``graphs``/``loglikes``: dicts utt → PackedGraph / [T, P] array.
    Returns utt → (words, alignment, score) like ViterbiDecoder.decode.
    Graphs are bucketed by (padded T, padded S, padded arc counts) so a
    handful of compiles serve a whole corpus."""
    decs = {}
    for u, g in graphs.items():
        if not isinstance(g, PackedGraph):
            g = PackedGraph.from_fst(g)
        decs[u] = ViterbiDecoder(g, tid_to_pdf, acoustic_scale)

    T_BUCKET = 128
    groups: dict = {}
    for u, dec in decs.items():
        T = len(loglikes[u])
        Tp = max(1, int(np.ceil(T / T_BUCKET))) * T_BUCKET
        sig = (Tp, dec._num_states_padded,
               len(dec._em[0]), len(dec._ep[0]))
        groups.setdefault(sig, []).append(u)

    out = {}
    for (Tp, S, Aem, Aep), utts in sorted(groups.items()):
        eps_iters = max(max(decs[u].graph.eps_diameter
                            for u in utts), 1)
        for i0 in range(0, len(utts), batch):
            chunk = utts[i0:i0 + batch]
            B = len(chunk)
            rows = chunk + [chunk[0]] * (batch - B)  # pad to one compile
            lls = np.zeros((batch, Tp, loglikes[chunk[0]].shape[1]),
                           np.float32)
            valid = np.zeros((batch, Tp), np.float32)
            inits = np.zeros((batch, S), np.float32)
            init_bps = []
            em = [np.zeros((batch, Aem), np.int32) for _ in range(3)] \
                + [np.zeros((batch, Aem), np.float32),
                   np.zeros((batch, Aem), np.int64)]
            ep = [np.zeros((batch, Aep), np.int32) for _ in range(2)] \
                + [np.zeros((batch, Aep), np.float32),
                   np.zeros((batch, Aep), np.int64)]
            for j, u in enumerate(rows):
                dec = decs[u]
                T = len(loglikes[u])
                lls[j, :T] = loglikes[u]
                valid[j, :T] = 1.0
                ini, ibp = dec._init()
                inits[j] = ini
                if j < B:
                    init_bps.append(ibp)
                es, ed, eil, ew, ei = dec._em
                em[0][j], em[1][j] = es, ed
                em[2][j] = dec.tid_to_pdf[eil]
                em[3][j], em[4][j] = ew, ei
                ps, pd, pw, pi = dec._ep
                ep[0][j], ep[1][j] = ps, pd
                ep[2][j], ep[3][j] = pw, pi
            finals, bps = _viterbi_scan_batched(
                jnp.asarray(lls), jnp.asarray(inits),
                *(jnp.asarray(a) for a in em),
                *(jnp.asarray(a) for a in ep),
                jnp.asarray(acoustic_scale, jnp.float32),
                S, eps_iters, jnp.asarray(valid))
            finals = np.asarray(finals)
            bps = np.asarray(bps)
            for j, u in enumerate(chunk):
                T = len(loglikes[u])
                out[u] = decs[u]._finish(finals[j], bps[j][:T], T,
                                         init_bps[j])
    return out


def equal_align(graph_fst: Fst, trans_model, num_frames: int,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Uniform initial alignment (reference: bin/align-equal-compiled.cc):
    pick a path through the graph and stretch it over num_frames by
    inserting self-loops.

    The path chosen is the LONGEST acyclic path fitting num_frames, so
    optional-silence branches are taken and silence models receive
    occupancy from iteration 0 (the reference gets this from its random
    path choice + --boost-silence)."""
    # longest-emitting-arcs path over the graph's DFS-forward DAG
    # (back edges — e.g. the 5-state silence topology's backward
    # transitions — are dropped; they never extend a simple path anyway)
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {graph_fst.start: GRAY}
    order = []
    dag_arcs = []  # (src, arc) with no self-loops / back edges
    stack = [(graph_fst.start, iter(graph_fst.arcs[graph_fst.start]))]
    while stack:
        s, it = stack[-1]
        advanced = False
        for a in it:
            if a.nextstate == s:
                continue
            c = color.get(a.nextstate, WHITE)
            if c == GRAY:
                continue  # back edge
            dag_arcs.append((s, a))
            if c == WHITE:
                color[a.nextstate] = GRAY
                stack.append(
                    (a.nextstate, iter(graph_fst.arcs[a.nextstate]))
                )
                advanced = True
                break
        if not advanced:
            color[s] = BLACK
            order.append(s)
            stack.pop()
    topo_pos = {s: i for i, s in enumerate(reversed(order))}
    dag_by_src: Dict[int, list] = {}
    for s, a in dag_arcs:
        dag_by_src.setdefault(s, []).append(a)
    best_len: Dict[int, int] = {graph_fst.start: 0}
    prev: Dict[int, Tuple[int, "object"]] = {graph_fst.start: (-1, None)}
    for s in sorted(topo_pos, key=topo_pos.get):
        if s not in best_len:
            continue
        for a in dag_by_src.get(s, ()):
            emit = 1 if a.ilabel > 0 else 0
            cand = best_len[s] + emit
            if cand > best_len.get(a.nextstate, -1) and \
                    cand <= num_frames:
                best_len[a.nextstate] = cand
                prev[a.nextstate] = (s, a)
    finals = [s for s in graph_fst.finals if s in best_len]
    if not finals:
        raise RuntimeError("graph has no accepting path within frames")
    end = max(finals, key=lambda s: best_len[s])
    path = []
    s = end
    while prev[s][1] is not None:
        p, a = prev[s]
        path.append(a)
        s = p
    path.reverse()
    emitting = [a for a in path if a.ilabel > 0]
    n = len(emitting)
    if n == 0 or num_frames < n:
        raise RuntimeError(
            f"cannot equal-align {n} states into {num_frames} frames"
        )
    # distribute extra frames as self-loops after each emitting arc
    base = num_frames // n
    extra = num_frames % n
    ali = []
    for i, a in enumerate(emitting):
        count = base + (1 if i < extra else 0)
        ts, _ = trans_model.tid_to_arc(a.ilabel)
        self_tid = None
        for ai, (dest, _p) in enumerate(trans_model.arcs_of(ts)):
            if dest == trans_model.states[ts].hmm_state:
                self_tid = trans_model.pair_to_tid(ts, ai)
                break
        # occupying a state for k frames consumes (k-1) self-loop arcs
        # then the forward arc (all emit the state's pdf)
        if count > 1:
            if self_tid is None:
                raise RuntimeError("state has no self-loop for stretching")
            ali.extend([self_tid] * (count - 1))
        ali.append(a.ilabel)
    return np.asarray(ali, np.int32)
