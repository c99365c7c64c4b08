"""Incremental (online) Viterbi decoding.

JAX-native equivalent of the reference online decoder (reference:
src/aslp-online/online-nnet-decoder.h:66 MultiUtteranceNnetDecoder with
AdvanceDecoding/FinalizeDecoding/GetBestPath/ResetDecoder over
LatticeFasterOnlineDecoder).

Wraps the dense Viterbi scan so scores advance chunk-by-chunk: the state
vector is the carry, per-chunk backpointers accumulate host-side, and
partial results backtrace from the current best state without
finalizing."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from kaldi_aslp_tpu.decoder.viterbi import (
    NEG_INF,
    PackedGraph,
    ViterbiDecoder,
    _eps_relax_host,
    _round_up,
    _viterbi_scan,
)


class OnlineViterbiDecoder(ViterbiDecoder):
    """advance_decoding(chunk) / partial / finalize / reset."""

    def __init__(self, graph: PackedGraph, tid_to_pdf, acoustic_scale=1.0,
                 chunk_bucket: int = 64):
        super().__init__(graph, tid_to_pdf, acoustic_scale)
        self.chunk_bucket = chunk_bucket
        self.reset()

    def reset(self) -> None:
        """(reference: ResetDecoder — next utterance)."""
        g = self.graph
        S = self._num_states_padded
        init = np.full(S, NEG_INF, np.float32)
        init[g.start] = 0.0
        self._init_bp = np.full(S, -1, np.int64)
        init, self._init_bp = _eps_relax_host(
            init, self._init_bp, self._ep, g.eps_diameter
        )
        self._scores = init
        self._bps: List[np.ndarray] = []
        self.num_frames_decoded = 0

    def advance_decoding(self, loglikes: np.ndarray) -> None:
        """Consume [T_chunk, P] acoustic scores."""
        T = len(loglikes)
        if T == 0:
            return
        g = self.graph
        em_src, em_dst, em_il, em_w, em_idx = self._em
        ep_src, ep_dst, ep_w, ep_idx = self._ep
        Tp = _round_up(T, self.chunk_bucket)
        ll = np.zeros((Tp, loglikes.shape[1]), np.float32)
        ll[:T] = loglikes
        valid = np.zeros(Tp, np.float32)
        valid[:T] = 1.0
        scores, bps, _alphas = _viterbi_scan(
            jnp.asarray(ll), jnp.asarray(self._scores),
            jnp.asarray(em_src), jnp.asarray(em_dst),
            jnp.asarray(self.tid_to_pdf[em_il]),
            jnp.asarray(em_w), jnp.asarray(em_idx),
            jnp.asarray(ep_src), jnp.asarray(ep_dst),
            jnp.asarray(ep_w), jnp.asarray(ep_idx),
            jnp.asarray(self.acoustic_scale, jnp.float32),
            self._num_states_padded, max(g.eps_diameter, 1),
            jnp.asarray(valid),
        )
        self._scores = np.asarray(scores)
        self._bps.extend(np.asarray(bps)[:T])
        self.num_frames_decoded += T

    def _backtrace(self, end_state: int) -> Tuple[List[int], np.ndarray]:
        T = self.num_frames_decoded
        ali = np.zeros(T, np.int32)
        words_rev: List[int] = []
        s = end_state
        t = T - 1
        while t >= 0:
            a = int(self._bps[t][s])
            if a < 0:
                break
            if self.graph.olabel[a] > 0:
                words_rev.append(int(self.graph.olabel[a]))
            if self.graph.ilabel[a] > 0:
                ali[t] = self.graph.ilabel[a]
                t -= 1
            s = int(self.graph.src[a])
        while s != self.graph.start:
            a = int(self._init_bp[s])
            if a < 0:
                break
            if self.graph.olabel[a] > 0:
                words_rev.append(int(self.graph.olabel[a]))
            s = int(self.graph.src[a])
        return list(reversed(words_rev)), ali

    def get_partial_path(self) -> List[int]:
        """Best words so far, from the currently-best state (may change
        as more audio arrives — the reference's partial result)."""
        if self.num_frames_decoded == 0:
            return []
        end = int(np.argmax(self._scores))
        return self._backtrace(end)[0]

    def finalize_decoding(self) -> Tuple[List[int], np.ndarray, float]:
        """Require a final state (reference: FinalizeDecoding +
        GetBestPath with final costs)."""
        g = self.graph
        final_cost = np.full(self._num_states_padded, np.inf, np.float32)
        final_cost[:g.num_states] = g.final
        total = self._scores - np.where(np.isinf(final_cost), np.inf,
                                        final_cost)
        end = int(np.argmax(total))
        if not np.isfinite(total[end]) or total[end] <= NEG_INF:
            # no reachable final state: fall back to best partial
            end = int(np.argmax(self._scores))
            words, ali = self._backtrace(end)
            return words, ali, float(self._scores[end])
        words, ali = self._backtrace(end)
        return words, ali, float(total[end])

    def final_relative_cost(self) -> float:
        """Relative cost of final states: 0 when a final state has the
        best score this frame, +inf when no final state is reachable
        (reference: lattice-faster-online-decoder FinalRelativeCost,
        consumed by online-endpoint.cc EndpointDetected)."""
        if self.num_frames_decoded == 0:
            return float("inf")
        g = self.graph
        final_cost = np.full(self._num_states_padded, np.inf, np.float32)
        final_cost[:g.num_states] = g.final
        with np.errstate(invalid="ignore"):
            total = self._scores - final_cost
        best_final = float(np.max(np.nan_to_num(total, nan=-np.inf)))
        best_any = float(np.max(self._scores))
        if not np.isfinite(best_final) or best_final <= NEG_INF:
            return float("inf")
        return max(0.0, best_any - best_final)

    def trailing_silence_frames(self, sil_tids: np.ndarray) -> int:
        """Frames of silence at the end of the current best path
        (endpointing input, reference: online-endpoint.cc
        TrailingSilenceLength)."""
        if self.num_frames_decoded == 0:
            return 0
        end = int(np.argmax(self._scores))
        _, ali = self._backtrace(end)
        sil = set(int(t) for t in np.asarray(sil_tids).reshape(-1))
        count = 0
        for tid in ali[::-1]:
            if int(tid) in sil or int(tid) == 0:
                count += 1
            else:
                break
        return count
