"""Batched decoding: many utterances through one jitted Viterbi.

JAX-native equivalent of the reference's decode-time parallelism
(reference: run.pl JOB=1:nj ark-sharded latgen-faster-mapped processes +
latgen-faster-mapped-parallel --num-threads, decode.sh:93-134).  Here
the parallel axis is the batch: utterances are padded to a shared
T bucket and the dense Viterbi scan is vmapped over the batch, so one
device pass decodes the whole batch; host backtrace per utterance.

For bootstrap-scale graphs this is exact; pruned search for very large
HCLGs is future work (a top-k compaction of the same scan)."""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.decoder.viterbi import (
    NEG_INF,
    PackedGraph,
    ViterbiDecoder,
    _eps_relax_host,
    _round_up,
    _viterbi_scan,
)


class BatchedViterbiDecoder(ViterbiDecoder):
    """decode_batch: [B, T_max, P] + lengths → per-utt (words, ali)."""

    @partial(jax.jit, static_argnums=0)
    def _scan_batch(self, ll, valid, init):
        em_src, em_dst, em_il, em_w, em_idx = self._em
        ep_src, ep_dst, ep_w, ep_idx = self._ep
        g = self.graph

        def one(ll_i, valid_i):
            return _viterbi_scan(
                ll_i, jnp.asarray(init),
                jnp.asarray(em_src), jnp.asarray(em_dst),
                jnp.asarray(self.tid_to_pdf[em_il]),
                jnp.asarray(em_w), jnp.asarray(em_idx),
                jnp.asarray(ep_src), jnp.asarray(ep_dst),
                jnp.asarray(ep_w), jnp.asarray(ep_idx),
                jnp.asarray(self.acoustic_scale, jnp.float32),
                self._num_states_padded, max(g.eps_diameter, 1),
                valid_i,
            )
        return jax.vmap(one)(ll, valid)

    def decode_batch(
        self,
        loglikes: List[np.ndarray],
        bucket: int = 128,
    ) -> List[Tuple[List[int], np.ndarray, float]]:
        g = self.graph
        B = len(loglikes)
        T_max = _round_up(max(len(x) for x in loglikes), bucket)
        P = loglikes[0].shape[1]
        ll = np.zeros((B, T_max, P), np.float32)
        valid = np.zeros((B, T_max), np.float32)
        for i, x in enumerate(loglikes):
            ll[i, :len(x)] = x
            valid[i, :len(x)] = 1.0

        S = self._num_states_padded
        init = np.full(S, NEG_INF, np.float32)
        init[g.start] = 0.0
        init_bp = np.full(S, -1, np.int64)
        init, init_bp = _eps_relax_host(init, init_bp, self._ep,
                                        g.eps_diameter)

        final_scores, bps, _ = self._scan_batch(
            jnp.asarray(ll), jnp.asarray(valid), init
        )
        final_scores = np.asarray(final_scores)
        bps = np.asarray(bps)

        final_cost = np.full(S, np.inf, np.float32)
        final_cost[:g.num_states] = g.final
        results = []
        for i, x in enumerate(loglikes):
            T = len(x)
            total = final_scores[i] - np.where(
                np.isinf(final_cost), np.inf, final_cost
            )
            end = int(np.argmax(total))
            if not np.isfinite(total[end]) or total[end] <= NEG_INF:
                raise RuntimeError(f"utt {i}: no complete path")
            words, ali = self._backtrace_one(bps[i], init_bp, end, T)
            results.append((words, ali, float(total[end])))
        return results

    def _backtrace_one(self, bps, init_bp, end_state, T):
        ali = np.zeros(T, np.int32)
        words_rev: List[int] = []
        s = end_state
        t = T - 1
        while t >= 0:
            a = int(bps[t][s])
            if a < 0:
                raise RuntimeError(f"broken backpointer t={t} s={s}")
            if self.graph.olabel[a] > 0:
                words_rev.append(int(self.graph.olabel[a]))
            if self.graph.ilabel[a] > 0:
                ali[t] = self.graph.ilabel[a]
                t -= 1
            s = int(self.graph.src[a])
        while s != self.graph.start:
            a = int(init_bp[s])
            if a < 0:
                break
            if self.graph.olabel[a] > 0:
                words_rev.append(int(self.graph.olabel[a]))
            s = int(self.graph.src[a])
        return list(reversed(words_rev)), ali
