"""Beam-pruned token-passing decoder over CSR-packed arcs, on device.

JAX-native re-design of the reference's pruned decoders (reference:
src/decoder/faster-decoder.h:61-174 FasterDecoder — hashed active
tokens, adaptive beam, max-active; src/decoder/lattice-faster-decoder.h:
96-364 LatticeFasterDecoder — ForwardLink records, PruneActiveTokens;
driven from src/bin/latgen-faster-mapped.cc).

Where the reference keeps a dynamic hash map of active states, this
version keeps a FIXED-size frontier of K = max_active tokens and
re-expresses every step as static-shape vector ops inside one
``lax.scan`` over frames:

  1. *expansion*: out-arcs of the frontier are enumerated by exclusive-
     cumsum over per-state degrees + a monotone-rank segment fill into
     a fixed arc budget A (the frontier is score-sorted, so on overflow
     the worst tokens lose their arcs first — the analogue of
     adaptive-beam tightening);
  2. *beam prune*: candidates below ``best - beam`` are masked;
  3. *dedup*: sort candidates by (destination, -score); the first entry
     of each destination run is its exact per-state max.  Scatter-free:
     a sort is one vectorized op where a scatter-max serializes on
     colliding destinations;
  4. *max-active prune*: ``lax.top_k`` over the A candidates → the new
     frontier, emitted with (arc id, previous slot) backpointers;
  5. *epsilon stages*: ``eps_diameter`` further expansion+merge rounds
     over the eps-arc CSR (the ProcessNonemitting equivalent), each
     emitting its own backpointer plane so host backtrace can walk
     through within-frame eps chains.

Everything is bucketed/static so one XLA compile serves all utterances;
per-chunk host pulls keep memory bounded for arbitrarily long audio.
Lattice records (all surviving candidate arcs per stage, with graph and
acoustic costs separable by arc id) feed decoder/lattice.py's Lattice
type for LMWT sweeps, MBR and n-best exactly like the dense path."""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.decoder.viterbi import NEG_INF, PackedGraph
from kaldi_aslp_tpu.decoder.lattice import Lattice, LatticeArc
from kaldi_aslp_tpu.utils.log import get_logger

# Design note: the per-frame cost is op EXECUTION (each op's fixed
# launch latency), which lax.scan unrolling does not reduce; lowering
# the op count per frame does (e.g. the 5 record fields packed into one
# scan output).


@dataclass
class CsrGraph:
    """Arc arrays grouped by source state (emitting / epsilon split).

    ``*_arc``: index into the original PackedGraph arc arrays, so
    olabels and exact weights stay addressable from records."""

    em_row_ptr: np.ndarray   # [S+1]
    em_dst: np.ndarray
    em_tid: np.ndarray
    em_olabel: np.ndarray
    em_weight: np.ndarray
    em_arc: np.ndarray
    ep_row_ptr: np.ndarray   # [S+1]
    ep_dst: np.ndarray
    ep_olabel: np.ndarray
    ep_weight: np.ndarray
    ep_arc: np.ndarray
    final: np.ndarray        # [S] costs, inf = non-final
    start: int
    num_states: int
    eps_diameter: int
    packed: PackedGraph

    @classmethod
    def from_packed(cls, g: PackedGraph) -> "CsrGraph":
        S = g.num_states
        # within each state's row, arcs are sorted by weight ascending:
        # capping a state's expansion at K (max-active) is then EXACT —
        # of a single source's candidates only its K cheapest can ever
        # be among the K winners — which is what lets hub states (a
        # word-loop start state has out-degree ≈ vocabulary) live with
        # a small arc budget instead of forcing A ≈ max out-degree
        order = np.lexsort((g.weight, g.src))

        def csr(mask):
            ids = order[mask[order]]
            counts = np.bincount(g.src[ids], minlength=S)
            row_ptr = np.zeros(S + 1, np.int32)
            np.cumsum(counts, out=row_ptr[1:])
            return row_ptr, ids.astype(np.int32)

        em_ptr, em_ids = csr(g.ilabel > 0)
        ep_ptr, ep_ids = csr(g.ilabel == 0)

        def family(ids, tid):
            """Arc field arrays; an empty family gets one unreachable
            sentinel arc (no row_ptr covers index 0, so it is never a
            candidate) — zero-length arrays break XLA's gathers."""
            if len(ids):
                return (g.dst[ids].astype(np.int32),
                        g.ilabel[ids].astype(np.int32) if tid else
                        g.olabel[ids].astype(np.int32),
                        g.olabel[ids].astype(np.int32),
                        g.weight[ids].astype(np.float32),
                        ids.astype(np.int32))
            return (np.asarray([g.start], np.int32),
                    np.zeros(1, np.int32), np.zeros(1, np.int32),
                    np.asarray([1e30], np.float32),
                    np.zeros(1, np.int32))

        em_dst, em_tid, em_ol, em_w, em_arc = family(em_ids, True)
        ep_dst, _, ep_ol, ep_w, ep_arc = family(ep_ids, False)
        return cls(
            em_row_ptr=em_ptr, em_dst=em_dst,
            em_tid=em_tid,
            em_olabel=em_ol,
            em_weight=em_w,
            em_arc=em_arc,
            ep_row_ptr=ep_ptr, ep_dst=ep_dst,
            ep_olabel=ep_ol,
            ep_weight=ep_w,
            ep_arc=ep_arc,
            final=np.asarray(g.final, np.float32), start=int(g.start),
            num_states=S, eps_diameter=int(g.eps_diameter), packed=g,
        )

    @classmethod
    def from_fst(cls, fst) -> "CsrGraph":
        return cls.from_packed(PackedGraph.from_fst(fst))


# sentinel destination for dead candidates: sorts after every real
# state id (graphs are << 2^30 states)
INVALID_DST = np.int32(2 ** 30)


def _join_sorted(sorted_keys: np.ndarray, queries: np.ndarray):
    """Sort-merge join: for each query, all positions in
    ``sorted_keys`` holding an equal value.  Returns (rep, match):
    expanded pair indices (query index, sorted-key index).  O(output +
    log-factors) — replaces per-element dict lookups in the host
    lattice build (the old dict product was O(|closure| x |arcs|) per
    frame and took tens of minutes on dense 60s stress decodes)."""
    lo = np.searchsorted(sorted_keys, queries, "left")
    hi = np.searchsorted(sorted_keys, queries, "right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z
    rep = np.repeat(np.arange(len(queries), dtype=np.int64), cnt)
    excl = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(excl, cnt)
    return rep, lo[rep] + within


def _closure_arrays(g: PackedGraph, eps_ids: np.ndarray,
                    sources: np.ndarray, rounds: int, wmax: int):
    """Vectorized eps prefix closure: best (cost, word string) eps path
    u→v over the arcs ``eps_ids``, for every source u in ``sources``
    (identity rows included).  Words ride as a [N, wmax] int32 matrix
    with a count column (eps paths carry at most ``rounds`` labels —
    the eps DAG's diameter bounds path length).

    Returns (u, v, w, words, cnt) numpy arrays."""
    L = len(sources)
    u = sources.astype(np.int64)
    v = sources.astype(np.int64)
    w = np.zeros(L, np.float64)
    words = np.full((L, max(wmax, 1)), -1, np.int32)
    cnt = np.zeros(L, np.int64)
    if len(eps_ids) == 0 or L == 0:
        return u, v, w, words, cnt
    eps_ids = np.asarray(eps_ids, np.int64)
    es = g.src[eps_ids]
    order = np.argsort(es, kind="stable")
    es_sorted = es[order].astype(np.int64)
    ed = g.dst[eps_ids[order]].astype(np.int64)
    ew = g.weight[eps_ids[order]].astype(np.float64)
    eo = g.olabel[eps_ids[order]].astype(np.int32)
    for _ in range(rounds):
        rep, mi = _join_sorted(es_sorted, v)
        if len(rep) == 0:
            break
        nu = u[rep]
        nv = ed[mi]
        nw = w[rep] + ew[mi]
        nwords = words[rep].copy()
        ncnt = cnt[rep].copy()
        has = eo[mi] > 0
        if has.any():
            if int(ncnt[has].max()) >= wmax:
                raise RuntimeError(
                    "eps word chain exceeds declared eps diameter "
                    f"({wmax}); graph eps structure is inconsistent")
            nwords[np.nonzero(has)[0], ncnt[has]] = eo[mi][has]
            ncnt = ncnt + has
        u = np.concatenate([u, nu])
        v = np.concatenate([v, nv])
        w = np.concatenate([w, nw])
        words = np.concatenate([words, nwords])
        cnt = np.concatenate([cnt, ncnt])
        # dedup (u, v) keeping min cost (each round extends paths by
        # one hop; subpath optimality makes per-pair best sufficient)
        o = np.lexsort((w, v, u))
        uu, vv = u[o], v[o]
        first = np.concatenate(
            [[True], (uu[1:] != uu[:-1]) | (vv[1:] != vv[:-1])])
        keep = o[first]
        u, v, w = u[keep], v[keep], w[keep]
        words, cnt = words[keep], cnt[keep]
    return u, v, w, words, cnt


def _bucket_pairs_by_time(tvals: np.ndarray, avals: np.ndarray,
                          length: int):
    """Unique (t, arc) pairs split into per-t arrays (vectorized)."""
    out = [np.zeros(0, np.int64) for _ in range(length)]
    if len(avals) == 0 or length == 0:
        return out
    o = np.lexsort((avals, tvals))
    tv, av = tvals[o].astype(np.int64), avals[o].astype(np.int64)
    first = np.concatenate(
        [[True], (tv[1:] != tv[:-1]) | (av[1:] != av[:-1])])
    tv, av = tv[first], av[first]
    starts = np.searchsorted(tv, np.arange(length + 1))
    for t in range(length):
        out[t] = av[starts[t]:starts[t + 1]]
    return out


def _expand(states, scores, row_se, budget: int, cap: int = 0):
    """Enumerate the out-arcs of the frontier into a fixed budget.

    Segment fill by monotone rank: ``excl`` (exclusive cumsum of
    degrees) is sorted, so the frontier slot owning budget position j
    is exactly ``#{k : excl[k] <= j} - 1`` — one fused
    broadcast-compare-reduce over [A, K], no scatter and no
    multi-pass cummax.  (History: ``searchsorted`` lowered to a
    log2(K)-deep chain of [A] gathers; the scatter + cummax forward
    fill that replaced it still took ~10 passes over [A].
    Zero-degree slots are skipped naturally: their excl ties the next
    slot's and the tie-break picks the later slot.)

    ``row_se`` is the [S, 2] (start, degree) table — one gather per
    frontier instead of two row_ptr gathers.

    ``cap`` > 0 limits each state's expansion to its ``cap``
    lowest-weight arcs (rows are weight-sorted, CsrGraph.from_packed).
    For EPS arcs a cap of K is EXACT — an eps candidate's score is
    source score minus arc weight, so only a source's K cheapest arcs
    can be among the K winners.  Emitting arcs carry per-arc acoustic
    terms, so the emitting stage passes cap=0 (degrees there are
    self-loop + transitions — small; it is eps word-loop junctions
    that fan out to vocabulary-sized degrees and would otherwise force
    the arc budget up to the max out-degree).

    ``scores`` rides along so ALL per-slot fields are fetched by ONE
    row gather: random gathers pay per touched row, not per element,
    so gathering the packed [K, 2] table (row_start - excl, score) once
    costs about what gathering a single [K] array costs — and three
    separate [A]-indexed gathers (starts/excl/scores) collapse into
    one.  row_start - excl is exact in f32 (graphs < 2^24 arcs).

    Returns (arc_pos [A] int32 absolute positions into the CSR arrays,
    slot [A] frontier slot each arc came from, score [A] source score,
    valid [A] bool)."""
    K = states.shape[0]
    safe = jnp.maximum(states, 0)
    se = row_se[safe]                           # [K, 2] one gather
    starts = se[:, 0]
    deg = jnp.where(states >= 0, se[:, 1], 0)
    if cap > 0:
        deg = jnp.minimum(deg, cap)
    cum = jnp.cumsum(deg)                       # inclusive
    excl = cum - deg
    total = cum[-1]
    j = jnp.arange(budget, dtype=jnp.int32)
    slot = jnp.sum((excl[None, :] <= j[:, None]).astype(jnp.int32),
                   axis=1) - 1                  # always >= 0: excl[0]=0
    slot_c = jnp.clip(slot, 0, K - 1)
    tbl = jnp.stack([(starts - excl).astype(jnp.float32), scores],
                    axis=1)                     # [K, 2]
    row = tbl[slot_c]                           # ONE [A, 2] gather
    arc_pos = row[:, 0].astype(jnp.int32) + j
    sc_slot = row[:, 1]
    valid = j < total
    return jnp.where(valid, arc_pos, 0), slot_c, sc_slot, valid


def _dedup_topk(cand_dst, cand_score, valid, K: int):
    """Exact per-state dedup + top-K, scatter-free.

    Sort candidates by (dst, -score): the best candidate per state is
    the first of its run; mask the rest and top-K what survives.  Sorts
    are vectorized and vmap cleanly, unlike the dense scatter-max table
    this replaces (serialized on collisions, O(num_states) carry).

    Returns (new_states, new_scores, chosen_idx [K] candidate index,
    -1 for dead slots)."""
    A = cand_dst.shape[0]
    score_all = jnp.where(valid, cand_score, NEG_INF)
    dsts = jnp.where(valid, cand_dst, INVALID_DST)
    idx = jnp.arange(A, dtype=jnp.int32)
    sd, snegs, sidx = jax.lax.sort((dsts, -score_all, idx), num_keys=2)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sd[1:] != sd[:-1]])
    masked = jnp.where(first & (sd < INVALID_DST), -snegs, NEG_INF)
    topk_scores, sel = jax.lax.top_k(masked, K)
    alive = topk_scores > NEG_INF / 2
    picked = jnp.stack([sd, sidx], axis=1)[sel]   # ONE row gather
    new_states = jnp.where(alive, picked[:, 0], -1)
    new_scores = jnp.where(alive, topk_scores, NEG_INF)
    chosen = jnp.where(alive, picked[:, 1], -1)
    return new_states, new_scores, chosen


@partial(jax.jit, static_argnames=(
    "K", "A", "A_em", "chunk", "eps_rounds", "record_lattice",
    "rec_budget"))
def _beam_scan(
    ll_all,              # [Tp, P] device-resident acoustic scores
    t0,                  # scalar: first frame of this chunk
    total_t,             # scalar: true utterance length
    states, scores,      # carry-in frontier [K]
    em_se, em_pack,          # [S,2] (start,deg) + packed [N,3] arc rows
    ep_se, ep_pack,          # eps [S,2] (start,deg) + packed [N,3] rows
    acoustic_scale, beam,
    K: int, A: int, A_em: int, chunk: int, eps_rounds: int,
    record_lattice: bool, rec_budget: int = 0,
):
    """One chunk of frames starting at traced offset ``t0`` (the slice
    happens inside the jit so ONE compile serves every chunk — eager
    per-offset slicing would recompile per chunk).  Emits per frame, per
    stage (0 = emitting, 1..eps_rounds = eps) the backpointer planes
    (arc, prev slot) and, in lattice mode, the surviving candidate
    records."""
    loglikes = jax.lax.dynamic_slice_in_dim(ll_all, t0, chunk)
    valid_frames = (t0 + jnp.arange(chunk)) < total_t

    def frame(carry, inp):
        ll_t, v_t = inp
        st, sc = carry

        stage_arc = []
        stage_slot = []
        rec_pk = []
        rec_cnt = []

        def record(arc_pos_v, sc_vals, src_vals, dst_vals, dl_vals,
                   ok_v):
            """Record one stage's beam survivors; with rec_budget > 0
            keep only the budget's best-forward-score entries and emit
            the exact survivor count so the caller can detect drops and
            escalate (records are a superset the backward prune
            filters, so compaction by forward score is safe ONLY when
            nothing is dropped — counts make that checkable).

            ``dst_vals``/``dl_vals`` (arc destination, ac - w "delta")
            ride along so the backward prune needs NO packed-arc
            re-gathers at all (random gathers are slow — re-reading
            em_pack/ep_pack per chunk cost more than the whole prune
            scan).

            The 5 fields are PACKED fields-major into one [5, W] int32
            plane (floats bitcast): each plane was a separate lax.scan
            output, i.e. a separate dynamic-update-slice per frame, and
            the per-iteration output writes — not the bytes — are what
            made the record-mode forward scan slower than best-path.
            Fields-major keeps W in the minor (contiguous) dimension."""
            ra = jnp.where(ok_v, arc_pos_v, -1)
            rs = jnp.where(ok_v, sc_vals, NEG_INF)
            rr = jnp.where(ok_v, src_vals, -1)
            rd = jnp.where(ok_v, dst_vals, -1)
            rl = jnp.where(ok_v, dl_vals, NEG_INF)
            # count from the same predicate the compaction's alive mask
            # uses (rs finite), so a survivor can never be dropped by
            # the top-k below without registering as an overflow
            rec_cnt.append(jnp.sum((rs > NEG_INF / 2).astype(jnp.int32)))
            if rec_budget and rec_budget < ra.shape[0]:
                top, sel = jax.lax.top_k(rs, rec_budget)
                alive = top > NEG_INF / 2
                ra = jnp.where(alive, ra[sel], -1)
                rr = jnp.where(alive, rr[sel], -1)
                rd = jnp.where(alive, rd[sel], -1)
                rl = jnp.where(alive, rl[sel], NEG_INF)
                rs = top
            bits = partial(jax.lax.bitcast_convert_type,
                           new_dtype=jnp.int32)
            rec_pk.append(jnp.stack([ra, bits(rs), rr, rd, bits(rl)]))

        # ---- stage 0: emitting arcs consume the acoustic frame ----
        # one row gather per arc: the packed [N, 3] layout (dst, pdf,
        # bitcast weight) turns three scattered HBM accesses into one —
        # random-access gathers pay per touched cache line, not per
        # element, so AoS beats SoA here
        arc_pos, slot, src_sc, ok = _expand(st, sc, em_se, A_em)
        row = em_pack[arc_pos]                   # [A_em, 3] int32
        cand_dst = row[:, 0]
        ac = acoustic_scale * ll_t[row[:, 1]]
        w = jax.lax.bitcast_convert_type(row[:, 2], jnp.float32)
        cand = src_sc - w + ac
        best = jnp.max(jnp.where(ok, cand, NEG_INF))
        ok = ok & (cand >= best - beam)
        nst, nsc, chosen = _dedup_topk(cand_dst, cand, ok, K)
        sel = jnp.maximum(chosen, 0)
        picked = jnp.stack([arc_pos, slot], axis=1)[sel]   # one gather
        stage_arc.append(jnp.where(chosen >= 0, picked[:, 0], -1))
        stage_slot.append(jnp.where(chosen >= 0, picked[:, 1], -1))
        if record_lattice:
            # em planes ride at their natural [A_em] width (the eps
            # stages use the full budget A; padding em records up to A
            # cost ~50 KB/frame of pure padding traffic through both
            # scans).  Padding frames (~v_t) must record nothing:
            # their replayed frontier would inflate the device-
            # compaction counts and the host lattice build.  Scores
            # and source states ride along so the backward prune scan
            # can rank and relax records.
            record(arc_pos, cand, st[slot], cand_dst, ac - w, ok & v_t)
        st, sc = nst, nsc

        # ---- eps stages: relax non-emitting arcs, merge with frontier
        for _ in range(eps_rounds):
            arc_pos, slot, src_sc, ok = _expand(st, sc, ep_se, A,
                                                cap=K)
            erow = ep_pack[arc_pos]              # [A, 2] int32
            dst_e = erow[:, 0]
            w_e = jax.lax.bitcast_convert_type(erow[:, 1], jnp.float32)
            cand_e = src_sc - w_e
            ok = ok & (cand_e >= best - beam)
            # merge candidates with the carried frontier: first K
            # entries are the frontier itself (arc = -1 marker)
            m_dst = jnp.concatenate([st, dst_e])
            m_score = jnp.concatenate([sc, cand_e])
            m_ok = jnp.concatenate([st >= 0, ok])
            nst, nsc, chosen = _dedup_topk(m_dst, m_score, m_ok, K)
            sel = jnp.maximum(chosen, 0)
            from_eps = chosen >= K
            eps_sel = jnp.maximum(sel - K, 0)
            epicked = jnp.stack([arc_pos, slot], axis=1)[eps_sel]
            stage_arc.append(jnp.where(
                from_eps, epicked[:, 0], -1))
            stage_slot.append(jnp.where(
                chosen < 0, -1,
                jnp.where(from_eps, epicked[:, 1], sel)))
            if record_lattice:
                record(arc_pos, cand_e, st[slot], dst_e, -w_e, ok & v_t)
            st, sc = nst, nsc

        # padding frames are no-ops; their backpointer planes are the
        # identity so backtrace can walk straight through them
        ident = jnp.arange(K, dtype=jnp.int32)
        arcs_out = jnp.stack(
            [jnp.where(v_t, a, -1) for a in stage_arc])
        slots_out = jnp.stack(
            [jnp.where(v_t, s, ident) for s in stage_slot])
        out = (arcs_out, slots_out, sc)
        if record_lattice:
            # em plane at natural [5, A_em] width (or the record
            # budget); eps planes stacked at [eps_rounds, 5, width]
            # (zero-size when the graph has no eps arcs)
            eps_w = min(rec_budget, A) if rec_budget else A
            eps_pk = (jnp.stack(rec_pk[1:]) if len(rec_pk) > 1
                      else jnp.zeros((0, 5, eps_w), jnp.int32))
            out = out + (rec_pk[0], eps_pk, jnp.stack(rec_cnt))
        st = jnp.where(v_t, st, carry[0])
        sc = jnp.where(v_t, sc, carry[1])
        return (st, sc), out

    (states, scores), outs = jax.lax.scan(
        frame, (states, scores), (loglikes, valid_frames))
    return (states, scores), outs


def _groupmax_sorted(srcq: jnp.ndarray, vals: jnp.ndarray) -> jnp.ndarray:
    """Per-source max of (src, val) pairs, laid out so each group's max
    sits at the LEFTMOST position of that src in sorted-key order —
    exactly where a leftmost binary search over the sorted keys lands.

    One 2-key sort: lexicographic (src asc, -val asc) puts every run's
    best value first.  The key order depends only on the (static) src
    multiset, so lookup positions are precomputable outside the scan
    even though the values are dynamic.  This replaced an in-scan
    segmented associative_scan whose ~14 log-depth passes per stage per
    frame were pure dispatch overhead (one sort replaces them)."""
    _, negmax = jax.lax.sort((srcq, -vals), num_keys=2)
    return -negmax


def _bs_left(keys: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Batched leftmost binary search: ``keys`` [..., N] sorted rows,
    ``q`` [..., M] queries with matching leading dims.  Unrolled
    log2(N) take_along_axis steps — batched gathers OUTSIDE any
    sequential scan, where they vectorize across rows."""
    N = keys.shape[-1]
    lo = jnp.zeros(q.shape, jnp.int32)
    hi = jnp.full(q.shape, N, jnp.int32)
    # N+1 possible insertion points: ceil(log2(N+1)) halvings leave the
    # worst-case interval at length 1, so one MORE step is required to
    # resolve it (a 12-step search over 4096 keys returned a wrong
    # leftmost position for exactly one query pattern — measured)
    steps = max(int(np.ceil(np.log2(N + 1))) + 1, 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        km = jnp.take_along_axis(keys, jnp.minimum(mid, N - 1), axis=-1)
        # `cont` makes converged lanes no-ops: without it an extra
        # iteration at lo == hi == N reads the clamped key and can push
        # lo out of range
        cont = lo < hi
        go_right = cont & (km < q)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(cont & ~go_right, mid, hi)
    return lo


@partial(jax.jit, static_argnames=("R_em", "R_ep"))
def _compact_record_chunk(em_pk, eps_pk, R_em: int, R_ep: int):
    """Batched (non-scan) compaction of one chunk's PACKED record
    planes ([..., 5, W] fields-major int32, see _beam_scan's record())
    to the measured live width: a stable (key, index) sort per stage
    finds the permutation moving live entries (pos >= 0) to the front
    of each row, one take_along_axis applies it to all 5 field rows,
    then the rows are sliced to R.  EXACT — the caller sizes R_em/R_ep
    from the per-frame live counts the forward scan emits, so nothing
    can be dropped.

    Why outside the scan: the prune scan's per-frame gather/scatter
    cost is proportional to the STATIC plane width, while in-scan top_k compaction made
    the forward scan slower (lax.top_k at large K is far more expensive
    than a sort).  Sorting HERE is batched across the whole chunk with
    no sequential dependency, which is where sorts are cheap."""
    def compact(pk, R):
        W = pk.shape[-1]
        if R >= W:
            return pk
        pos = pk[..., 0, :]
        key = jnp.where(pos >= 0, jnp.int32(0), jnp.int32(1))
        idx = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32),
                               pos.shape)
        _, perm = jax.lax.sort((key, idx), num_keys=1, dimension=-1)
        g = jnp.take_along_axis(pk, perm[..., None, :], axis=-1)
        return g[..., :R]

    return compact(em_pk, R_em), compact(eps_pk, R_ep)


@partial(jax.jit, static_argnames=("stages", "chunk", "R_pr"))
def _record_prune_chunk(
    em_pk,               # [chunk, 5, Wm] packed em records (fields
    #                      pos/sc/src/dst/dl; sc+dl are f32 bitcast —
    #                      see _beam_scan's record())
    eps_pk,              # [chunk, stages-1, 5, Wp] packed eps records
    valid,               # [chunk] bool: frame < total_t
    em_arc, ep_arc,      # CSR position → global arc id
    V,                   # [S] f32 dense backward values (carry; seeded
    #                      with -final_cost / pseudo-finals for the
    #                      LAST chunk — padding frames pass it through)
    thresh,
    stages: int, chunk: int, R_pr: int,
):
    """Forward-backward prune of the recorded arcs (reference role:
    PruneActiveTokens / PruneForwardLinks,
    src/decoder/lattice-faster-decoder.h:96-364 — there incremental
    over token lists, here one reverse pass).

    Design history: a sorted backward SET paid ~6 sorted-set ops per
    frame in the scan; a precomputed-join rewrite (batched binary
    searches outside the scan + one group-max sort per stage inside)
    made the scan cheap but its batched ``take_along_axis`` binary
    searches (13-step searches over [128, 12k] queries) dominated
    everything.  This version keeps the backward values in a DENSE
    [num_states] f32 table instead (2.2 MB on the 540k-state bench
    graph): per frame per stage, tail = one V[dst] gather, update = one
    fresh-table scatter-max at src (no precomputed joins at all).  The arc deltas
    (ac - w) ride in the record planes from the forward pass, so the
    prune re-reads NO packed-arc tables.

    Returns (V', kept [chunk, R_pr] global arc ids, counts [chunk])."""
    E = stages - 1
    S = V.shape[0]

    em_pos = em_pk[:, 0]
    live_m = em_pos >= 0
    arcid_m = jnp.where(live_m, em_arc[jnp.maximum(em_pos, 0)], -1)
    eps_arcid = []
    for s in range(E):
        pos = eps_pk[:, s, 0]
        eps_arcid.append(
            jnp.where(pos >= 0, ep_arc[jnp.maximum(pos, 0)], -1))

    def unpack(row):
        """[5, W] packed field rows → the scan body's field dict (the
        bitcasts are free reinterprets; row slices are contiguous)."""
        f32 = partial(jax.lax.bitcast_convert_type,
                      new_dtype=jnp.float32)
        return dict(sc=f32(row[1]), src=row[2], dst=row[3],
                    dl=f32(row[4]))

    def step(V, xs):
        em_row, eps_rows, v_t = xs
        em = unpack(em_row)
        # eps stages in reverse: stage s continues via LATER eps stages
        # of the same frame and via the next frame's em (V).  ONE
        # running backward table W (seeded with V) replaces the
        # per-stage fresh veps tables: when stage s is processed, W
        # holds exactly V + the contributions of stages k > s — the
        # only tails stage s may legally use — so each stage costs one
        # gather + one scatter-max instead of the old 1 + (E - 1 - s)
        # gathers + fresh-table scatter (round-4 STATUS queued fusion).
        W = V
        tot_e = [None] * E
        for s in range(E - 1, -1, -1):
            e = unpack(eps_rows[s])
            dst = jnp.maximum(e["dst"], 0)
            tail = jnp.where(e["dst"] >= 0, W[dst], NEG_INF)
            tot_e[s] = e["sc"] + tail
            # dead entries carry src -1, which would WRAP to S-1 under
            # jit — remap to S so mode="drop" genuinely drops them
            src_ix = jnp.where(e["src"] >= 0, e["src"], S)
            W = W.at[src_ix].max(tail + e["dl"], mode="drop")
        dst = jnp.maximum(em["dst"], 0)
        tail = jnp.where(em["dst"] >= 0, W[dst], NEG_INF)
        tot_m = em["sc"] + tail
        src_ix = jnp.where(em["src"] >= 0, em["src"], S)
        Vn = jnp.full((S,), NEG_INF, jnp.float32).at[
            src_ix].max(tail + em["dl"], mode="drop")
        # padding frames record nothing and must pass V through
        Vn = jnp.where(v_t, Vn, V)
        tot_e_out = (jnp.stack(tot_e)
                     if E else jnp.zeros((0, em["sc"].shape[-1]),
                                         jnp.float32))
        return Vn, (tot_m, tot_e_out)

    V2, (tot_m_all, tot_e_all) = jax.lax.scan(
        step, V, (em_pk, eps_pk, valid), reverse=True)

    # ---- batched post: threshold, exact counts, top-R_pr compaction
    # to global arc ids ----
    rank = tot_m_all
    arcids = arcid_m
    if E:
        rank = jnp.concatenate(
            [rank] + [tot_e_all[:, s] for s in range(E)], axis=1)
        arcids = jnp.concatenate([arcids] + eps_arcid, axis=1)
    keeps = rank >= thresh
    counts = keeps.sum(axis=1)
    masked = jnp.where(keeps, rank, NEG_INF)
    top_sc, sel = jax.lax.top_k(masked, min(R_pr, masked.shape[1]))
    kept = jnp.where(top_sc > NEG_INF / 2,
                     jnp.take_along_axis(arcids, sel, axis=1), -1)
    return V2, kept, counts


@partial(jax.jit, static_argnames=("stages",))
def _backtrace_scan(arc_planes, slot_planes, start_slot, stages: int):
    """Device backtrace: walk the (time, stage) backpointer planes from
    the winning final slot.  Returns (slot at t=0, arcs [T, stages] in
    reverse traversal order — row 0 is the LAST frame, and within a row
    stages are descending)."""

    def step(slot, planes):
        arcs_t, slots_t = planes
        outs = []
        for s in range(stages - 1, -1, -1):
            outs.append(arcs_t[s, slot])
            slot = slots_t[s, slot]
        return slot, jnp.stack(outs)

    slot, arcs = jax.lax.scan(
        step, jnp.asarray(start_slot, jnp.int32),
        (arc_planes[::-1], slot_planes[::-1]))
    return slot, arcs


@partial(jax.jit, static_argnames=("stages",))
def _backtrace_scan_batched(arc_planes, slot_planes, start_slots,
                            stages: int):
    """[B, ...] backtrace as ONE compiled program (an eager vmap would
    dispatch every scan step as a separate remote call)."""
    return jax.vmap(
        lambda a, s, k: _backtrace_scan(a, s, k, stages),
        in_axes=(0, 0, 0))(arc_planes, slot_planes, start_slots)


@jax.jit
def _best_final_dev(st, sc, final_tbl):
    """Device-side FindBestPath final-state selection (the host version
    forced a frontier fetch per utterance, serializing consecutive
    decodes on the fetch RTT).  Returns (slot, score, reached_final)."""
    fin = jnp.where(st >= 0, final_tbl[jnp.maximum(st, 0)], jnp.inf)
    total = jnp.where(jnp.isfinite(fin), sc - fin, NEG_INF)
    k1 = jnp.argmax(total)
    k2 = jnp.argmax(sc)
    has = total[k1] > NEG_INF / 2
    k = jnp.where(has, k1, k2).astype(jnp.int32)
    score = jnp.where(has, total[k1], sc[k2])
    return k, score, has


class BeamSearchDecoder:
    """Beam + max-active pruned decode over a CsrGraph.

    decode(loglikes) → (words, alignment, score) like ViterbiDecoder,
    but with per-frame cost O(A log K) independent of graph size
    (reference: FasterDecoder semantics).  With
    ``generate_lattice=True``, decode_lattice() also returns a pruned
    Lattice built from the surviving candidate arcs (reference:
    LatticeFasterDecoder::GetRawLattice)."""

    def __init__(self, graph: CsrGraph, tid_to_pdf: np.ndarray,
                 acoustic_scale: float = 1.0, beam: float = 16.0,
                 max_active: int = 4096, arc_budget: Optional[int] = None,
                 chunk: int = 128, approx_topk: Optional[bool] = None):
        # approx_topk is accepted for back-compat and ignored: the
        # sort-based dedup is exact AND as fast as the old approx path
        del approx_topk
        if isinstance(graph, PackedGraph):
            graph = CsrGraph.from_packed(graph)
        self.graph = graph
        self.tid_to_pdf = np.asarray(tid_to_pdf, np.int32)
        self.acoustic_scale = float(acoustic_scale)
        self.beam = float(beam)
        self.K = int(max_active)
        # 4K default: per-state expansion is capped at K (exact, see
        # CsrGraph), so the budget covers a frontier of avg degree 4;
        # overflow drops the worst-scored tokens' arcs first
        self.A = int(arc_budget or 4 * self.K)
        # emitting out-degrees are small and static per graph: size the
        # emitting budget exactly (every [A_em] op in the scan shrinks)
        max_em_deg = int(max(1, np.max(np.diff(graph.em_row_ptr))))
        self.A_em = int(min(self.A, self.K * max_em_deg))
        self.chunk = int(chunk)
        self._em_pdf = self.tid_to_pdf[graph.em_tid]
        # device-resident graph arrays; per-arc fields are packed into
        # one row (AoS) so the random gather touches ONE cache line
        # per arc instead of four
        # arc ids are NOT stored on device: backpointer planes carry
        # CSR positions, which the host maps through em_arc/ep_arc at
        # backtrace time — a narrower row per gather, and the [N,3]
        # shape keeps XLA from re-laying-out the table every chunk
        # (the old [N,4] row got a 17MB layout copy per scan call)
        em_pack = np.stack([
            graph.em_dst.astype(np.int32),
            self._em_pdf.astype(np.int32),
            graph.em_weight.astype(np.float32).view(np.int32),
        ], axis=1)
        ep_pack = np.stack([
            graph.ep_dst.astype(np.int32),
            graph.ep_weight.astype(np.float32).view(np.int32),
        ], axis=1)
        def se(row_ptr):
            rp = np.asarray(row_ptr, np.int64)
            return np.stack([rp[:-1], rp[1:] - rp[:-1]],
                            axis=1).astype(np.int32)

        self._dev = {
            "em_se": jnp.asarray(se(graph.em_row_ptr)),
            "em_pack": jnp.asarray(em_pack),
            "ep_se": jnp.asarray(se(graph.ep_row_ptr)),
            "ep_pack": jnp.asarray(ep_pack),
            "em_arc": jnp.asarray(graph.em_arc),
            "ep_arc": jnp.asarray(graph.ep_arc),
            "final": jnp.asarray(graph.final.astype(np.float32)),
        }
        self.eps_rounds = max(graph.eps_diameter, 0)
        # per-frame budget for the device-compacted lattice record
        # fetch (decode_lattice); the budget escalates in powers of two
        # up to rec_budget_max, beyond which the best-scored records
        # are kept (per-frame record beam) and drops are counted in
        # last_record_drops
        self.rec_budget = 1024
        self.rec_budget_max = 16384
        # natural-width record planes (no in-scan compaction at all)
        # whenever they fit this HBM budget; beyond it the forward pass
        # falls back to rec_fwd_budget compaction with escalation
        self.record_mem_bytes = 2 << 30
        # per-stage width of the STORED record planes in the forward
        # scan (exact: survivor counts ride along and any overflow
        # re-runs the record pass at the next power of two) — the
        # record prune scan's per-frame sorted-set ops scale with this
        self.rec_fwd_budget = 2048
        self.last_record_drops = 0
        # compact the prune scan's input planes to the measured live
        # width before the backward pass (see _compact_record_chunk):
        # the running-table prune is SCATTER-dominated and scatter cost
        # is proportional to plane width; lattices are identical either
        # way (not measured on the H100 yet).
        self.compact_prune_inputs = True
        # extra slack on the device-side record prune: the recorded
        # scores are f32 running sums over the whole utterance, so
        # near-threshold arcs carry O(0.1) accumulated rounding noise
        # on hour-scale/score-scale decodes; the margin keeps a slight
        # superset and the host build's f64 forward-backward prune
        # stays the arbiter.  0 reproduces the f32-exact prune.
        self.record_prune_margin = 0.5



    # -- position→arc-id mapping (device planes carry CSR positions) --
    def _map_rev_arcs(self, arcs_rt):
        """[..., stages DESCENDING] device-backtrace output: the last
        column is the emitting stage."""
        g = self.graph
        out = np.empty_like(arcs_rt)
        n = arcs_rt.shape[-1]
        for j in range(n):
            table = g.em_arc if (n - 1 - j) == 0 else g.ep_arc
            p = arcs_rt[..., j]
            out[..., j] = np.where(
                p >= 0, table[np.minimum(np.maximum(p, 0),
                                         len(table) - 1)], -1)
        return out

    def _pad_device(self, loglikes, T: int):
        """Pad to a power-of-two number of chunks so the jitted scan
        compiles O(log T) times total, not once per utterance length."""
        ll_dev = jnp.asarray(loglikes, jnp.float32)
        n_chunks = max(1, (T + self.chunk - 1) // self.chunk)
        n_chunks = 1 << (n_chunks - 1).bit_length()
        Tp = n_chunks * self.chunk
        if Tp > T:
            ll_dev = jnp.pad(ll_dev, ((0, Tp - T), (0, 0)))
        return ll_dev, Tp

    def _scan_chunk(self, ll_dev, t0: int, T: int, st, sc,
                    record_lattice: bool, rec_budget: int = 0):
        return _beam_scan(
            ll_dev, jnp.int32(t0), jnp.int32(T), st, sc,
            self._dev["em_se"], self._dev["em_pack"],
            self._dev["ep_se"], self._dev["ep_pack"],
            jnp.float32(self.acoustic_scale), jnp.float32(self.beam),
            self.K, self.A, self.A_em, self.chunk, self.eps_rounds,
            record_lattice, rec_budget,
        )

    # -- initial frontier: start state + host eps closure --------------
    def _init_frontier(self):
        # memoized: the graph is immutable and this host eps closure
        # was recomputed 2-3x per decode_lattice call
        cached = getattr(self, "_init_frontier_cache", None)
        if cached is not None:
            return cached
        g = self.graph
        score = {g.start: 0.0}
        bp: Dict[int, int] = {}
        frontier = [g.start]
        for _ in range(max(self.eps_rounds, 1)):
            new = []
            for s in frontier:
                for p in range(g.ep_row_ptr[s], g.ep_row_ptr[s + 1]):
                    d = int(g.ep_dst[p])
                    c = score[s] - float(g.ep_weight[p])
                    if c > score.get(d, -np.inf):
                        score[d] = c
                        bp[d] = int(g.ep_arc[p])
                        new.append(d)
            frontier = new
            if not frontier:
                break
        items = sorted(score.items(), key=lambda kv: -kv[1])[:self.K]
        states = np.full(self.K, -1, np.int32)
        scores = np.full(self.K, NEG_INF, np.float32)
        for i, (s, c) in enumerate(items):
            states[i] = s
            scores[i] = c
        self._init_frontier_cache = (states, scores, bp)
        return states, scores, bp

    def _best_final(self, states, scores):
        g = self.graph
        final = np.where(states >= 0,
                         g.final[np.maximum(states, 0)], np.inf)
        total = np.where(np.isfinite(final), scores - final, -np.inf)
        k = int(np.argmax(total))
        if not np.isfinite(total[k]):
            # no token on a final state: fall back to best score
            k = int(np.argmax(scores))
            if scores[k] <= NEG_INF / 2:
                raise RuntimeError("decode failed: empty frontier")
            return k, float(scores[k]), False
        return k, float(total[k]), True

    def decode(self, loglikes: np.ndarray
               ) -> Tuple[List[int], np.ndarray, float]:
        """Best-path decode with device-resident backpointer planes and
        a device-side backtrace scan — only ~T ints cross the host
        boundary (backpointer planes are ~MBs per chunk; the
        reference's host decoder has no such boundary to worry
        about)."""
        pend = self._dispatch_decode(loglikes)
        return self._finish_decode(pend)

    def decode_many(self, loglikes_list, ahead: int = 2):
        """Decode a list of utterances with the next utterances' device
        work dispatched BEFORE the current one's results are fetched:
        the per-utterance fetch round trip hides behind the next scans, so aggregate throughput approaches the
        pure scan rate (the run.pl nj-sharded offline-decode role,
        reference: aslp_scripts/aslp_nnet/decode.sh:129-134, served on
        one chip by pipelining instead of process parallelism).

        ``ahead`` bounds in-flight utterances: each holds its [Tp,
        stages, K] backpointer planes in HBM until its backtrace
        executes."""
        out, window = [], []
        for x in loglikes_list:
            window.append(self._dispatch_decode(x))
            if len(window) > ahead:
                out.append(self._finish_decode(window.pop(0)))
        out.extend(self._finish_decode(p) for p in window)
        return out

    def _dispatch_decode(self, loglikes):
        """Dispatch one utterance's full decode (scan chunks + device
        best-final + device backtrace); returns handles, fetches
        NOTHING."""
        T = len(loglikes)
        states0, scores0, init_bp = self._init_frontier()
        if T == 0:
            k, score, _ = self._best_final(states0, scores0)
            # host-value handle: (flat=score, n_stages=k) by position
            return (score, k, 0, states0, init_bp)
        st = jnp.asarray(states0)
        sc = jnp.asarray(scores0)
        # single upload (or no-op if the AM already produced the scores
        # on device); the chunk offset is a traced scalar so one compile
        # serves every chunk
        ll_dev, Tp = self._pad_device(loglikes, T)
        dev_arc = []
        dev_slot = []
        for t0 in range(0, T, self.chunk):
            (st, sc), outs = self._scan_chunk(
                ll_dev, t0, T, st, sc, False)
            dev_arc.append(outs[0])
            dev_slot.append(outs[1])
        k, score, _ = _best_final_dev(st, sc, self._dev["final"])
        arc_planes = jnp.concatenate(dev_arc)
        slot_planes = jnp.concatenate(dev_slot)
        n_stages = arc_planes.shape[1]
        final_slot, arcs_rev = _backtrace_scan(
            arc_planes, slot_planes, k, n_stages)
        # ONE array to fetch: the two scalars ride behind the flattened
        # arc matrix (every fetch is a device round trip)
        flat = jnp.concatenate([
            arcs_rev.reshape(-1),
            final_slot.astype(jnp.int32)[None],
            jax.lax.bitcast_convert_type(score, jnp.int32)[None]])
        return (flat, n_stages, T, states0, init_bp)

    def _finish_decode(self, pend):
        """Fetch + host tail for one _dispatch_decode handle."""
        flat, n_stages, T, states0, init_bp = pend
        if T == 0:
            k, score = n_stages, flat   # host values from dispatch
            words, ali = self._init_chain_words(k, states0, init_bp)
            return words, ali, score
        h = np.asarray(flat)                       # the one fetch
        final_slot = int(h[-2])
        score = float(np.asarray(h[-1], np.int32).view(np.float32))
        if score <= NEG_INF / 2:
            raise RuntimeError("decode failed: empty frontier")
        arcs_rev = h[:-2].reshape(-1, n_stages)
        words, ali = self._host_path_tail(arcs_rev, final_slot, T,
                                          states0, init_bp)
        return words, ali, score

    def _init_chain_words(self, slot, states0, init_bp):
        """Words on the initial host eps chain ending at frontier slot
        ``slot`` (the whole path for an empty utterance)."""
        g = self.graph.packed
        words_rev: List[int] = []
        s = int(states0[slot])
        while s in init_bp:
            a = init_bp[s]
            if g.olabel[a] > 0:
                words_rev.append(int(g.olabel[a]))
            s = int(g.src[a])
        return list(reversed(words_rev)), np.zeros(0, np.int32)

    # -- lattice generation -------------------------------------------
    def decode_lattice(self, loglikes: np.ndarray,
                       lattice_beam: float = 8.0
                       ) -> Tuple[List[int], np.ndarray, float, Lattice]:
        """Best path + pruned lattice from the surviving-arc records
        (reference: DecodeUtteranceLatticeFaster → GetRawLattice then
        forward-backward prune at lattice_beam).

        Device-resident like :meth:`decode`: backpointer planes never
        cross the host boundary (device backtrace scan), and the
        [T, stages, A] record planes are forward-backward PRUNED at
        ``lattice_beam`` on device (_record_prune_scan — the
        PruneActiveTokens role as one reverse pass), then compacted to
        global arc ids before the one fetch: only the true lattice
        arcs ever cross to the host (the unpruned superset is 100-1000x
        larger on dense decodes and its fetch + host folding dominated
        lattice RTF)."""
        ll = np.asarray(loglikes, np.float32)
        T = len(ll)
        states0, scores0, init_bp = self._init_frontier()
        st = jnp.asarray(states0)
        sc = jnp.asarray(scores0)
        ll_dev, _Tp = self._pad_device(ll, T)
        # forward pass with compacted record planes: per stage only the
        # rec_fwd_budget best-forward-score beam survivors are stored —
        # UNLESS the natural-width planes fit the memory budget, in
        # which case no in-scan compaction runs at all (R=0): nothing
        # can overflow, no escalation re-run, and the forward pass costs
        # barely more than best-path (beam-saturated graphs keep ~all
        # candidates, so compaction there only burned top_k time and a
        # second forward pass)
        est_bytes = (T * (self.A_em + self.eps_rounds * self.A) * 5 * 4)
        R = 0 if est_bytes <= self.record_mem_bytes \
            else self.rec_fwd_budget
        dev_arc, dev_slot = [], []
        dev_planes = []   # per chunk: (em_pk [chunk, 5, Wm],
        #                   eps_pk [chunk, E, 5, Wp]) packed planes
        cnts = []
        for t0 in range(0, T, self.chunk):
            (st, sc), outs = self._scan_chunk(ll_dev, t0, T, st, sc,
                                              True, R)
            dev_arc.append(outs[0])
            dev_slot.append(outs[1])
            dev_planes.append(outs[3:5])
            cnts.append(outs[5])
        width = max(self.A, self.A_em)
        while R and R < width and T > 0:
            max_cnt = int(jnp.max(jnp.concatenate(cnts)))
            if max_cnt <= R:
                break
            R = 1 << (max_cnt - 1).bit_length()
            st2 = jnp.asarray(states0)
            sc2 = jnp.asarray(scores0)
            dev_planes, cnts = [], []
            for t0 in range(0, T, self.chunk):
                (st2, sc2), outs = self._scan_chunk(
                    ll_dev, t0, T, st2, sc2, True, R)
                dev_planes.append(outs[3:5])
                cnts.append(outs[5])
        if T > 0 and self.compact_prune_inputs:
            # one fetch of the per-frame live counts sizes the compacted
            # planes EXACTLY (nothing dropped); the prune scan's cost is
            # proportional to static width, so eps planes at the eps
            # budget A shrink to ~K (the expansion cap bounds live eps
            # records) while a saturated em stage is left alone
            c = np.asarray(jnp.concatenate(cnts))[:T]
            Wm = dev_planes[0][0].shape[-1]
            Wp = dev_planes[0][1].shape[-1] if self.eps_rounds else 0

            def pow2(n):
                return 1 << max(int(n) - 1, 0).bit_length()

            R_em = min(pow2(c[:, 0].max() if c.size else 1), Wm)
            R_ep = min(pow2(c[:, 1:].max() if (self.eps_rounds
                                               and c.shape[1] > 1)
                            else 1), Wp) if Wp else 0
            if R_em < Wm or (Wp and R_ep < Wp):
                dev_planes = [
                    _compact_record_chunk(*pl, R_em=R_em,
                                          R_ep=max(R_ep, 1))
                    for pl in dev_planes]
        states = np.asarray(st)
        scores = np.asarray(sc)
        k, best_score, is_final = self._best_final(states, scores)
        if T == 0:
            words, ali = self._init_chain_words(k, states0, init_bp)
            pseudo = None if is_final else (states, scores)
            lat = self._build_lattice(
                ll, np.zeros((0, 1, 1), np.int32), best_score,
                lattice_beam, pseudo_finals=pseudo)
            return words, ali, best_score, lat
        # when NO surviving token sits on a real final state, the
        # reference emits the lattice anyway, treating all last-frame
        # tokens as final with zero cost (GetRawLattice with
        # use_final_probs=false, lattice-faster-decoder.h:96-364);
        # without this the backward pass from graph finals is empty and
        # the whole utterance would produce a path-less lattice
        pseudo = None if is_final else (states, scores)
        rec_arc = self._prune_records_device(
            dev_planes, ll_dev, T, best_score, lattice_beam, pseudo)
        words, ali = self._backtrace_device(
            dev_arc, dev_slot, k, T, states0, init_bp)
        lat = self._build_lattice(ll, rec_arc, best_score, lattice_beam,
                                  pseudo_finals=pseudo)
        return words, ali, best_score, lat

    def _final_plane(self, pseudo_finals):
        """[S] f32 backward seed at time T: -final cost (NEG_INF for
        non-final); pseudo mode seats every surviving token at cost 0."""
        S = self.graph.num_states
        if pseudo_finals is None:
            cached = self._dev.get("final_plane")
            if cached is None:
                fin = np.asarray(self.graph.final, np.float32)
                plane = np.where(np.isfinite(fin), -fin,
                                 np.float32(NEG_INF)).astype(np.float32)
                cached = self._dev["final_plane"] = jnp.asarray(plane)
            return cached
        fstates, fscores = pseudo_finals
        plane = np.full(S, NEG_INF, np.float32)
        ok = (fstates >= 0) & (fscores > NEG_INF / 2)
        plane[fstates[ok]] = 0.0
        return jnp.asarray(plane)

    def _prune_records_device(self, dev_planes, ll_dev,
                              T, best_score, lattice_beam, pseudo_finals):
        """Exact device-side forward-backward prune of the recorded
        arcs + compaction to global arc ids (see _record_prune_chunk).
        Returns [T, 1, R] global-arc-id planes for _build_lattice."""
        stages = 1 + self.eps_rounds
        # record entries per frame, from the actual (possibly budget-
        # compacted) plane widths
        width = dev_planes[0][0].shape[-1] \
            + self.eps_rounds * dev_planes[0][1].shape[-1]
        thresh = jnp.float32(best_score - lattice_beam
                             - self.record_prune_margin)
        n_chunks = len(dev_planes)

        def run(R_pr: int):
            R_pr = min(R_pr, width)
            # dense backward seed: -final_cost per state (or the
            # pseudo-final plane); padding frames pass it through so
            # the boundary frame t = T-1 reads finals straight from V
            V = self._final_plane(pseudo_finals)
            kept, counts = [None] * n_chunks, [None] * n_chunks
            for i in range(n_chunks - 1, -1, -1):
                t0 = i * self.chunk
                valid = jnp.asarray(
                    np.arange(t0, t0 + self.chunk) < T)
                V, kept[i], counts[i] = _record_prune_chunk(
                    *dev_planes[i], valid,
                    self._dev["em_arc"], self._dev["ep_arc"],
                    V, thresh, stages, self.chunk, R_pr)
            # concat on device: every host value fetch is a round trip,
            # so per-chunk np.asarray pulls (2 x 47 on a 60 s
            # utterance) would serialize the prune — one stacked fetch
            # per array amortizes it
            return jnp.concatenate(kept), jnp.concatenate(counts)

        kept, counts_dev = run(self.rec_budget)
        counts = np.asarray(counts_dev)[:T]
        max_count = int(counts.max()) if T else 0
        self.last_record_drops = 0
        if max_count > self.rec_budget:
            # escalate the per-frame budget (power-of-two so the jit
            # cache stays bounded); counts are exact survivor counts,
            # so a capped budget's drops are counted, not silent
            R = 1 << (max_count - 1).bit_length()
            if R > self.rec_budget_max:
                R = self.rec_budget_max
                self.last_record_drops = int(
                    np.maximum(counts - R, 0).sum())
                get_logger("beam").warning(
                    "lattice records capped at %d/frame: dropped %d "
                    "lowest-scored surviving arcs", R,
                    self.last_record_drops)
            else:
                # PERSIST the escalated budget: decodes over the same
                # graph/beam keep similar survivor counts, so starting
                # the next utterance at the escalated R avoids paying
                # a full second prune pass every time
                self.rec_budget = R
            kept, _ = run(R)
        # device-side flatten-compact before the fetch: the [T, R]
        # plane is mostly -1 fill (a 60 s utterance would fetch 24.6 MB
        # for ~0.5 MB of survivors).  A
        # two-operand sort moves valid entries to the front in
        # flat-index (= frame-major) order; only the valid prefix
        # crosses the host boundary.
        flat = kept[:T].reshape(-1)
        N = flat.shape[0]
        key = jnp.where(flat >= 0, jnp.arange(N, dtype=jnp.int32),
                        jnp.int32(N))
        _, flat_sorted = jax.lax.sort((key, flat), num_keys=1)
        # exact per-frame valid counts from the plane itself (the
        # escalation `counts` are survivor counts, which exceed the
        # stored width in the capped case)
        per_frame = np.asarray(jnp.sum(kept[:T] >= 0, axis=-1))
        total = int(per_frame.sum())
        arcs = np.asarray(flat_sorted[:total]).astype(np.int64)
        tt = np.repeat(np.arange(T, dtype=np.int64), per_frame)
        return tt, arcs

    def _backtrace_device(self, dev_arc, dev_slot, k, T, states0,
                          init_bp):
        """Shared device-side backtrace tail (see :meth:`decode`)."""
        arc_planes = jnp.concatenate(dev_arc)
        slot_planes = jnp.concatenate(dev_slot)
        n_stages = arc_planes.shape[1]
        final_slot, arcs_rev = _backtrace_scan(
            arc_planes, slot_planes, k, n_stages)
        return self._host_path_tail(np.asarray(arcs_rev),
                                    int(final_slot), T, states0, init_bp)

    def _host_path_tail(self, arcs_rev, final_slot: int, T, states0,
                        init_bp):
        """Map fetched reverse-order arc rows to words + alignment."""
        g = self.graph.packed
        arcs_rt = self._map_rev_arcs(np.asarray(arcs_rev))
        Tp = arcs_rt.shape[0]
        ali = np.zeros(T, np.int32)
        words_rev: List[int] = []
        for t_rev in range(Tp):
            frame = Tp - 1 - t_rev
            for arc in arcs_rt[t_rev]:          # stage descending
                arc = int(arc)
                if arc < 0:
                    continue
                if g.olabel[arc] > 0:
                    words_rev.append(int(g.olabel[arc]))
                if g.ilabel[arc] > 0 and frame < T:
                    ali[frame] = g.ilabel[arc]
        s = int(states0[final_slot])
        while s in init_bp:
            a = init_bp[s]
            if g.olabel[a] > 0:
                words_rev.append(int(g.olabel[a]))
            s = int(g.src[a])
        return list(reversed(words_rev)), ali

    def _build_lattice_native(self, tt, arcs, T, ll, best_score,
                              lattice_beam, pseudo_finals):
        """C++ host build over the record arrays (native/
        lattice_build.cc — the per-frame numpy loop below costs ~1 s of
        interpreter overhead at T=6000).  Returns a Lattice or None
        (no toolchain / unexpected native error → numpy fallback)."""
        from kaldi_aslp_tpu import native
        g = self.graph.packed
        states0, scores0, init_bp = self._init_frontier()
        rounds = max(self.eps_rounds, 1)
        wmax = rounds + 1
        if wmax > 8:
            return None
        arcs = np.asarray(arcs, np.int64)
        tt = np.asarray(tt, np.int64)
        is_eps = g.ilabel[arcs] == 0 if len(arcs) else \
            np.zeros(0, bool)
        init_arcs = np.asarray(sorted(init_bp.values()), np.int64)
        ept = np.concatenate([np.zeros(len(init_arcs), np.int64),
                              tt[is_eps] + 1])
        epa = np.concatenate([init_arcs, arcs[is_eps]])
        emt, ema = tt[~is_eps], arcs[~is_eps]

        def dedup(t, a):
            if not len(t):
                return t, a
            o = np.lexsort((a, t))
            t, a = t[o], a[o]
            first = np.concatenate(
                [[True], (t[1:] != t[:-1]) | (a[1:] != a[:-1])])
            return t[first], a[first]

        ept, epa = dedup(ept, epa)
        emt, ema = dedup(emt, ema)
        ok = (states0 >= 0) & (scores0 > NEG_INF / 2)
        if pseudo_finals is not None:
            fstates, fscores = pseudo_finals
            fok = (fstates >= 0) & (fscores > NEG_INF / 2)
            fin_s = np.unique(fstates[fok]).astype(np.int64)
            fin_c = np.zeros(len(fin_s), np.float64)
            fold = False
        else:
            fin_all = np.asarray(self.graph.final, np.float64)
            fin_s = np.nonzero(np.isfinite(fin_all))[0].astype(np.int64)
            fin_c = fin_all[fin_s]
            fold = True
        out = native.lattice_build(
            g.src, g.dst, g.ilabel, g.olabel, g.weight, g.num_states,
            np.asarray(ll, np.float32), self.tid_to_pdf,
            float(self.acoustic_scale),
            ept, epa, emt, ema,
            states0[ok], scores0[ok].astype(np.float64),
            fin_s, fin_c, fold, np.asarray(self.graph.final, np.float32),
            float(best_score), float(lattice_beam), rounds, wmax)
        if out is None:
            return None
        n = len(out["tend"])
        words, wcnt = out["words"], out["wcnt"]
        arcs_out = [LatticeArc(
            int(out["tend"][i]), int(out["u"][i]), int(out["dst"][i]),
            int(out["tid"][i]),
            tuple(int(x) for x in words[i, :wcnt[i]]),
            float(out["w"][i]), float(out["ac"][i])) for i in range(n)]
        finals = {int(s): float(c) for s, c in
                  zip(out["fin_states"], out["fin_costs"])}
        return Lattice(T, arcs_out, self.graph.start, finals)

    def _build_lattice(self, loglikes, rec_arc, best_score, lattice_beam,
                       pseudo_finals=None):
        """Sparse forward-backward over recorded arcs, fully
        vectorized.

        Records give, per frame, candidate arcs surviving the decode
        beam (global arc ids, compacted on device).  Recorded eps arcs
        (which occur *after* the emitting stage of their frame, i.e. at
        the next time index) are folded as prefixes into the emitting
        arcs they precede — the same eps-free arc shape the dense
        lattice builder uses (decoder/lattice.py epsfree_arcs) but
        restricted to the recorded sparse set.  The per-frame closure
        and folding are numpy sort-merge joins (_join_sorted /
        _closure_arrays); forward/backward scores live in dense [S]
        arrays with touched-entry resets, so per-frame cost is
        O(folded arcs · log) with no per-arc Python.  An arc survives
        if its forward score + best completion is within lattice_beam
        of the best path; eps suffixes into final states fold into
        final costs (word outputs on a pure eps suffix are dropped,
        matching the dense builder)."""
        g = self.graph.packed
        T = len(loglikes)
        pdf = np.asarray(self.tid_to_pdf)
        ll = np.asarray(loglikes)
        scale = float(self.acoustic_scale)
        rounds = max(self.eps_rounds, 1)
        wmax = rounds + 1  # eps-prefix words + emitting-arc word

        # recorded arcs by time: eps arcs recorded in frame t happen at
        # time t+1; emitting arcs of frame t span t → t+1.  rec_arc is
        # either a (tt, arcs) pair (device-compacted, the fast path) or
        # a [T, stages, W] plane with -1 fill.
        eps_at = [np.zeros(0, np.int64) for _ in range(T + 1)]
        em_at = [np.zeros(0, np.int64) for _ in range(T)]
        if isinstance(rec_arc, tuple):
            tt, arcs = rec_arc
        elif T > 0 and rec_arc.size:
            flat = rec_arc.reshape(T, -1)
            tt, pos = np.nonzero(flat >= 0)
            arcs = flat[tt, pos]
        else:
            tt = arcs = np.zeros(0, np.int64)
        states0, scores0, init_bp = self._init_frontier()

        if T > 0:
            nat = self._build_lattice_native(
                tt, arcs, T, ll, best_score, lattice_beam,
                pseudo_finals)
            if nat is not None:
                return nat

        if T > 0 and len(arcs):
            is_eps = g.ilabel[arcs] == 0
            eps_at = _bucket_pairs_by_time(
                tt[is_eps] + 1, arcs[is_eps], T + 1)
            em_at = _bucket_pairs_by_time(tt[~is_eps], arcs[~is_eps], T)
        # time-0 eps arcs come from the host init closure
        eps_at[0] = np.unique(np.concatenate(
            [eps_at[0],
             np.asarray(sorted(init_bp.values()), np.int64)]))

        # dense score planes with touched-entry reset (S can be 10^6;
        # a fresh [S] fill per frame would be O(T*S))
        S = self.graph.num_states
        FD = np.full(S, -np.inf, np.float64)
        live = states0[(states0 >= 0) & (scores0 > NEG_INF / 2)]
        live = np.unique(live.astype(np.int64))
        np.maximum.at(FD, states0[states0 >= 0].astype(np.int64),
                      scores0[states0 >= 0].astype(np.float64))

        # per-frame folded-arc arrays kept for backward + prune
        folded = []
        for t in range(T):
            em = em_at[t]
            if len(em) == 0 or len(live) == 0:
                folded.append(None)
                FD[live] = -np.inf
                live = np.zeros(0, np.int64)
                continue
            cu, cv, cw, cwords, ccnt = _closure_arrays(
                g, eps_at[t], live, rounds, wmax)
            # join closure targets with emitting-arc sources
            o = np.argsort(cv, kind="stable")
            cu, cv, cw = cu[o], cv[o], cw[o]
            cwords, ccnt = cwords[o], ccnt[o]
            esrc = g.src[em].astype(np.int64)
            rep, mi = _join_sorted(cv, esrc)
            if len(rep) == 0:
                folded.append(None)
                FD[live] = -np.inf
                live = np.zeros(0, np.int64)
                continue
            fa = em[rep]
            fu = cu[mi]
            fdst = g.dst[fa].astype(np.int64)
            ftid = g.ilabel[fa].astype(np.int64)
            fw = cw[mi] + g.weight[fa].astype(np.float64)
            fac = -ll[t, pdf[ftid]].astype(np.float64)
            fwords = cwords[mi].copy()
            fcnt = ccnt[mi].copy()
            eo = g.olabel[fa].astype(np.int32)
            has = eo > 0
            if has.any():
                fwords[np.nonzero(has)[0], fcnt[has]] = eo[has]
                fcnt = fcnt + has
            base = FD[fu]
            cand = base - fw - scale * fac
            # advance the dense forward plane
            FD[live] = -np.inf
            live = np.unique(fdst)
            np.maximum.at(FD, fdst, cand)
            folded.append(
                dict(u=fu, dst=fdst, tid=ftid, w=fw, ac=fac,
                     words=fwords, cnt=fcnt, base=base))

        # final costs + eps-suffix folding at time T
        if pseudo_finals is not None:
            # no real final reached: every surviving last-frame token is
            # final at zero cost (GetRawLattice use_final_probs=false)
            fstates, fscores = pseudo_finals
            ok = (fstates >= 0) & (fscores > NEG_INF / 2)
            finals = {int(s): 0.0 for s in np.unique(fstates[ok])}
        else:
            fin_all = np.asarray(self.graph.final, np.float64)
            fin_idx = np.nonzero(np.isfinite(fin_all))[0]
            finals = {int(s): float(fin_all[s]) for s in fin_idx}
            if len(eps_at[T]) and len(live):
                cu, cv, cw, _cword, _ccnt = _closure_arrays(
                    g, eps_at[T], live, rounds, wmax)
                fin_cost = np.asarray(self.graph.final, np.float64)
                reach_final = np.isfinite(fin_cost[cv])
                for u_, v_, w_ in zip(cu[reach_final], cv[reach_final],
                                      cw[reach_final]):
                    cand = float(w_) + fin_cost[v_]
                    if cand < finals.get(int(u_), np.inf):
                        finals[int(u_)] = float(cand)
        FD[live] = -np.inf

        # backward pass over the folded arrays (dense plane + touched
        # reset, same trick)
        BD = np.full(S, -np.inf, np.float64)
        btouched = np.asarray(sorted(finals.keys()), np.int64)
        for s, c in finals.items():
            BD[s] = max(BD[s], -c)
        tails = [None] * T
        for t in range(T - 1, -1, -1):
            f = folded[t]
            if f is None:
                BD[btouched] = -np.inf
                btouched = np.zeros(0, np.int64)
                continue
            tail = BD[f["dst"]]
            tails[t] = tail
            cand = tail - f["w"] - scale * f["ac"]
            BD[btouched] = -np.inf
            btouched = np.unique(f["u"])
            np.maximum.at(BD, f["u"], cand)
        BD[btouched] = -np.inf

        # prune + emit
        thresh = float(best_score) - float(lattice_beam)
        arcs_out: List[LatticeArc] = []
        for t in range(T):
            f = folded[t]
            if f is None:
                continue
            tot = f["base"] - f["w"] - scale * f["ac"] + tails[t]
            keep = np.nonzero(tot >= thresh - 1e-9)[0]
            words_m = f["words"]
            cnt_m = f["cnt"]
            for i in keep:
                arcs_out.append(LatticeArc(
                    t + 1, int(f["u"][i]), int(f["dst"][i]),
                    int(f["tid"][i]),
                    tuple(int(x) for x in words_m[i, :cnt_m[i]]),
                    float(f["w"][i]), float(f["ac"][i])))
        return Lattice(T, arcs_out, self.graph.start, finals)


@partial(jax.jit, static_argnames=("K", "A", "A_em", "chunk",
                                   "eps_rounds"))
def _beam_scan_batched(ll, t0, total_t, st, sc,
                       em_se, em_pack,
                       ep_se, ep_pack,
                       acoustic_scale, beam,
                       K: int, A: int, A_em: int, chunk: int,
                       eps_rounds: int):
    """vmap of the chunk scan over a batch of utterances (shared graph,
    per-utterance frontier/length)."""

    def one(ll1, tt1, st1, sc1):
        return _beam_scan(
            ll1, t0, tt1, st1, sc1,
            em_se, em_pack, ep_se, ep_pack,
            acoustic_scale, beam, K, A, A_em, chunk, eps_rounds, False)

    return jax.vmap(one)(ll, total_t, st, sc)


class BatchedBeamDecoder(BeamSearchDecoder):
    """Beam decode a BATCH of utterances in lockstep over one shared
    graph (reference: per-core run.pl sharding, decode.sh:129-134,
    re-expressed as one vectorized device program), parity-tested
    against single-stream decode.

    Caveat: the batch amortizes fixed per-frame op overhead but the
    [B, A] arc gathers scale with B, so it need not beat B sequential
    decodes (not measured on the H100 yet).  Use it for lockstep
    latency (serve B sessions concurrently).  Memory: the device-resident backpointer planes
    are [B, Tp, stages, K] int32 ×2 — size the batch accordingly."""

    def decode_batch(self, loglikes_list):
        """list of [T_b, P] → list of (words, ali, score)."""
        B = len(loglikes_list)
        if B == 0:
            return []
        lens = [len(x) for x in loglikes_list]
        Tmax = max(lens)
        states0, scores0, init_bp = self._init_frontier()
        # shared padded batch, assembled ON DEVICE: the scores come from
        # the acoustic model as device arrays, and np.asarray'ing them
        # back to host + re-uploading the [B, Tp, P] block would cost
        # a round trip per stream.  jnp.pad per stream is one tiny eager op;
        # distinct source lengths each compile a trivial pad kernel.
        n_chunks = max(1, (Tmax + self.chunk - 1) // self.chunk)
        n_chunks = 1 << (n_chunks - 1).bit_length()
        Tp = n_chunks * self.chunk
        padded = []
        for x in loglikes_list:
            xd = jnp.asarray(x, jnp.float32)
            if xd.shape[0] < Tp:
                xd = jnp.pad(xd, ((0, Tp - xd.shape[0]), (0, 0)))
            padded.append(xd)
        ll_dev = jnp.stack(padded)
        st = jnp.broadcast_to(jnp.asarray(states0), (B, self.K))
        sc = jnp.broadcast_to(jnp.asarray(scores0), (B, self.K))
        total_t = jnp.asarray(lens, jnp.int32)
        dev_arc, dev_slot = [], []
        for t0 in range(0, Tmax, self.chunk):
            (st, sc), outs = _beam_scan_batched(
                ll_dev, jnp.int32(t0), total_t, st, sc,
                self._dev["em_se"], self._dev["em_pack"],
                self._dev["ep_se"], self._dev["ep_pack"],
                jnp.float32(self.acoustic_scale),
                jnp.float32(self.beam),
                self.K, self.A, self.A_em, self.chunk, self.eps_rounds,
            )
            dev_arc.append(outs[0])
            dev_slot.append(outs[1])
        arc_planes = jnp.concatenate(dev_arc, axis=1)   # [B, Tc, st, K]
        slot_planes = jnp.concatenate(dev_slot, axis=1)
        n_stages = arc_planes.shape[2]
        # final-state selection on device: the old per-stream host
        # _best_final forced a frontier fetch that serialized the whole
        # batch on a round trip before the backtrace could dispatch
        ks, scores_dev, _ = jax.vmap(
            _best_final_dev, in_axes=(0, 0, None))(st, sc,
                                                   self._dev["final"])
        scores_out = [float(s) for s in np.asarray(scores_dev)]
        # per-utterance backtrace must start at ITS last frame: planes
        # beyond len are identity, so walking from the common end works
        final_slots, arcs_rev = _backtrace_scan_batched(
            arc_planes, slot_planes, ks.astype(jnp.int32), n_stages)
        arcs_rt = self._map_rev_arcs(np.asarray(arcs_rev))  # [B,Tc,desc]
        final_slots = np.asarray(final_slots)
        g = self.graph.packed
        out = []
        Tc = arcs_rt.shape[1]
        for b in range(B):
            T = lens[b]
            ali = np.zeros(T, np.int32)
            words_rev: List[int] = []
            for t_rev in range(Tc):
                frame = Tc - 1 - t_rev
                for arc in arcs_rt[b, t_rev]:
                    arc = int(arc)
                    if arc < 0:
                        continue
                    if g.olabel[arc] > 0:
                        words_rev.append(int(g.olabel[arc]))
                    if g.ilabel[arc] > 0 and frame < T:
                        ali[frame] = g.ilabel[arc]
            s = int(states0[final_slots[b]])
            while s in init_bp:
                a = init_bp[s]
                if g.olabel[a] > 0:
                    words_rev.append(int(g.olabel[a]))
                s = int(g.src[a])
            out.append((list(reversed(words_rev)), ali, scores_out[b]))
        return out
