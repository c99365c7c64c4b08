"""Kaldi-form lattices: state-based Lattice / CompactLattice types,
conversion from the internal time-synchronous lattice, lattice
determinization, scaling and best-path.

JAX-native equivalents of the reference lattice layer (reference:
src/lat/kaldi-lattice.h — Lattice is an FST with LatticeWeight
(graph_cost, acoustic_cost), CompactLattice is an acceptor over words
with CompactLatticeWeight (LatticeWeight + transition-id string);
src/lat/determinize-lattice-pruned.{h,cc} DeterminizeLatticePruned —
one path per word sequence, keeping the best-scoring alignment;
src/latbin/lattice-scale.cc, lattice-best-path.cc).

The determinization is a weighted subset construction over the acyclic
word-level view of the lattice: a det state is a normalized set of
(node, pending-words, Δgraph, Δacoustic, tid-string) elements; arcs are
labelled with one word; the element with the best (graph+acoustic)
total contributes the arc weight and alignment — exactly the reference
semantics (Viterbi per word sequence, best alignment kept).  Since the
internal lattice is acyclic the construction always terminates;
``prune`` drops elements more than that margin worse than the best
element of their det state (the reference's lattice-determinization
pruning is likewise approximate)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_aslp_tpu.decoder.lattice import Lattice, LatticeArc


# ---------------------------------------------------------------------------
# state-based lattice types (the on-disk shapes)
# ---------------------------------------------------------------------------

@dataclass
class StateLatticeArc:
    src: int
    dst: int
    ilabel: int          # transition-id (0 = eps)
    olabel: int          # word (0 = eps)
    graph_cost: float
    acoustic_cost: float


@dataclass
class StateLattice:
    """Kaldi ``Lattice``: transducer tid → word with paired costs."""
    num_states: int
    start: int
    arcs: List[StateLatticeArc]
    finals: Dict[int, Tuple[float, float]]   # state → (graph, acoustic)


@dataclass
class CompactLatticeArcT:
    src: int
    dst: int
    word: int
    graph_cost: float
    acoustic_cost: float
    tids: Tuple[int, ...]


@dataclass
class CompactLattice:
    """Kaldi ``CompactLattice``: word acceptor, tid strings on arcs."""
    num_states: int
    start: int
    arcs: List[CompactLatticeArcT]
    # state → (graph, acoustic, tids)
    finals: Dict[int, Tuple[float, float, Tuple[int, ...]]]


# ---------------------------------------------------------------------------
# internal ↔ state lattice
# ---------------------------------------------------------------------------

def lattice_to_state(lat: Lattice) -> StateLattice:
    """Internal time-synchronous lattice → Kaldi Lattice shape.

    Nodes are (t, graph state); arcs carrying k>1 words become a chain
    with eps-input links for the extra words (the reference's lattices
    hold one word per arc for the same reason)."""
    nodes: Dict[Tuple[int, int], int] = {}

    def nid(t: int, s: int) -> int:
        key = (t, s)
        if key not in nodes:
            nodes[key] = len(nodes)
        return nodes[key]

    start = nid(0, lat.start)
    arcs: List[StateLatticeArc] = []
    extra = [len(nodes)]  # box for chain-state allocation

    def alloc() -> int:
        extra[0] += 1
        return extra[0] - 1

    # ensure node ids for all arc endpoints first (stable numbering)
    for a in lat.arcs:
        nid(a.t - 1, a.src)
        nid(a.t, a.dst)
    for s in lat.final_costs:
        nid(lat.num_frames, s)
    extra[0] = len(nodes)

    for a in lat.arcs:
        u = nodes[(a.t - 1, a.src)]
        v = nodes[(a.t, a.dst)]
        words = list(a.words)
        first = words[0] if words else 0
        if len(words) <= 1:
            arcs.append(StateLatticeArc(
                u, v, a.tid, first, a.graph_cost, a.acoustic_cost))
        else:
            mid = alloc()
            arcs.append(StateLatticeArc(
                u, mid, a.tid, first, a.graph_cost, a.acoustic_cost))
            for w in words[1:-1]:
                nxt = alloc()
                arcs.append(StateLatticeArc(mid, nxt, 0, w, 0.0, 0.0))
                mid = nxt
            arcs.append(StateLatticeArc(mid, v, 0, words[-1], 0.0, 0.0))
    finals = {nodes[(lat.num_frames, s)]: (c, 0.0)
              for s, c in lat.final_costs.items()}
    return StateLattice(extra[0], start, arcs, finals)


def state_to_lattice(slat: StateLattice) -> Lattice:
    """Kaldi Lattice shape → internal time-synchronous lattice.

    Requires a time-synchronous transducer (every path to a node crosses
    the same number of emitting arcs — true for lattices this framework
    writes).  Eps-input arcs (word chains) are folded forward into their
    emitting predecessor."""
    # depth = number of emitting arcs from start
    order, depth = _toposort_depth(slat)
    # fold eps-arc chains: words + costs accumulate onto the emitting
    # arc that precedes them
    out_eps: Dict[int, List[StateLatticeArc]] = {}
    for a in slat.arcs:
        if a.ilabel == 0:
            out_eps.setdefault(a.src, []).append(a)

    def eps_tails(state: int):
        """Paths of eps arcs from state → (end state, words, g, a)."""
        results = []
        stack = [(state, (), 0.0, 0.0)]
        while stack:
            s, words, g, ac = stack.pop()
            succ = out_eps.get(s, ())
            results.append((s, words, g, ac))
            for e in succ:
                w2 = words + ((e.olabel,) if e.olabel > 0 else ())
                stack.append((e.dst, w2, g + e.graph_cost,
                              ac + e.acoustic_cost))
        return results

    arcs: List[LatticeArc] = []
    finals: Dict[int, float] = {}
    T = max(depth.values()) if depth else 0
    for a in slat.arcs:
        if a.ilabel == 0:
            continue
        t = depth[a.src] + 1
        base_words = (a.olabel,) if a.olabel > 0 else ()
        for (end, words, g, ac) in eps_tails(a.dst):
            arcs.append(LatticeArc(
                t, a.src, end, a.ilabel, base_words + words,
                a.graph_cost + g, a.acoustic_cost + ac))
    for s, (g, ac) in slat.finals.items():
        if depth.get(s, -1) == T:
            finals[s] = g + ac
    return Lattice(T, arcs, slat.start, finals)


def _toposort_depth(slat: StateLattice):
    """Topological order + emitting-depth per state (raises on cycles
    or time-asynchronous structure)."""
    n = slat.num_states
    adj: Dict[int, List[StateLatticeArc]] = {}
    indeg = np.zeros(n, np.int64)
    for a in slat.arcs:
        adj.setdefault(a.src, []).append(a)
        indeg[a.dst] += 1
    from collections import deque
    q = deque(s for s in range(n) if indeg[s] == 0)
    depth = {slat.start: 0}
    order = []
    seen = 0
    while q:
        s = q.popleft()
        order.append(s)
        seen += 1
        for a in adj.get(s, ()):
            if s in depth:
                d = depth[s] + (1 if a.ilabel > 0 else 0)
                prev = depth.get(a.dst)
                if prev is None:
                    depth[a.dst] = d
                elif prev != d:
                    raise ValueError(
                        "lattice is not time-synchronous: state "
                        f"{a.dst} reachable at depths {prev} and {d}")
            indeg[a.dst] -= 1
            if indeg[a.dst] == 0:
                q.append(a.dst)
    if seen != n:
        raise ValueError("lattice contains a cycle")
    return order, depth


# ---------------------------------------------------------------------------
# determinization (reference: determinize-lattice-pruned.h)
# ---------------------------------------------------------------------------

class DeterminizeFailed(Exception):
    """Raised when subset construction exceeds its work budget
    (reference: DeterminizeLatticePruned returns false when max_mem is
    exhausted, determinize-lattice-pruned.h)."""


def determinize_lattice(lat: Lattice,
                        prune: Optional[float] = None,
                        max_work: Optional[int] = None) -> CompactLattice:
    """One arc per word per det state; best alignment kept (reference:
    DeterminizeLatticePruned semantics).  ``max_work`` bounds total
    closure expansions — the role of the reference's ``max_mem`` guard;
    on overrun raises :class:`DeterminizeFailed` (callers retry with a
    tighter ``prune`` or fall back to the raw lattice, exactly the
    reference wrapper's strategy)."""
    work_budget = [max_work if max_work is not None else -1]

    def charge(n: int = 1):
        if work_budget[0] < 0:
            return
        work_budget[0] -= n
        if work_budget[0] < 0:
            raise DeterminizeFailed(
                "determinization exceeded work budget "
                f"(max_work={max_work}); retry with smaller prune")

    # word-level adjacency over (t, state) nodes
    arcs_from: Dict[Tuple[int, int], List[LatticeArc]] = {}
    for a in lat.arcs:
        arcs_from.setdefault((a.t - 1, a.src), []).append(a)

    Element = Tuple[Tuple[int, int], Tuple[int, ...], float, float,
                    Tuple[int, ...]]
    # (node, pending_words, graph, acoustic, tids)

    def closure(elems: List[Element]):
        """Follow word-free arcs to quiescence; emit (next_word →
        list of (element-after-consuming-that-word)).

        Elements are deduped per (node, pending) keeping the single
        best (cost, alignment) — the lattice semiring keeps ONE
        weight+string per subset state (reference: LatticeWeight Plus
        = min by weight, lexicographic string tie-break,
        lattice-weight.h).  Keying on the alignment string too made
        the expansion exponential in self-loop alternations (measured:
        66 s / 7M expansions on a 473-arc lattice)."""
        by_word: Dict[int, List[Element]] = {}
        final_elems: List[Element] = []
        stack = list(elems)
        best_seen: Dict[Tuple, Tuple[float, Tuple[int, ...]]] = {}
        while stack:
            charge()
            node, pending, g, ac, tids = stack.pop()
            key = (node, pending)
            tot = g + ac
            cur = best_seen.get(key)
            if cur is not None and cur <= (tot, tids):
                continue
            best_seen[key] = (tot, tids)
            if pending:
                by_word.setdefault(pending[0], []).append(
                    (node, pending[1:], g, ac, tids))
                continue
            # final?
            if node[0] == lat.num_frames and node[1] in lat.final_costs:
                final_elems.append((node, (), g, ac, tids))
            for a in arcs_from.get(node, ()):
                nnode = (a.t, a.dst)
                ng, na = g + a.graph_cost, ac + a.acoustic_cost
                ntids = tids + (a.tid,)
                if a.words:
                    by_word.setdefault(a.words[0], []).append(
                        (nnode, tuple(a.words[1:]), ng, na, ntids))
                else:
                    stack.append((nnode, (), ng, na, ntids))
        return by_word, final_elems

    def normalize(elems: List[Element]):
        """Subtract best (g, ac) and common tid prefix → (det key,
        shifted elements, (g0, ac0, tids0))."""
        # semiring dedup: one best (cost, alignment) per (node, pending)
        bykey: Dict[Tuple, Element] = {}
        for e in elems:
            k = (e[0], e[1])
            cur = bykey.get(k)
            if cur is None or (e[2] + e[3], e[4]) < (cur[2] + cur[3],
                                                     cur[4]):
                bykey[k] = e
        elems = list(bykey.values())
        best = min(elems, key=lambda e: e[2] + e[3])
        g0, ac0 = best[2], best[3]
        tids_list = [e[4] for e in elems]
        prefix = tids_list[0]
        for t in tids_list[1:]:
            k = 0
            while k < len(prefix) and k < len(t) and prefix[k] == t[k]:
                k += 1
            prefix = prefix[:k]
        p = len(prefix)
        shifted = []
        for (node, pending, g, ac, tids) in elems:
            dg, dac = g - g0, ac - ac0
            if prune is not None and dg + dac > prune:
                continue
            shifted.append((node, pending, round(dg, 6), round(dac, 6),
                            tids[p:]))
        shifted.sort()
        return tuple(shifted), shifted, (g0, ac0, prefix)

    start_elem: Element = ((0, lat.start), (), 0.0, 0.0, ())
    key0, elems0, _ = normalize([start_elem])
    ids: Dict[Tuple, int] = {key0: 0}
    work = [(0, elems0)]
    out_arcs: List[CompactLatticeArcT] = []
    finals: Dict[int, Tuple[float, float, Tuple[int, ...]]] = {}
    while work:
        sid, elems = work.pop()
        by_word, final_elems = closure(list(elems))
        if final_elems:
            best = min(final_elems, key=lambda e: e[2] + e[3])
            fc = lat.final_costs[best[0][1]]
            finals[sid] = (best[2] + fc, best[3], best[4])
        for w, nelems in by_word.items():
            key, shifted, (g0, ac0, tids0) = normalize(nelems)
            if not shifted:
                continue
            nid = ids.get(key)
            if nid is None:
                nid = len(ids)
                ids[key] = nid
                work.append((nid, shifted))
            out_arcs.append(CompactLatticeArcT(
                sid, nid, w, g0, ac0, tids0))
    return CompactLattice(len(ids), 0, out_arcs, finals)


def determinize_lattice_pruned(lat: Lattice, prune: float,
                               max_work: int = 2_000_000,
                               retries: int = 3) -> CompactLattice:
    """Determinize with a work budget, halving the prune beam on
    overrun (reference: DeterminizeLatticeDeleteInputSymbols wrapper /
    LatticeDeterminizerPruned retry-with-smaller-beam behaviour,
    determinize-lattice-pruned.cc).  Raises DeterminizeFailed only if
    every retry also overruns."""
    err: Optional[DeterminizeFailed] = None
    for _ in range(retries + 1):
        try:
            return determinize_lattice(lat, prune=prune, max_work=max_work)
        except DeterminizeFailed as e:
            err = e
            prune *= 0.5
    raise err  # type: ignore[misc]


# ---------------------------------------------------------------------------
# operations on the on-disk shapes (reference: latbin tools)
# ---------------------------------------------------------------------------

def scale_lattice(obj, lm_scale: float = 1.0, acoustic_scale: float = 1.0):
    """(reference: lattice-scale.cc ScaleLattice with lm2acwt=0 etc. —
    diagonal scaling of (graph, acoustic))."""
    if isinstance(obj, StateLattice):
        arcs = [StateLatticeArc(a.src, a.dst, a.ilabel, a.olabel,
                                a.graph_cost * lm_scale,
                                a.acoustic_cost * acoustic_scale)
                for a in obj.arcs]
        finals = {s: (g * lm_scale, ac * acoustic_scale)
                  for s, (g, ac) in obj.finals.items()}
        return StateLattice(obj.num_states, obj.start, arcs, finals)
    arcs = [CompactLatticeArcT(a.src, a.dst, a.word,
                               a.graph_cost * lm_scale,
                               a.acoustic_cost * acoustic_scale, a.tids)
            for a in obj.arcs]
    finals = {s: (g * lm_scale, ac * acoustic_scale, tids)
              for s, (g, ac, tids) in obj.finals.items()}
    return CompactLattice(obj.num_states, obj.start, arcs, finals)


def _dag_best_path(num_states, start, arcs, finals, arc_cost, final_cost):
    """Generic min-cost path over an acyclic arc list."""
    adj: Dict[int, List] = {}
    indeg = np.zeros(num_states, np.int64)
    for a in arcs:
        adj.setdefault(a.src, []).append(a)
        indeg[a.dst] += 1
    from collections import deque
    q = deque(s for s in range(num_states) if indeg[s] == 0)
    INF = np.inf
    cost = np.full(num_states, INF)
    cost[start] = 0.0
    back: Dict[int, object] = {}
    topo = []
    while q:
        s = q.popleft()
        topo.append(s)
        for a in adj.get(s, ()):
            if cost[s] < INF:
                c = cost[s] + arc_cost(a)
                if c < cost[a.dst]:
                    cost[a.dst] = c
                    back[a.dst] = a
            indeg[a.dst] -= 1
            if indeg[a.dst] == 0:
                q.append(a.dst)
    if len(topo) != num_states:
        raise ValueError("lattice contains a cycle")
    best_s, best_c = None, INF
    for s, f in finals.items():
        if cost[s] < INF:
            c = cost[s] + final_cost(f)
            if c < best_c:
                best_s, best_c = s, c
    if best_s is None:
        raise RuntimeError("lattice has no successful path")
    path = []
    s = best_s
    while s in back:
        a = back[s]
        path.append(a)
        s = a.src
    path.reverse()
    return path, best_s, best_c


def compact_lattice_best_path(clat: CompactLattice,
                              lm_scale: float = 1.0,
                              acoustic_scale: float = 1.0
                              ) -> Tuple[List[int], List[int], float]:
    """(reference: lattice-best-path.cc) → (words, alignment, cost)."""
    path, fs, cost = _dag_best_path(
        clat.num_states, clat.start, clat.arcs, clat.finals,
        lambda a: lm_scale * a.graph_cost
        + acoustic_scale * a.acoustic_cost,
        lambda f: lm_scale * f[0] + acoustic_scale * f[1],
    )
    words = [a.word for a in path if a.word > 0]
    ali: List[int] = []
    for a in path:
        ali.extend(a.tids)
    ali.extend(clat.finals[fs][2])
    return words, ali, cost


def state_lattice_best_path(slat: StateLattice,
                            lm_scale: float = 1.0,
                            acoustic_scale: float = 1.0
                            ) -> Tuple[List[int], List[int], float]:
    path, _fs, cost = _dag_best_path(
        slat.num_states, slat.start, slat.arcs, slat.finals,
        lambda a: lm_scale * a.graph_cost
        + acoustic_scale * a.acoustic_cost,
        lambda f: lm_scale * f[0] + acoustic_scale * f[1],
    )
    words = [a.olabel for a in path if a.olabel > 0]
    ali = [a.ilabel for a in path if a.ilabel > 0]
    return words, ali, cost


def compact_lattice_lmrescore(clat: CompactLattice, G,
                              lm_scale: float = 1.0) -> CompactLattice:
    """Lattice-level LM rescoring: compose the word acceptor with a
    (possibly backoff) G over words and fold ``lm_scale`` × the LM cost
    into the graph costs (reference: latbin/lattice-lmrescore.cc —
    typical workflow runs this twice, once with the old G at
    lm_scale=-1 to remove its scores, then with the new G at +1).

    ``G`` is an Fst whose arcs are word-labelled (ilabel == olabel ==
    word id) with eps arcs as backoff.  States of the result are
    (lattice state, G state) pairs; paths whose word sequence G rejects
    are dropped."""
    from collections import deque

    INF = float("inf")

    # eps closure per G state: reachable (state, cost) via backoff arcs
    def g_eps_closure(g0: int):
        best = {g0: 0.0}
        q = deque([g0])
        while q:
            s = q.popleft()
            for a in G.arcs[s]:
                if a.ilabel == 0:
                    c = best[s] + a.weight
                    if c < best.get(a.nextstate, INF) - 1e-12:
                        best[a.nextstate] = c
                        q.append(a.nextstate)
        return best

    closure_cache: Dict[int, Dict[int, float]] = {}

    def step_word(g0: int, word: int):
        """All (g', lm_cost) after consuming ``word`` from g0 (indexed
        arc lookup — see Fst.arcs_with_label)."""
        if g0 not in closure_cache:
            closure_cache[g0] = g_eps_closure(g0)
        out: Dict[int, float] = {}
        for s, c0 in closure_cache[g0].items():
            for a in G.arcs_with_label(s, word):
                c = c0 + a.weight
                if c < out.get(a.nextstate, INF) - 1e-12:
                    out[a.nextstate] = c
        return out

    arcs_by_src: Dict[int, List[CompactLatticeArcT]] = {}
    for a in clat.arcs:
        arcs_by_src.setdefault(a.src, []).append(a)

    ids: Dict[Tuple[int, int], int] = {}

    def pid(u: int, g: int) -> int:
        key = (u, g)
        if key not in ids:
            ids[key] = len(ids)
        return ids[key]

    start = pid(clat.start, G.start)
    out_arcs: List[CompactLatticeArcT] = []
    finals: Dict[int, Tuple[float, float, Tuple[int, ...]]] = {}
    seen = set()
    work = deque([(clat.start, G.start)])
    seen.add((clat.start, G.start))
    while work:
        u, g = work.popleft()
        src_id = pid(u, g)
        if u in clat.finals:
            fg, fa, ftids = clat.finals[u]
            if g not in closure_cache:
                closure_cache[g] = g_eps_closure(g)
            best_final = INF
            for s, c0 in closure_cache[g].items():
                if s in G.finals:
                    best_final = min(best_final, c0 + G.finals[s])
            if np.isfinite(best_final):
                finals[src_id] = (fg + lm_scale * best_final, fa, ftids)
        for a in arcs_by_src.get(u, ()):
            if a.word == 0:
                targets = {g: 0.0}
            else:
                targets = step_word(g, a.word)
            for g2, lm_cost in targets.items():
                out_arcs.append(CompactLatticeArcT(
                    src_id, pid(a.dst, g2), a.word,
                    a.graph_cost + lm_scale * lm_cost,
                    a.acoustic_cost, a.tids))
                if (a.dst, g2) not in seen:
                    seen.add((a.dst, g2))
                    work.append((a.dst, g2))
    return CompactLattice(len(ids), start, out_arcs, finals)
