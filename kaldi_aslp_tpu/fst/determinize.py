"""Weighted determinization and minimization.

JAX-native equivalents of the reference graph-optimization passes
(reference: src/fstext/determinize-star.h DeterminizeStar — subset
determinization of functional transducers with residual weights and
output-string residuals, epsilon-input chains for multi-symbol outputs;
src/fstbin/fstminimizeencoded.cc — minimization treating
(ilabel, olabel, weight) as an encoded label).

Host-side graph algebra used by mkgraph-style pipelines to shrink
L∘G / CLG before H expansion."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, FrozenSet, List, Tuple

from kaldi_aslp_tpu.fst.fst import EPS, Arc, Fst

INF = float("inf")


def _quantize(w: float, delta: float) -> int:
    return int(round(w / delta))


def determinize(fst: Fst, delta: float = 1e-4,
                max_states: int = 1_000_000) -> Fst:
    """Subset determinization with residual weights + output residuals
    (reference: determinize-star.h).  Input must be functional on the
    subsets it explores (true for our L∘G graphs).  Input-epsilon arcs
    are closed over first (they carry no output in our graphs after
    remove_epsilon; word-bearing eps-input arcs are folded into the
    output residual)."""
    out = Fst()
    # element: (state, residual weight, residual output tuple)
    Element = Tuple[int, float, Tuple[int, ...]]

    def closure(elems: List[Element]) -> List[Element]:
        """Extend over input-eps arcs (collecting outputs/weights)."""
        best: Dict[Tuple[int, Tuple[int, ...]], float] = {}
        stack = list(elems)
        for s, w, o in elems:
            key = (s, o)
            if w < best.get(key, INF):
                best[key] = w
        while stack:
            s, w, o = stack.pop()
            if w > best.get((s, o), INF):
                continue
            for a in fst.arcs[s]:
                if a.ilabel != EPS:
                    continue
                no = o + ((a.olabel,) if a.olabel != EPS else ())
                nw = w + a.weight
                if nw < best.get((a.nextstate, no), INF) - delta / 2:
                    best[(a.nextstate, no)] = nw
                    stack.append((a.nextstate, nw, no))
        return [(s, w, o) for (s, o), w in best.items()]

    def normalize(elems: List[Element]):
        """Pull out the common weight and common output prefix."""
        w_min = min(w for _, w, _ in elems)
        # longest common output prefix
        outs = [o for _, _, o in elems]
        prefix: Tuple[int, ...] = outs[0]
        for o in outs[1:]:
            n = 0
            for x, y2 in zip(prefix, o):
                if x != y2:
                    break
                n += 1
            prefix = prefix[:n]
            if not prefix:
                break
        normed = tuple(sorted(
            (s, _quantize(w - w_min, delta), o[len(prefix):])
            for s, w, o in elems
        ))
        return w_min, prefix, normed

    subset_id: Dict = {}

    def get_state(key) -> int:
        if key not in subset_id:
            if len(subset_id) >= max_states:
                raise RuntimeError("determinize: state blowup")
            subset_id[key] = out.add_state()
        return subset_id[key]

    def emit(src: int, ilabel: int, outputs: Tuple[int, ...],
             weight: float, dst: int) -> None:
        """Arc with a possibly multi-symbol output → eps-input chain."""
        if len(outputs) <= 1:
            out.add_arc(src, Arc(ilabel, outputs[0] if outputs else EPS,
                                 weight, dst))
            return
        cur = src
        for k, o in enumerate(outputs[:-1]):
            nxt = out.add_state()
            out.add_arc(cur, Arc(ilabel if k == 0 else EPS, o,
                                 weight if k == 0 else 0.0, nxt))
            cur = nxt
        out.add_arc(cur, Arc(EPS, outputs[-1], 0.0, dst))

    start_elems = closure([(fst.start, 0.0, ())])
    w0, p0, start_key = normalize(start_elems)
    start = get_state(start_key)
    out.set_start(start)
    if w0 != 0.0 or p0:
        raise RuntimeError("determinize: weighted/labeled start residual")

    queue = deque([start_key])
    done = {start_key}
    while queue:
        key = queue.popleft()
        src = subset_id[key]
        elems = [(s, w * delta, o) for (s, w, o) in key]
        # final weight: elements that are final — outputs must be pushed
        final_w = INF
        for s, w, o in elems:
            if s in fst.finals:
                if o:
                    # residual output at a final state: emit via an
                    # eps chain to a fresh final state
                    fstate = out.add_state()
                    emit(src, EPS, o, w + fst.finals[s], fstate)
                    out.set_final(fstate, 0.0)
                else:
                    final_w = min(final_w, w + fst.finals[s])
        if final_w < INF:
            out.set_final(src, final_w)
        # group non-eps arcs by input label
        by_label: Dict[int, List[Element]] = defaultdict(list)
        for s, w, o in elems:
            for a in fst.arcs[s]:
                if a.ilabel == EPS:
                    continue
                by_label[a.ilabel].append((
                    a.nextstate, w + a.weight,
                    o + ((a.olabel,) if a.olabel != EPS else ()),
                ))
        for ilabel, nexts in sorted(by_label.items()):
            nexts = closure(nexts)
            w_min, prefix, nkey = normalize(nexts)
            dst = get_state(nkey)
            emit(src, ilabel, prefix, w_min, dst)
            if nkey not in done:
                done.add(nkey)
                queue.append(nkey)
    return out.connect()


def minimize_encoded(fst: Fst, delta: float = 1e-4) -> Fst:
    """Weighted minimization with (ilabel, olabel, quantized weight)
    treated as one encoded label (reference: fstminimizeencoded) —
    partition refinement (Moore's algorithm)."""
    n = fst.num_states
    if n == 0:
        return Fst()
    # initial partition: by final weight
    def final_sig(s):
        return _quantize(fst.finals.get(s, INF if s not in fst.finals
                                        else 0.0), delta) \
            if s in fst.finals else None
    block: List[int] = [0] * n
    sig_map: Dict = {}
    for s in range(n):
        sig = final_sig(s)
        if sig not in sig_map:
            sig_map[sig] = len(sig_map)
        block[s] = sig_map[sig]
    changed = True
    while changed:
        changed = False
        sig_map = {}
        new_block = [0] * n
        for s in range(n):
            arcsig = tuple(sorted(
                (a.ilabel, a.olabel, _quantize(a.weight, delta),
                 block[a.nextstate])
                for a in fst.arcs[s]
            ))
            sig = (block[s], arcsig)
            if sig not in sig_map:
                sig_map[sig] = len(sig_map)
            new_block[s] = sig_map[sig]
        if new_block != block:
            block = new_block
            changed = True
    # build the quotient
    out = Fst()
    reps: Dict[int, int] = {}
    for s in range(n):
        if block[s] not in reps:
            reps[block[s]] = out.add_state()
    out.set_start(reps[block[fst.start]])
    added = set()
    for s in range(n):
        b = block[s]
        if (b, "done") in added:
            continue
        added.add((b, "done"))
        for a in fst.arcs[s]:
            out.add_arc(reps[b], Arc(a.ilabel, a.olabel, a.weight,
                                     reps[block[a.nextstate]]))
        if s in fst.finals:
            out.set_final(reps[b], fst.finals[s])
    return out.connect()
