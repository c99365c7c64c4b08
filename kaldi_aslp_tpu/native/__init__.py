"""Native (C++) runtime components, loaded via ctypes.

The reference's runtime around the compute path is C++ (Table I/O,
data loading — reference: src/util/); these are the JAX-framework
equivalents.  Built on first use with the system compiler into
``~/.cache/kaldi_aslp_tpu``; every entry point has a pure-Python
fallback so the package works without a toolchain."""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


class ArkEntryStruct(ctypes.Structure):
    _fields_ = [
        ("key_off", ctypes.c_int64),
        ("key_len", ctypes.c_int32),
        ("kind", ctypes.c_int32),
        ("data_off", ctypes.c_int64),
        ("rows", ctypes.c_int32),
        ("cols", ctypes.c_int32),
    ]


def _build() -> Optional[str]:
    here = os.path.dirname(__file__)
    srcs = [os.path.join(here, f)
            for f in ("ark_scan.cc", "batch_pack.cc", "fst_compose.cc",
                      "lattice_build.cc")]
    cache = os.path.join(
        os.path.expanduser("~"), ".cache", "kaldi_aslp_tpu"
    )
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, "libkaldi_aslp_native.so")
    if os.path.exists(so) and all(
            os.path.getmtime(so) >= os.path.getmtime(s) for s in srcs):
        return so
    for cxx in ("c++", "g++", "clang++"):
        try:
            subprocess.run(
                [cxx, "-O2", "-shared", "-fPIC", "-o", so] + srcs,
                check=True, capture_output=True,
            )
            return so
        except (FileNotFoundError, subprocess.CalledProcessError):
            continue
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        so = _build()
        if so is not None:
            lib = ctypes.CDLL(so)
            lib.ark_scan.restype = ctypes.c_int64
            lib.ark_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ArkEntryStruct), ctypes.c_int64,
            ]
            lib.gather_rows_f32.restype = None
            lib.gather_rows_f32.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
            ]
            PF = ctypes.POINTER(ctypes.c_float)
            PI = ctypes.POINTER(ctypes.c_int32)
            lib.pad_batch_f32.restype = None
            lib.pad_batch_f32.argtypes = [
                ctypes.POINTER(PF), PI, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, PF,
            ]
            lib.pad_batch_bf16.restype = None
            lib.pad_batch_bf16.argtypes = [
                ctypes.POINTER(PF), PI, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_uint16),
            ]
            lib.pad_batch_int8.restype = None
            lib.pad_batch_int8.argtypes = [
                ctypes.POINTER(PF), PI, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int8), PF, PF,
            ]
            P64 = ctypes.POINTER(ctypes.c_int64)
            lib.fst_compose.restype = ctypes.c_void_p
            lib.fst_compose.argtypes = (
                [ctypes.c_int32, PI, PI, PI, PF, PI, PF, ctypes.c_int32]
                * 2 + [P64, P64, ctypes.POINTER(ctypes.c_int32)])
            lib.fst_compose_fetch.restype = None
            lib.fst_compose_fetch.argtypes = [
                ctypes.c_void_p, PI, PI, PI, PF, PI, PF]
            lib.fst_compose_free.restype = None
            lib.fst_compose_free.argtypes = [ctypes.c_void_p]
            PD = ctypes.POINTER(ctypes.c_double)
            lib.lattice_build.restype = ctypes.c_int64
            lib.lattice_build.argtypes = [
                PI, PI, PI, PI, PF, ctypes.c_int64,          # graph
                PF, ctypes.c_int64, ctypes.c_int64, PI,       # ll/T/P/lut
                ctypes.c_double,                              # scale
                P64, P64, ctypes.c_int64,                     # eps recs
                P64, P64, ctypes.c_int64,                     # em recs
                P64, PD, ctypes.c_int64,                      # init
                P64, PD, ctypes.c_int64,                      # finals
                ctypes.c_int64, PF,                           # fold/g_final
                ctypes.c_double, ctypes.c_double,             # best/beam
                ctypes.c_int64, ctypes.c_int64,               # rounds/wmax
                ctypes.c_int64, PI, P64, P64, PI, PD, PD, PI, PI,
                ctypes.c_int64, P64, PD, P64,                 # finals out
            ]
            _LIB = lib
    return _LIB


def _row_ptrs(arrays):
    PF = ctypes.POINTER(ctypes.c_float)
    ptrs = (PF * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = a.ctypes.data_as(PF)
    return ptrs


def pad_pack(feats_list, Tmax: int, mode: str = "f32"):
    """Fused pad(+cast/quantize) of per-utterance [T_i, D] float32
    matrices into one [S, Tmax, D] buffer (the data-reader.cc stream
    assembly role).  Returns (payload, scale, offset) — scale/offset
    are None except int8 — or None when no native library is available
    (callers fall back to numpy)."""
    lib = get_lib()
    if lib is None:  # pragma: no cover - toolchain present in CI
        return None
    feats_list = [np.ascontiguousarray(f, np.float32) for f in feats_list]
    S = len(feats_list)
    D = feats_list[0].shape[1]
    # the C side trusts these unconditionally (raw memcpy); a mismatch
    # that the numpy fallback would raise on must not read/write OOB
    for f in feats_list:
        if f.ndim != 2 or f.shape[1] != D:
            raise ValueError(
                f"pad_pack: inconsistent feature dim {f.shape} vs D={D}")
        if len(f) > Tmax:
            raise ValueError(
                f"pad_pack: utterance length {len(f)} exceeds Tmax={Tmax}")
    lens = np.asarray([len(f) for f in feats_list], np.int32)
    ptrs = _row_ptrs(feats_list)
    lens_p = lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if mode == "f32":
        out = np.empty((S, Tmax, D), np.float32)
        lib.pad_batch_f32(ptrs, lens_p, S, Tmax, D,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out, None, None
    if mode == "bf16":
        import ml_dtypes
        out = np.empty((S, Tmax, D), np.uint16)
        lib.pad_batch_bf16(
            ptrs, lens_p, S, Tmax, D,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        return out.view(ml_dtypes.bfloat16), None, None
    if mode == "int8":
        out = np.empty((S, Tmax, D), np.int8)
        scale = np.empty(D, np.float32)
        offset = np.empty(D, np.float32)
        lib.pad_batch_int8(
            ptrs, lens_p, S, Tmax, D,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            scale.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offset.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out, scale, offset
    raise ValueError(f"unknown mode {mode!r}")


KIND_FM, KIND_DM, KIND_FV, KIND_IV = 1, 2, 3, 4
KIND_CM, KIND_CM2, KIND_CM3 = 5, 6, 7


class FastArkReader:
    """Zero-copy ark access: one native scan, then numpy views.

    Falls back to the Python table reader when no compiler is present."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._buf = f.read()
        self._entries = {}
        lib = get_lib()
        if lib is not None:
            self._scan_native(lib)
        else:  # pragma: no cover - toolchain always present in CI
            self._scan_python()

    def _scan_native(self, lib) -> None:
        cap = 4096
        arr = (ArkEntryStruct * cap)()
        n = lib.ark_scan(self._buf, len(self._buf), arr, cap)
        while n == -2:
            cap *= 4
            arr = (ArkEntryStruct * cap)()
            n = lib.ark_scan(self._buf, len(self._buf), arr, cap)
        if n < 0:
            raise IOError(f"native ark scan failed on {self.path}")
        for i in range(n):
            e = arr[i]
            key = self._buf[e.key_off:e.key_off + e.key_len].decode()
            self._entries[key] = (e.kind, e.data_off, e.rows, e.cols)

    def _scan_python(self) -> None:
        import io
        from kaldi_aslp_tpu.io.table import (
            MatrixHolder, _read_key,
        )
        f = io.BytesIO(self._buf)
        holder = MatrixHolder()
        while True:
            key = _read_key(f)
            if key is None:
                break
            start = f.tell()
            value = holder.read_entry(f)
            self._entries[key] = ("py", start, value)

    def keys(self):
        return list(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def __getitem__(self, key) -> np.ndarray:
        e = self._entries[key]
        if e[0] == "py":
            return e[2]
        kind, off, rows, cols = e
        buf = self._buf
        if kind == KIND_FM:
            return np.frombuffer(buf, dtype="<f4", count=rows * cols,
                                 offset=off).reshape(rows, cols)
        if kind == KIND_DM:
            return np.frombuffer(buf, dtype="<f8", count=rows * cols,
                                 offset=off).reshape(rows, cols)
        if kind == KIND_FV:
            return np.frombuffer(buf, dtype="<f4", count=rows,
                                 offset=off)
        if kind == KIND_IV:
            return np.frombuffer(buf, dtype="<i4", count=rows,
                                 offset=off)
        # compressed: reuse the python decoder on a slice
        import io as _io
        from kaldi_aslp_tpu.io import kaldi_io
        token = {KIND_CM: 1, KIND_CM2: 2, KIND_CM3: 3}[kind]
        return kaldi_io._read_compressed_matrix(
            _io.BytesIO(buf[off:]), token
        )

    def gather_rows(self, key: str, row_indices: np.ndarray
                    ) -> np.ndarray:
        """Native row gather for minibatch assembly (FM entries)."""
        e = self._entries[key]
        lib = get_lib()
        if e[0] == "py" or lib is None or e[0] != KIND_FM:
            return np.ascontiguousarray(self[key][row_indices])
        kind, off, rows, cols = e
        idx = np.ascontiguousarray(row_indices, np.int64)
        out = np.empty((len(idx), cols), np.float32)
        lib.gather_rows_f32(
            self._buf, off, cols,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out


def fst_compose_csr(csr1, start1: int, csr2, start2: int):
    """Native tropical composition + connect over raw CSR arrays —
    the array-native boundary of fst_compose.cc (fsttablecompose role).

    ``csr1``/``csr2`` are (row [S+1], il, ol, w, dst, fin [S]) numpy
    tuples; machine 2's arcs must already be ilabel-sorted within each
    state.  Returns (src, il, ol, w, dst, fin, start) arrays or None
    without the native library.  No per-arc Python anywhere: at the
    multi-million-arc scale of real decode-graph builds the old
    Fst-object boundary (one Arc() per output arc) cost minutes while
    the C++ core ran in seconds."""
    lib = get_lib()
    if lib is None:  # pragma: no cover - toolchain present in CI
        return None
    PI = ctypes.POINTER(ctypes.c_int32)
    PF = ctypes.POINTER(ctypes.c_float)

    def ptrs(csr):
        row, il, ol, w, dst, fin = [np.ascontiguousarray(a) for a in csr]
        return [row.ctypes.data_as(PI), il.ctypes.data_as(PI),
                ol.ctypes.data_as(PI), w.ctypes.data_as(PF),
                dst.ctypes.data_as(PI), fin.ctypes.data_as(PF)]

    S1 = len(csr1[0]) - 1
    S2 = len(csr2[0]) - 1
    ns = ctypes.c_int64()
    na = ctypes.c_int64()
    st = ctypes.c_int32()
    handle = lib.fst_compose(
        S1, *ptrs(csr1), start1, S2, *ptrs(csr2), start2,
        ctypes.byref(ns), ctypes.byref(na), ctypes.byref(st))
    try:
        src = np.empty(na.value, np.int32)
        il = np.empty(na.value, np.int32)
        ol = np.empty(na.value, np.int32)
        w = np.empty(na.value, np.float32)
        dst = np.empty(na.value, np.int32)
        fin = np.empty(max(ns.value, 1), np.float32)
        lib.fst_compose_fetch(
            handle, src.ctypes.data_as(PI), il.ctypes.data_as(PI),
            ol.ctypes.data_as(PI), w.ctypes.data_as(PF),
            dst.ctypes.data_as(PI), fin.ctypes.data_as(PF))
    finally:
        lib.fst_compose_free(handle)
    return src, il, ol, w, dst, fin[:ns.value], int(st.value)


def fst_compose(f1, f2):
    """Native tropical composition + connect (fst_compose.cc), the
    fsttablecompose role.  Returns a new Fst, or None when no native
    library is available (Fst.compose falls back to python).  Exact
    drop-in for fst/fst.py Fst.compose — identical state numbering and
    arc order (tests assert to_text equality)."""
    lib = get_lib()
    if lib is None:  # pragma: no cover - toolchain present in CI
        return None
    from kaldi_aslp_tpu.fst.fst import Arc, Fst

    PI = ctypes.POINTER(ctypes.c_int32)
    PF = ctypes.POINTER(ctypes.c_float)

    def to_csr(f, sort_by_il):
        S = f.num_states
        row = np.zeros(S + 1, np.int32)
        il, ol, w, dst = [], [], [], []
        for s, arcs in enumerate(f.arcs):
            if sort_by_il:
                arcs = sorted(arcs, key=lambda a: a.ilabel)  # stable
            row[s + 1] = row[s] + len(arcs)
            for a in arcs:
                il.append(a.ilabel)
                ol.append(a.olabel)
                w.append(a.weight)
                dst.append(a.nextstate)
        fin = np.full(S, np.inf, np.float32)
        for s, c in f.finals.items():
            fin[s] = c
        return (row, np.asarray(il, np.int32), np.asarray(ol, np.int32),
                np.asarray(w, np.float32), np.asarray(dst, np.int32),
                fin)

    def ptrs(csr):
        row, il, ol, w, dst, fin = csr
        return [row.ctypes.data_as(PI), il.ctypes.data_as(PI),
                ol.ctypes.data_as(PI), w.ctypes.data_as(PF),
                dst.ctypes.data_as(PI), fin.ctypes.data_as(PF)]

    c1 = to_csr(f1, False)
    c2 = to_csr(f2, True)
    ns = ctypes.c_int64()
    na = ctypes.c_int64()
    st = ctypes.c_int32()
    handle = lib.fst_compose(
        f1.num_states, *ptrs(c1), f1.start,
        f2.num_states, *ptrs(c2), f2.start,
        ctypes.byref(ns), ctypes.byref(na), ctypes.byref(st))
    try:
        src = np.empty(na.value, np.int32)
        il = np.empty(na.value, np.int32)
        ol = np.empty(na.value, np.int32)
        w = np.empty(na.value, np.float32)
        dst = np.empty(na.value, np.int32)
        fin = np.empty(max(ns.value, 1), np.float32)
        lib.fst_compose_fetch(
            handle, src.ctypes.data_as(PI), il.ctypes.data_as(PI),
            ol.ctypes.data_as(PI), w.ctypes.data_as(PF),
            dst.ctypes.data_as(PI), fin.ctypes.data_as(PF))
    finally:
        lib.fst_compose_free(handle)

    out = Fst()
    for _ in range(ns.value):
        out.add_state()
    if st.value >= 0:
        out.set_start(int(st.value))
    for i in range(na.value):
        out.add_arc(int(src[i]), Arc(int(il[i]), int(ol[i]),
                                     float(w[i]), int(dst[i])))
    for s in np.nonzero(np.isfinite(fin[:ns.value]))[0]:
        out.set_final(int(s), float(fin[s]))
    return out


def lattice_build(g_src, g_dst, g_ilabel, g_olabel, g_weight, n_states,
                  ll, tid_pdf, scale,
                  eps_t, eps_arc, em_t, em_arc,
                  init_states, init_scores,
                  final_states, final_costs, fold_suffix, g_final,
                  best_score, lattice_beam, rounds, wmax):
    """Native host lattice build (forward-backward prune + eps folding
    over device-pruned records; see lattice_build.cc).  Returns a dict
    of arrays or None when no native library is available — the caller
    (decoder/beam.py:_build_lattice) falls back to the numpy path."""
    lib = get_lib()
    if lib is None:  # pragma: no cover - toolchain present in CI
        return None
    PI = ctypes.POINTER(ctypes.c_int32)
    PF = ctypes.POINTER(ctypes.c_float)
    PD = ctypes.POINTER(ctypes.c_double)
    P64 = ctypes.POINTER(ctypes.c_int64)

    def i32(a):
        return np.ascontiguousarray(a, np.int32)

    def i64(a):
        return np.ascontiguousarray(a, np.int64)

    def f32(a):
        return np.ascontiguousarray(a, np.float32)

    def f64(a):
        return np.ascontiguousarray(a, np.float64)

    g_src, g_dst = i32(g_src), i32(g_dst)
    g_ilabel, g_olabel = i32(g_ilabel), i32(g_olabel)
    g_weight, ll, g_final = f32(g_weight), f32(ll), f32(g_final)
    tid_pdf = i32(tid_pdf)
    eps_t, eps_arc = i64(eps_t), i64(eps_arc)
    em_t, em_arc = i64(em_t), i64(em_arc)
    init_states, init_scores = i64(init_states), f64(init_scores)
    final_states, final_costs = i64(final_states), f64(final_costs)
    T = int(ll.shape[0]) if ll.ndim == 2 else 0
    P = int(ll.shape[1]) if ll.ndim == 2 else 1
    wmax = int(max(wmax, 1))

    cap = max(int(len(em_t)) * 2 + 64, 1024)
    fin_cap = max(int(len(final_states)) + int(n_states) // 64 + 1024,
                  2048)
    while True:
        tend = np.empty(cap, np.int32)
        u = np.empty(cap, np.int64)
        dst = np.empty(cap, np.int64)
        tid = np.empty(cap, np.int32)
        w = np.empty(cap, np.float64)
        ac = np.empty(cap, np.float64)
        words = np.empty(cap * wmax, np.int32)
        wcnt = np.empty(cap, np.int32)
        fin_s = np.empty(fin_cap, np.int64)
        fin_c = np.empty(fin_cap, np.float64)
        fin_n = np.zeros(1, np.int64)
        r = lib.lattice_build(
            g_src.ctypes.data_as(PI), g_dst.ctypes.data_as(PI),
            g_ilabel.ctypes.data_as(PI), g_olabel.ctypes.data_as(PI),
            g_weight.ctypes.data_as(PF), ctypes.c_int64(int(n_states)),
            ll.ctypes.data_as(PF), ctypes.c_int64(T), ctypes.c_int64(P),
            tid_pdf.ctypes.data_as(PI), ctypes.c_double(float(scale)),
            eps_t.ctypes.data_as(P64), eps_arc.ctypes.data_as(P64),
            ctypes.c_int64(len(eps_t)),
            em_t.ctypes.data_as(P64), em_arc.ctypes.data_as(P64),
            ctypes.c_int64(len(em_t)),
            init_states.ctypes.data_as(P64),
            init_scores.ctypes.data_as(PD),
            ctypes.c_int64(len(init_states)),
            final_states.ctypes.data_as(P64),
            final_costs.ctypes.data_as(PD),
            ctypes.c_int64(len(final_states)),
            ctypes.c_int64(1 if fold_suffix else 0),
            g_final.ctypes.data_as(PF),
            ctypes.c_double(float(best_score)),
            ctypes.c_double(float(lattice_beam)),
            ctypes.c_int64(int(rounds)), ctypes.c_int64(wmax),
            ctypes.c_int64(cap),
            tend.ctypes.data_as(PI), u.ctypes.data_as(P64),
            dst.ctypes.data_as(P64), tid.ctypes.data_as(PI),
            w.ctypes.data_as(PD), ac.ctypes.data_as(PD),
            words.ctypes.data_as(PI), wcnt.ctypes.data_as(PI),
            ctypes.c_int64(fin_cap), fin_s.ctypes.data_as(P64),
            fin_c.ctypes.data_as(PD), fin_n.ctypes.data_as(P64),
        )
        r = int(r)
        if r == -1000000002:
            raise RuntimeError(
                "eps word chain exceeds declared eps diameter "
                f"({wmax}); graph eps structure is inconsistent")
        if r <= -1000000000:
            return None          # unexpected native error: fall back
        if r == -1000000003 or int(fin_n[0]) > fin_cap:
            fin_cap = max(int(fin_n[0]), 2 * fin_cap)
            continue
        if r < 0:
            cap = -r
            continue
        n = r
        nf = int(fin_n[0])
        return {
            "tend": tend[:n], "u": u[:n], "dst": dst[:n],
            "tid": tid[:n], "w": w[:n], "ac": ac[:n],
            "words": words[:n * wmax].reshape(n, wmax),
            "wcnt": wcnt[:n],
            "fin_states": fin_s[:nf], "fin_costs": fin_c[:nf],
        }
