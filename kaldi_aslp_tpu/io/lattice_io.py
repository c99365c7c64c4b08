"""Kaldi lattice serialization: text and binary (OpenFst VectorFst
layout), plus table holders.

JAX-native equivalent of the reference lattice I/O (reference:
src/lat/kaldi-lattice.{h,cc} — WriteLattice/WriteCompactLattice write
either the OpenFst binary VectorFst form or the FstPrinter text form;
LatticeHolder/CompactLatticeHolder detect binary by the leading FST
magic number instead of the usual \\0B marker, kaldi-lattice.cc:491-512;
weight text forms per src/fstext/lattice-weight.h:367 "g,a" and :676
"g,a,tid_tid_tid").

Binary layout (OpenFst 1.3.4 VectorFst, the version the reference
vendors per tools/Makefile:6):
  int32 magic 2125659606; string fsttype "vector"; string arctype
  ("lattice4" | "compactlattice44", lattice-weight.h:86,442); int32
  version 2; int32 flags 0; uint64 properties; int64 start; int64
  numstates; int64 numarcs; then per state: final weight, int64 narcs,
  arcs as (int32 ilabel, int32 olabel, weight, int32 nextstate).
  LatticeWeight = 2 float32; CompactLatticeWeight = 2 float32 + int32 n
  + n×int32 (lattice-weight.h:129-145,483-510).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, List, Tuple, Union

import numpy as np

from kaldi_aslp_tpu.decoder.compact import (
    CompactLattice,
    CompactLatticeArcT,
    StateLattice,
    StateLatticeArc,
)
from kaldi_aslp_tpu.io.kaldi_io import KaldiIOError

FST_MAGIC = 2125659606
_INF = float("inf")

AnyLattice = Union[StateLattice, CompactLattice]


def _fmt_f(v: float) -> str:
    """OpenFst float printing (matches FloatToString: 'Infinity',
    integer-valued floats without decimals)."""
    if np.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == int(v):
        return str(int(v))
    return repr(float(np.float32(v)))


def _parse_f(s: str) -> float:
    if s == "Infinity":
        return _INF
    if s == "-Infinity":
        return -_INF
    return float(s)


# ---------------------------------------------------------------------------
# text form
# ---------------------------------------------------------------------------

def write_lattice_text(f: BinaryIO, lat: AnyLattice) -> None:
    """FstPrinter-style text, newline-framed like the reference holder
    (leading '\\n' after the key, trailing blank line terminator)."""
    lines: List[str] = []
    if isinstance(lat, StateLattice):
        arcs_by_src: Dict[int, List[StateLatticeArc]] = {}
        for a in lat.arcs:
            arcs_by_src.setdefault(a.src, []).append(a)
        order = _print_order(lat.num_states, lat.start)
        for s in order:
            for a in arcs_by_src.get(s, ()):
                lines.append(
                    f"{a.src}\t{a.dst}\t{a.ilabel}\t{a.olabel}\t"
                    f"{_fmt_f(a.graph_cost)},{_fmt_f(a.acoustic_cost)}")
            if s in lat.finals:
                g, ac = lat.finals[s]
                lines.append(f"{s}\t{_fmt_f(g)},{_fmt_f(ac)}")
    else:
        arcs_by_src2: Dict[int, List[CompactLatticeArcT]] = {}
        for a in lat.arcs:
            arcs_by_src2.setdefault(a.src, []).append(a)
        order = _print_order(lat.num_states, lat.start)
        for s in order:
            for a in arcs_by_src2.get(s, ()):
                tids = "_".join(str(t) for t in a.tids)
                lines.append(
                    f"{a.src}\t{a.dst}\t{a.word}\t"
                    f"{_fmt_f(a.graph_cost)},{_fmt_f(a.acoustic_cost)},"
                    f"{tids}")
            if s in lat.finals:
                g, ac, tids_t = lat.finals[s]
                tids = "_".join(str(t) for t in tids_t)
                lines.append(
                    f"{s}\t{_fmt_f(g)},{_fmt_f(ac)},{tids}")
    f.write(("\n" + "\n".join(lines) + "\n\n").encode())


def _print_order(num_states: int, start: int) -> List[int]:
    """Start state first (OpenFst prints start first)."""
    order = [start] + [s for s in range(num_states) if s != start]
    return order


def read_lattice_text(f: BinaryIO) -> AnyLattice:
    """Read one newline-terminated text lattice; auto-detects Lattice
    vs CompactLattice by the weight field's comma count (reference:
    kaldi-lattice.cc LatticeReader::ReadText)."""
    lines: List[str] = []
    while True:
        line = f.readline()
        if not line:
            break
        text = line.decode().strip("\r\n")
        if text.strip() == "":
            if lines:
                break
            continue
        lines.append(text)
    if not lines:
        raise KaldiIOError("empty text lattice")
    is_compact = None
    parsed = []
    for text in lines:
        cols = text.split("\t") if "\t" in text else text.split()
        parsed.append(cols)
        w = cols[-1]
        if "," in w:
            n = w.count(",")
            got_compact = (n == 2)
            if is_compact is None:
                is_compact = got_compact
            elif is_compact != got_compact:
                raise KaldiIOError("mixed lattice/compact-lattice lines")
    if is_compact is None:
        is_compact = False
    max_state = 0
    arcs: List = []
    finals: Dict = {}
    start = None
    for cols in parsed:
        if len(cols) == 1:  # final with One weight
            s = int(cols[0])
            finals[s] = (0.0, 0.0, ()) if is_compact else (0.0, 0.0)
            max_state = max(max_state, s)
        elif len(cols) == 2:  # final with weight
            s = int(cols[0])
            finals[s] = _parse_weight(cols[1], is_compact)
            max_state = max(max_state, s)
        else:
            s, d = int(cols[0]), int(cols[1])
            max_state = max(max_state, s, d)
            if is_compact:
                if len(cols) == 4:
                    word, w = int(cols[2]), cols[3]
                elif len(cols) == 3:
                    word, w = int(cols[2]), "0,0,"
                else:
                    raise KaldiIOError(f"bad compact lattice line {cols}")
                g, ac, tids = _parse_weight(w, True)
                arcs.append(CompactLatticeArcT(s, d, word, g, ac, tids))
            else:
                if len(cols) == 5:
                    il, ol, w = int(cols[2]), int(cols[3]), cols[4]
                elif len(cols) == 4:
                    il, ol, w = int(cols[2]), int(cols[3]), "0,0"
                else:
                    raise KaldiIOError(f"bad lattice line {cols}")
                g, ac = _parse_weight(w, False)
                arcs.append(StateLatticeArc(s, d, il, ol, g, ac))
        if start is None:
            start = int(cols[0])
    n = max_state + 1
    if is_compact:
        return CompactLattice(n, start or 0, arcs, finals)
    return StateLattice(n, start or 0, arcs, finals)


def _parse_weight(s: str, compact: bool):
    parts = s.split(",")
    if compact:
        if len(parts) != 3:
            raise KaldiIOError(f"bad compact weight {s!r}")
        tids = tuple(int(t) for t in parts[2].split("_") if t)
        return _parse_f(parts[0]), _parse_f(parts[1]), tids
    if len(parts) != 2:
        raise KaldiIOError(f"bad lattice weight {s!r}")
    return _parse_f(parts[0]), _parse_f(parts[1])


# ---------------------------------------------------------------------------
# binary form (OpenFst VectorFst)
# ---------------------------------------------------------------------------

def _w_int32(f, v):
    f.write(struct.pack("<i", v))


def _w_int64(f, v):
    f.write(struct.pack("<q", v))


def _w_u64(f, v):
    f.write(struct.pack("<Q", v))


def _w_f32(f, v):
    f.write(struct.pack("<f", v))


def _w_str(f, s):
    b = s.encode()
    _w_int32(f, len(b))
    f.write(b)


def _r_int32(f):
    return struct.unpack("<i", f.read(4))[0]


def _r_int64(f):
    return struct.unpack("<q", f.read(8))[0]


def _r_u64(f):
    return struct.unpack("<Q", f.read(8))[0]


def _r_f32(f):
    return struct.unpack("<f", f.read(4))[0]


def _r_str(f):
    n = _r_int32(f)
    return f.read(n).decode()


def write_lattice_binary(f: BinaryIO, lat: AnyLattice) -> None:
    compact = isinstance(lat, CompactLattice)
    arcs_by_src: Dict[int, List] = {}
    for a in lat.arcs:
        arcs_by_src.setdefault(a.src, []).append(a)
    _w_int32(f, FST_MAGIC)
    _w_str(f, "vector")
    _w_str(f, "compactlattice44" if compact else "lattice4")
    _w_int32(f, 2)        # VectorFst kFileVersion
    _w_int32(f, 0)        # flags: no symbol tables
    _w_u64(f, 3)          # properties: kExpanded | kMutable
    _w_int64(f, lat.start)
    _w_int64(f, lat.num_states)
    _w_int64(f, len(lat.arcs))
    for s in range(lat.num_states):
        if compact:
            g, ac, tids = lat.finals.get(s, (_INF, _INF, ()))
            _w_f32(f, g)
            _w_f32(f, ac)
            _w_int32(f, len(tids))
            for t in tids:
                _w_int32(f, t)
        else:
            g, ac = lat.finals.get(s, (_INF, _INF))
            _w_f32(f, g)
            _w_f32(f, ac)
        arcs = arcs_by_src.get(s, ())
        _w_int64(f, len(arcs))
        for a in arcs:
            if compact:
                _w_int32(f, a.word)
                _w_int32(f, a.word)
                _w_f32(f, a.graph_cost)
                _w_f32(f, a.acoustic_cost)
                _w_int32(f, len(a.tids))
                for t in a.tids:
                    _w_int32(f, t)
                _w_int32(f, a.dst)
            else:
                _w_int32(f, a.ilabel)
                _w_int32(f, a.olabel)
                _w_f32(f, a.graph_cost)
                _w_f32(f, a.acoustic_cost)
                _w_int32(f, a.dst)


def read_lattice_binary(f: BinaryIO) -> AnyLattice:
    magic = _r_int32(f)
    if magic != FST_MAGIC:
        raise KaldiIOError(f"bad FST magic {magic}")
    fsttype = _r_str(f)
    arctype = _r_str(f)
    if fsttype not in ("vector", "const"):
        raise KaldiIOError(f"unsupported fst type {fsttype!r}")
    if fsttype == "const":
        raise KaldiIOError("const fst reading not supported; use vector")
    compact = arctype.startswith("compact")
    if arctype not in ("lattice4", "compactlattice44"):
        raise KaldiIOError(f"unsupported arc type {arctype!r}")
    version = _r_int32(f)
    if version < 1:
        raise KaldiIOError(f"bad VectorFst version {version}")
    _flags = _r_int32(f)
    if _flags & 0x3:
        raise KaldiIOError("lattices with symbol tables not supported")
    _props = _r_u64(f)
    start = _r_int64(f)
    num_states = _r_int64(f)
    _num_arcs = _r_int64(f)
    arcs: List = []
    finals: Dict = {}
    for s in range(num_states):
        if compact:
            g = _r_f32(f)
            ac = _r_f32(f)
            n = _r_int32(f)
            tids = tuple(_r_int32(f) for _ in range(n))
            if not (np.isinf(g) and np.isinf(ac)):
                finals[s] = (g, ac, tids)
        else:
            g = _r_f32(f)
            ac = _r_f32(f)
            if not (np.isinf(g) and np.isinf(ac)):
                finals[s] = (g, ac)
        narcs = _r_int64(f)
        for _ in range(narcs):
            il = _r_int32(f)
            ol = _r_int32(f)
            if compact:
                g = _r_f32(f)
                ac = _r_f32(f)
                n = _r_int32(f)
                tids = tuple(_r_int32(f) for _ in range(n))
                dst = _r_int32(f)
                arcs.append(CompactLatticeArcT(s, dst, ol, g, ac, tids))
            else:
                g = _r_f32(f)
                ac = _r_f32(f)
                dst = _r_int32(f)
                arcs.append(StateLatticeArc(s, dst, il, ol, g, ac))
    if compact:
        return CompactLattice(num_states, start, arcs, finals)
    return StateLattice(num_states, start, arcs, finals)


# ---------------------------------------------------------------------------
# table holders (binary detection by magic, kaldi-lattice.cc:491-512)
# ---------------------------------------------------------------------------

from kaldi_aslp_tpu.io.table import (  # noqa: E402
    Holder,
    RandomAccessTableReader,
    SequentialTableReader,
    TableWriter,
)


class LatticeHolder(Holder):
    """Holds either lattice shape; reads detect form automatically."""

    name = "lattice"

    def read_entry(self, f: BinaryIO):
        head = f.read(4)
        f.seek(-len(head), 1)
        if len(head) == 4 and struct.unpack("<i", head)[0] == FST_MAGIC:
            return read_lattice_binary(f)
        return read_lattice_text(f)

    def write(self, f, value, binary):
        # no \0B marker and no separator in binary mode, mirroring the
        # reference holder (kaldi-lattice.h:75-80)
        if binary:
            write_lattice_binary(f, value)
        else:
            write_lattice_text(f, value)


class CompactLatticeHolder(LatticeHolder):
    name = "compact-lattice"

    def write(self, f, value, binary):
        if not isinstance(value, CompactLattice):
            raise KaldiIOError("CompactLatticeHolder needs CompactLattice")
        super().write(f, value, binary)


def lattice_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, LatticeHolder())


def compact_lattice_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, CompactLatticeHolder())


def sequential_lattice_reader(rspec: str) -> SequentialTableReader:
    return SequentialTableReader(rspec, LatticeHolder())


def random_access_lattice_reader(rspec: str) -> RandomAccessTableReader:
    return RandomAccessTableReader(rspec, LatticeHolder())
