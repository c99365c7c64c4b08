"""Kaldi Table I/O: ark/scp readers and writers.

JAX-framework replacement for the reference Table layer (reference:
src/util/kaldi-table.h, kaldi-holder.h): SequentialTableReader /
RandomAccessTableReader / TableWriter over rspecifier / wspecifier strings
(``ark:-``, ``scp:feats.scp``, ``ark,t:f``, ``ark:gunzip -c f.gz|``,
``ark,scp:f.ark,f.scp``).  Pipes are honoured so reference recipe command
strings (e.g. feats_tr="ark:copy-feats ... |") keep working.  A pipe's
command runs with JAX pinned to the CPU: when both ends are this
package's tools, only the process that opened the pipe may hold the card.
"""

from __future__ import annotations

import io
import os
import subprocess
from typing import BinaryIO, Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from kaldi_aslp_tpu.io import kaldi_io
from kaldi_aslp_tpu.io.kaldi_io import (
    BINARY_MARKER,
    KaldiIOError,
)
from kaldi_aslp_tpu.utils.jax_setup import cpu_only_env


# ---------------------------------------------------------------------------
# specifier parsing
# ---------------------------------------------------------------------------

class Specifier:
    """Parsed r/wspecifier (reference: kaldi-table.cc ReadScriptFile etc.)."""

    def __init__(self, spec: str, for_write: bool):
        self.raw = spec
        self.for_write = for_write
        if ":" not in spec:
            raise KaldiIOError(f"bad specifier (missing ':'): {spec!r}")
        opts, self.path = spec.split(":", 1)
        parts = opts.split(",")
        self.kind = parts[0]  # "ark" | "scp" | "ark,scp" handled below
        flags = set(parts[1:])
        if "scp" in flags and self.kind == "ark":
            self.kind = "ark,scp"
            flags.discard("scp")
            # path is "foo.ark,foo.scp"
            self.path, self.scp_path = self.path.split(",", 1)
        else:
            self.scp_path = None
        if self.kind not in ("ark", "scp", "ark,scp"):
            raise KaldiIOError(f"bad specifier kind {self.kind!r} in {spec!r}")
        self.text = "t" in flags            # text mode
        self.permissive = "p" in flags      # tolerate missing entries
        self.sorted = "s" in flags
        self.called_sorted = "cs" in flags
        self.once = "o" in flags
        self.binary = not self.text


def _open_rxfilename(path: str) -> BinaryIO:
    """Open an extended input filename: file, '-', 'cmd |', 'file:offset'."""
    path = path.strip()
    if path == "" or path == "-":
        return os.fdopen(os.dup(0), "rb")
    if path.endswith("|"):
        proc = subprocess.Popen(
            path[:-1], shell=True, stdout=subprocess.PIPE,
            env=cpu_only_env(),
        )
        return proc.stdout  # type: ignore[return-value]
    if ":" in path:
        base, _, off = path.rpartition(":")
        if off.isdigit() and os.path.exists(base):
            f = open(base, "rb")
            f.seek(int(off))
            return f
    return open(path, "rb")


def _open_wxfilename(path: str) -> BinaryIO:
    path = path.strip()
    if path == "" or path == "-":
        return os.fdopen(os.dup(1), "wb")
    if path.startswith("|"):
        proc = subprocess.Popen(path[1:], shell=True, stdin=subprocess.PIPE,
                                env=cpu_only_env())
        return proc.stdin  # type: ignore[return-value]
    return open(path, "wb")


# ---------------------------------------------------------------------------
# holders: how to read/write one value
# ---------------------------------------------------------------------------

def _read_key(f: BinaryIO) -> Optional[str]:
    """Read whitespace-terminated key; None at EOF."""
    chars = []
    while True:
        c = f.read(1)
        if not c:
            return b"".join(chars).decode() if chars else None
        if c in b" \t\n":
            if chars:
                return b"".join(chars).decode()
            continue
        chars.append(c)


class Holder:
    name = "object"

    def read(self, f: BinaryIO, binary: bool):
        raise NotImplementedError

    def write(self, f: BinaryIO, value, binary: bool):
        raise NotImplementedError

    def read_entry(self, f: BinaryIO):
        """Read one value after the key: sniff the binary marker."""
        pos_binary = _consume_marker(f)
        if pos_binary:
            return self.read(f, True)
        return self.read(f, False)


def _consume_marker(f: BinaryIO) -> bool:
    head = f.read(2)
    if head == BINARY_MARKER:
        return True
    # not binary: un-read. Pipes aren't seekable → wrap in buffered reader
    if hasattr(f, "seek") and f.seekable():
        f.seek(-len(head), 1)
    else:  # pragma: no cover - pipe path exercised via BufferedReader
        raise KaldiIOError("non-seekable text stream")
    return False


class MatrixHolder(Holder):
    name = "matrix"

    def read(self, f, binary):
        if binary:
            return kaldi_io.read_matrix(f, True)
        # text: consume through closing ']'
        return _read_text_through_bracket(f, kaldi_io.read_text_matrix_lines)

    def write(self, f, value, binary):
        if binary:
            f.write(BINARY_MARKER)
        kaldi_io.write_matrix(f, np.asarray(value), binary)
        if not binary:
            return


class VectorHolder(Holder):
    name = "vector"

    def read(self, f, binary):
        if binary:
            return kaldi_io.read_vector(f, True)
        return _read_text_through_bracket(
            f, lambda s: np.array(s.strip("[] \n").split(), dtype=np.float32)
        )

    def write(self, f, value, binary):
        if binary:
            f.write(BINARY_MARKER)
        kaldi_io.write_vector(f, np.asarray(value), binary)


class IntVectorHolder(Holder):
    name = "int-vector"

    def read(self, f, binary):
        return kaldi_io.read_int_vector(f, binary)

    def write(self, f, value, binary):
        if binary:
            f.write(BINARY_MARKER)
        kaldi_io.write_int_vector(f, np.asarray(value, dtype=np.int32), binary)


class PosteriorHolder(Holder):
    name = "posterior"

    def read(self, f, binary):
        return kaldi_io.read_posterior(f, binary)

    def write(self, f, value, binary):
        if binary:
            f.write(BINARY_MARKER)
        kaldi_io.write_posterior(f, value, binary)


def _read_text_through_bracket(f: BinaryIO, parse: Callable):
    """Accumulate text until the matching ']' then parse."""
    buf = []
    depth = 0
    seen_open = False
    while True:
        c = f.read(1)
        if not c:
            break
        buf.append(c)
        if c == b"[":
            depth += 1
            seen_open = True
        elif c == b"]":
            depth -= 1
            if seen_open and depth == 0:
                break
    return parse(b"".join(buf).decode())


# ---------------------------------------------------------------------------
# readers / writers
# ---------------------------------------------------------------------------

class SequentialTableReader:
    """Iterate (key, value) in file order (reference: kaldi-table.h:93)."""

    def __init__(self, rspecifier: str, holder: Holder):
        self.spec = Specifier(rspecifier, for_write=False)
        self.holder = holder
        if self.spec.kind == "scp":
            self._scp = _load_scp(self.spec.path)
            self._iter = self._iter_scp()
        else:
            raw = _open_rxfilename(self.spec.path)
            self._f = io.BufferedReader(io.BytesIO(raw.read())) \
                if not _seekable(raw) else raw
            if not _seekable(raw):
                raw.close()
            self._iter = self._iter_ark()

    def _iter_ark(self) -> Iterator[Tuple[str, object]]:
        while True:
            key = _read_key(self._f)
            if key is None:
                break
            yield key, self.holder.read_entry(self._f)
        self._f.close()

    def _iter_scp(self) -> Iterator[Tuple[str, object]]:
        for key, rxfilename in self._scp:
            try:
                f = _open_rxfilename(rxfilename)
                buf = f if _seekable(f) else io.BufferedReader(
                    io.BytesIO(f.read())
                )
                value = self.holder.read_entry(buf)
                buf.close()
            except (OSError, KaldiIOError):
                if self.spec.permissive:
                    continue
                raise
            yield key, value

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        return self._iter


class RandomAccessTableReader:
    """Keyed lookup; loads scp lazily, ark eagerly (reference: kaldi-table.h)."""

    def __init__(self, rspecifier: str, holder: Holder):
        self.spec = Specifier(rspecifier, for_write=False)
        self.holder = holder
        self._cache: Dict[str, object] = {}
        if self.spec.kind == "scp":
            self._scp = dict(_load_scp(self.spec.path))
        else:
            self._scp = None
            for key, value in SequentialTableReader(rspecifier, holder):
                self._cache[key] = value

    def __contains__(self, key: str) -> bool:
        if self._scp is not None:
            return key in self._scp
        return key in self._cache

    def __getitem__(self, key: str):
        if key in self._cache:
            return self._cache[key]
        if self._scp is None or key not in self._scp:
            raise KeyError(key)
        f = _open_rxfilename(self._scp[key])
        buf = f if _seekable(f) else io.BufferedReader(io.BytesIO(f.read()))
        value = self.holder.read_entry(buf)
        buf.close()
        self._cache[key] = value
        return value


class TableWriter:
    """Write (key, value) entries; supports ark / ark,t / ark,scp / scp."""

    def __init__(self, wspecifier: str, holder: Holder):
        self.spec = Specifier(wspecifier, for_write=True)
        self.holder = holder
        if self.spec.kind == "scp":
            raise KaldiIOError(
                "writing to scp: alone is unsupported (use ark,scp:)"
            )
        self._f = _open_wxfilename(self.spec.path)
        self._scp_f = (
            open(self.spec.scp_path, "w") if self.spec.scp_path else None
        )
        self._abs_path = (
            os.path.abspath(self.spec.path)
            if self.spec.path not in ("", "-") and not self.spec.path.startswith("|")
            else self.spec.path
        )

    def write(self, key: str, value) -> None:
        if " " in key:
            raise KaldiIOError(f"key may not contain spaces: {key!r}")
        self._f.write(key.encode() + b" ")
        if self._scp_f is not None:
            offset = self._f.tell()
            self._scp_f.write(f"{key} {self._abs_path}:{offset}\n")
        self.holder.write(self._f, value, self.spec.binary)
        if not self.spec.binary:
            self._f.write(b"")  # text holders terminate with newline already
        self._f.flush()

    def __setitem__(self, key: str, value) -> None:
        self.write(key, value)

    def close(self) -> None:
        self._f.close()
        if self._scp_f is not None:
            self._scp_f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _seekable(f) -> bool:
    try:
        return f.seekable()
    except Exception:
        return False


def _load_scp(path: str):
    entries = []
    f = _open_rxfilename(path)
    for line in io.TextIOWrapper(f):
        line = line.strip()
        if not line:
            continue
        key, _, rxfilename = line.partition(" ")
        entries.append((key, rxfilename.strip()))
    return entries


# ---------------------------------------------------------------------------
# typed convenience constructors (the reference's typedef zoo,
# kaldi-table.h:240-260)
# ---------------------------------------------------------------------------

def sequential_matrix_reader(rspec: str) -> SequentialTableReader:
    return SequentialTableReader(rspec, MatrixHolder())


def sequential_vector_reader(rspec: str) -> SequentialTableReader:
    return SequentialTableReader(rspec, VectorHolder())


def sequential_int_vector_reader(rspec: str) -> SequentialTableReader:
    return SequentialTableReader(rspec, IntVectorHolder())


def sequential_posterior_reader(rspec: str) -> SequentialTableReader:
    return SequentialTableReader(rspec, PosteriorHolder())


def random_access_matrix_reader(rspec: str) -> RandomAccessTableReader:
    return RandomAccessTableReader(rspec, MatrixHolder())


def random_access_vector_reader(rspec: str) -> RandomAccessTableReader:
    return RandomAccessTableReader(rspec, VectorHolder())


def random_access_int_vector_reader(rspec: str) -> RandomAccessTableReader:
    return RandomAccessTableReader(rspec, IntVectorHolder())


def random_access_posterior_reader(rspec: str) -> RandomAccessTableReader:
    return RandomAccessTableReader(rspec, PosteriorHolder())


def matrix_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, MatrixHolder())


def vector_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, VectorHolder())


def int_vector_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, IntVectorHolder())


def posterior_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, PosteriorHolder())
