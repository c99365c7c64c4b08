"""Byte-aware host→device feature transport.

The reference's trainers copy float32 feature matrices host→GPU over
PCIe, where bandwidth is never the constraint
(src/aslp-nnet/nnet-randomizer.cc AddData / cu-matrix CopyFromMat).
Where the host→device link is narrow, corpus-fed training becomes
BYTE-BOUND on the feature upload (bench.py: `pipeline_efficiency_pct`;
whether it is on an H100 over PCIe is not measured yet).  The fix is
to ship fewer bytes and reconstruct on device:

- ``bf16``: features cross the wire as bfloat16 (2 bytes).  The
  flagship nets run their matmuls in bf16 anyway (models/recurrent.py
  ``bf16=True``), so nothing numeric is lost that those matmuls would
  have kept.
- ``int8``: per-feature-dim affine quantization (4 bytes of scale +
  offset per dim, ~1 byte per value).  Log-mel/MFCC dims have a few
  tens of dB of dynamic range, far inside int8's ~48 dB SNR; the
  dequantized features are re-zeroed outside each utterance's length so
  padding stays exact.
- ``f32``: passthrough (the reference-faithful default).

Masks are never transported: ``[S, T]`` frame masks are derived on
device from the (tiny) length vector.

Host side: ``pack_feats``.  Device side (call INSIDE jit):
``unpack_feats`` + ``mask_from_lengths``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import ml_dtypes
import numpy as np

TRANSPORTS = ("f32", "bf16", "int8", "int8d")


def mask_from_lengths(in_lens: jnp.ndarray, T: int) -> jnp.ndarray:
    """[S] lengths → [S, T] float32 0/1 mask (device-side)."""
    t = jnp.arange(T, dtype=jnp.int32)[None, :]
    return (t < in_lens.astype(jnp.int32)[:, None]).astype(jnp.float32)


def pack_feats(feats: np.ndarray, transport: str,
               in_lens: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Optional[np.ndarray],
                          Optional[np.ndarray]]:
    """Host-side cast/quantize.  Returns (payload, scale, offset); the
    scale/offset are None except for int8 (where they are [D] f32).

    ``in_lens`` (for padded [S, T, D] input) restricts the int8
    quantization statistics to real frames — padding zeros would
    otherwise pollute the per-dim range.  Padding bytes are arbitrary
    by contract: unpack_feats re-zeroes them from the lengths.  The
    fused native pad+quantize (native/batch_pack.cc) is used when the
    C++ library is available."""
    if transport == "f32":
        return np.asarray(feats, np.float32), None, None
    if transport == "bf16":
        f = np.asarray(feats, np.float32)
        if f.ndim == 3 and in_lens is not None:
            from kaldi_aslp_tpu import native
            lens = np.asarray(in_lens, np.int64)
            packed = native.pad_pack(
                [f[s, :lens[s]] for s in range(f.shape[0])],
                f.shape[1], "bf16")
            if packed is not None:
                return packed
        return f.astype(ml_dtypes.bfloat16), None, None
    if transport == "int8":
        f = np.asarray(feats, np.float32)
        if f.ndim == 3 and in_lens is not None:
            from kaldi_aslp_tpu import native
            lens = np.asarray(in_lens, np.int64)
            packed = native.pad_pack(
                [f[s, :lens[s]] for s in range(f.shape[0])],
                f.shape[1], "int8")
            if packed is not None:
                return packed
            real = np.concatenate(
                [f[s, :lens[s]] for s in range(f.shape[0])])
        else:
            real = f.reshape(-1, f.shape[-1])
        lo = real.min(axis=0)
        hi = real.max(axis=0)
        scale = np.maximum(hi - lo, 1e-10).astype(np.float32) / 254.0
        offset = lo.astype(np.float32)
        q = np.rint((f - offset) / scale) - 127.0
        return q.astype(np.int8), scale, offset
    if transport == "int8d":
        # time-delta-coded int8: for a link that compresses the stream,
        # and consecutive feature frames are highly correlated, so
        # shipping first-order time differences of the int8 codes turns
        # the payload into near-zero bytes the compressor can crush
        # (measured rates in STATUS.md).  The per-dim scale is widened
        # (if needed) so every frame-to-frame difference fits int8 —
        # the encode is then a pure vectorized diff and the device
        # decode an exact integer cumsum along T.
        f = np.asarray(feats, np.float32)
        if f.ndim == 3 and in_lens is not None:
            lens = np.asarray(in_lens, np.int64)
            real = np.concatenate(
                [f[s, :lens[s]] for s in range(f.shape[0])])
        else:
            real = f.reshape(-1, f.shape[-1])
        lo = real.min(axis=0)
        hi = real.max(axis=0)
        scale = np.maximum(hi - lo, 1e-10).astype(np.float32) / 254.0
        v = np.rint((f - lo) / scale)                 # [.., T, D] codes
        dmax = np.abs(np.diff(v, axis=-2)).max(axis=tuple(
            range(v.ndim - 1))) if v.shape[-2] > 1 else np.zeros(
            v.shape[-1])
        widen = np.maximum(dmax / 127.0, 1.0).astype(np.float32)
        scale = scale * widen
        v = np.clip(np.rint((f - lo) / scale), 0, 254)
        d = np.diff(v, axis=-2, prepend=0.0)
        d[..., 0, :] = v[..., 0, :] - 127.0           # first frame code
        return d.astype(np.int8), scale, lo.astype(np.float32)
    raise ValueError(f"unknown transport {transport!r}")


def unpack_feats(payload: jnp.ndarray, scale: Optional[jnp.ndarray],
                 offset: Optional[jnp.ndarray],
                 in_lens: Optional[jnp.ndarray] = None,
                 delta: bool = False) -> jnp.ndarray:
    """Device-side inverse of pack_feats (traceable).  For int8 the
    padded region is re-zeroed from ``in_lens`` so padding stays an
    exact 0.0 (quantization would otherwise leave `offset`-ish values
    there, and splice/conv layers read across frame boundaries).
    ``delta=True`` decodes the "int8d" wire format: integer cumsum
    along T reverses the time-delta coding exactly."""
    if payload.dtype == jnp.int8:
        codes = payload.astype(jnp.int32)
        if delta:
            codes = jnp.cumsum(codes, axis=-2)
        f = (codes.astype(jnp.float32) + 127.0) * scale + offset
        if in_lens is not None and f.ndim == 3:
            f = f * mask_from_lengths(in_lens, f.shape[1])[:, :, None]
        return f
    if payload.dtype == jnp.bfloat16:
        return payload.astype(jnp.float32)
    return payload
