"""Batched corpus feature extraction: one device program per bucket.

The reference extracts features one utterance at a time through
compute-mfcc-feats/compute-fbank-feats (src/featbin/, driven by
steps/make_fbank.sh); per-utterance calls are cheap on a local CPU.
On a device every per-utterance dispatch+fetch is a round trip (and
every new length a compile).  This helper stacks utterances into [B, samples] buckets
(1-second sample buckets, like the single-utterance path), runs ONE
vmapped program per chunk, fetches one [B, T, D] array, and slices the
true frame counts out on host — two round trips per 64 utterances
instead of two per utterance.

Works for any extractor whose jitted ``_compute(self, wav, key)``
consumes a whole padded waveform (Fbank, Mfcc, Spectrogram).  PLP runs
its LPC tail on host and is not supported here.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_aslp_tpu.feats.window import num_frames as _num_frames


def compute_batched(extractor, waves: Dict[str, np.ndarray],
                    batch_size: int = 64,
                    key: Optional[jax.Array] = None
                    ) -> Dict[str, np.ndarray]:
    """{utt: [samples]} → {utt: [frames, dim]} with bucketed batching.

    ``key`` enables dither (split per utterance); None disables it,
    matching the single-utterance ``__call__`` contract."""
    fn = extractor._compute.__wrapped__  # the unjitted method
    bucket = int(extractor.frame_opts.samp_freq)  # 1 s of samples

    if key is None:
        batched = jax.jit(jax.vmap(lambda w: fn(extractor, w, None)))
    else:
        batched = jax.jit(jax.vmap(lambda w, k: fn(extractor, w, k)))

    groups: Dict[int, list] = {}
    for u, w in waves.items():
        padded = int(np.ceil(max(len(w), 1) / bucket)) * bucket
        groups.setdefault(padded, []).append(u)

    out: Dict[str, np.ndarray] = {}
    ki = 0
    for padded, utts in sorted(groups.items()):
        for i in range(0, len(utts), batch_size):
            chunk = utts[i:i + batch_size]
            B = len(chunk)
            # pad the ragged tail with zero rows: one compiled shape
            # per bucket length, not one per tail size
            arr = np.zeros((batch_size, padded), np.float32)
            for j, u in enumerate(chunk):
                w = np.asarray(waves[u], np.float32)
                arr[j, :len(w)] = w
            if key is None:
                feats = batched(arr)
            else:
                keys = jax.vmap(lambda s: jax.random.fold_in(key, s))(
                    jnp.arange(ki, ki + batch_size))
                ki += batch_size
                feats = batched(arr, keys)
            feats = np.asarray(feats)  # ONE fetch for the whole chunk
            for j, u in enumerate(chunk):
                n = _num_frames(len(waves[u]), extractor.frame_opts)
                out[u] = feats[j, :n]
    return out
