"""Trainers: frame-level CE/MSE and sequence CTC training loops.

JAX-native equivalents of the reference trainer binaries (reference:
src/aslp-nnetbin/aslp-nnet-train-simple.cc:31-371 full frame loop,
aslp-nnet-train-ctc-streams.cc:118-204, the MPI worker loop
aslp-parallelbin/aslp-nnet-train-lstm-stream-worker.cc).

One jitted train step fuses forward + loss + backward + SGD update; the
data-parallel variant wraps it in shard_map with pmean'd grads (BSP) —
see kaldi_aslp_tpu/parallel/."""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_aslp_tpu.models.nnet import Nnet
from kaldi_aslp_tpu.models.losses import (
    LossReporter,
    ctc_batch_loss,
    mse_loss,
    xent_loss,
)
from kaldi_aslp_tpu.train.sgd import (
    NnetTrainOptions,
    init_velocity,
    make_sgd_update,
)
from kaldi_aslp_tpu.utils.log import get_logger

logger = get_logger("trainer")


class FrameTrainer:
    """Frame-shuffled CE/MSE training (reference: aslp-nnet-train-simple)."""

    def __init__(self, net: Nnet, opts: Optional[NnetTrainOptions] = None,
                 objective: str = "xent"):
        self.net = net
        self.opts = opts or NnetTrainOptions()
        self.objective = objective
        self._update = make_sgd_update(net, self.opts)
        self._step = jax.jit(self._make_step())
        self._eval = jax.jit(self._make_eval())
        self._base_rng = jax.random.PRNGKey(777)
        self._rng_counter = 0

    def _loss(self, logits, targets, weights):
        if self.objective == "xent":
            return xent_loss(logits, targets, weights)
        if self.objective == "mse":
            return mse_loss(logits, targets, weights)
        raise ValueError(self.objective)

    def _make_step(self):
        def step(params, velocity, feats, targets, weights, lr, rng):
            def loss_fn(p):
                y, _ = self.net.apply(p, feats, train=True, rng=rng)
                return self._loss(y, targets, weights)
            (loss, aux), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params)
            params, velocity = self._update(params, grads, velocity, lr)
            return params, velocity, loss, aux
        return step

    def _make_eval(self):
        def evaluate(params, feats, targets, weights):
            y, _ = self.net.apply(params, feats, train=False)
            return self._loss(y, targets, weights)
        return evaluate

    def train_epoch(
        self, params, velocity, batches: Iterator, learn_rate: float,
        reporter: Optional[LossReporter] = None,
    ):
        from kaldi_aslp_tpu.data.prefetch import DevicePrefetcher
        reporter = reporter or LossReporter(self.objective)
        lr = jnp.asarray(learn_rate, jnp.float32)
        tgt_dtype = (jnp.int32 if self.objective == "xent"
                     else jnp.float32)

        def upload(batch):
            feats, targets = batch[0], batch[1]
            weights = batch[2] if len(batch) > 2 else np.ones(
                len(feats), np.float32
            )
            return (jnp.asarray(feats), jnp.asarray(targets, tgt_dtype),
                    jnp.asarray(weights, jnp.float32))

        for dev in DevicePrefetcher(batches, transform=upload):
            self._rng_counter += 1
            rng = jax.random.fold_in(self._base_rng, self._rng_counter)
            params, velocity, loss, aux = self._step(
                params, velocity, *dev, lr, rng,
            )
            reporter.update(aux)
        return params, velocity, reporter

    def evaluate(self, params, batches: Iterator,
                 reporter: Optional[LossReporter] = None) -> LossReporter:
        reporter = reporter or LossReporter(self.objective + "-cv")
        tgt_dtype = jnp.int32 if self.objective == "xent" else jnp.float32
        for batch in batches:
            feats, targets = batch[0], batch[1]
            weights = batch[2] if len(batch) > 2 else np.ones(
                len(feats), np.float32
            )
            _, aux = self._eval(
                params, jnp.asarray(feats), jnp.asarray(targets, tgt_dtype),
                jnp.asarray(weights, jnp.float32),
            )
            reporter.update(aux)
        return reporter


class CtcTrainer:
    """Whole-utterance CTC training (reference:
    aslp-nnet-train-ctc-streams.cc).

    ``transport`` selects how feature bytes cross the host→device
    boundary (see data/transport.py): "f32" is the reference-faithful
    passthrough; "bf16"/"int8" halve/quarter the upload for byte-bound
    links, with the frame mask derived on device from the lengths."""

    def __init__(self, net: Nnet, opts: Optional[NnetTrainOptions] = None,
                 blank: int = 0, transport: str = "f32"):
        from kaldi_aslp_tpu.data.transport import TRANSPORTS
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}")
        self.net = net
        self.opts = opts or NnetTrainOptions()
        self.blank = blank
        self.transport = transport
        self._update = make_sgd_update(net, self.opts)
        self._step = jax.jit(self._make_step())
        self._eval = jax.jit(self._make_eval())
        self._base_rng = jax.random.PRNGKey(777)
        self._rng_counter = 0

    def _make_step(self):
        from kaldi_aslp_tpu.data.transport import (
            mask_from_lengths,
            unpack_feats,
        )

        def core(params, velocity, feats, labels, in_lens, lab_lens,
                 mask, lr, rng):
            def loss_fn(p):
                y, _ = self.net.apply(p, feats, train=True, mask=mask,
                                      rng=rng)
                return ctc_batch_loss(
                    y, labels, in_lens, lab_lens, self.blank
                )
            (loss, aux), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params)
            params, velocity = self._update(params, grads, velocity, lr)
            return params, velocity, loss, aux

        if self.transport == "f32":
            return core

        delta = self.transport == "int8d"

        def step(params, velocity, payload, scale, offset, labels,
                 in_lens, lab_lens, lr, rng):
            feats = unpack_feats(payload, scale, offset, in_lens,
                                 delta=delta)
            mask = mask_from_lengths(in_lens, feats.shape[1])
            return core(params, velocity, feats, labels, in_lens,
                        lab_lens, mask, lr, rng)
        return step

    def _make_eval(self):
        def evaluate(params, feats, labels, in_lens, lab_lens, mask):
            y, _ = self.net.apply(params, feats, train=False, mask=mask)
            return ctc_batch_loss(y, labels, in_lens, lab_lens, self.blank)
        return evaluate

    def _upload(self, b):
        """Host-side pack + async device upload of one CtcBatch (runs on
        the DevicePrefetcher worker thread)."""
        from kaldi_aslp_tpu.data.transport import pack_feats
        labels = jnp.asarray(b.labels)
        in_lens = jnp.asarray(b.input_lengths)
        lab_lens = jnp.asarray(b.label_lengths)
        if self.transport == "f32":
            return (jnp.asarray(b.feats), labels, in_lens, lab_lens,
                    jnp.asarray(b.frame_mask))
        payload, scale, offset = pack_feats(b.feats, self.transport,
                                            b.input_lengths)
        D = b.feats.shape[-1]
        if scale is None:
            scale = np.ones(D, np.float32)
            offset = np.zeros(D, np.float32)
        return (jnp.asarray(payload), jnp.asarray(scale),
                jnp.asarray(offset), labels, in_lens, lab_lens)

    def make_cache(self, max_bytes: Optional[int] = None, **kw):
        """HBM-resident epoch cache bound to this trainer's transport
        (see data/device_cache.py); pass it to train_epoch."""
        from kaldi_aslp_tpu.data.device_cache import DeviceEpochCache
        return DeviceEpochCache(self._upload, max_bytes=max_bytes, **kw)

    def train_epoch(self, params, velocity, batches: Iterator,
                    learn_rate: float,
                    reporter: Optional[LossReporter] = None,
                    cache=None):
        from kaldi_aslp_tpu.data.prefetch import DevicePrefetcher
        reporter = reporter or LossReporter("ctc")
        lr = jnp.asarray(learn_rate, jnp.float32)
        if cache is not None:
            source = DevicePrefetcher(cache.epoch(batches))
        else:
            source = DevicePrefetcher(batches, transform=self._upload)
        for dev in source:
            self._rng_counter += 1
            rng = jax.random.fold_in(self._base_rng, self._rng_counter)
            params, velocity, loss, aux = self._step(
                params, velocity, *dev, lr, rng,
            )
            reporter.update(
                {"frames": aux["frames"], "loss_sum": aux["loss_sum"]}
            )
        return params, velocity, reporter

    def evaluate(self, params, batches: Iterator,
                 reporter: Optional[LossReporter] = None) -> LossReporter:
        reporter = reporter or LossReporter("ctc-cv")
        for b in batches:
            _, aux = self._eval(
                params, jnp.asarray(b.feats), jnp.asarray(b.labels),
                jnp.asarray(b.input_lengths), jnp.asarray(b.label_lengths),
                jnp.asarray(b.frame_mask),
            )
            reporter.update(
                {"frames": aux["frames"], "loss_sum": aux["loss_sum"]}
            )
        return reporter
