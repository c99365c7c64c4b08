"""Batch normalization with cross-replica statistics.

JAX-native equivalent of the reference's BatchNormalization component
(reference: src/aslp-nnet/nnet-batch-normalization.h:32), whose
distinguishing feature is *global* accumulated statistics synchronized
across workers at the end of training (reference: MpiNode::ReduceAccStat
mpi-node.h:77-92, worker main :254-257).

Here the train-time batch statistics are optionally psum'd over a named
mesh axis (``axis_name``) — the idiomatic mesh replacement for the MPI
allreduce — and the running accumulators (sum, sumsq, count) live in the
component *state* pytree so they checkpoint with the model."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.models.component import Component, register


@register
class BatchNormalization(Component):
    token = "<BatchNormalization>"
    updatable = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.eps = float(attrs.get("epsilon", 1e-5))
        self.axis_name = attrs.get("axis_name", None)

    def init_params(self, key):
        D = self.input_dim
        return {"gamma": jnp.ones((D,), jnp.float32),
                "beta": jnp.zeros((D,), jnp.float32)}

    def init_state(self, num_streams: int = 0):
        D = self.input_dim
        # accumulated global stats (the reference's acc_mean_/acc_var_/count_)
        return {"sum": jnp.zeros((D,), jnp.float32),
                "sumsq": jnp.zeros((D,), jnp.float32),
                "count": jnp.zeros((), jnp.float32)}

    def apply(self, params, x, state=None, train=False, rng=None, mask=None):
        if state is None:
            state = self.init_state()
        flat = x.reshape(-1, x.shape[-1])
        if mask is not None:
            m = mask.reshape(-1, 1)
            count = jnp.maximum(m.sum(), 1.0)
            s = (flat * m).sum(axis=0)
            sq = (flat * flat * m).sum(axis=0)
        else:
            count = jnp.asarray(float(flat.shape[0]), jnp.float32)
            s = flat.sum(axis=0)
            sq = (flat * flat).sum(axis=0)
        if train:
            if self.axis_name is not None:
                s = jax.lax.psum(s, self.axis_name)
                sq = jax.lax.psum(sq, self.axis_name)
                count = jax.lax.psum(count, self.axis_name)
            mean = s / count
            var = sq / count - mean * mean
            new_state = {"sum": state["sum"] + s,
                         "sumsq": state["sumsq"] + sq,
                         "count": state["count"] + count}
        else:
            total = jnp.maximum(state["count"], 1.0)
            mean = state["sum"] / total
            var = state["sumsq"] / total - mean * mean
            new_state = state
        inv = jax.lax.rsqrt(jnp.maximum(var, 0.0) + self.eps)
        y = (x - mean) * inv * params["gamma"] + params["beta"]
        return y, new_state

    def lr_coefs(self):
        return {"gamma": float(self.attrs.get("learn_rate_coef", 1.0)),
                "beta": float(self.attrs.get("learn_rate_coef", 1.0))}


def merge_bn_stats(states):
    """Sum per-shard accumulated BN stats (the ReduceAccStat equivalent
    when shards trained independently, e.g. BMUF blocks)."""
    return jax.tree_util.tree_map(lambda *xs: sum(xs), *states)
