"""Frame-level components: transforms, activations, utility layers.

JAX-native equivalents of the reference component zoo
(reference: src/aslp-nnet/nnet-affine-transform.h:34,
nnet-linear-transform.h:33, nnet-activation.h:35-356,
nnet-various.h:43-483).  All are pure elementwise/matmul ops on [..., D]
arrays; Splice is a time-axis gather on [S, T, D]."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.models.component import Component, register


@register
class AffineTransform(Component):
    """y = x W^T + b (reference: nnet-affine-transform.h:34).

    Init attrs mirror the proto: param_stddev (gaussian weights),
    bias_mean/bias_range (uniform bias), learn_rate_coef,
    bias_learn_rate_coef, max_norm."""

    token = "<AffineTransform>"
    updatable = True

    def init_params(self, key):
        k1, k2 = jax.random.split(key)
        stddev = float(self.attrs.get("param_stddev", 0.1))
        bias_mean = float(self.attrs.get("bias_mean", -2.0))
        bias_range = float(self.attrs.get("bias_range", 2.0))
        w = stddev * jax.random.normal(
            k1, (self.output_dim, self.input_dim), jnp.float32
        )
        b = bias_mean + bias_range * (
            jax.random.uniform(k2, (self.output_dim,), jnp.float32) - 0.5
        )
        return {"w": w, "b": b}

    def apply(self, params, x, state=None, train=False, rng=None):
        y = jnp.dot(x, params["w"].T, preferred_element_type=jnp.float32)
        return y + params["b"], state

    def lr_coefs(self) -> Dict[str, float]:
        return {
            "w": float(self.attrs.get("learn_rate_coef", 1.0)),
            "b": float(self.attrs.get("bias_learn_rate_coef", 1.0)),
        }

    @property
    def max_norm(self) -> float:
        return float(self.attrs.get("max_norm", 0.0))


@register
class LinearTransform(Component):
    """y = x W^T, no bias (reference: nnet-linear-transform.h:33)."""

    token = "<LinearTransform>"
    updatable = True

    def init_params(self, key):
        stddev = float(self.attrs.get("param_stddev", 0.1))
        return {
            "w": stddev * jax.random.normal(
                key, (self.output_dim, self.input_dim), jnp.float32
            )
        }

    def apply(self, params, x, state=None, train=False, rng=None):
        return jnp.dot(x, params["w"].T,
                       preferred_element_type=jnp.float32), state

    def lr_coefs(self):
        return {"w": float(self.attrs.get("learn_rate_coef", 1.0))}


@register
class Sigmoid(Component):
    token = "<Sigmoid>"

    def apply(self, params, x, state=None, train=False, rng=None):
        return jax.nn.sigmoid(x), state


@register
class Tanh(Component):
    token = "<Tanh>"

    def apply(self, params, x, state=None, train=False, rng=None):
        return jnp.tanh(x), state


@register
class ReLU(Component):
    token = "<ReLU>"

    def apply(self, params, x, state=None, train=False, rng=None):
        return jnp.maximum(x, 0.0), state


@register
class Softmax(Component):
    """(reference: nnet-activation.h:35 — computed in log-sum-exp
    stable form; decode-side log is fused by XLA)."""

    token = "<Softmax>"

    def apply(self, params, x, state=None, train=False, rng=None):
        return jax.nn.softmax(x, axis=-1), state


@register
class BlockSoftmax(Component):
    """Per-block softmax for multi-task heads (reference: nnet-activation.h,
    <BlockDims> "d1:d2:...")."""

    token = "<BlockSoftmax>"

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        dims = attrs.get("block_dims", str(output_dim))
        if isinstance(dims, str):
            self.block_dims = [int(d) for d in dims.replace(",", ":").split(":")]
        else:
            self.block_dims = list(dims)
        if sum(self.block_dims) != output_dim:
            raise ValueError("block dims must sum to output dim")

    def apply(self, params, x, state=None, train=False, rng=None):
        outs = []
        off = 0
        for d in self.block_dims:
            outs.append(jax.nn.softmax(x[..., off:off + d], axis=-1))
            off += d
        return jnp.concatenate(outs, axis=-1), state


@register
class Dropout(Component):
    """(reference: nnet-activation.h Dropout, dropout_retention)."""

    token = "<Dropout>"

    def apply(self, params, x, state=None, train=False, rng=None):
        retention = float(self.attrs.get("dropout_retention", 0.5))
        if not train or rng is None or retention >= 1.0:
            return x, state
        mask = jax.random.bernoulli(rng, retention, x.shape)
        return jnp.where(mask, x / retention, 0.0), state


@register
class Pnorm(Component):
    """Group p-norm dimension reduction (reference: nnet-activation.h Pnorm)."""

    token = "<Pnorm>"

    def apply(self, params, x, state=None, train=False, rng=None):
        p = float(self.attrs.get("p", 2.0))
        group = self.input_dim // self.output_dim
        shape = x.shape[:-1] + (self.output_dim, group)
        xg = jnp.abs(x.reshape(shape)) ** p
        return jnp.sum(xg, axis=-1) ** (1.0 / p), state


@register
class Maxout(Component):
    token = "<Maxout>"

    def apply(self, params, x, state=None, train=False, rng=None):
        group = self.input_dim // self.output_dim
        shape = x.shape[:-1] + (self.output_dim, group)
        return jnp.max(x.reshape(shape), axis=-1), state


@register
class LengthNorm(Component):
    """Normalize each frame to unit L2 length (reference: nnet-various.h)."""

    token = "<LengthNormComponent>"

    def apply(self, params, x, state=None, train=False, rng=None):
        norm = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True) + 1e-20)
        return x / norm, state


@register
class AddShift(Component):
    """Learned additive bias, e.g. trained mean-shift
    (reference: nnet-various.h AddShift)."""

    token = "<AddShift>"
    updatable = True

    def init_params(self, key):
        return {"b": jnp.zeros((self.input_dim,), jnp.float32)}

    def apply(self, params, x, state=None, train=False, rng=None):
        return x + params["b"], state

    def lr_coefs(self):
        return {"b": float(self.attrs.get("learn_rate_coef", 1.0))}


@register
class Rescale(Component):
    """Learned per-dim scale (reference: nnet-various.h Rescale)."""

    token = "<Rescale>"
    updatable = True

    def init_params(self, key):
        return {"s": jnp.ones((self.input_dim,), jnp.float32)}

    def apply(self, params, x, state=None, train=False, rng=None):
        return x * params["s"], state

    def lr_coefs(self):
        return {"s": float(self.attrs.get("learn_rate_coef", 1.0))}


@register
class CopyComponent(Component):
    """Rearranges/duplicates columns via a copy index vector
    (reference: nnet-various.h CopyComponent, <BuildVector>)."""

    token = "<Copy>"

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        spec = attrs.get("build_vector", "")
        self.indices = _parse_build_vector(spec) if spec else list(
            range(output_dim)
        )
        if len(self.indices) != output_dim:
            raise ValueError("copy indices must match output dim")

    def apply(self, params, x, state=None, train=False, rng=None):
        return x[..., jnp.asarray(self.indices)], state


@register
class Transmit(Component):
    """Identity pass-through (reference: nnet-activation.h Transmit)."""

    token = "<Transmit>"

    def apply(self, params, x, state=None, train=False, rng=None):
        return x, state


@register
class Splice(Component):
    """Time-axis frame splicing inside the network
    (reference: nnet-various.h:43 Splice, <BuildVector> "-5:5").

    Operates on [S, T, D]: output frame t concatenates input frames
    t+o for each offset o (edge-clamped), matching the reference's
    behavior on full utterances."""

    token = "<Splice>"
    recurrent = False

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        spec = attrs.get("build_vector", "")
        self.offsets = _parse_build_vector(spec) if spec else [0]
        if input_dim * len(self.offsets) != output_dim:
            raise ValueError(
                f"splice: {input_dim}*{len(self.offsets)} != {output_dim}"
            )

    def apply(self, params, x, state=None, train=False, rng=None):
        if x.ndim < 2:
            raise ValueError("Splice needs a time axis: [.., T, D]")
        T = x.shape[-2]
        t = jnp.arange(T)
        cols = [
            jnp.take(x, jnp.clip(t + o, 0, T - 1), axis=-2)
            for o in self.offsets
        ]
        return jnp.concatenate(cols, axis=-1), state


def _parse_build_vector(spec) -> List[int]:
    """Parse "-5:5" / "0 1 2" / "-2:2 5" into an int list
    (reference: nnet-various.h BuildIntegerVector)."""
    if isinstance(spec, (list, tuple)):
        return [int(v) for v in spec]
    out: List[int] = []
    for part in str(spec).replace(",", " ").split():
        if ":" in part:
            lo, hi = part.split(":")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out
