"""1-D convolution + max-pooling components.

JAX-native equivalents of the reference's nnet1-style frequency-axis conv
(reference: src/aslp-nnet/nnet-convolutional-component.h:65
ConvolutionalComponent — input vector seen as num_splice copies of
patch_stride frequency bins, filters of patch_dim slid with patch_step;
src/aslp-nnet/nnet-max-pooling-component.h:39 MaxPoolingComponent).

The patch extraction is a static gather and the filter application one
matmul over all patches.  Output layout is filter-major
([patch0·f0.., patch1·f0..] grouped as out[..., p*num_filters+f] in the
reference; we use the same patch-major order so pooling indices match)."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.models.component import Component, register


@register
class ConvolutionalComponent(Component):
    token = "<ConvolutionalComponent>"
    updatable = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.patch_dim = int(attrs["patch_dim"])
        self.patch_step = int(attrs.get("patch_step", 1))
        self.patch_stride = int(attrs.get("patch_stride", input_dim))
        if input_dim % self.patch_stride:
            raise ValueError("input_dim must be a multiple of patch_stride")
        self.num_splice = input_dim // self.patch_stride
        self.num_patches = 1 + (
            self.patch_stride - self.patch_dim
        ) // self.patch_step
        if output_dim % self.num_patches:
            raise ValueError("output_dim must be a multiple of num_patches")
        self.num_filters = output_dim // self.num_patches
        # static patch gather indices into the input vector:
        # patch p, splice s covers bins [p*step, p*step+patch_dim) of splice s
        idx = np.empty(
            (self.num_patches, self.num_splice * self.patch_dim), np.int32
        )
        for p in range(self.num_patches):
            cols = []
            for s in range(self.num_splice):
                base = s * self.patch_stride + p * self.patch_step
                cols.extend(range(base, base + self.patch_dim))
            idx[p] = cols
        # host numpy so Nnet.apply under jit embeds it as a literal — a
        # jit must not close over a device array
        # (tests/test_no_device_consts.py)
        self._patch_idx = idx

    def init_params(self, key):
        k1, k2 = jax.random.split(key)
        fan_in = self.num_splice * self.patch_dim
        stddev = float(self.attrs.get("param_stddev", 0.1))
        return {
            "filters": stddev * jax.random.normal(
                k1, (self.num_filters, fan_in), jnp.float32
            ),
            "bias": jnp.zeros((self.num_filters,), jnp.float32),
        }

    def apply(self, params, x, state=None, train=False, rng=None):
        # x: [..., input_dim] → patches [..., num_patches, splice*patch_dim]
        patches = x[..., self._patch_idx]
        y = jnp.einsum("...pk,fk->...pf", patches, params["filters"],
                       preferred_element_type=jnp.float32) + params["bias"]
        return y.reshape(x.shape[:-1] + (self.output_dim,)), state

    def lr_coefs(self):
        return {"filters": float(self.attrs.get("learn_rate_coef", 1.0)),
                "bias": float(self.attrs.get("bias_learn_rate_coef", 1.0))}


@register
class MaxPoolingComponent(Component):
    """Max over pool_size patches per filter
    (reference: nnet-max-pooling-component.h:39)."""

    token = "<MaxPoolingComponent>"

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.pool_size = int(attrs["pool_size"])
        self.pool_step = int(attrs.get("pool_step", self.pool_size))
        self.pool_stride = int(attrs.get("pool_stride", 1))
        # pool_stride = num_filters; input is [num_patches, num_filters]
        self.num_filters = self.pool_stride
        self.num_patches = input_dim // self.num_filters
        self.num_pools = 1 + (
            self.num_patches - self.pool_size
        ) // self.pool_step
        if output_dim != self.num_pools * self.num_filters:
            raise ValueError("max-pooling dims inconsistent")

    def apply(self, params, x, state=None, train=False, rng=None):
        shape = x.shape[:-1] + (self.num_patches, self.num_filters)
        xg = x.reshape(shape)
        pools = []
        for p in range(self.num_pools):
            s = p * self.pool_step
            pools.append(
                jnp.max(xg[..., s:s + self.pool_size, :], axis=-2)
            )
        y = jnp.stack(pools, axis=-2)
        return y.reshape(x.shape[:-1] + (self.output_dim,)), state
