"""Feedforward sequential memory components: cFSMN and row convolution.

JAX-native equivalents of the reference's FSMN family (reference:
src/aslp-nnet/nnet-cfsmn-component.h:33 CompactFsmn — past/future memory
taps with per-dim learned coefficients, contexts parsed at :54-70;
src/aslp-nnet/nnet-row-convolution.{h,cc} RowConvolution).

Both are depthwise 1-D convolutions along time with static tap offsets,
expressed as clamped gathers + weighted sums so XLA lowers them to fused
vector ops (no scan needed — they are not recurrent)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.models.component import Component, register


@register
class CompactFsmn(Component):
    """y_t = x_t + Σ_{i=0..l_order} a_i ⊙ x_{t-i·l_stride}
                + Σ_{j=1..r_order} c_j ⊙ x_{t+j·r_stride}

    (reference: nnet-cfsmn-component.h:33; the memory operates on the
    low-rank projection produced by a preceding LinearTransform, exactly
    like the reference pairs cFSMN with a projection layer)."""

    token = "<CompactFsmn>"
    updatable = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        if input_dim != output_dim:
            raise ValueError("CompactFsmn requires input_dim == output_dim")
        self.l_order = int(attrs.get("l_order", attrs.get("lorder", 10)))
        self.r_order = int(attrs.get("r_order", attrs.get("rorder", 10)))
        self.l_stride = int(attrs.get("l_stride", attrs.get("lstride", 1)))
        self.r_stride = int(attrs.get("r_stride", attrs.get("rstride", 1)))

    def init_params(self, key):
        k1, k2 = jax.random.split(key)
        D = self.input_dim
        scale = float(self.attrs.get("param_scale", 0.1))
        return {
            "a": scale * jax.random.normal(
                k1, (self.l_order + 1, D), jnp.float32
            ),
            "c": scale * jax.random.normal(
                k2, (self.r_order, D), jnp.float32
            ),
        }

    def apply(self, params, x, state=None, train=False, rng=None, mask=None):
        if x.ndim < 3:
            raise ValueError("CompactFsmn needs [S, T, D] input")
        S, T, D = x.shape
        if mask is not None:
            x = x * mask[..., None]
        t = jnp.arange(T)
        y = x
        for i in range(self.l_order + 1):
            idx = jnp.clip(t - i * self.l_stride, 0, T - 1)
            valid = (t - i * self.l_stride >= 0).astype(x.dtype)[None, :, None]
            y = y + params["a"][i] * jnp.take(x, idx, axis=1) * valid
        for j in range(1, self.r_order + 1):
            idx = jnp.clip(t + j * self.r_stride, 0, T - 1)
            valid = (t + j * self.r_stride < T).astype(x.dtype)[None, :, None]
            y = y + params["c"][j - 1] * jnp.take(x, idx, axis=1) * valid
        return y, state


@register
class RowConvolution(Component):
    """Future-looking depthwise conv: y_t = Σ_{j=0..ctx} w_j ⊙ x_{t+j}
    (reference: nnet-row-convolution.h, Deep Speech 2 style lookahead)."""

    token = "<RowConvolution>"
    updatable = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        if input_dim != output_dim:
            raise ValueError("RowConvolution requires input_dim == output_dim")
        self.future_ctx = int(attrs.get("future_ctx", 2))

    def init_params(self, key):
        scale = float(self.attrs.get("param_scale", 0.1))
        return {
            "w": scale * jax.random.normal(
                key, (self.future_ctx + 1, self.input_dim), jnp.float32
            )
        }

    def apply(self, params, x, state=None, train=False, rng=None, mask=None):
        if x.ndim < 3:
            raise ValueError("RowConvolution needs [S, T, D] input")
        S, T, D = x.shape
        if mask is not None:
            x = x * mask[..., None]
        t = jnp.arange(T)
        y = jnp.zeros_like(x)
        for j in range(self.future_ctx + 1):
            idx = jnp.clip(t + j, 0, T - 1)
            valid = (t + j < T).astype(x.dtype)[None, :, None]
            y = y + params["w"][j] * jnp.take(x, idx, axis=1) * valid
        return y, state
