"""Recurrent components: LSTM(P) / BLSTM / LC-BLSTM / CIFG-LSTM / GRU.

JAX re-design of the reference's multi-stream recurrent zoo
(reference: src/aslp-nnet/nnet-lstm-projected-streams.h:46,
nnet-blstm-projected-streams.h, nnet-blstm-projected-streams-lc.h:57,
nnet-recurrent-component.h:28,106, nnet-gru-streams.h,
nnet-lstm-couple-if-projected-streams.h).

Key design decisions:
  - layout is [S, T, D] (streams, time, feat); the input projection
    ``x @ W_gifo_x^T`` is hoisted out of the time loop as ONE [S*T, D]
    matmul (the reference does the same trick, :347-432), and only
    the [S, P] recurrent matmul lives inside ``lax.scan``;
  - per-stream sequence masks gate state updates, so right-padding
    never corrupts carried state — this also makes the *backward*
    direction of BLSTM correct under padding without per-stream
    reversal gymnastics (pad frames are no-ops in any direction);
  - cross-chunk streaming state (the reference's ``prev_nnet_state_``)
    is an explicit carry pytree returned to the caller;
  - gate order is g,i,f,o exactly like the reference so imported
    reference models slot in unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.models.component import Component, register



def _mm(a, b, dtype=None):
    """Matmul with optional bf16 inputs + f32 accumulation."""
    if dtype is not None:
        a = a.astype(dtype)
        b = b.astype(dtype)
    return jnp.dot(a, b, preferred_element_type=jnp.float32)


@jax.custom_vjp
def _einsum_stg_bf16(x, w):
    """Input-projection einsum with bf16 operands FORWARD AND BACKWARD.

    Without the custom VJP the transpose einsums mix the f32 cotangent
    with the bf16 weight and XLA upcasts them to f32 matmuls — at
    [S*T, 640]x[640, 4C] sizes that is the single largest f32 block of
    the training step.  A bf16 component means bf16 matmuls throughout; f32
    accumulation keeps the update numerically sane."""
    return jnp.einsum("std,gd->stg", x.astype(jnp.bfloat16),
                      w.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)


def _einsum_stg_bf16_fwd(x, w):
    return _einsum_stg_bf16(x, w), (x, w)


def _einsum_stg_bf16_bwd(res, dy):
    x, w = res
    dyb = dy.astype(jnp.bfloat16)
    dx = jnp.einsum("stg,gd->std", dyb, w.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
    dw = jnp.einsum("stg,std->gd", dyb, x.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
    return dx.astype(x.dtype), dw.astype(w.dtype)


_einsum_stg_bf16.defvjp(_einsum_stg_bf16_fwd, _einsum_stg_bf16_bwd)


def _einsum_stg(x, w, dtype=None):
    if dtype is not None:
        if dtype == jnp.bfloat16:
            # under shard_map a replicated weight meets batch-varying
            # activations: mark it varying before the custom VJP, so the
            # weight cotangent is summed over the batch axes outside it
            missing = tuple(jax.typeof(x).vma - jax.typeof(w).vma)
            if missing:
                w = jax.lax.pcast(w, missing, to="varying")
            return _einsum_stg_bf16(x, w)
        x = x.astype(dtype)
        w = w.astype(dtype)
    return jnp.einsum("std,gd->stg", x, w,
                      preferred_element_type=jnp.float32)

def _state_like(state, x):
    """Make a (possibly fresh-zeros) state pytree inherit x's varying mesh
    axes, so lax.scan carries typecheck under shard_map (adding a [S,1]
    zero derived from x is a no-op numerically but propagates the VMA)."""
    z = jnp.zeros_like(x[:, :1, 0])
    return jax.tree_util.tree_map(lambda s: s + z, state)


def _masked(new, old, mask_t):
    """Update state only where mask is 1 (mask_t: [S] or [S,1])."""
    m = mask_t[:, None] if mask_t.ndim == 1 else mask_t
    return m * new + (1.0 - m) * old


def _split4(g):
    c = g.shape[-1] // 4
    return g[..., :c], g[..., c:2 * c], g[..., 2 * c:3 * c], g[..., 3 * c:]


@register
class LstmProjectedStreams(Component):
    """Peephole LSTM with recurrent projection
    (reference: nnet-lstm-projected-streams.h:46).

    Params: w_gifo_x [4C, D], w_gifo_r [4C, P], bias [4C],
    peephole_{i,f,o}_c [C], w_r_m [P, C]."""

    token = "<LstmProjectedStreams>"
    updatable = True
    recurrent = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.cell_dim = int(attrs.get("cell_dim", output_dim))
        self.proj_dim = int(output_dim)
        self.cell_clip = float(attrs.get("cell_clip", 50.0))
        self.compute_dtype = (jnp.bfloat16 if attrs.get("bf16", False)
                              else None)

    def init_params(self, key):
        ks = jax.random.split(key, 6)
        D, C, P = self.input_dim, self.cell_dim, self.proj_dim
        scale = float(self.attrs.get("param_scale", 0.1))  # reference
        # uses uniform init scaled by param_scale (nnet-lstm-projected-
        # streams.h InitData)
        def u(k, shape):
            return scale * (2.0 * jax.random.uniform(k, shape, jnp.float32)
                            - 1.0)
        return {
            "w_gifo_x": u(ks[0], (4 * C, D)),
            "w_gifo_r": u(ks[1], (4 * C, P)),
            "bias": u(ks[2], (4 * C,)),
            "peephole_i_c": u(ks[3], (C,)),
            "peephole_f_c": u(ks[4], (C,)),
            "peephole_o_c": u(ks[5], (C,)),
            "w_r_m": u(jax.random.split(ks[5])[0], (P, C)),
        }

    def init_state(self, num_streams: int):
        return {
            "c": jnp.zeros((num_streams, self.cell_dim), jnp.float32),
            "r": jnp.zeros((num_streams, self.proj_dim), jnp.float32),
        }

    def apply(self, params, x, state=None, train=False, rng=None, mask=None):
        """x: [S, T, D]; mask: [S, T] (1=valid); state: carried {c, r}."""
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S)
        state = _state_like(state, x)
        if mask is None:
            mask = jnp.ones((S, T), jnp.float32)
        # hoisted input projection: one big matmul
        dt = getattr(self, "compute_dtype", None)
        xg = _einsum_stg(x, params["w_gifo_x"], dt) + params["bias"]
        clip = self.cell_clip
        w_gifo_r_T = params["w_gifo_r"].T

        def step(carry, inp):
            c_prev, r_prev = carry
            xg_t, m_t = inp
            gates = xg_t + _mm(r_prev, w_gifo_r_T, dt)
            g, i, f, o = _split4(gates)
            i = jax.nn.sigmoid(i + params["peephole_i_c"] * c_prev)
            f = jax.nn.sigmoid(f + params["peephole_f_c"] * c_prev)
            c = f * c_prev + i * jnp.tanh(g)
            if clip > 0:
                c = jnp.clip(c, -clip, clip)
            o = jax.nn.sigmoid(o + params["peephole_o_c"] * c)
            m = o * jnp.tanh(c)
            r = _mm(m, params["w_r_m"].T, dt)
            c = _masked(c, c_prev, m_t)
            r = _masked(r, r_prev, m_t)
            return (c, r), r * (m_t[:, None] if m_t.ndim == 1 else m_t)

        (c_f, r_f), ys = jax.lax.scan(
            step, (state["c"], state["r"]),
            (jnp.swapaxes(xg, 0, 1), mask.T),
        )
        return jnp.swapaxes(ys, 0, 1), {"c": c_f, "r": r_f}


@register
class Lstm(Component):
    """Unprojected LSTM (reference: nnet-recurrent-component.h:28)."""

    token = "<Lstm>"
    updatable = True
    recurrent = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.cell_dim = int(output_dim)
        self.cell_clip = float(attrs.get("cell_clip", 50.0))

    def init_params(self, key):
        ks = jax.random.split(key, 3)
        D, C = self.input_dim, self.cell_dim
        scale = float(self.attrs.get("param_scale", 0.1))
        def u(k, shape):
            return scale * (2.0 * jax.random.uniform(k, shape, jnp.float32)
                            - 1.0)
        return {
            "w_gifo_x": u(ks[0], (4 * C, D)),
            "w_gifo_r": u(ks[1], (4 * C, C)),
            "bias": u(ks[2], (4 * C,)),
        }

    def init_state(self, num_streams):
        C = self.cell_dim
        return {"c": jnp.zeros((num_streams, C), jnp.float32),
                "r": jnp.zeros((num_streams, C), jnp.float32)}

    def apply(self, params, x, state=None, train=False, rng=None, mask=None):
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S)
        state = _state_like(state, x)
        if mask is None:
            mask = jnp.ones((S, T), jnp.float32)
        xg = jnp.einsum("std,gd->stg", x, params["w_gifo_x"],
                        preferred_element_type=jnp.float32) + params["bias"]
        clip = self.cell_clip

        def step(carry, inp):
            c_prev, r_prev = carry
            xg_t, m_t = inp
            gates = xg_t + jnp.dot(r_prev, params["w_gifo_r"].T,
                                   preferred_element_type=jnp.float32)
            g, i, f, o = _split4(gates)
            i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
            c = f * c_prev + i * jnp.tanh(g)
            if clip > 0:
                c = jnp.clip(c, -clip, clip)
            m = o * jnp.tanh(c)
            c = _masked(c, c_prev, m_t)
            m = _masked(m, r_prev, m_t)
            return (c, m), m * m_t[:, None]

        (c_f, r_f), ys = jax.lax.scan(
            step, (state["c"], state["r"]),
            (jnp.swapaxes(xg, 0, 1), mask.T),
        )
        return jnp.swapaxes(ys, 0, 1), {"c": c_f, "r": r_f}


@register
class LstmCifgProjectedStreams(LstmProjectedStreams):
    """Coupled input-forget LSTM: i = 1 - f
    (reference: nnet-lstm-couple-if-projected-streams.h)."""

    token = "<LstmCifgProjectedStreams>"

    def apply(self, params, x, state=None, train=False, rng=None, mask=None):
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S)
        state = _state_like(state, x)
        if mask is None:
            mask = jnp.ones((S, T), jnp.float32)
        xg = jnp.einsum("std,gd->stg", x, params["w_gifo_x"],
                        preferred_element_type=jnp.float32) + params["bias"]
        clip = self.cell_clip

        def step(carry, inp):
            c_prev, r_prev = carry
            xg_t, m_t = inp
            gates = xg_t + jnp.dot(r_prev, params["w_gifo_r"].T,
                                   preferred_element_type=jnp.float32)
            g, _i, f, o = _split4(gates)
            f = jax.nn.sigmoid(f + params["peephole_f_c"] * c_prev)
            i = 1.0 - f
            c = f * c_prev + i * jnp.tanh(g)
            if clip > 0:
                c = jnp.clip(c, -clip, clip)
            o = jax.nn.sigmoid(o + params["peephole_o_c"] * c)
            m = o * jnp.tanh(c)
            r = jnp.dot(m, params["w_r_m"].T,
                        preferred_element_type=jnp.float32)
            c = _masked(c, c_prev, m_t)
            r = _masked(r, r_prev, m_t)
            return (c, r), r * m_t[:, None]

        (c_f, r_f), ys = jax.lax.scan(
            step, (state["c"], state["r"]),
            (jnp.swapaxes(xg, 0, 1), mask.T),
        )
        return jnp.swapaxes(ys, 0, 1), {"c": c_f, "r": r_f}


@register
class GruStreams(Component):
    """GRU (reference: nnet-gru-streams.h).

    Params: w_zrc_x [3H, D], w_zrc_h [3H, H], bias [3H]; gate order
    z (update), r (reset), c (candidate)."""

    token = "<GruStreams>"
    updatable = True
    recurrent = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.hidden = int(output_dim)

    def init_params(self, key):
        ks = jax.random.split(key, 3)
        D, H = self.input_dim, self.hidden
        scale = float(self.attrs.get("param_scale", 0.1))
        def u(k, shape):
            return scale * (2.0 * jax.random.uniform(k, shape, jnp.float32)
                            - 1.0)
        return {"w_zrc_x": u(ks[0], (3 * H, D)),
                "w_zrc_h": u(ks[1], (3 * H, H)),
                "bias": u(ks[2], (3 * H,))}

    def init_state(self, num_streams):
        return {"h": jnp.zeros((num_streams, self.hidden), jnp.float32)}

    def apply(self, params, x, state=None, train=False, rng=None, mask=None):
        S, T, _ = x.shape
        H = self.hidden
        if state is None:
            state = self.init_state(S)
        state = _state_like(state, x)
        if mask is None:
            mask = jnp.ones((S, T), jnp.float32)
        xg = jnp.einsum("std,gd->stg", x, params["w_zrc_x"],
                        preferred_element_type=jnp.float32) + params["bias"]
        w_h = params["w_zrc_h"]

        def step(h_prev, inp):
            xg_t, m_t = inp
            zr_h = jnp.dot(h_prev, w_h[:2 * H].T,
                           preferred_element_type=jnp.float32)
            z = jax.nn.sigmoid(xg_t[:, :H] + zr_h[:, :H])
            r = jax.nn.sigmoid(xg_t[:, H:2 * H] + zr_h[:, H:])
            cand = jnp.tanh(
                xg_t[:, 2 * H:]
                + jnp.dot(r * h_prev, w_h[2 * H:].T,
                          preferred_element_type=jnp.float32)
            )
            h = (1.0 - z) * h_prev + z * cand
            h = _masked(h, h_prev, m_t)
            return h, h * m_t[:, None]

        h_f, ys = jax.lax.scan(
            step, state["h"], (jnp.swapaxes(xg, 0, 1), mask.T)
        )
        return jnp.swapaxes(ys, 0, 1), {"h": h_f}


class _Bidirectional(Component):
    """Shared machinery: run a cell forward and backward, concat outputs.

    The backward pass flips x/mask in time; masked state updates make the
    (flipped-to-front) right-padding a no-op, so no per-stream reversal is
    needed."""

    updatable = True
    recurrent = True
    cell_cls: type = None  # type: ignore

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        if output_dim % 2:
            raise ValueError("bidirectional output dim must be even")
        half_attrs = dict(attrs)
        self.fwd = self.cell_cls(input_dim, output_dim // 2, **half_attrs)
        self.bwd = self.cell_cls(input_dim, output_dim // 2, **half_attrs)

    def init_params(self, key):
        k1, k2 = jax.random.split(key)
        return {"fwd": self.fwd.init_params(k1),
                "bwd": self.bwd.init_params(k2)}

    def init_state(self, num_streams):
        # only the forward direction carries streaming state; the backward
        # direction needs the future and is recomputed per chunk (this is
        # what makes the LC variant "latency-controlled")
        return {"fwd": self.fwd.init_state(num_streams)}

    def apply(self, params, x, state=None, train=False, rng=None, mask=None):
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S)
        state = _state_like(state, x)
        if mask is None:
            mask = jnp.ones((S, T), jnp.float32)
        y_f, s_f = self.fwd.apply(params["fwd"], x, state["fwd"],
                                  train=train, rng=rng, mask=mask)
        x_rev = jnp.flip(x, axis=1)
        mask_rev = None if mask is None else jnp.flip(mask, axis=1)
        y_b, _ = self.bwd.apply(params["bwd"], x_rev, None,
                                train=train, rng=rng, mask=mask_rev)
        y_b = jnp.flip(y_b, axis=1)
        return jnp.concatenate([y_f, y_b], axis=-1), {"fwd": s_f}


@register
class BLstmProjectedStreams(_Bidirectional):
    """(reference: nnet-blstm-projected-streams.h)."""

    token = "<BLstmProjectedStreams>"
    cell_cls = LstmProjectedStreams


@register
class BLstm(_Bidirectional):
    """(reference: nnet-recurrent-component.h:106)."""

    token = "<BLstm>"
    cell_cls = Lstm


@register
class BLstmProjectedStreamsLC(_Bidirectional):
    """Latency-controlled BLSTM (reference:
    nnet-blstm-projected-streams-lc.h:57).

    Forward direction scans the whole input and carries state across
    chunks; the backward direction only sees ``chunk_size`` frames at a
    time (reset at each chunk boundary), bounding lookahead latency.
    Implemented by folding chunks into the stream axis for the backward
    pass: [S, T, D] → [S*n_chunks, chunk, D] — every chunk's backward
    scan runs in parallel, a strictly better schedule than the
    reference's sequential per-chunk loop."""

    token = "<BLstmProjectedStreamsLC>"
    cell_cls = LstmProjectedStreams

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.chunk_size = int(attrs.get("chunk_size", 64))

    def apply(self, params, x, state=None, train=False, rng=None, mask=None):
        S, T, D = x.shape
        if state is None:
            state = self.init_state(S)
        state = _state_like(state, x)
        y_f, s_f = self.fwd.apply(params["fwd"], x, state["fwd"],
                                  train=train, rng=rng, mask=mask)

        chunk = self.chunk_size
        pad = (-T) % chunk
        xp = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
        mp = (jnp.pad(mask, ((0, 0), (0, pad)))
              if mask is not None
              else jnp.pad(jnp.ones((S, T), jnp.float32), ((0, 0), (0, pad))))
        n_chunks = xp.shape[1] // chunk
        xc = xp.reshape(S * n_chunks, chunk, D)
        mc = mp.reshape(S * n_chunks, chunk)
        y_b, _ = self.bwd.apply(
            params["bwd"], jnp.flip(xc, axis=1), None,
            train=train, rng=rng, mask=jnp.flip(mc, axis=1),
        )
        y_b = jnp.flip(y_b, axis=1).reshape(S, n_chunks * chunk, -1)[:, :T]
        return jnp.concatenate([y_f, y_b], axis=-1), {"fwd": s_f}
