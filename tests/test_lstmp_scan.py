"""LSTMP / BLSTMP scans against a per-frame numpy mirror of the cell
(reference: nnet-lstm-projected-streams.h PropagateFnc, the peephole
LSTM with recurrent projection; gate order g,i,f,o)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from kaldi_aslp_tpu.models.recurrent import (
    BLstmProjectedStreams,
    LstmProjectedStreams,
)
from kaldi_aslp_tpu.parallel.mesh import make_mesh

D, C, PROJ = 5, 7, 4


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def mirror_lstmp(p, x, length, clip, c0=None, r0=None):
    """One stream, frame by frame in float64: (outputs [T, P], c, r)."""
    p = {k: np.asarray(v, np.float64) for k, v in p.items()}
    Cd = p["w_r_m"].shape[1]
    c = np.zeros(Cd) if c0 is None else np.asarray(c0, np.float64)
    r = np.zeros(p["w_r_m"].shape[0]) if r0 is None \
        else np.asarray(r0, np.float64)
    ys = np.zeros((len(x), len(r)))
    for t in range(length):
        gates = p["w_gifo_x"] @ x[t] + p["w_gifo_r"] @ r + p["bias"]
        g, i, f, o = np.split(gates, 4)
        i = _sig(i + p["peephole_i_c"] * c)
        f = _sig(f + p["peephole_f_c"] * c)
        c = f * c + i * np.tanh(g)
        if clip > 0:
            c = np.clip(c, -clip, clip)
        o = _sig(o + p["peephole_o_c"] * c)
        r = p["w_r_m"] @ (o * np.tanh(c))
        ys[t] = r
    return ys, c, r


def mirror_blstmp(p, x, length, clip):
    yf, c, r = mirror_lstmp(p["fwd"], x, length, clip)
    yb_rev, _, _ = mirror_lstmp(p["bwd"], x[:length][::-1], length, clip)
    yb = np.zeros_like(yf)
    yb[:length] = yb_rev[:length][::-1]
    return np.concatenate([yf, yb], axis=1), c, r


def _model(kind, clip=50.0, bf16=False):
    attrs = dict(cell_dim=C, cell_clip=clip, param_scale=0.5, bf16=bf16)
    if kind == "lstmp":
        return LstmProjectedStreams(D, PROJ, **attrs)
    return BLstmProjectedStreams(D, 2 * PROJ, **attrs)


def _mirror(kind, params, x, length, clip):
    if kind == "lstmp":
        return mirror_lstmp(params, x, length, clip)
    return mirror_blstmp(params, x, length, clip)


def _inputs(rng, S=3, T=9):
    x = rng.randn(S, T, D).astype(np.float32)
    lengths = np.asarray([T] + list(rng.randint(1, T, S - 1)), np.int32)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return x, lengths, mask


@pytest.mark.parametrize("kind,clip", [("lstmp", 50.0), ("lstmp", 0.3),
                                       ("lstmp", 0.0), ("blstmp", 50.0),
                                       ("blstmp", 0.3)])
def test_scan_matches_per_frame_mirror(rng, kind, clip):
    m = _model(kind, clip)
    params = m.init_params(jax.random.PRNGKey(3))
    x, lengths, mask = _inputs(rng)
    y, state = m.apply(params, jnp.asarray(x), mask=jnp.asarray(mask))
    c_fin = state["c"] if kind == "lstmp" else state["fwd"]["c"]
    for s, L in enumerate(lengths):
        want, c, _ = _mirror(kind, params, x[s], L, clip)
        np.testing.assert_allclose(np.asarray(y[s]), want, rtol=2e-5,
                                   atol=2e-6)
        np.testing.assert_allclose(np.asarray(c_fin[s]), c, rtol=2e-5,
                                   atol=2e-6)


def _mirror_loss(kind, params, x, lengths, clip, w_out):
    return sum(float(np.sum(_mirror(kind, params, x[s], L, clip)[0]
                            * w_out[s])) for s, L in enumerate(lengths))


@pytest.mark.parametrize("kind", ["lstmp", "blstmp"])
@pytest.mark.parametrize("wrt", ["params", "input"])
def test_gradients_match_mirror_directional_derivative(rng, kind, wrt):
    """<grad, v> of the scan against a central difference of the float64
    mirror along a random direction v."""
    clip = 0.0  # smooth, so the central difference is exact to O(eps^2)
    m = _model(kind, clip)
    params = m.init_params(jax.random.PRNGKey(5))
    x, lengths, mask = _inputs(rng)
    w_out = rng.randn(*x.shape[:2], m.output_dim)

    def loss(p, xx):
        y, _ = m.apply(p, xx, mask=jnp.asarray(mask))
        return jnp.sum(y * w_out)
    g_p, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    eps = 1e-5
    if wrt == "params":
        v = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape), params)
        analytic = sum(float(np.sum(np.asarray(g) * d)) for g, d in zip(
            jax.tree_util.tree_leaves(g_p), jax.tree_util.tree_leaves(v)))

        def at(sign):
            p = jax.tree_util.tree_map(
                lambda a, d: np.asarray(a, np.float64) + sign * eps * d,
                params, v)
            return _mirror_loss(kind, p, x.astype(np.float64), lengths,
                                clip, w_out)
    else:
        v = rng.randn(*x.shape)
        analytic = float(np.sum(np.asarray(g_x) * v))

        def at(sign):
            return _mirror_loss(kind, params, x + sign * eps * v, lengths,
                                clip, w_out)
    numeric = (at(1) - at(-1)) / (2 * eps)
    assert analytic == pytest.approx(numeric, rel=1e-3, abs=1e-4)


@pytest.mark.parametrize("kind", ["lstmp", "blstmp"])
def test_right_padding_is_a_no_op(rng, kind):
    m = _model(kind)
    params = m.init_params(jax.random.PRNGKey(7))
    x, lengths, mask = _inputs(rng, T=8)
    pad = 5
    x_pad = np.concatenate([x, 50.0 * rng.randn(x.shape[0], pad, D)], 1)
    mask_pad = np.pad(mask, ((0, 0), (0, pad)))
    y, st = m.apply(params, jnp.asarray(x), mask=jnp.asarray(mask))
    y2, st2 = m.apply(params, jnp.asarray(x_pad, jnp.float32),
                      mask=jnp.asarray(mask_pad))
    np.testing.assert_allclose(np.asarray(y2[:, :8]), np.asarray(y),
                               rtol=1e-6, atol=1e-7)
    assert not np.asarray(y2[:, 8:]).any()
    for a, b in zip(jax.tree_util.tree_leaves(st2),
                    jax.tree_util.tree_leaves(st)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_state_carried_across_chunks(rng):
    """Three chunks with the carried {c, r} equal one pass — the
    reference's prev_nnet_state_ across multi-stream chunks."""
    m = _model("lstmp")
    params = m.init_params(jax.random.PRNGKey(9))
    x = jnp.asarray(rng.randn(2, 12, D).astype(np.float32))
    y_all, st_all = m.apply(params, x)
    state, ys = None, []
    for k in range(3):
        y, state = m.apply(params, x[:, 4 * k:4 * (k + 1)], state)
        ys.append(y)
    np.testing.assert_allclose(np.asarray(jnp.concatenate(ys, 1)),
                               np.asarray(y_all), rtol=1e-6, atol=1e-7)
    for k in ("c", "r"):
        np.testing.assert_allclose(np.asarray(state[k]),
                                   np.asarray(st_all[k]), rtol=1e-6,
                                   atol=1e-7)


def test_bf16_matmuls_stay_close_to_f32(rng):
    params = _model("blstmp").init_params(jax.random.PRNGKey(11))
    x, _, mask = _inputs(rng)
    y32, _ = _model("blstmp").apply(params, jnp.asarray(x),
                                    mask=jnp.asarray(mask))
    y16, _ = _model("blstmp", bf16=True).apply(params, jnp.asarray(x),
                                                mask=jnp.asarray(mask))
    assert y16.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(y16), np.asarray(y32),
                               atol=3e-2)


def test_bf16_blstmp_gradient_under_shard_map(rng):
    """Data-parallel gradient of a bf16 BLSTMP (replicated weights,
    batch split over 'data') equals the single-device gradient."""
    m = _model("blstmp", bf16=True)
    params = m.init_params(jax.random.PRNGKey(13))
    x, _, mask = _inputs(rng, S=4)
    mesh = make_mesh(("data",), devices=jax.devices()[:2])

    def loss(p, xx, mm):
        y, _ = m.apply(p, xx, mask=mm, train=True)
        return jnp.mean(y ** 2)

    def local(p, xx, mm):
        return jax.grad(lambda q: jax.lax.pmean(loss(q, xx, mm),
                                                "data"))(p)
    g_dp = jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(), P("data"), P("data")),
                             out_specs=P()))(params, x, mask)
    g_one = jax.grad(loss)(params, x, mask)
    # bf16 cotangents round differently per shard: compare at bf16 scale
    for a, b in zip(jax.tree_util.tree_leaves(g_dp),
                    jax.tree_util.tree_leaves(g_one)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max()
