"""Byte-aware feature transport (data/transport.py) + lazy LossReporter.

For byte-bound host→device links features cross as bf16/int8 and
masks are derived on device.  These tests pin:
round-trip accuracy bounds, exact zero padding after int8 dequant, mask
equivalence with the batcher's host mask, and that transported training
steps match the f32 path within quantization tolerance.  (The reference
has no analogue — its PCIe CopyFromMat is never the bottleneck;
cf. src/aslp-nnet/nnet-randomizer.cc AddData.)
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kaldi_aslp_tpu.data.sequence import CtcBatcher, CtcBatcherOptions
from kaldi_aslp_tpu.data.transport import (
    mask_from_lengths,
    pack_feats,
    unpack_feats,
)


def _rand_feats(S=3, T=20, D=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(S, T, D) * 3 + rs.randn(D) * 5).astype(np.float32)


def test_f32_passthrough_exact():
    f = _rand_feats()
    payload, scale, offset = pack_feats(f, "f32")
    assert scale is None and offset is None
    out = np.asarray(unpack_feats(jnp.asarray(payload), None, None))
    np.testing.assert_array_equal(out, f)


def test_bf16_round_trip_tolerance():
    f = _rand_feats()
    payload, scale, offset = pack_feats(f, "bf16")
    assert payload.nbytes == f.nbytes // 2
    out = np.asarray(unpack_feats(jnp.asarray(payload), None, None))
    # bf16 has an 8-bit mantissa: relative error <= 2^-8
    np.testing.assert_allclose(out, f, rtol=2 ** -8, atol=1e-6)


def test_int8_round_trip_tolerance_and_exact_padding():
    f = _rand_feats()
    S, T, D = f.shape
    in_lens = np.array([20, 13, 7], np.int32)
    for s in range(S):
        f[s, in_lens[s]:] = 0.0
    payload, scale, offset = pack_feats(f, "int8")
    assert payload.dtype == np.int8 and payload.nbytes == f.nbytes // 4
    out = np.asarray(unpack_feats(jnp.asarray(payload), jnp.asarray(scale),
                                  jnp.asarray(offset),
                                  jnp.asarray(in_lens)))
    # quantization step is scale per dim; round-off error <= scale/2 + eps
    err = np.abs(out - f)
    assert (err <= scale[None, None, :] * 0.51 + 1e-6).all()
    # padding must be EXACT zero (splice/conv read across boundaries)
    for s in range(S):
        np.testing.assert_array_equal(out[s, in_lens[s]:], 0.0)


def test_int8_constant_dim_does_not_blow_up():
    f = _rand_feats()
    f[..., 2] = 4.2  # zero dynamic range on one dim
    payload, scale, offset = pack_feats(f, "int8")
    out = np.asarray(unpack_feats(jnp.asarray(payload), jnp.asarray(scale),
                                  jnp.asarray(offset)))
    np.testing.assert_allclose(out[..., 2], 4.2, atol=1e-5)


def test_mask_from_lengths_matches_batcher_mask():
    rs = np.random.RandomState(3)
    utts = [(f"u{i}", rs.randn(int(rs.randint(5, 33)), 4).astype(np.float32),
             rs.randint(1, 9, 3).astype(np.int32)) for i in range(8)]
    opts = CtcBatcherOptions(num_streams=4, bucket_time=8, bucket_labels=4,
                             frame_limit=10 ** 9)
    for b in CtcBatcher(iter(utts), opts):
        dev = np.asarray(mask_from_lengths(
            jnp.asarray(b.input_lengths), b.feats.shape[1]))
        np.testing.assert_array_equal(dev, b.frame_mask)


def test_int8d_decodes_to_exact_int8_codes():
    """Delta coding is lossless over the int8 quantization grid: the
    cumsum-decoded codes equal direct int8 quantization at the (possibly
    widened) scale, and padding decodes to exact zero."""
    f = _rand_feats()
    S, T, D = f.shape
    in_lens = np.array([20, 13, 7], np.int32)
    for s in range(S):
        f[s, in_lens[s]:] = 0.0
    payload, scale, offset = pack_feats(f, "int8d", in_lens)
    assert payload.dtype == np.int8 and payload.nbytes == f.nbytes // 4
    out = np.asarray(unpack_feats(jnp.asarray(payload), jnp.asarray(scale),
                                  jnp.asarray(offset), jnp.asarray(in_lens),
                                  delta=True))
    err = np.abs(out - f)
    assert (err <= scale[None, None, :] * 0.51 + 1e-6).all()
    for s in range(S):
        np.testing.assert_array_equal(out[s, in_lens[s]:], 0.0)
    # deltas really are small for temporally-smooth features (frame
    # rate >> modulation rate, the MFCC regime)
    T2 = 400
    t = np.linspace(0, 1, T2, dtype=np.float32)
    g = np.stack([np.sin(2 * np.pi * (d + 1) * t) for d in range(D)],
                 axis=1)[None].repeat(S, 0).astype(np.float32)
    p2, s2, o2 = pack_feats(g, "int8d", np.full(S, T2, np.int32))
    assert np.abs(p2[:, 1:]).mean() < 8.0


@pytest.mark.parametrize("transport,tol", [("bf16", 2e-2), ("int8", 6e-2),
                                           ("int8d", 6e-2)])
def test_ctc_trainer_transport_matches_f32(transport, tol):
    from kaldi_aslp_tpu.models.nnet import Nnet
    from kaldi_aslp_tpu.models.simple import AffineTransform
    from kaldi_aslp_tpu.train import NnetTrainOptions, init_velocity
    from kaldi_aslp_tpu.train.trainer import CtcTrainer

    rs = np.random.RandomState(0)
    D, V, S, T, U = 6, 7, 4, 24, 4
    utts = [(f"u{i}", rs.randn(int(rs.randint(16, T + 1)), D)
             .astype(np.float32),
             rs.randint(1, V, int(rs.randint(2, U + 1))).astype(np.int32))
            for i in range(8)]
    opts = CtcBatcherOptions(num_streams=S, bucket_time=T, bucket_labels=U,
                             frame_limit=10 ** 9, sort_by_length=False)

    def run(tr):
        net = Nnet()
        net.add(AffineTransform(D, V))
        trainer = CtcTrainer(net, NnetTrainOptions(momentum=0.9),
                             transport=tr)
        params = net.init(jax.random.PRNGKey(0))
        velocity = init_velocity(params)
        batches = list(CtcBatcher(iter(utts), opts))
        params, velocity, rep = trainer.train_epoch(
            params, velocity, iter(batches), 0.01)
        return rep.avg_loss, params

    loss_ref, params_ref = run("f32")
    loss_t, params_t = run(transport)
    assert loss_t == pytest.approx(loss_ref, rel=tol)
    for (k1, a), (k2, b) in zip(
            jax.tree_util.tree_leaves_with_path(params_ref),
            jax.tree_util.tree_leaves_with_path(params_t)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=tol, atol=tol)


def test_loss_reporter_defers_fetches_until_read():
    from kaldi_aslp_tpu.models.losses import LossReporter

    rep = LossReporter("t")
    for i in range(10):
        rep.update({"frames": jnp.asarray(5.0),
                    "loss_sum": jnp.asarray(1.0 * i)})
    assert len(rep._pending) == 10  # nothing fetched yet
    assert rep.frames == 50.0
    assert not rep._pending
    assert rep.avg_loss == pytest.approx(45.0 / 50.0)
    # drains automatically at the pending cap
    for i in range(LossReporter.MAX_PENDING):
        rep.update({"frames": jnp.asarray(1.0),
                    "loss_sum": jnp.asarray(0.0)})
    assert not rep._pending
    assert rep.frames == 50.0 + LossReporter.MAX_PENDING
    assert "AvgLoss" in rep.report()
