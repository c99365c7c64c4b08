"""No jitted entry point may close over a DEVICE array.

A jit-compiled program that captures a jax.Array constant — even a
scalar like ``lr = jnp.asarray(1e-4)`` — ties the compiled program to
that buffer on that device: the constant is baked into the executable
(and re-traced code leaks one compile per fresh array).  Captured host
numpy arrays (HLO literals) and arrays passed as arguments are the
supported forms.

These tests trace the hot entry points with ``jax.make_jaxpr`` and
assert the resulting jaxpr carries no jax.Array consts, so the pattern
cannot silently return.  (The reference has no analogue — CUDA kernels
take every pointer as an argument by construction; cf. the argument
lists of src/aslp-nnet/ctc-loss.cc and cu-matrix.h kernels.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def device_consts(fn, *args, **kwargs):
    closed = jax.make_jaxpr(fn)(*args, **kwargs)
    bad = [c for c in closed.consts if isinstance(c, jax.Array)]
    # constants can also hide inside nested pjit/closed-call eqns
    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            for v in eqn.params.values():
                inner = getattr(v, "jaxpr", None)
                if inner is not None:
                    bad.extend(c for c in getattr(v, "consts", ())
                               if isinstance(c, jax.Array))
                    walk(inner)
    walk(closed.jaxpr)
    return bad


def test_detector_flags_captured_device_array():
    c = jnp.arange(4.0)

    def bad_fn(x):
        return (x + c).sum()

    assert device_consts(bad_fn, jnp.ones(4))


def test_detector_passes_numpy_capture_and_args():
    c = np.arange(4.0, dtype=np.float32)

    def ok_fn(x):
        return (x + c).sum()

    assert not device_consts(ok_fn, jnp.ones(4))
    assert not device_consts(lambda x, y: (x + y).sum(),
                             jnp.ones(4), jnp.arange(4.0))


@pytest.mark.parametrize("maker", ["fbank", "mfcc", "plp", "spectrogram"])
def test_feature_extractors_capture_no_device_arrays(maker):
    from kaldi_aslp_tpu.feats.fbank import Fbank
    from kaldi_aslp_tpu.feats.mfcc import Mfcc
    from kaldi_aslp_tpu.feats.plp import Plp, Spectrogram

    f = {"fbank": Fbank, "mfcc": Mfcc, "plp": Plp,
         "spectrogram": Spectrogram}[maker]()
    wav = jnp.zeros(16000, jnp.float32)
    # trace the underlying jitted method (self is static under its jit;
    # Plp runs its LPC tail on host, so its device part is _device_part)
    meth = f._device_part if maker == "plp" else f._compute
    assert not device_consts(
        lambda w: meth.__wrapped__(f, w, None), wav)


def test_conv_nnet_apply_captures_no_device_arrays():
    from kaldi_aslp_tpu.models.conv import ConvolutionalComponent
    from kaldi_aslp_tpu.models.nnet import Nnet

    net = Nnet()
    net.add(ConvolutionalComponent(
        27, 28, patch_dim=3, patch_step=1, patch_stride=9))
    params = net.init(jax.random.PRNGKey(0))
    x = jnp.zeros((2, 5, 27), jnp.float32)
    assert not device_consts(
        lambda p, xx: net.apply(p, xx)[0], params, x)


def test_trainer_steps_capture_no_device_arrays():
    from kaldi_aslp_tpu.models.nnet import Nnet
    from kaldi_aslp_tpu.models.simple import AffineTransform, Softmax
    from kaldi_aslp_tpu.train import NnetTrainOptions, init_velocity
    from kaldi_aslp_tpu.train.trainer import CtcTrainer, FrameTrainer

    net = Nnet()
    net.add(AffineTransform(8, 12))
    params = net.init(jax.random.PRNGKey(0))
    velocity = init_velocity(params)
    rng = jax.random.PRNGKey(1)

    ft = FrameTrainer(net, NnetTrainOptions(momentum=0.9))
    feats = jnp.zeros((4, 8)); tgt = jnp.zeros(4, jnp.int32)
    w = jnp.ones(4); lr = jnp.float32(0.001)
    assert not device_consts(ft._make_step(), params, velocity, feats,
                             tgt, w, lr, rng)

    ct = CtcTrainer(net, NnetTrainOptions(momentum=0.9))
    S, T, U = 2, 6, 2
    assert not device_consts(
        ct._make_step(), params, velocity, jnp.zeros((S, T, 8)),
        jnp.ones((S, U), jnp.int32), jnp.full(S, T, jnp.int32),
        jnp.full(S, U, jnp.int32), jnp.ones((S, T)), lr, rng)

    for tr, payload in [("bf16", jnp.zeros((S, T, 8), jnp.bfloat16)),
                        ("int8", jnp.zeros((S, T, 8), jnp.int8))]:
        ctt = CtcTrainer(net, NnetTrainOptions(momentum=0.9), transport=tr)
        assert not device_consts(
            ctt._make_step(), params, velocity, payload,
            jnp.ones(8), jnp.zeros(8),
            jnp.ones((S, U), jnp.int32), jnp.full(S, T, jnp.int32),
            jnp.full(S, U, jnp.int32), lr, rng)


def test_bench_flagship_step_captures_no_device_arrays():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench as B

    step, params, velocity = B._build_flagship()
    S, T, U, D, V = 2, 8, 2, B.BENCH_D, B.BENCH_V
    args = (params, velocity, jnp.zeros((S, T, D)),
            jnp.ones((S, U), jnp.int32), jnp.full(S, T, jnp.int32),
            jnp.full(S, U, jnp.int32), jnp.ones((S, T)))
    assert not device_consts(step.__wrapped__, *args)


def test_beam_decoder_compaction_captures_no_device_arrays():
    from kaldi_aslp_tpu.decoder.beam import _record_prune_chunk

    neg = jax.lax.bitcast_convert_type(jnp.float32(-1e30), jnp.int32)
    em_pk = jnp.full((4, 5, 8), -1, jnp.int32).at[:, (1, 4)].set(neg)
    eps_pk = jnp.full((4, 1, 5, 8), -1, jnp.int32).at[:, :, (1, 4)].set(neg)
    valid = jnp.ones((4,), bool)
    em = jnp.arange(5, dtype=jnp.int32)
    ep = jnp.arange(3, dtype=jnp.int32)
    V = jnp.full((6,), -1e30, jnp.float32)
    assert not device_consts(
        lambda *a: _record_prune_chunk(
            *a, jnp.float32(-10.0),
            stages=2, chunk=4, R_pr=4),
        em_pk, eps_pk, valid, em, ep, V)
