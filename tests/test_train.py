"""Trainer / scheduler / parallel tests.

Distributed logic runs on the 8-device virtual CPU mesh (conftest), the
equivalent of the reference's localhost-mpirun testing (SURVEY.md §4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from kaldi_aslp_tpu.models import Nnet, xent_loss
from kaldi_aslp_tpu.train import (
    CtcTrainer,
    FrameTrainer,
    NewbobOptions,
    NewbobScheduler,
    NnetTrainOptions,
    init_velocity,
    make_sgd_update,
)
from kaldi_aslp_tpu.parallel import (
    BmufOptions,
    BmufState,
    bmuf_sync,
    make_bsp_train_step,
    make_mesh,
    make_optimizer,
    OptimizerOptions,
    shard_batch,
)

PROTO = """<AffineTransform> <InputDim> 8 <OutputDim> 16 <ParamStddev> 0.1
<Sigmoid> <InputDim> 16 <OutputDim> 16
<AffineTransform> <InputDim> 16 <OutputDim> 4 <ParamStddev> 0.1"""


def _toy_data(rng, n=512, dim=8, classes=4):
    """Linearly separable-ish toy task."""
    w = rng.randn(dim, classes)
    x = rng.randn(n, dim).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.int32)
    return x, y


def test_frame_trainer_learns(rng):
    net = Nnet.from_proto(PROTO)
    params = net.init(jax.random.PRNGKey(0))
    velocity = init_velocity(params)
    trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.9))
    x, y = _toy_data(rng)

    def batches():
        for i in range(0, len(x), 64):
            yield x[i:i + 64], y[i:i + 64]

    rep0 = trainer.evaluate(params, batches())
    for _ in range(10):
        params, velocity, rep = trainer.train_epoch(
            params, velocity, batches(), learn_rate=0.5
        )
    rep1 = trainer.evaluate(params, batches())
    assert rep1.avg_loss < rep0.avg_loss * 0.5
    assert rep1.frame_accuracy > 80.0


def test_sgd_l2_and_max_norm(rng):
    net = Nnet.from_proto(
        "<AffineTransform> <InputDim> 4 <OutputDim> 4 <MaxNorm> 0.5"
    )
    params = net.init(jax.random.PRNGKey(1))
    update = make_sgd_update(net, NnetTrainOptions(l2_penalty=0.1))
    grads = jax.tree_util.tree_map(jnp.zeros_like, params)
    p2, _ = update(params, grads, init_velocity(params),
                   jnp.asarray(0.1, jnp.float32))
    # zero grads + L2 → shrink toward 0; max-norm clips row norms
    w2 = np.asarray(p2["0"]["w"])
    norms = np.linalg.norm(w2, axis=1)
    assert (norms <= 0.5 + 1e-5).all()


def test_newbob_schedule(tmp_path):
    sched = NewbobScheduler(
        str(tmp_path), initial_lr=0.008,
        opts=NewbobOptions(start_halving_impr=0.01,
                           end_halving_impr=0.001, max_iters=20),
    )
    # big improvements: lr stays
    assert sched.report(10.0) and sched.learn_rate == 0.008
    assert sched.report(8.0) and sched.learn_rate == 0.008
    # small improvement < 1% → halving starts
    sched.report(7.95)
    assert sched.state.halving and sched.learn_rate == 0.004
    # worse → rejected
    assert not sched.report(8.5)
    assert sched.learn_rate == 0.002
    # tiny improvement < 0.1% while halving → done
    sched.report(7.949)
    assert sched.done
    # resume from disk
    sched2 = NewbobScheduler(str(tmp_path), initial_lr=0.008)
    assert sched2.state.iter == sched.state.iter
    assert sched2.learn_rate == sched.learn_rate


def test_ctc_trainer_smoke(rng):
    net = Nnet.from_proto(
        "<Lstm> <InputDim> 6 <OutputDim> 16\n"
        "<AffineTransform> <InputDim> 16 <OutputDim> 8 <ParamStddev> 0.1"
    )
    params = net.init(jax.random.PRNGKey(2))
    velocity = init_velocity(params)
    trainer = CtcTrainer(net)
    from kaldi_aslp_tpu.data.sequence import CtcBatcher, CtcBatcherOptions

    def src():
        for i in range(8):
            T = 20 + i
            yield (f"u{i}", rng.randn(T, 6).astype(np.float32),
                   rng.randint(1, 8, 3))
    batches = list(CtcBatcher(src(), CtcBatcherOptions(num_streams=4)))
    l0 = trainer.evaluate(params, batches).avg_loss
    for _ in range(15):
        params, velocity, rep = trainer.train_epoch(
            params, velocity, batches, learn_rate=0.1
        )
    l1 = trainer.evaluate(params, batches).avg_loss
    assert l1 < l0


def test_bsp_data_parallel_matches_single_device(rng):
    """psum-averaged sharded grads == single-device full-batch grads
    (the BSP equivalence, reference: bsp-worker.cc)."""
    net = Nnet.from_proto(PROTO)
    params = net.init(jax.random.PRNGKey(3))
    x, y = _toy_data(rng, n=64)
    xb, yb = jnp.asarray(x), jnp.asarray(y)

    def loss_fn(p, batch):
        out, _ = net.apply(p, batch["x"])
        return xent_loss(out, batch["y"])

    update = make_sgd_update(net, NnetTrainOptions())
    velocity = init_velocity(params)

    def update_fn(p, g, vel, lr):
        return update(p, g, vel, lr)

    mesh = make_mesh(("data",))
    assert mesh.devices.size == 8
    step = make_bsp_train_step(loss_fn, update_fn, mesh)
    batch = shard_batch({"x": xb, "y": yb}, mesh)
    p_dp, v_dp, loss_dp, _ = step(
        params, velocity, batch, jnp.asarray(0.1, jnp.float32)
    )

    # single-device reference
    (_, _), g_ref = jax.value_and_grad(loss_fn, has_aux=True)(
        params, {"x": xb, "y": yb}
    )
    p_ref, _ = update(params, g_ref, velocity, jnp.asarray(0.1, jnp.float32))
    for a, b in zip(jax.tree_util.tree_leaves(p_dp),
                    jax.tree_util.tree_leaves(p_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reports_frames", [True, False])
def test_bsp_weights_shards_by_their_frames(rng, reports_frames):
    """Shards of unequal frame counts: a loss that reports its frames
    gives the one-device step over the whole batch; one that does not
    gives the equal-weight mean of the shard losses."""
    net = Nnet.from_proto(PROTO)
    params = net.init(jax.random.PRNGKey(4))
    x, y = _toy_data(rng, n=64)
    # shard k keeps k + 1 of its 8 frames
    w = (np.arange(64) % 8 < np.repeat(np.arange(8) + 1, 8)).astype(
        np.float32)
    data = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.asarray(w)}

    def loss_fn(p, batch):
        out, _ = net.apply(p, batch["x"])
        loss, aux = xent_loss(out, batch["y"], batch["w"])
        return loss, (aux if reports_frames else 0.0)

    update = make_sgd_update(net, NnetTrainOptions())
    velocity = init_velocity(params)
    lr = jnp.asarray(0.1, jnp.float32)
    mesh = make_mesh(("data",))
    step = make_bsp_train_step(loss_fn, update, mesh)
    p_dp, _, loss_dp, _ = step(params, velocity, shard_batch(data, mesh), lr)

    grad = jax.value_and_grad(lambda p, b: loss_fn(p, b)[0])
    if reports_frames:
        loss_ref, g_ref = grad(params, data)
    else:
        parts = [grad(params, jax.tree_util.tree_map(
            lambda a: a[8 * k:8 * (k + 1)], data)) for k in range(8)]
        loss_ref = sum(v for v, _ in parts) / 8
        g_ref = jax.tree_util.tree_map(lambda *g: sum(g) / 8,
                                       *[g for _, g in parts])
    p_ref, _ = update(params, g_ref, velocity, lr)
    np.testing.assert_allclose(float(loss_dp), float(loss_ref), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p_dp),
                    jax.tree_util.tree_leaves(p_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_bmuf_sync(rng):
    params = {"w": jnp.asarray(rng.randn(4, 4).astype(np.float32))}
    state = BmufState(params)
    opts = BmufOptions(bmuf_momentum=0.5, bmuf_learn_rate=1.0,
                       nesterov=False)
    # two blocks drifted by +1 and +3 → average drift +2
    avg = {"w": params["w"] + 2.0}
    new_p, state = bmuf_sync(state, avg, opts)
    # d = 0.5*0 + 0.5*2 = 1 → w = w_prev + 1
    np.testing.assert_allclose(
        np.asarray(new_p["w"]), np.asarray(params["w"]) + 1.0, rtol=1e-6
    )
    # second sync with same drift: d = 0.5*1 + 0.5*2 = 1.5
    avg2 = {"w": new_p["w"] + 2.0}
    new_p2, state = bmuf_sync(state, avg2, opts)
    np.testing.assert_allclose(
        np.asarray(new_p2["w"]),
        np.asarray(new_p["w"]) + 1.5, rtol=1e-5
    )


def test_optimizer_factory():
    import optax
    for name in ("sgd", "momentum", "adagrad", "rmsprop", "adadelta",
                 "adam"):
        opt = make_optimizer(OptimizerOptions(optimizer=name))
        params = {"w": jnp.ones((3,))}
        st = opt.init(params)
        upd, _ = opt.update({"w": jnp.ones((3,))}, st, params)
        assert jnp.isfinite(upd["w"]).all()
    with pytest.raises(ValueError):
        make_optimizer(OptimizerOptions(optimizer="bogus"))
