"""BSP-inside-blocks + BMUF-across-blocks equivalence tests
(reference: src/aslp-parallel/bmuf-worker.cc:37-68 sync protocol over
mpirun worker groups, train_scheduler_mpi.sh topology)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from kaldi_aslp_tpu.parallel import (
    BmufOptions,
    make_bmuf_block_step,
    make_mesh,
    stack_block_states,
)


def _setup(rng):
    # tiny quadratic model: params {'w': [D]}, loss = mean((x @ w - y)^2)
    D = 8
    params = {"w": jnp.asarray(rng.randn(D).astype(np.float32))}

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"]
        return jnp.mean((pred - batch["y"]) ** 2), 0.0

    def update_fn(p, grads, vel, lr):
        vel = jax.tree_util.tree_map(
            lambda v, g: 0.9 * v + g, vel, grads)
        p = jax.tree_util.tree_map(
            lambda a, v: a - lr * v, p, vel)
        return p, vel

    vel0 = jax.tree_util.tree_map(jnp.zeros_like, params)
    return params, vel0, loss_fn, update_fn


def test_bmuf_block_step_matches_manual_simulation(rng):
    n_blocks, per_block = 2, 4
    mesh = make_mesh(("block", "data"),
                     devices=jax.devices()[:n_blocks * per_block],
                     shape=(n_blocks, per_block))
    params, vel0, loss_fn, update_fn = _setup(rng)
    opts = BmufOptions(bmuf_momentum=0.8, bmuf_learn_rate=1.0,
                       nesterov=True)
    inner = 3
    S = 16  # divisible by 8 devices
    batch = {
        "x": jnp.asarray(rng.randn(S, 8).astype(np.float32)),
        "y": jnp.asarray(rng.randn(S).astype(np.float32)),
    }
    step = make_bmuf_block_step(loss_fn, update_fn, mesh, opts,
                                inner_steps=inner)
    sharded = jax.tree_util.tree_map(
        lambda a: jax.device_put(
            a, NamedSharding(mesh, P(("block", "data")))), batch)
    w_prev = params
    delta = jax.tree_util.tree_map(jnp.zeros_like, params)
    opt_blk = stack_block_states(vel0, n_blocks)
    lr = jnp.float32(0.05)
    w2, w_prev2, delta2, opt2, loss2 = step(
        params, w_prev, delta, opt_blk, sharded, lr)

    # ---- manual simulation ----
    halves = [
        {k: np.asarray(v)[:S // 2] for k, v in batch.items()},
        {k: np.asarray(v)[S // 2:] for k, v in batch.items()},
    ]

    def train_block(p, b):
        vel = {"w": np.zeros(8, np.float32)}
        p = {"w": np.asarray(p["w"]).copy()}
        for _ in range(inner):
            # full-block gradient == pmean of per-device shard grads
            x, y = b["x"], b["y"]
            pred = x @ p["w"]
            g = 2.0 * x.T @ (pred - y) / len(y)
            vel["w"] = 0.9 * vel["w"] + g
            p["w"] = p["w"] - 0.05 * vel["w"]
        return p

    blocks = [train_block(params, b) for b in halves]
    avg = {"w": (blocks[0]["w"] + blocks[1]["w"]) / 2}
    g = avg["w"] - np.asarray(w_prev["w"])
    d = 0.8 * 0.0 + (1 - 0.8) * 1.0 * g
    new_prev = np.asarray(w_prev["w"]) + d
    new_w = new_prev + 0.8 * d

    np.testing.assert_allclose(np.asarray(w2["w"]), new_w, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(w_prev2["w"]), new_prev,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(delta2["w"]), d, rtol=1e-5,
                               atol=1e-6)
    # per-block momenta survived with the block dim
    assert np.asarray(opt2["w"]).shape == (n_blocks, 8)
    assert not np.allclose(np.asarray(opt2["w"])[0],
                           np.asarray(opt2["w"])[1])


def test_bmuf_block_step_weights_data_shards_by_frames(rng):
    """Inside a block, cards with unequal frame counts: each block's
    inner step is the one-device step over the block's frames."""
    mesh = make_mesh(("block", "data"), devices=jax.devices()[:4],
                     shape=(2, 2))
    params, vel0, _, update_fn = _setup(rng)

    def loss_fn(p, batch):
        err = (batch["x"] @ p["w"] - batch["y"]) ** 2
        frames = batch["f"].sum()
        return (err * batch["f"]).sum() / frames, {"frames": frames}

    S = 16
    batch = {
        "x": jnp.asarray(rng.randn(S, 8).astype(np.float32)),
        "y": jnp.asarray(rng.randn(S).astype(np.float32)),
        # the four cards keep 1, 4, 2 and 3 of their 4 frames
        "f": jnp.asarray((np.arange(S) % 4 < np.repeat([1, 4, 2, 3], 4))
                         .astype(np.float32)),
    }
    opts = BmufOptions(bmuf_momentum=0.0, bmuf_learn_rate=1.0,
                       nesterov=False)
    step = make_bmuf_block_step(loss_fn, update_fn, mesh, opts,
                                inner_steps=1)
    sharded = jax.tree_util.tree_map(
        lambda a: jax.device_put(
            a, NamedSharding(mesh, P(("block", "data")))), batch)
    lr = jnp.float32(0.05)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    w2, *_ = step(params, params, zeros, stack_block_states(vel0, 2),
                  sharded, lr)

    grad = jax.grad(lambda p, b: loss_fn(p, b)[0])
    blocks = []
    for k in range(2):
        half = jax.tree_util.tree_map(lambda a: a[8 * k:8 * (k + 1)], batch)
        blocks.append(update_fn(params, grad(params, half), vel0, lr)[0])
    want = (np.asarray(blocks[0]["w"]) + np.asarray(blocks[1]["w"])) / 2
    np.testing.assert_allclose(np.asarray(w2["w"]), want, rtol=1e-5,
                               atol=1e-6)


def test_per_host_input_sharding():
    """split_data_dir's round-robin shard per process index is
    disjoint, complete, and deterministic (the per-worker scp shard
    semantics of train_scheduler_mpi.sh)."""
    from kaldi_aslp_tpu.io import DataDir, split_data_dir

    d = DataDir(path="/tmp/nonexistent_datadir_test")
    for i in range(11):
        k = f"utt{i:02d}"
        d.wav_scp[k] = f"/wav/{k}.wav"
        d.text[k] = "hello"
        d.utt2spk[k] = "spk"
    shards = split_data_dir(d, 4)
    seen = []
    for s in shards:
        seen.extend(s.wav_scp)
    assert sorted(seen) == sorted(d.wav_scp)
    assert len(set(seen)) == len(seen)
    again = split_data_dir(d, 4)
    for a, b in zip(shards, again):
        assert list(a.wav_scp) == list(b.wav_scp)
