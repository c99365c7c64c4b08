"""BSP data parallelism: shard_map + psum gradient averaging.

JAX-native equivalent of the reference's synchronous strategies
(reference: src/aslp-parallel/bsp-worker.cc:33 — periodic model averaging
over MPI Allreduce).  Here the idiomatic form is *gradient* averaging
every step: the model stays replicated, the batch is sharded over the
'data' mesh axis, and the global-batch gradient falls out of
differentiating the pmean'd loss (XLA auto-inserts the backward psum for
replicated params), replacing the GPU→CPU→MPI→CPU→GPU staging
(mpi-node.h:77-92).  With sync every step this is mathematically the
reference's BSP with sync_period = minibatch.

Losses that are means over frames (ctc_batch_loss, xent_loss) report
their frame count as ``aux["frames"]``; the shards are then weighted by
it, so a step over shards of unequal length equals the one-card step
over the whole batch."""

from __future__ import annotations

from typing import Any, Callable

import jax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def global_mean(loss, aux, axis):
    """The loss over the whole batch from each shard's ``loss``: the
    shards weighted by ``aux["frames"]`` where the loss reports it,
    else equally."""
    if isinstance(aux, dict) and "frames" in aux:
        frames = aux["frames"]
        return (jax.lax.psum(loss * frames, axis)
                / jax.lax.psum(frames, axis))
    return jax.lax.pmean(loss, axis)


def make_bsp_train_step(
    loss_fn: Callable,
    update_fn: Callable,
    mesh: Mesh,
    axis: str = "data",
    batch_spec: P = None,
):
    """Build a jitted data-parallel train step.

    loss_fn(params, batch) → (loss, aux) on the local shard.
    update_fn(params, grads, opt_state, learn_rate) → (params, opt_state).

    Returns step(params, opt_state, batch, learn_rate) →
    (params, opt_state, loss, aux); params/opt_state replicated, batch
    sharded on its leading axis.  The gradient of the global loss
    (``global_mean``) IS the global-batch gradient (backward psum
    inserted automatically for the replicated params), so no manual
    gradient collective is needed."""
    if batch_spec is None:
        batch_spec = P(axis)

    def shard_step(params, opt_state, batch, learn_rate):
        def global_loss(p):
            loss, aux = loss_fn(p, batch)
            return global_mean(loss, aux, axis), aux
        (loss, aux), grads = jax.value_and_grad(
            global_loss, has_aux=True
        )(params)
        aux = jax.lax.pmean(aux, axis)
        new_params, new_opt = update_fn(params, grads, opt_state, learn_rate)
        return new_params, new_opt, loss, aux

    sharded = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P(), P(), batch_spec, P()),
        out_specs=(P(), P(), P(), P()),
    )
    return jax.jit(sharded)


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data") -> Any:
    """Device-put a host batch with its leading dim sharded."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), batch
    )
