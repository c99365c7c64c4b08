"""BMUF: block-momentum update filtering as an outer optimizer.

JAX-native equivalent of the reference's scalable sync strategy
(reference: src/aslp-parallel/bmuf-worker.cc:37-68 — every sync_period
frames each worker computes delta = w_local − w_prev, allreduces it,
applies a momentum filter d(t) = m·d(t−1) + (1−m)·lr_bmuf·G(t), sets
w ← w_prev + d (+ Nesterov pre-shift), and snapshots w_prev).

Here this is the *outer* loop over host groups or gradient-accumulation
blocks: the inner loop is plain BSP/psum over the cards of a block;
BMUF reconciles blocks trained independently.  Pure pytree math — the
allreduce is either `jax.lax.pmean` (inside shard_map over a 'block'
axis) or host-level process allreduce; both callers just hand this class
the block-averaged parameters."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config


@dataclasses.dataclass
class BmufOptions(Config):
    bmuf_momentum: float = 0.9
    bmuf_learn_rate: float = 1.0
    nesterov: bool = True  # NBM variant (the reference default scheme)


class BmufState:
    def __init__(self, params: Any):
        self.w_prev = params
        self.delta = jax.tree_util.tree_map(jnp.zeros_like, params)


def bmuf_sync(
    state: BmufState,
    block_avg_params: Any,
    opts: BmufOptions,
):
    """One BMUF synchronization.

    block_avg_params: the across-block average of locally-trained params
    (the Allreduce(SUM)/num_blocks result).  Returns (new_params, state).
    """
    m, lr = opts.bmuf_momentum, opts.bmuf_learn_rate

    def upd(w_prev, delta, w_avg):
        g = w_avg - w_prev                       # block gradient G(t)
        d = m * delta + (1.0 - m) * lr * g       # momentum filter
        w = w_prev + d
        if opts.nesterov:
            w_next_base = w                      # snapshot BEFORE lookahead
            w = w + m * d                        # Nesterov pre-shift
            return w, d, w_next_base
        return w, d, w

    flat_prev, treedef = jax.tree_util.tree_flatten(state.w_prev)
    flat_delta = jax.tree_util.tree_leaves(state.delta)
    flat_avg = jax.tree_util.tree_leaves(block_avg_params)
    new_w, new_d, new_prev = [], [], []
    for wp, dl, wa in zip(flat_prev, flat_delta, flat_avg):
        w, d, p = upd(wp, dl, wa)
        new_w.append(w)
        new_d.append(d)
        new_prev.append(p)
    state.delta = jax.tree_util.tree_unflatten(treedef, new_d)
    state.w_prev = jax.tree_util.tree_unflatten(treedef, new_prev)
    return jax.tree_util.tree_unflatten(treedef, new_w), state


def make_bmuf_block_step(
    loss_fn,
    update_fn,
    mesh,
    opts: Optional[BmufOptions] = None,
    inner_steps: int = 2,
    block_axis: str = "block",
    data_axis: str = "data",
    scan_batches: bool = False,
):
    """BSP inside blocks, BMUF across blocks, in ONE shard_map over a
    (block, data) mesh — the runnable form of the reference's
    "mpirun groups with BMUF sync" topology (reference:
    aslp_scripts/aslp_nnet/train_scheduler_mpi.sh + bmuf-worker.cc;
    PARALLELISM.md strategy map).

    Carries (w, w_prev, delta, opt_states) where opt_states has a
    leading block dim (each block keeps its own local momenta, like the
    reference workers).  Per call: ``inner_steps`` of psum-BSP SGD over
    the block's data shard, then the BMUF momentum filter over the
    across-block model average.

    Returns step(w, w_prev, delta, opt_states, batch, lr) →
    (w, w_prev, delta, opt_states, loss).

    scan_batches=False: every inner step re-uses ``batch`` (the dryrun
    form).  scan_batches=True: each leaf of ``batch`` carries a leading
    ``inner_steps`` dim and the inner scan consumes one slice per step —
    the worker-CLI form where --sync-period frames of fresh data pass
    between BMUF syncs (reference: bmuf-worker.cc Synchronize every
    sync_period frames)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from kaldi_aslp_tpu.parallel.bsp import global_mean

    opts = opts or BmufOptions()
    m, blr = opts.bmuf_momentum, opts.bmuf_learn_rate

    def shard_step(w, w_prev, delta, opt_blk, batch, lr):
        opt = jax.tree_util.tree_map(lambda v: v[0], opt_blk)
        # the carry becomes block-varying after the first inner step
        # (each block sees different data); mark it so up front or the
        # scan carry typecheck rejects it (see CLAUDE.md VMA invariant)
        def vary(t):
            return jax.tree_util.tree_map(
                lambda a: jax.lax.pcast(a, (block_axis,), to="varying"),
                t)
        p = vary(w)

        def one(carry, step_batch):
            p, opt = carry
            b = step_batch if scan_batches else batch

            def global_loss(pp):
                loss, aux = loss_fn(pp, b)
                return global_mean(loss, aux, data_axis), aux

            (loss, _aux), grads = jax.value_and_grad(
                global_loss, has_aux=True)(p)
            p, opt = update_fn(p, grads, opt, lr)
            return (p, opt), loss

        (p, opt), losses = jax.lax.scan(
            one, (p, opt), batch if scan_batches else None,
            length=None if scan_batches else inner_steps)
        p_avg = jax.tree_util.tree_map(
            lambda a: jax.lax.pmean(a, block_axis), p)
        # BMUF filter (replicated math, identical on every device)
        g = jax.tree_util.tree_map(lambda a, b: a - b, p_avg, w_prev)
        new_delta = jax.tree_util.tree_map(
            lambda d, gg: m * d + (1.0 - m) * blr * gg, delta, g)
        new_prev = jax.tree_util.tree_map(
            lambda wp, d: wp + d, w_prev, new_delta)
        if opts.nesterov:
            new_w = jax.tree_util.tree_map(
                lambda wb, d: wb + m * d, new_prev, new_delta)
        else:
            new_w = new_prev
        loss_out = jax.lax.pmean(losses[-1], block_axis)
        opt_out = jax.tree_util.tree_map(lambda v: v[None], opt)
        return new_w, new_prev, new_delta, opt_out, loss_out

    batch_spec = (P(None, (block_axis, data_axis)) if scan_batches
                  else P((block_axis, data_axis)))
    step = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(block_axis), batch_spec, P()),
        out_specs=(P(), P(), P(), P(block_axis), P()),
    )
    return jax.jit(step)


def stack_block_states(opt_state, num_blocks: int):
    """Replicate an optimizer state with a leading block dimension (the
    per-block local momenta carried by make_bmuf_block_step)."""
    return jax.tree_util.tree_map(
        lambda v: jnp.stack([v] * num_blocks), opt_state)
