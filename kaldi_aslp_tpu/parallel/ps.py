"""EASGD / ASGD / MASGD: asynchronous parameter-server strategies as
deterministic-schedule mesh programs.

JAX-native re-design of the reference's parameter-server trio
(reference: src/aslp-parallel/easgd-server.cc:63-89 + easgd-worker.cc:
37-69 — elastic pairwise averaging; asgd-server.cc:82-109 +
asgd-worker.cc:34-69 — accumulated-delta push / model pull;
masgd-server.cc:109-137 — ASGD with per-worker (LMASGD) or global
(GMASGD) server momentum, masgd-server.h:22-24).

The reference's asynchrony is nothing but an MPI *arrival order*:
workers hit their --sync-period frame count, send kMsgSynchronize, and
the server serves them strictly one at a time (easgd-server.cc:38-61
Run loop).  Given the arrival schedule, the parameter trajectory is
fully determined.  Here (single controller, SPMD over a mesh) we
reproduce exactly that math under an explicit deterministic schedule —
round-robin by default, which is the steady state of equal-speed
workers — so the modes are runnable, testable and bit-reproducible:

  * each worker's local model is a row of a stacked pytree sharded over
    a ('worker',) mesh axis; local SGD between syncs runs data-parallel
    with NO collectives (shard_map, params worker-varying);
  * a sync round is a sequential ``lax.scan`` over worker rows that
    threads the server state through the pairwise updates in arrival
    order — the mesh image of the server's one-at-a-time Update() loop.

Per-mode sync math (verified against the reference sources):

  EASGD (alpha default 0.5, easgd-server.h:23): simultaneous exchange
      x_s ← (1−α)·x_s + α·x_w        (server, easgd-server.cc:85-88)
      x_w ← (1−α)·x_w + α·x_s_old    (worker, easgd-worker.cc:62-65)
  ASGD (alpha default 1.0, asgd-server.h:23): delta push, model pull
      Δ   = x_w − x_prev             (asgd-worker.cc:40-44)
      x_s ← x_s + α·Δ                (asgd-server.cc:91-96)
      x_w = x_prev = x_s             (asgd-worker.cc:61-66)
  MASGD (momentum default 0.9, masgd-server.h:27): ASGD with a server
      momentum filter; LMASGD keeps one buffer per worker, GMASGD one
      shared buffer (masgd-server.cc:117-125)
      d   ← m·d + Δ;  x_s ← x_s + d
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config

tmap = jax.tree_util.tree_map


@dataclasses.dataclass
class PsOptions(Config):
    mode: str = "easgd"          # easgd | asgd | masgd
    alpha: float = 0.5           # easgd elastic / asgd gain
    masgd_momentum: float = 0.9  # masgd server momentum
    masgd_type: str = "local"    # local (LMASGD, the compiled-in
    #                              reference default) | global (GMASGD)
    # NB: the reference's per-mode alpha defaults differ (easgd 0.5,
    # asgd 1.0 — easgd-server.h:23 / asgd-server.h:23); callers pick.


class PsState:
    """Server params + stacked per-worker state.

    ``workers``: pytree with a leading [W] dim (each row one worker's
    local model).  ``prev``: model at the worker's last pull
    (asgd/masgd; asgd-worker.cc prev_worker_gpu_params_).  ``diffs``:
    masgd momentum — per-worker [W, ...] for LMASGD, unstacked for
    GMASGD."""

    def __init__(self, params: Any, num_workers: int, opts: PsOptions):
        self.opts = opts
        self.server = params
        self.workers = tmap(
            lambda v: jnp.broadcast_to(v, (num_workers,) + v.shape), params)
        self.num_workers = num_workers
        if opts.mode in ("asgd", "masgd"):
            self.prev = self.workers
        else:
            self.prev = None
        if opts.mode == "masgd":
            if opts.masgd_type == "local":
                self.diffs = tmap(jnp.zeros_like, self.workers)
            else:
                self.diffs = tmap(jnp.zeros_like, params)
        else:
            self.diffs = None


def easgd_pair_sync(server: Any, worker: Any, alpha: float):
    """One worker↔server elastic exchange (both sides read the OTHER's
    pre-update value — the MPI_Sendrecv in the reference is
    simultaneous)."""
    new_server = tmap(lambda s, w: (1.0 - alpha) * s + alpha * w,
                      server, worker)
    new_worker = tmap(lambda w, s: (1.0 - alpha) * w + alpha * s,
                      worker, server)
    return new_server, new_worker


def asgd_pair_sync(server: Any, worker: Any, prev: Any, alpha: float):
    """Delta push + model pull; returns (server, worker, prev) — the
    latter two both equal the post-update server model."""
    new_server = tmap(lambda s, w, p: s + alpha * (w - p),
                      server, worker, prev)
    return new_server, new_server, new_server


def masgd_pair_sync(server: Any, worker: Any, prev: Any, diff: Any,
                    momentum: float):
    """ASGD with a server-side momentum filter on the pushed delta."""
    new_diff = tmap(lambda d, w, p: momentum * d + (w - p),
                    diff, worker, prev)
    new_server = tmap(lambda s, d: s + d, server, new_diff)
    return new_server, new_server, new_server, new_diff


from functools import partial


@partial(jax.jit, static_argnames=("mode", "alpha", "momentum", "local"))
def _sync_round_impl(server, workers, prev, diffs, order, *,
                     mode: str, alpha: float, momentum: float,
                     local: bool):
    """Jitted core of :func:`ps_sync_round`.  State rides as ARGUMENTS,
    never as scan-body closure constants: an eager ``lax.scan`` whose
    body closes over concrete arrays bakes them into the jaxpr as
    literals, so every call compiles a fresh program — a sync round per
    training round leaked one LLVM JIT compilation each until the
    process died of code-arena exhaustion (observed on the 8-device CPU
    mesh after a few hundred rounds)."""
    if mode == "easgd":
        def body(server, idx):
            worker = tmap(lambda v: v[idx], workers)
            new_server, new_worker = easgd_pair_sync(
                server, worker, alpha)
            return new_server, (idx, new_worker)

        server, (idxs, rows) = jax.lax.scan(body, server, order)
        new_workers = tmap(lambda ws, r: ws.at[idxs].set(r),
                           workers, rows)
        return server, new_workers, None, None

    if mode == "asgd":
        def body(server, idx):
            worker = tmap(lambda v: v[idx], workers)
            pv = tmap(lambda v: v[idx], prev)
            server, new_worker, new_prev = asgd_pair_sync(
                server, worker, pv, alpha)
            return server, (idx, new_worker, new_prev)

        server, (idxs, rows, prows) = jax.lax.scan(body, server, order)
        new_workers = tmap(lambda ws, r: ws.at[idxs].set(r),
                           workers, rows)
        new_prev = tmap(lambda ws, r: ws.at[idxs].set(r), prev, prows)
        return server, new_workers, new_prev, None

    if mode == "masgd":
        def body(carry, idx):
            server, gdiff = carry
            worker = tmap(lambda v: v[idx], workers)
            pv = tmap(lambda v: v[idx], prev)
            diff = (tmap(lambda v: v[idx], diffs) if local else gdiff)
            server, new_worker, new_prev, new_diff = masgd_pair_sync(
                server, worker, pv, diff, momentum)
            out_diff = new_diff if local else None
            return (server, new_diff if not local else gdiff), \
                (idx, new_worker, new_prev, out_diff)

        gdiff0 = diffs if not local else tmap(
            lambda v: jnp.zeros_like(v[0]), diffs)
        (server, gdiff), (idxs, rows, prows, drows) = jax.lax.scan(
            body, (server, gdiff0), order)
        new_workers = tmap(lambda ws, r: ws.at[idxs].set(r),
                           workers, rows)
        new_prev = tmap(lambda ws, r: ws.at[idxs].set(r), prev, prows)
        new_diffs = (tmap(lambda ws, r: ws.at[idxs].set(r),
                          diffs, drows) if local else gdiff)
        return server, new_workers, new_prev, new_diffs

    raise ValueError(f"unknown ps mode {mode!r}")


def ps_sync_round(state: PsState, order: Optional[Any] = None) -> PsState:
    """One full round of sequential worker→server syncs.

    ``order``: [W] int32 arrival order (default 0..W-1 round-robin).
    The core is one cached jit (_sync_round_impl); worker rows are
    gathered/updated by index so any permutation schedule is
    expressible (stragglers, reversed arrivals, ...)."""
    opts = state.opts
    W = state.num_workers
    if order is None:
        order = jnp.arange(W, dtype=jnp.int32)
    else:
        order = jnp.asarray(order, jnp.int32)

    server, workers, prev, diffs = _sync_round_impl(
        state.server, state.workers, state.prev, state.diffs, order,
        mode=opts.mode, alpha=opts.alpha,
        momentum=opts.masgd_momentum,
        local=opts.masgd_type == "local")
    new = PsState.__new__(PsState)
    new.opts, new.num_workers = opts, W
    new.server = server
    new.workers = workers
    new.prev = prev
    new.diffs = diffs
    return new


def make_ps_round_step(
    loss_fn: Callable,
    update_fn: Callable,
    mesh,
    opts: Optional[PsOptions] = None,
    inner_steps: int = 1,
    axis: str = "worker",
    scan_batches: bool = False,
):
    """One PS round: ``inner_steps`` of LOCAL SGD per worker (no
    collectives — each worker trains its own model row on its own data
    shard) followed by the sequential server sync round.  The mesh image
    of the reference's worker loop: train --sync-period frames, then
    Synchronize() (easgd-worker.cc:37, driven by
    aslp-nnet-train-lstm-stream-worker.cc).

    loss_fn(params, batch) → (loss, aux); update_fn(params, grads,
    opt_state, lr) → (params, opt_state).

    Returns step(workers, opt_states, batch, lr) →
    (workers, opt_states, mean_loss): stacked [W, ...] trees in and
    out; call ``ps_sync_round`` on a PsState carrying the result (the
    sync is separate so callers control the arrival schedule).  With
    ``scan_batches`` each batch leaf has a leading [inner_steps] dim
    consumed one slice per local step."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    opts = opts or PsOptions()

    def local_train(workers, opt_states, batch, lr):
        # inside shard_map: each device sees its [1, ...] worker row
        p = tmap(lambda v: v[0], workers)
        opt = tmap(lambda v: v[0], opt_states)

        def one(carry, step_batch):
            p, opt = carry
            b = step_batch if scan_batches else batch

            def local_loss(pp):
                loss, aux = loss_fn(pp, b)
                return loss, aux

            (loss, _aux), grads = jax.value_and_grad(
                local_loss, has_aux=True)(p)
            p, opt = update_fn(p, grads, opt, lr)
            return (p, opt), loss

        (p, opt), losses = jax.lax.scan(
            one, (p, opt), batch if scan_batches else None,
            length=None if scan_batches else inner_steps)
        # [1] per-worker mean loss (rank >= 1 so out_specs can stack it)
        return (tmap(lambda v: v[None], p), tmap(lambda v: v[None], opt),
                jnp.mean(losses)[None])

    batch_spec = P(None, axis) if scan_batches else P(axis)
    step = shard_map(
        local_train,
        mesh=mesh,
        in_specs=(P(axis), P(axis), batch_spec, P()),
        out_specs=(P(axis), P(axis), P(axis)),
    )

    def full(workers, opt_states, batch, lr):
        workers, opt_states, losses = step(workers, opt_states, batch, lr)
        return workers, opt_states, jnp.mean(losses)

    return jax.jit(full)


def stack_worker_states(tree: Any, num_workers: int) -> Any:
    """Replicate a pytree with a leading worker dimension."""
    return tmap(lambda v: jnp.broadcast_to(
        jnp.asarray(v), (num_workers,) + jnp.asarray(v).shape), tree)
