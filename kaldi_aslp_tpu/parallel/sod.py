"""SOD (sum-of-delta) outer training with a pluggable server optimizer.

JAX-native equivalent of the reference's SOD worker/server pair
(reference: src/aslp-parallel/sod-worker.cc:37 + optimizer.h — workers
push parameter deltas, the server applies them through SGD/Momentum/
AdaGrad/RMSprop/AdaDelta/Adam).

Here the "server" is just the replicated update applied to the
block-averaged delta: delta = avg(w_local) − w_global is fed through an
optax transformation as if it were a gradient (sign-flipped)."""

from __future__ import annotations

from typing import Any, Tuple

import jax


class SodState:
    def __init__(self, params: Any,
                 optimizer: "optax.GradientTransformation"):
        self.w_global = params
        self.optimizer = optimizer
        self.opt_state = optimizer.init(params)


def sod_sync(state: SodState, block_avg_params: Any) -> Tuple[Any, "SodState"]:
    """One synchronization: treat −delta as the gradient
    (reference: sod-worker.cc Synchronize + server optimizer update)."""
    neg_delta = jax.tree_util.tree_map(
        lambda g, w: w - g, block_avg_params, state.w_global
    )
    import optax  # only the server-optimizer strategies need it

    updates, state.opt_state = state.optimizer.update(
        neg_delta, state.opt_state, state.w_global
    )
    state.w_global = optax.apply_updates(state.w_global, updates)
    return state.w_global, state


def model_average_sync(params_list) -> Any:
    """Plain BSP model averaging over worker copies
    (reference: bsp-worker.cc:33 — params/num_workers allreduce);
    host-level helper for sync_period-style experiments."""
    n = len(params_list)
    return jax.tree_util.tree_map(
        lambda *xs: sum(xs) / n, *params_list
    )
