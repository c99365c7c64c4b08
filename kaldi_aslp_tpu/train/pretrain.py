"""Layer-wise discriminative pretraining.

JAX-native equivalent of the reference's pretraining chain (reference:
aslp_scripts/aslp_nnet/pretrain.sh — grow the net one hidden layer per
epoch via ``aslp-nnet-init hidden.conf - | aslp-nnet-insert``; component
insertion + next-affine re-randomization in
src/aslp-nnetbin/aslp-nnet-insert.cc:14-49 ``InsertComponents`` /
``IndexOfLastUpdatableComponent`` and the ``--randomize-next-component``
block at :125-155, stddev = stddev_factor / sqrt(input_dim)).

Shapes stay static per depth: each growth step builds a fresh ``Nnet``
and re-jits, so XLA compiles once per depth — the pretrain loop is a
handful of compilations, not per-minibatch retraces.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.models.nnet import Nnet


def last_updatable_index(net: Nnet) -> int:
    """Index of the last updatable component (reference:
    aslp-nnet-insert.cc:14 IndexOfLastUpdatableComponent)."""
    idx = -1
    for i, node in enumerate(net.nodes):
        if getattr(node.comp, "updatable", False):
            idx = i
    return idx


def _require_chain(net: Nnet, what: str) -> None:
    for i, node in enumerate(net.nodes):
        want = [("in:0", 0)] if i == 0 else [(i - 1, 0)]
        if [tuple(e) for e in node.inputs] != want:
            raise ValueError(
                f"{what} is not a simple chain (MIMO/branching graph)")


def insert_components(
    base: Nnet,
    base_params: Dict,
    ins: Nnet,
    ins_params: Dict,
    insert_at: int = -1,
    randomize_next: bool = True,
    stddev_factor: float = 0.1,
    key: Optional[jax.Array] = None,
) -> Tuple[Nnet, Dict]:
    """Insert ``ins``'s chain into ``base`` before component ``insert_at``
    (< 0 → before the last updatable component, the pretrain.sh growth
    position) and optionally re-randomize the next affine.

    Returns a fresh (net, params); inputs are not mutated."""
    _require_chain(base, "base net")
    _require_chain(ins, "insert net")
    if insert_at < 0:
        insert_at = last_updatable_index(base)
        if insert_at < 0:
            raise ValueError("base net has no updatable component")
    if not 0 <= insert_at <= len(base.nodes):
        raise ValueError(f"bad insert position {insert_at}")

    out = Nnet()
    params: Dict = {}
    order = (
        [("b", i) for i in range(insert_at)]
        + [("i", i) for i in range(len(ins.nodes))]
        + [("b", i) for i in range(insert_at, len(base.nodes))]
    )
    for which, i in order:
        net, p = (base, base_params) if which == "b" else (ins, ins_params)
        cid = out.add(net.nodes[i].comp)
        params[str(cid)] = p[str(i)]

    if randomize_next:
        nxt = insert_at + len(ins.nodes)
        comp = out.nodes[nxt].comp
        p = params[str(nxt)]
        if not (getattr(comp, "updatable", False)
                and "w" in p and "b" in p):
            raise ValueError(
                "--randomize-next-component: component after the insert "
                f"is not an updatable affine: {type(comp).__name__}")
        if key is None:
            key = jax.random.PRNGKey(0)
        kw, kb = jax.random.split(key)
        w = p["w"]
        stddev = stddev_factor / float(jnp.sqrt(w.shape[1]))
        params[str(nxt)] = {
            **p,
            "w": stddev * jax.random.normal(kw, w.shape, w.dtype),
            "b": stddev * jax.random.normal(kb, p["b"].shape,
                                            p["b"].dtype),
        }
    return out, params


def pretrain_layerwise(
    initial_net: Nnet,
    hidden_factory: Callable[[int], Nnet],
    num_hid: int,
    train_fn: Callable[[Nnet, Dict, int], Dict],
    key: Optional[jax.Array] = None,
    stddev_factor: float = 0.1,
) -> Tuple[Nnet, Dict]:
    """Grow-and-train loop of pretrain.sh:56-86.

    ``initial_net``: the 1-hidden-layer proto net (nnet.proto role).
    ``hidden_factory(depth)``: a fresh hidden block to splice in before
    the output layer when growing to ``depth`` hidden layers (the
    hidden.conf role; called with depth = 2..num_hid).
    ``train_fn(net, params, depth) -> params``: one pretrain epoch at a
    fixed learn rate (the script's inner ``$train_tool`` loop).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    key, k0 = jax.random.split(key)
    net = initial_net
    params = net.init(k0)
    params = train_fn(net, params, 1)
    for depth in range(2, num_hid + 1):
        key, k_init, k_rand = jax.random.split(key, 3)
        hidden = hidden_factory(depth)
        hidden_params = hidden.init(k_init)
        net, params = insert_components(
            net, params, hidden, hidden_params,
            insert_at=-1, randomize_next=True,
            stddev_factor=stddev_factor, key=k_rand,
        )
        params = train_fn(net, params, depth)
    return net, params
