"""Per-component SGD with momentum / L1 / L2 / lr-coefs / max-norm.

JAX-native equivalent of the reference's in-component update rule
(reference: src/aslp-nnet/nnet-trnopts.h NnetTrainOptions —
learn_rate/momentum/l1_penalty/l2_penalty; per-component
learn_rate_coef / bias_learn_rate_coef and max_norm applied inside
AffineTransform::Update, nnet-affine-transform.h).

Implemented as a pure (params, grads, velocity) → (params, velocity)
update so it lives inside the jitted train step."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.utils.config import Config
from kaldi_aslp_tpu.models.nnet import Nnet


@dataclasses.dataclass
class NnetTrainOptions(Config):
    learn_rate: float = 0.008
    momentum: float = 0.0
    l1_penalty: float = 0.0
    l2_penalty: float = 0.0


def init_velocity(params) -> Any:
    return jax.tree_util.tree_map(jnp.zeros_like, params)


def _leaf_coef(net: Nnet, cid: str, path) -> float:
    """lr multiplier for a param leaf: the component's lr_coefs() entry
    for the leaf's top-level name (nested subtrees — e.g. BLSTM fwd/bwd —
    inherit coef 1.0 unless the top name matches)."""
    comp = net.nodes[int(cid)].comp
    coefs = comp.lr_coefs() if hasattr(comp, "lr_coefs") else {}
    top = path[0].key if path else None
    return float(coefs.get(top, 1.0))


def make_sgd_update(net: Nnet, opts: NnetTrainOptions):
    """Returns update(params, grads, velocity, learn_rate) — pure, jittable.

    learn_rate is a traced scalar so newbob halving does not retrigger
    compilation."""

    def update(params, grads, velocity, learn_rate):
        new_params: Dict[str, Any] = {}
        new_vel: Dict[str, Any] = {}
        for cid, p in params.items():
            flat_p, treedef = jax.tree_util.tree_flatten_with_path(p)
            flat_g = jax.tree_util.tree_leaves(grads[cid])
            flat_v = jax.tree_util.tree_leaves(velocity[cid])
            out_p, out_v = [], []
            for (path, pl), gl, vl in zip(flat_p, flat_g, flat_v):
                coef = _leaf_coef(net, cid, path)
                if opts.l2_penalty != 0.0:
                    gl = gl + opts.l2_penalty * pl
                if opts.l1_penalty != 0.0:
                    gl = gl + opts.l1_penalty * jnp.sign(pl)
                v_new = opts.momentum * vl - learn_rate * coef * gl
                out_p.append(pl + v_new)
                out_v.append(v_new)
            np_ = jax.tree_util.tree_unflatten(treedef, out_p)
            nv_ = jax.tree_util.tree_unflatten(treedef, out_v)
            # max-norm column clipping (reference: AffineTransform max_norm)
            comp = net.nodes[int(cid)].comp
            mn = getattr(comp, "max_norm", 0.0)
            if mn and isinstance(np_, dict) and "w" in np_:
                w = np_["w"]
                norms = jnp.sqrt(
                    jnp.sum(w * w, axis=1, keepdims=True) + 1e-20
                )
                np_["w"] = jnp.where(norms > mn, w * (mn / norms), w)
            new_params[cid] = np_
            new_vel[cid] = nv_
        return new_params, new_vel

    return update
