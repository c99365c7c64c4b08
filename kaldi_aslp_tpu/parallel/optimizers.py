"""Server-side optimizer zoo (reference: src/aslp-parallel/optimizer.h:21-221
— SGD / Momentum / AdaGrad / RMSprop / AdaDelta / Adam + factory from
OptimizerOption).

Thin optax-backed factory: the reference uses these on the parameter
server for ASGD/MASGD/SOD; here they drive either the main trainer or the
outer (BMUF/SOD-style) update on aggregated deltas."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from kaldi_aslp_tpu.utils.config import Config


@dataclasses.dataclass
class OptimizerOptions(Config):
    optimizer: str = "sgd"  # sgd|momentum|adagrad|rmsprop|adadelta|adam
    learn_rate: float = 0.008
    momentum: float = 0.9
    rho: float = 0.95      # adadelta / rmsprop decay
    epsilon: float = 1e-8
    beta1: float = 0.9
    beta2: float = 0.999


def make_optimizer(opts: OptimizerOptions
                   ) -> "optax.GradientTransformation":
    """Factory (reference: optimizer.h Optimizer::GetInstance).  optax is
    imported here, so the BSP/BMUF training path needs only JAX."""
    import optax

    name = opts.optimizer.lower()
    lr = opts.learn_rate
    if name == "sgd":
        return optax.sgd(lr)
    if name == "momentum":
        return optax.sgd(lr, momentum=opts.momentum)
    if name == "adagrad":
        return optax.adagrad(lr, eps=opts.epsilon)
    if name == "rmsprop":
        return optax.rmsprop(lr, decay=opts.rho, eps=opts.epsilon)
    if name == "adadelta":
        return optax.adadelta(lr, rho=opts.rho, eps=opts.epsilon)
    if name == "adam":
        return optax.adam(lr, b1=opts.beta1, b2=opts.beta2,
                          eps=opts.epsilon)
    raise ValueError(f"unknown optimizer {opts.optimizer!r}")
