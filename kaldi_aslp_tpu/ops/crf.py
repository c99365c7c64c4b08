"""Linear-chain CRF: forward-backward training + Viterbi tagging.

JAX-native replacement for the reference's CRF++ dependency
(reference: src/aslp-online/punctuation-processor.{h,cc} wraps
CRFPP::Tagger, gated by HAVE_CRF in src/aslp.mk:9-12).  Instead of
binding the C++ CRF++ library, the model is ~80 lines of JAX: hashed
window features → emission scores, a [Y, Y] transition matrix, exact
log-likelihood via a `lax.scan` forward recursion (so training is just
`jax.grad`), and Viterbi decoding as a second scan.  Sequences are
bucketed and masked like every other variable-length path in the
framework."""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

NEG = -1e30


@dataclasses.dataclass
class CrfParams:
    emission: jnp.ndarray    # [F, Y] hashed-feature weights
    transition: jnp.ndarray  # [Y, Y] from → to
    start: jnp.ndarray       # [Y]
    end: jnp.ndarray         # [Y]


def init_crf(num_features: int, num_tags: int,
             key: Optional[jax.Array] = None) -> CrfParams:
    key = key if key is not None else jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    return CrfParams(
        emission=0.01 * jax.random.normal(
            k1, (num_features, num_tags), jnp.float32),
        transition=0.01 * jax.random.normal(
            k2, (num_tags, num_tags), jnp.float32),
        start=jnp.zeros(num_tags, jnp.float32),
        end=jnp.zeros(num_tags, jnp.float32),
    )


jax.tree_util.register_pytree_node(
    CrfParams,
    lambda p: ((p.emission, p.transition, p.start, p.end), None),
    lambda _, c: CrfParams(*c),
)


def _emissions(params: CrfParams, feat_ids: jnp.ndarray) -> jnp.ndarray:
    """[T, K] hashed feature ids (−1 = absent) → [T, Y] scores."""
    w = params.emission[jnp.maximum(feat_ids, 0)]        # [T, K, Y]
    w = jnp.where((feat_ids >= 0)[:, :, None], w, 0.0)
    return w.sum(axis=1)


@jax.jit
def crf_log_likelihood(params: CrfParams, feat_ids: jnp.ndarray,
                       tags: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Exact sequence log-likelihood (masked frames are no-ops)."""
    em = _emissions(params, feat_ids)                     # [T, Y]
    T, Y = em.shape

    # score of the reference path
    tag_scores = em[jnp.arange(T), tags] * mask
    trans_scores = params.transition[tags[:-1], tags[1:]] \
        * mask[1:] * mask[:-1]
    path = (params.start[tags[0]] + tag_scores.sum()
            + trans_scores.sum())
    last = jnp.maximum(jnp.sum(mask).astype(jnp.int32) - 1, 0)
    path = path + params.end[tags[last]]

    # partition function
    def step(alpha, inp):
        em_t, m_t = inp
        new = jax.nn.logsumexp(
            alpha[:, None] + params.transition, axis=0) + em_t
        return jnp.where(m_t > 0, new, alpha), None

    alpha0 = params.start + em[0]
    alpha, _ = jax.lax.scan(step, alpha0, (em[1:], mask[1:]))
    logz = jax.nn.logsumexp(alpha + params.end)
    return path - logz


@jax.jit
def crf_viterbi(params: CrfParams, feat_ids: jnp.ndarray,
                mask: jnp.ndarray) -> jnp.ndarray:
    """Best tag sequence [T] (entries beyond the mask are arbitrary)."""
    em = _emissions(params, feat_ids)
    T, Y = em.shape

    def step(alpha, inp):
        em_t, m_t = inp
        scores = alpha[:, None] + params.transition    # [from, to]
        best = jnp.max(scores, axis=0) + em_t
        bp = jnp.argmax(scores, axis=0)
        new = jnp.where(m_t > 0, best, alpha)
        bp = jnp.where(m_t > 0, bp, jnp.arange(Y))
        return new, bp

    alpha0 = params.start + em[0]
    alpha, bps = jax.lax.scan(step, alpha0, (em[1:], mask[1:]))
    last_tag = jnp.argmax(alpha + params.end)

    def back(tag, bp):
        return bp[tag], bp[tag]

    _, rev = jax.lax.scan(back, last_tag, bps[::-1])
    return jnp.concatenate([rev[::-1], last_tag[None]])


def crf_train(
    corpus: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_features: int,
    num_tags: int,
    num_epochs: int = 30,
    learn_rate: float = 0.5,
    l2: float = 1e-4,
    bucket: int = 32,
    seed: int = 0,
) -> CrfParams:
    """Batched SGD on the exact negative log-likelihood.

    ``corpus``: list of (feat_ids [T, K] int32 with −1 padding,
    tags [T] int32)."""
    params = init_crf(num_features, num_tags, jax.random.PRNGKey(seed))

    @jax.jit
    def step(params, feat_ids, tags, mask, lr):
        def loss_fn(p):
            ll = crf_log_likelihood(p, feat_ids, tags, mask)
            reg = l2 * (jnp.sum(p.emission ** 2)
                        + jnp.sum(p.transition ** 2))
            return -ll + reg
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params = jax.tree_util.tree_map(
            lambda a, g: a - lr * g, params, grads)
        return params, loss

    rng = np.random.RandomState(seed)
    order = np.arange(len(corpus))
    for epoch in range(num_epochs):
        rng.shuffle(order)
        lr = learn_rate / (1.0 + 0.3 * epoch)
        for idx in order:
            feat_ids, tags = corpus[idx]
            T = len(tags)
            Tp = max(bucket, int(np.ceil(T / bucket)) * bucket)
            fi = np.full((Tp, feat_ids.shape[1]), -1, np.int32)
            fi[:T] = feat_ids
            tg = np.zeros(Tp, np.int32)
            tg[:T] = tags
            m = np.zeros(Tp, np.float32)
            m[:T] = 1.0
            params, _ = step(params, jnp.asarray(fi), jnp.asarray(tg),
                             jnp.asarray(m), jnp.float32(lr))
    return params


def crf_tag(params: CrfParams, feat_ids: np.ndarray,
            bucket: int = 32) -> np.ndarray:
    T = len(feat_ids)
    Tp = max(bucket, int(np.ceil(T / bucket)) * bucket)
    fi = np.full((Tp, feat_ids.shape[1]), -1, np.int32)
    fi[:T] = feat_ids
    m = np.zeros(Tp, np.float32)
    m[:T] = 1.0
    tags = crf_viterbi(params, jnp.asarray(fi), jnp.asarray(m))
    return np.asarray(tags)[:T]
