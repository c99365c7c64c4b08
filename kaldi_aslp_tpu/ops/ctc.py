"""Batched CTC loss: log-space alpha-beta over expanded label sequences.

JAX equivalent of the reference's Eesen-style CTC (reference:
src/aslp-nnet/ctc-loss.cc:115 EvalParallel — label expansion with
interleaved blanks at :134-149, per-timestep alpha/beta GPU kernels via
CuMatrixBase::ComputeCtcAlpha/Beta/ErrorMSeq cu-matrix.h:355-394, log-space
helpers ctc-utils.h:29-60; also the warp-ctc wrapper warp-ctc.cc:48).

Design differences from the reference (deliberate):
  - each recursion computes ALL sequences' alpha (beta) in lockstep on
    [S, U'] rows (the reference launches one CUDA kernel per timestep):
    on the GPU as one Pallas kernel with the time loop inside
    (ops/ctc_pallas.py), elsewhere as one ``lax.scan`` per direction;
  - gradients come from a custom VJP using the standard occupancy formula
    dL/dlogit = softmax(logit) − γ, so the backward pass is a cheap
    reverse scan + one scatter instead of autodiff through the forward;
  - everything is static-shape: labels are padded to U_max and sequences
    to T_max with explicit length vectors, so the kernel compiles once
    per bucket shape.

Blank id = 0, matching the reference's CTC label convention
(aslp-bin/aslp-ali-minus-one shifts labels so blank is 0).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def expand_labels(labels: jnp.ndarray, blank: int = 0) -> jnp.ndarray:
    """[S, U] → [S, 2U+1] with blanks interleaved
    (reference: ctc-loss.cc:134-149)."""
    S, U = labels.shape
    exp = jnp.full((S, 2 * U + 1), blank, labels.dtype)
    return exp.at[:, 1::2].set(labels)


def _transition_mask(exp_labels: jnp.ndarray, blank: int) -> jnp.ndarray:
    """[S, U'] mask: 1 where the skip transition u-2 → u is allowed
    (l'_u != blank and l'_u != l'_{u-2})."""
    lp = exp_labels
    prev2 = jnp.concatenate(
        [jnp.full_like(lp[:, :2], -1), lp[:, :-2]], axis=1
    )
    return ((lp != blank) & (lp != prev2)).astype(jnp.float32)


def _shift_right(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Shift along the label axis, filling with -inf."""
    pad = jnp.full(x.shape[:-1] + (k,), NEG_INF, x.dtype)
    return jnp.concatenate([pad, x[..., :-k]], axis=-1)


def _shift_left(x: jnp.ndarray, k: int) -> jnp.ndarray:
    pad = jnp.full(x.shape[:-1] + (k,), NEG_INF, x.dtype)
    return jnp.concatenate([x[..., k:], pad], axis=-1)


def _lse3(a, b, c):
    m = jnp.maximum(jnp.maximum(a, b), c)
    m_safe = jnp.maximum(m, NEG_INF)
    return m_safe + jnp.log(
        jnp.exp(a - m_safe) + jnp.exp(b - m_safe) + jnp.exp(c - m_safe)
    )


def ctc_inputs(log_probs, labels, label_lengths, blank: int = 0):
    """The recursions' inputs: (lp_t [T, S, U'] per-frame emission scores
    of the expanded labels, NEG_INF past each sequence's 2U+1; skip_ok
    [S, U']; exp_lens [S]; exp_labels [S, U']; valid_u [S, U'])."""
    exp_labels = expand_labels(labels, blank)        # [S, U']
    Up = exp_labels.shape[1]
    exp_lens = 2 * label_lengths + 1                 # [S]
    skip_ok = _transition_mask(exp_labels, blank)    # [S, U']
    u_idx = jnp.arange(Up)[None, :]
    valid_u = (u_idx < exp_lens[:, None]).astype(jnp.float32)
    # per-frame label emission scores: lp[s, t, u] = log_probs[s, t, l'_u]
    lp = jnp.take_along_axis(log_probs, exp_labels[:, None, :], axis=2)
    lp = jnp.where(valid_u[:, None, :] > 0, lp, NEG_INF)
    return jnp.swapaxes(lp, 0, 1), skip_ok, exp_lens, exp_labels, valid_u


def alpha_beta_scan(lp_t, skip_ok, input_lengths, exp_lens):
    """The plain recursions: two ``lax.scan`` over time.  Returns
    (alphas [T, S, U'], betas [T, S, U']); alpha is held after each
    sequence's last frame, beta is NEG_INF after it."""
    T, S, Up = lp_t.shape
    u_idx = jnp.arange(Up)[None, :]
    t_range = jnp.arange(T)

    # ---- forward ----------------------------------------------------------
    alpha0 = jnp.where(u_idx < 2, lp_t[0], NEG_INF)

    def fwd_step(alpha_prev, inp):
        lp_cur, t = inp
        cand = _lse3(
            alpha_prev,
            _shift_right(alpha_prev, 1),
            jnp.where(skip_ok > 0, _shift_right(alpha_prev, 2), NEG_INF),
        ) + lp_cur
        active = (t < input_lengths)[:, None]
        alpha = jnp.where(active, cand, alpha_prev)
        return alpha, alpha

    # unroll: each step's work is tiny ([S, U'] elementwise), so the loop
    # overhead dominates; unrolling amortizes it
    _, alphas = jax.lax.scan(fwd_step, alpha0, (lp_t[1:], t_range[1:]),
                             unroll=8)
    alphas = jnp.concatenate([alpha0[None], alphas], axis=0)  # [T, S, U']

    # ---- backward ---------------------------------------------------------
    skip2 = _shift_left(skip_ok, 2) > 0
    at_end = ((u_idx == exp_lens[:, None] - 1)
              | (u_idx == exp_lens[:, None] - 2))

    def bwd_step(beta_next, inp):
        lp_cur, t = inp
        cand = _lse3(
            beta_next,
            _shift_left(beta_next, 1),
            jnp.where(skip2, _shift_left(beta_next, 2), NEG_INF),
        ) + lp_cur
        # initialize at the last active frame of each sequence
        is_last = (t == input_lengths - 1)[:, None]
        init = jnp.where(at_end, lp_cur, NEG_INF)
        beta = jnp.where(is_last, init,
                         jnp.where((t < input_lengths - 1)[:, None],
                                   cand, beta_next))
        return beta, beta

    # a zero that carries the batch's varying mesh axes, so the scan carry
    # typechecks under shard_map (numerically a no-op)
    beta_init = jnp.full((S, Up), NEG_INF) + jnp.zeros_like(lp_t[0])
    _, betas_rev = jax.lax.scan(
        bwd_step, beta_init, (lp_t[::-1], t_range[::-1]), unroll=8
    )
    return alphas, betas_rev[::-1]


def default_recursion():
    """The alpha/beta implementation for the default backend: the Pallas
    kernel on the GPU, the scan elsewhere."""
    if jax.default_backend() == "gpu":
        from kaldi_aslp_tpu.ops.ctc_pallas import ctc_alpha_beta_pallas
        return ctc_alpha_beta_pallas
    return alpha_beta_scan


def ctc_alpha_beta(
    log_probs: jnp.ndarray,     # [S, T, V] log-softmax outputs
    labels: jnp.ndarray,        # [S, U] padded with anything (use lengths)
    input_lengths: jnp.ndarray,  # [S]
    label_lengths: jnp.ndarray,  # [S]
    blank: int = 0,
    recursion=None,
):
    """Returns (neg_log_p [S], alpha [T, S, U'], beta [T, S, U'], lp_t,
    exp_labels, valid_u).  ``recursion`` is ``alpha_beta_scan``, the
    Pallas kernel, or None for ``default_recursion()``."""
    S, T, V = log_probs.shape
    lp_t, skip_ok, exp_lens, exp_labels, valid_u = ctc_inputs(
        log_probs, labels, label_lengths, blank)
    recursion = recursion or default_recursion()
    alphas, betas = recursion(lp_t, skip_ok, input_lengths, exp_lens)

    # ---- log likelihood ---------------------------------------------------
    u_idx = jnp.arange(lp_t.shape[2])[None, :]
    last_t = jnp.clip(input_lengths - 1, 0, T - 1)
    alpha_last = alphas[last_t, jnp.arange(S)]  # [S, U']
    at_end = jnp.where(
        (u_idx == exp_lens[:, None] - 1) | (u_idx == exp_lens[:, None] - 2),
        alpha_last, NEG_INF,
    )
    log_p = jax.nn.logsumexp(at_end, axis=1)
    return -log_p, alphas, betas, lp_t, exp_labels, valid_u


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def ctc_loss(logits, labels, input_lengths, label_lengths, blank=0,
             recursion=None):
    """Per-sequence CTC negative log-likelihood.

    logits: [S, T, V] raw network outputs (softmax applied internally,
    mirroring how the reference trainer feeds pre-softmax activations to
    Ctc::EvalParallel with the softmax folded into the gradient).
    ``recursion``: see ``ctc_alpha_beta``.
    """
    loss, _ = _ctc_fwd(logits, labels, input_lengths, label_lengths, blank,
                       recursion)
    return loss


def _ctc_fwd(logits, labels, input_lengths, label_lengths, blank,
             recursion):
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    nll, alphas, betas, lp_t, exp_labels, valid_u = ctc_alpha_beta(
        log_probs, labels, input_lengths, label_lengths, blank, recursion
    )
    residuals = (log_probs, alphas, betas, lp_t, exp_labels, valid_u,
                 input_lengths, nll)
    return nll, residuals


def _ctc_bwd(blank, recursion, residuals, g):
    (log_probs, alphas, betas, lp_t, exp_labels, valid_u,
     input_lengths, nll) = residuals
    S, T, V = log_probs.shape
    # occupancy γ_t(u) = exp(alpha + beta - lp - logp)
    logp = -nll  # [S]
    occ = alphas + betas - lp_t  # [T, S, U'] (still + logp to remove)
    occ = occ - logp[None, :, None]
    occ = jnp.where(valid_u[None] > 0, occ, NEG_INF)
    gamma_u = jnp.exp(jnp.swapaxes(occ, 0, 1))  # [S, T, U']
    # fold label occupancies into vocab: gamma[s,t,v] = Σ_{u: l'_u=v} γ[s,t,u].
    # Expressed as a one-hot batched matmul rather than a scatter-add, so
    # no scatter serializes on colliding labels.  Invalid/padded u rows
    # carry γ=0 so they contribute nothing regardless of their one-hot.
    one_hot = jax.nn.one_hot(exp_labels, V, dtype=log_probs.dtype)  # [S,U',V]
    gamma_v = jnp.einsum(
        "stu,suv->stv", gamma_u, one_hot,
        precision=jax.lax.Precision.HIGHEST,
    )
    y = jnp.exp(log_probs)
    grad = y - gamma_v  # d(-logp)/d logits
    t_mask = (jnp.arange(T)[None, :] < input_lengths[:, None])
    grad = grad * t_mask[:, :, None]
    grad = grad * g[:, None, None]
    return grad, None, None, None


ctc_loss.defvjp(_ctc_fwd, _ctc_bwd)


def ctc_greedy_decode(logits: jnp.ndarray, input_lengths, blank: int = 0):
    """Best-path collapse (reference: ctc-loss.cc:346 ErrorRate path).

    Returns [S, T] argmax frames; host code collapses repeats/blanks."""
    return jnp.argmax(logits, axis=-1)


def collapse_ctc_path(path, length, blank: int = 0):
    """Host-side: remove repeats then blanks (numpy/list)."""
    out = []
    prev = None
    for v in list(path)[: int(length)]:
        v = int(v)
        if v != prev and v != blank:
            out.append(v)
        prev = v
    return out
