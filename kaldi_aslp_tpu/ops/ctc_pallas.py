"""CTC alpha/beta recursions as GPU kernels (Pallas, Triton route).

Replaces (reference) the per-timestep CUDA kernel launches of
cuda_compute_ctc_alpha/beta (src/aslp-cudamatrix/cu-kernels.h:502-517,
dispatched from ctc-loss.cc:115 EvalParallel).  The layout is warp-ctc's:
each program owns one stream and runs the whole time loop inside the
kernel, so the 2·T serial steps of a batch cost one launch instead of
one loop iteration (and its kernels) per step; a second grid axis runs
the alpha and beta recursions of a stream side by side.  One stream per
program beat two and four at both the flagship shape and T=3000 (PERF.md).

Per program: the [1, U'] row of the recursion lives in registers; each
step's row is written to the [T, S, U'] output the custom VJP in
ops/ctc.py consumes, and the shift by 1 and by 2 along U' is a masked
reload of the row just stored (a block barrier separates the store from
the reload).  The step arithmetic is ops/ctc.py's scan step, term for
term, so both give the same alphas and betas.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from kaldi_aslp_tpu.ops.ctc import NEG_INF, _lse3, _shift_left


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _num_warps(width: int) -> int:
    """One warp per 256 row elements, 1 to 8: the row is a handful of
    registers per thread, and fewer warps make the per-step barrier
    cheaper."""
    return max(1, min(8, width // 256))


def _shifted(out_ref, t, rows, u, k, width, extra_mask=None):
    """out[t, rows, u + k] where 0 <= u + k < width, else NEG_INF."""
    src = u + k
    mask = (src >= 0) & (src < width)
    if extra_mask is not None:
        mask = mask & extra_mask
    src = jnp.clip(src, 0, out_ref.shape[-1] - 1)
    mask = jnp.broadcast_to(mask, (rows.shape[0], u.shape[1]))
    return plgpu.load(out_ref.at[t, rows, src], mask=mask, other=NEG_INF)


def _barrier(interpret):
    """Block barrier between a row's store and its reload (the interpreter
    runs the block's lanes in order and has no barrier to lower)."""
    if not interpret:
        plgpu.debug_barrier()


def _alpha(in_len_ref, lp_ref, skip_ref, out_ref, width, interpret):
    T = lp_ref.shape[0]
    G, Up = skip_ref.shape
    rows = jnp.arange(G)[:, None]
    u = jnp.arange(Up)[None, :]
    in_len = in_len_ref[...][:, None]
    skip = skip_ref[...] > 0

    alpha0 = jnp.where(u < 2, lp_ref[0], NEG_INF)
    out_ref[0] = alpha0
    _barrier(interpret)

    def step(t, prev):
        cand = _lse3(
            prev,
            _shifted(out_ref, t - 1, rows, u, -1, width),
            _shifted(out_ref, t - 1, rows, u, -2, width, skip),
        ) + lp_ref[t]
        alpha = jnp.where(t < in_len, cand, prev)
        out_ref[t] = alpha
        _barrier(interpret)
        return alpha

    jax.lax.fori_loop(1, T, step, alpha0)


def _beta(in_len_ref, exp_len_ref, lp_ref, skip2_ref, out_ref, width,
          interpret):
    T = lp_ref.shape[0]
    G, Up = skip2_ref.shape
    rows = jnp.arange(G)[:, None]
    u = jnp.arange(Up)[None, :]
    in_len = in_len_ref[...][:, None]
    exp_len = exp_len_ref[...][:, None]
    skip2 = skip2_ref[...] > 0
    at_end = (u == exp_len - 1) | (u == exp_len - 2)

    def beta_at(t, nxt, nxt1, nxt2):
        lp_cur = lp_ref[t]
        cand = _lse3(nxt, nxt1, nxt2) + lp_cur
        init = jnp.where(at_end, lp_cur, NEG_INF)
        beta = jnp.where(t == in_len - 1, init,
                         jnp.where(t < in_len - 1, cand, nxt))
        out_ref[t] = beta
        _barrier(interpret)
        return beta

    none = jnp.full((G, Up), NEG_INF, jnp.float32)
    beta_last = beta_at(T - 1, none, none, none)

    def step(i, nxt):
        t = T - 2 - i
        return beta_at(
            t, nxt,
            _shifted(out_ref, t + 1, rows, u, 1, width),
            _shifted(out_ref, t + 1, rows, u, 2, width, skip2),
        )

    jax.lax.fori_loop(0, T - 1, step, beta_last)


def _kernel(in_len_ref, exp_len_ref, lp_ref, skip_ref, skip2_ref,
            alpha_ref, beta_ref, *, width, interpret):
    """Grid (streams, 2): the second grid axis picks the direction, so a
    stream's alpha and beta recursions run at the same time on different
    SMs."""
    @pl.when(pl.program_id(1) == 0)
    def _():
        _alpha(in_len_ref, lp_ref, skip_ref, alpha_ref, width, interpret)

    @pl.when(pl.program_id(1) == 1)
    def _():
        _beta(in_len_ref, exp_len_ref, lp_ref, skip2_ref, beta_ref, width,
              interpret)


@partial(jax.jit, static_argnames=("interpret",))
def ctc_alpha_beta_pallas(
    lp_t: jnp.ndarray,           # [T, S, U'] emission scores (NEG_INF masked)
    skip_ok: jnp.ndarray,        # [S, U'] skip-transition mask
    input_lengths: jnp.ndarray,  # [S]
    exp_lens: jnp.ndarray,       # [S] expanded label lengths (2U+1)
    interpret: bool = False,
):
    """Returns (alphas [T, S, U'], betas [T, S, U']), equal to
    ops/ctc.py ``alpha_beta_scan`` on the same arguments.  U' is padded
    to a power of two."""
    T, S, width = lp_t.shape
    Up = _next_pow2(width)
    pad_u = Up - width
    input_lengths = input_lengths.astype(jnp.int32)
    exp_lens = exp_lens.astype(jnp.int32)
    skip2 = _shift_left(skip_ok, 2)
    if pad_u:
        lp_t = jnp.pad(lp_t, ((0, 0), (0, 0), (0, pad_u)),
                       constant_values=NEG_INF)
        skip_ok = jnp.pad(skip_ok, ((0, 0), (0, pad_u)))
        skip2 = jnp.pad(skip2, ((0, 0), (0, pad_u)))

    rows = pl.BlockSpec((1,), lambda i, d: (i,))
    row_block = pl.BlockSpec((1, Up), lambda i, d: (i, 0))
    time_block = pl.BlockSpec((T, 1, Up), lambda i, d: (0, i, 0))
    # under shard_map the rows vary over the same mesh axes as lp_t
    out = jax.ShapeDtypeStruct((T, S, Up), jnp.float32,
                               vma=jax.typeof(lp_t).vma)
    alphas, betas = pl.pallas_call(
        partial(_kernel, width=width, interpret=interpret),
        grid=(S, 2),
        in_specs=[rows, rows, time_block, row_block, row_block],
        out_specs=[time_block, time_block],
        out_shape=[out, out],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(Up), num_stages=1),
        interpret=interpret,
        name="ctc_alpha_beta",
    )(input_lengths, exp_lens, lp_t, skip_ok, skip2)
    return alphas[..., :width], betas[..., :width]
