"""The GPU CTC kernels (ops/ctc_pallas.py) against the lax.scan recursions
(op-equivalence pattern of SURVEY.md §4).

On the CPU the kernels run in Pallas's interpret mode; the tests marked
``gpu`` compile them for the card and are run by chip_smoke.py."""

from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from kaldi_aslp_tpu.ops import ctc
from kaldi_aslp_tpu.ops.ctc import (
    NEG_INF,
    alpha_beta_scan,
    ctc_alpha_beta,
    ctc_inputs,
    ctc_loss,
)
from kaldi_aslp_tpu.ops.ctc_pallas import _next_pow2, ctc_alpha_beta_pallas
from kaldi_aslp_tpu.parallel.mesh import make_mesh

interpreted = partial(ctc_alpha_beta_pallas, interpret=True)


def _case(name):
    """(logits, labels, input lengths, label lengths)."""
    rs = np.random.RandomState(sum(map(ord, name)))
    S, T, V, U = {
        "ragged": (4, 18, 9, 5),
        "zero_length_label": (3, 9, 6, 3),
        "repeated_labels": (3, 16, 5, 6),
        "width_not_pow2": (2, 12, 8, 6),
        "full_lengths": (5, 14, 7, 6),
        "tight_fit": (2, 6, 5, 3),
        "single_frame": (3, 1, 6, 2),
    }[name]
    logits = rs.randn(S, T, V).astype(np.float32)
    labels = rs.randint(1, V, (S, U)).astype(np.int32)
    in_lens = np.asarray([T] + list(rs.randint(T // 2, T + 1, S - 1)),
                         np.int32)
    lab_lens = np.asarray([U] + list(rs.randint(0, U + 1, S - 1)),
                          np.int32)
    if name == "ragged":
        in_lens, lab_lens = np.int32([18, 14, 11, 9]), np.int32([5, 4, 2, 1])
    if name == "zero_length_label":
        lab_lens = np.int32([3, 0, 0])
        in_lens = np.int32([9, 1, 5])
    if name == "repeated_labels":
        labels = np.int32([[3, 3, 3, 4, 4, 1], [2, 2, 1, 1, 2, 2],
                           [1, 2, 1, 2, 3, 3]])
        lab_lens = np.int32([6, 6, 4])
    if name == "full_lengths":
        in_lens, lab_lens = np.full(S, T, np.int32), np.full(S, U, np.int32)
    if name == "single_frame":
        # one frame: blank or one label fits, two labels cannot
        in_lens, lab_lens = np.int32([1, 1, 1]), np.int32([0, 1, 2])
    if name == "tight_fit":
        # the shortest inputs that can emit the labels (a repeat needs
        # a blank between its copies)
        labels = np.int32([[1, 1, 2], [3, 4, 4]])
        lab_lens, in_lens = np.int32([3, 2]), np.int32([4, 2])
    return (jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(in_lens),
            jnp.asarray(lab_lens))


CASES = ["ragged", "zero_length_label", "repeated_labels",
         "width_not_pow2", "full_lengths", "tight_fit", "single_frame"]


def _assert_log_space_close(x, y, rtol, name):
    x, y = np.asarray(x), np.asarray(y)
    rx, ry = x > NEG_INF / 2, y > NEG_INF / 2
    assert (rx == ry).all(), f"{name}: reachability differs"
    np.testing.assert_array_equal(x[~rx], y[~ry], err_msg=name)
    np.testing.assert_allclose(x[rx], y[rx], rtol=rtol, atol=rtol,
                               err_msg=name)


def _compare_recursions(case, kernel, rtol):
    logits, labels, in_lens, lab_lens = _case(case)
    log_probs = jax.nn.log_softmax(logits, -1)
    lp_t, skip_ok, exp_lens, _, _ = ctc_inputs(log_probs, labels, lab_lens)
    a_ref, b_ref = alpha_beta_scan(lp_t, skip_ok, in_lens, exp_lens)
    a, b = kernel(lp_t, skip_ok, in_lens, exp_lens)
    assert a.shape == a_ref.shape and b.shape == b_ref.shape
    _assert_log_space_close(a, a_ref, rtol, "alpha")
    _assert_log_space_close(b, b_ref, rtol, "beta")
    nll_ref = ctc_alpha_beta(log_probs, labels, in_lens, lab_lens,
                             recursion=alpha_beta_scan)[0]
    nll = ctc_alpha_beta(log_probs, labels, in_lens, lab_lens,
                         recursion=kernel)[0]
    np.testing.assert_allclose(np.asarray(nll), np.asarray(nll_ref),
                               rtol=rtol)


def _compare_grads(case, kernel, rtol):
    logits, labels, in_lens, lab_lens = _case(case)

    def total(lg, rec):
        return ctc_loss(lg, labels, in_lens, lab_lens, 0, rec).sum()
    g_ref = jax.grad(total)(logits, alpha_beta_scan)
    g = jax.grad(total)(logits, kernel)
    assert np.isfinite(np.asarray(g)).all()
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=rtol, atol=rtol)


@pytest.mark.parametrize("case", CASES)
def test_interpreted_kernel_matches_scan(case):
    # interpret mode evaluates the same arithmetic as the scan: bit-equal
    _compare_recursions(case, interpreted, rtol=0.0)


@pytest.mark.parametrize("case", ["ragged", "repeated_labels",
                                  "single_frame"])
def test_interpreted_kernel_gradient_through_custom_vjp(case):
    _compare_grads(case, interpreted, rtol=1e-6)


@pytest.mark.parametrize("width,padded", [(1, 1), (3, 4), (81, 128),
                                          (601, 1024), (128, 128)])
def test_width_padding_is_next_power_of_two(width, padded):
    assert _next_pow2(width) == padded


def test_default_recursion_follows_backend(monkeypatch):
    for backend, want in (("gpu", ctc_alpha_beta_pallas),
                          ("cpu", alpha_beta_scan)):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        assert ctc.default_recursion() is want


def test_ctc_loss_takes_default_recursion(monkeypatch):
    logits, labels, in_lens, lab_lens = _case("ragged")
    calls = []

    def spy(*args):
        calls.append(args)
        return alpha_beta_scan(*args)
    monkeypatch.setattr(ctc, "default_recursion", lambda: spy)
    jax.grad(lambda lg: ctc_loss(lg, labels, in_lens, lab_lens).sum())(
        logits)
    assert len(calls) == 1


def _sharded_loss(recursion, check_vma):
    mesh = make_mesh(("data",), devices=jax.devices()[:2])

    def local(lg, lab, il, ll):
        loss = ctc_loss(lg, lab, il, ll, 0, recursion).mean()
        return jax.lax.pmean(loss, "data")
    return jax.jit(shard_map(
        jax.value_and_grad(local), mesh=mesh,
        in_specs=(P("data"),) * 4, out_specs=(P(), P("data")),
        check_vma=check_vma))


def test_kernel_traces_under_shard_map_with_vma_checks():
    logits, labels, in_lens, lab_lens = _case("ragged")
    jaxpr = jax.make_jaxpr(_sharded_loss(interpreted, True))(
        logits, labels, in_lens, lab_lens)
    assert "pallas_call" in str(jaxpr)


def test_interpreted_kernel_under_shard_map_matches_scan():
    # the interpreter evaluates kernel bodies without mesh-axis types,
    # so this numeric check runs with vma checks off (the compiled
    # kernel is checked with them on in the gpu test below)
    args = _case("ragged")
    loss_ref, g_ref = _sharded_loss(alpha_beta_scan, False)(*args)
    loss, g = _sharded_loss(interpreted, False)(*args)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-6, atol=1e-6)


# ---- compiled for the card ------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_compiled_kernel_matches_scan(gpu, case):
    _compare_recursions(case, ctc_alpha_beta_pallas, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "repeated_labels"])
def test_compiled_kernel_gradient(gpu, case):
    _compare_grads(case, ctc_alpha_beta_pallas, rtol=1e-5)


@pytest.mark.gpu
def test_compiled_kernel_under_shard_map(gpu):
    mesh = make_mesh(("data",), devices=jax.devices()[:1])
    args = _case("ragged")

    def run(rec):
        def local(lg, lab, il, ll):
            return jax.lax.pmean(
                ctc_loss(lg, lab, il, ll, 0, rec).mean(), "data")
        return jax.jit(shard_map(
            jax.value_and_grad(local), mesh=mesh,
            in_specs=(P("data"),) * 4, out_specs=(P(), P("data"))))(*args)
    loss_ref, g_ref = run(alpha_beta_scan)
    loss, g = run(ctc_alpha_beta_pallas)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-5)
