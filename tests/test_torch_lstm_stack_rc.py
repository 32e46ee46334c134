"""The port's recompute-backward LSTM stack — K10 (`_fwd_train_rc_ref`), K11
(`_bwd_rc_ref`) and the autograd wrapper `lstm_stack_rc` on the CPU — against
the JAX package's `lstm_stack_pallas_rc` in interpret mode. Tolerances as
tests/test_torch_lstm_stack_seq.py: f32 values atol 1e-5, gradients atol
2e-5 / rtol 2e-4, the bf16 forward atol 1e-2 (one bf16 ulp of an h below 1
is at most 2^-8; c, which can pass 1, is held relative to its ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_lstm_stack import (
    _fwd_train_rc_impl,
    _vjp_bwd_rc,
    lstm_stack_pallas_rc,
)
from cerebra_torch.models import lstm_stack as ls
from tests.test_torch_lstm_stack import make_case, to_jax, to_torch
from tests.test_torch_lstm_stack_seq import GRAD_TOL, assert_grads, port_grads

torch.set_num_threads(1)


def jax_residuals(outs, L):
    """`_fwd_train_rc_impl`'s [(h_all, c_all)] × L as the port's stacked
    (h_all, c_all), each (L, T, B, H)."""
    return tuple(torch.from_numpy(np.stack([np.asarray(outs[2 * l + k], np.float32)
                                            for l in range(L)])) for k in (0, 1))


@pytest.mark.parametrize("L", [1, 2, 3])
def test_train_streams_match_pallas(L):
    """K10's h_all and c_all (c rounded to the stream dtype) over a ragged
    batch of 5."""
    x, layers = make_case(T=7, L=L, seed=100 + L)
    want_h, want_c = jax_residuals(_fwd_train_rc_impl(*to_jax(x, layers)), L)
    got_h, got_c = ls._fwd_train_rc_ref(*to_torch(x, layers))
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), want_c.numpy(), atol=1e-5)


@pytest.mark.parametrize("L", [1, 2, 3])
def test_plain_backward_matches_pallas_vjp(L):
    """K11's plain version fed the Pallas forward's residuals against
    `_vjp_bwd_rc`: dx and every dW."""
    T, B, H = 6, 5, 4
    x, layers = make_case(T=T, L=L, seed=110 + L)
    g = np.random.default_rng(111).normal(size=(T, B, H)).astype(np.float32)
    xj, lj = to_jax(x, layers)
    outs = _fwd_train_rc_impl(xj, lj)
    want_dx, want_l = _vjp_bwd_rc((xj, lj, outs), jnp.asarray(g))
    xt, lt = to_torch(x, layers)
    dx, got_l = ls._bwd_rc_ref(torch.from_numpy(g), xt, lt, *jax_residuals(outs, L))
    assert_grads(dx, got_l, want_dx, want_l)


@pytest.mark.parametrize("L", [1, 2, 3])
def test_wrapper_matches_pallas_values_and_grads(L):
    """`lstm_stack_rc`'s values (K4's plain version without grad) and
    jax.grad of `lstm_stack_pallas_rc` in x and the layers."""
    x, layers = make_case(T=5, L=L, seed=120 + L)
    w_out = np.random.default_rng(L).normal(size=(5, 5, 4)).astype(np.float32)
    xj, lj = to_jax(x, layers)
    np.testing.assert_allclose(ls.lstm_stack_rc(*to_torch(x, layers)).numpy(),
                               np.asarray(lstm_stack_pallas_rc(xj, lj)), atol=1e-5)
    want_x, want_l = jax.grad(lambda x, l: jnp.sum(lstm_stack_pallas_rc(x, l) * w_out),
                              argnums=(0, 1))(xj, lj)
    assert_grads(*port_grads(ls.lstm_stack_rc, x, layers, w_out), want_x, want_l)


def test_matches_the_shipped_stack():
    """In f32 the recompute backward gives the shipped stack's (K1 + K2g)
    values and gradients: only rounding points differ, and f32 has none."""
    x, layers = make_case(T=8, B=6, C=5, H=6, L=2, seed=130)
    w_out = np.random.default_rng(131).normal(size=(8, 6, 6)).astype(np.float32)
    got_x, got_l = port_grads(ls.lstm_stack_rc, x, layers, w_out)
    want_x, want_l = port_grads(ls.lstm_stack, x, layers, w_out)
    np.testing.assert_allclose(got_x.numpy(), want_x.numpy(), **GRAD_TOL)
    for got, want in zip(got_l, want_l):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_x_without_grad_gets_none_and_the_same_weight_grads():
    """K11 always computes dx; an x that needs no gradient gets none, and the
    weights' gradients are those of an x that does."""
    x, layers = make_case(T=5, L=2, seed=140)
    w_out = np.random.default_rng(141).normal(size=(5, 5, 4)).astype(np.float32)
    _, with_x = port_grads(ls.lstm_stack_rc, x, layers, w_out)
    got_x, without_x = port_grads(ls.lstm_stack_rc, x, layers, w_out, x_grad=False)
    assert got_x is None
    for got, want in zip(without_x, with_x):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_forward_matches_pallas():
    """K10 in bf16: both round h and c at the same points; a flipped
    rounding moves an element by a bf16 ulp or two."""
    x, layers = make_case(L=2, seed=150)
    want_h, want_c = jax_residuals(_fwd_train_rc_impl(*to_jax(x, layers, jnp.bfloat16)), 2)
    got_h, got_c = ls._fwd_train_rc_ref(*to_torch(x, layers, torch.bfloat16))
    np.testing.assert_allclose(got_h.float().numpy(), want_h.numpy(), atol=1e-2)
    np.testing.assert_allclose(got_c.float().numpy(), want_c.numpy(), atol=1e-2, rtol=1e-2)


def assert_rel_frob(got, want, limit, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= limit, f"{what}: relative Frobenius error {rel:.3e} > {limit}"


# The bf16 backwards against the Pallas ones on the same bf16 residuals. Both
# sides sum in f32 and round at the same points, so they agree but for a rare
# sum that lands the other side of a bf16 rounding (none in these cases: they
# agree bit for bit). A rounding point moved shifts many elements by an ulp
# (2^-8); on dx these cases read 3.7e-3 with K11's q rounded to bf16 as K2
# stores it, 2.9e-3 with its f rounded, 2.2e-3 with its prefactors left
# unrounded, 2.0e-3 with K14's dc rounded before its carry and 6.2e-4 with
# K14's dh left unrounded.
BF16_BWD_REL = 2e-4


def test_bf16_backward_matches_pallas_vjp():
    """K11's plain version in bf16, fed the Pallas forward's bf16 residuals,
    against `_vjp_bwd_rc`: dx and every dW in bf16. K11's rounding points are
    its own, not K2's: q and f stay f32; the prefactors, dc and dh and their
    products are rounded."""
    T, B, C, H, L = 8, 8, 5, 8, 2
    x, layers = make_case(T=T, B=B, C=C, H=H, L=L, seed=171)
    g = np.random.default_rng(172).normal(size=(T, B, H)).astype(np.float32)
    xj, lj = to_jax(x, layers, jnp.bfloat16)
    outs = _fwd_train_rc_impl(xj, lj)
    want_dx, want_l = _vjp_bwd_rc((xj, lj, outs), jnp.asarray(g, jnp.bfloat16))
    res = (r.to(torch.bfloat16) for r in jax_residuals(outs, L))
    dx, got_l = ls._bwd_rc_ref(torch.from_numpy(g).to(torch.bfloat16),
                               *to_torch(x, layers, torch.bfloat16), *res)
    assert dx.dtype == torch.bfloat16
    assert_rel_frob(dx.float(), want_dx, BF16_BWD_REL, "dx")
    for l in range(L):
        for name, a, b in zip(("dW_ih", "dW_hh", "db"), got_l[l], want_l[l]):
            assert_rel_frob(a.to(torch.bfloat16).float(), b, BF16_BWD_REL, f"{name}[{l}]")


def test_cpu_wrappers_take_plain_path():
    ls.reset_launches()
    x, layers = make_case()
    xt, lt = to_torch(x, layers, requires_grad=True)
    xt.requires_grad_(True)
    ls.lstm_stack_rc(xt, lt).sum().backward()
    with torch.no_grad():
        ls.lstm_stack_rc(xt, lt)
    ls.bwd_rc(torch.ones(6, 5, 4), *to_torch(x, layers), *ls.fwd_train_rc(*to_torch(x, layers)))
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES
    assert {"fwd_train_rc", "bwd_rc"} <= set(ls.LAUNCHES)


def test_rc_ref_gives_the_wrapper_gradients():
    """`lstm_stack_rc_ref`, the plain pair the card times the kernels
    against, is the CPU path of `lstm_stack_rc` itself."""
    x, layers = make_case(T=5, L=2, seed=160)
    w_out = np.random.default_rng(161).normal(size=(5, 5, 4)).astype(np.float32)
    got_x, got_l = port_grads(ls.lstm_stack_rc_ref, x, layers, w_out)
    want_x, want_l = port_grads(ls.lstm_stack_rc, x, layers, w_out)
    torch.testing.assert_close(got_x, want_x, rtol=0, atol=0)
    for got, want in zip(got_l, want_l):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
