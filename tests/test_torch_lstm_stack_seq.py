"""The port's full-sequence LSTM stack and input gradients — K4
(`_fwd_infer_ref`) and K2g (`_bwd_ref` with a full cotangent and/or dx) and
the autograd wrappers `lstm_stack` / `lstm_stack_last` on the CPU — against
the JAX package's Pallas stack in interpret mode, and against
torch.nn.LSTM. Tolerances as tests/test_torch_lstm_stack.py: f32 values
atol 1e-5, gradients atol 2e-5 / rtol 2e-4, bf16 forward atol 1e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_lstm_stack import (
    _fwd_train_impl,
    _vjp_bwd,
    lstm_stack_pallas,
    lstm_stack_pallas_last,
    lstm_stack_pallas_ndx,
)
from cerebra_torch.models import lstm_stack as ls
from tests.test_torch_lstm_stack import make_case, to_jax, to_torch

torch.set_num_threads(1)
GRAD_TOL = dict(atol=2e-5, rtol=2e-4)


def port_grads(fn, x, layers, w_out, x_grad=True):
    """x's (when `x_grad`) and every weight's gradient of
    sum(fn(x, layers) * w_out)."""
    xt, lt = to_torch(x, layers, requires_grad=True)
    xt.requires_grad_(x_grad)
    (fn(xt, lt) * torch.from_numpy(w_out)).sum().backward()
    return xt.grad, [[w.grad for w in l] for l in lt]


def assert_grads(got_x, got_l, want_x, want_l):
    if want_x is None:
        assert got_x is None
    else:
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **GRAD_TOL)
    for got, want in zip(got_l, want_l):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("L", [1, 2, 3])
def test_forward_matches_pallas(L):
    """K4's plain version and the no-grad wrapper, over a ragged batch of 5."""
    x, layers = make_case(L=L, seed=10 + L)
    want = np.asarray(lstm_stack_pallas(*to_jax(x, layers)))
    xt, lt = to_torch(x, layers)
    np.testing.assert_allclose(ls._fwd_infer_ref(xt, lt).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(ls.lstm_stack(xt, lt).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("L", [1, 2, 3])
def test_full_g_with_dx_matches_pallas(L):
    """jax.grad through lstm_stack_pallas (full (T, B, H) cotangent, dx) in
    x and the layers."""
    x, layers = make_case(T=5, L=L, seed=20 + L)
    w_out = np.random.default_rng(L).normal(size=(5, 5, 4)).astype(np.float32)
    want_x, want_l = jax.grad(lambda x, l: jnp.sum(lstm_stack_pallas(x, l) * w_out),
                              argnums=(0, 1))(*to_jax(x, layers))
    assert_grads(*port_grads(ls.lstm_stack, x, layers, w_out), want_x, want_l)


@pytest.mark.parametrize("L", [1, 2, 3])
def test_last_g_with_dx_matches_pallas(L):
    """jax.grad through lstm_stack_pallas_last ((B, H) cotangent, dx)."""
    x, layers = make_case(T=5, L=L, seed=30 + L)
    w_out = np.random.default_rng(L).normal(size=(5, 4)).astype(np.float32)
    want_x, want_l = jax.grad(lambda x, l: jnp.sum(lstm_stack_pallas_last(x, l) * w_out),
                              argnums=(0, 1))(*to_jax(x, layers))
    assert_grads(*port_grads(ls.lstm_stack_last, x, layers, w_out), want_x, want_l)


@pytest.mark.parametrize("L", [1, 2, 3])
def test_full_g_without_dx_matches_ndx(L):
    """An x that needs no gradient against lstm_stack_pallas_ndx: the same
    weight gradients through the backward without dx, and x gets none (JAX
    returns zeros)."""
    x, layers = make_case(T=5, L=L, seed=40 + L)
    w_out = np.random.default_rng(L).normal(size=(5, 5, 4)).astype(np.float32)
    want_x, want_l = jax.grad(lambda x, l: jnp.sum(lstm_stack_pallas_ndx(x, l) * w_out),
                              argnums=(0, 1))(*to_jax(x, layers))
    assert not np.asarray(want_x).any()
    assert_grads(*port_grads(ls.lstm_stack, x, layers, w_out, x_grad=False), None, want_l)


@pytest.mark.parametrize("g_full", [False, True], ids=["g_last", "g_full"])
@pytest.mark.parametrize("need_dx", [False, True], ids=["no_dx", "dx"])
def test_plain_backward_matches_pallas_vjp(g_full, need_dx):
    """`_bwd_ref` in each of its four forms against the Pallas `_vjp_bwd` on
    the same K1 residuals, in a 2-layer stack."""
    T, B, H, L = 5, 5, 4, 2
    x, layers = make_case(T=T, L=L, seed=50)
    g = np.random.default_rng(51).normal(size=(T, B, H) if g_full else (B, H)).astype(np.float32)
    xj, lj = to_jax(x, layers)
    outs = _fwd_train_impl(xj, lj)
    want_dx, want_l = _vjp_bwd((xj, lj, outs), jnp.asarray(g), need_dx=need_dx,
                               g_last_only=not g_full)
    xt, lt = to_torch(x, layers)
    dx, got_l = ls._bwd_ref(torch.from_numpy(g), xt, lt, *ls._fwd_train_ref(xt, lt), need_dx)
    assert_grads(dx, got_l, want_dx if need_dx else None, want_l)


def test_bf16_forward_matches_pallas():
    """In bf16 both round at the same points; a flipped rounding in the
    recurrence moves h by a bf16 ulp or two."""
    x, layers = make_case(L=2, seed=60)
    want = np.asarray(lstm_stack_pallas(*to_jax(x, layers, jnp.bfloat16)), dtype=np.float32)
    got = ls._fwd_infer_ref(*to_torch(x, layers, torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_full_sequence_matches_torch_lstm():
    """torch.nn.LSTM as a second oracle: values, and the gradients of x and
    the weights (nn.LSTM's two biases each get db)."""
    T, B, C, H, L = 7, 3, 6, 5, 2
    x, layers = make_case(T=T, B=B, C=C, H=H, L=L, seed=70)
    w_out = np.random.default_rng(71).normal(size=(T, B, H)).astype(np.float32)
    lstm = torch.nn.LSTM(C, H, num_layers=L)
    with torch.no_grad():
        for l, (w_ih, w_hh, b) in enumerate(layers):
            getattr(lstm, f"weight_ih_l{l}").copy_(torch.from_numpy(w_ih.T))
            getattr(lstm, f"weight_hh_l{l}").copy_(torch.from_numpy(w_hh.T))
            getattr(lstm, f"bias_ih_l{l}").copy_(torch.from_numpy(b))
            getattr(lstm, f"bias_hh_l{l}").zero_()
    xr = torch.from_numpy(x).requires_grad_(True)
    want = lstm(xr)[0]
    (want * torch.from_numpy(w_out)).sum().backward()
    got_x, got_l = port_grads(ls.lstm_stack, x, layers, w_out)
    xt, lt = to_torch(x, layers)
    np.testing.assert_allclose(ls.lstm_stack(xt, lt).numpy(), want.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), xr.grad.numpy(), **GRAD_TOL)
    for l in range(L):
        for k, name in enumerate(("weight_ih", "weight_hh", "bias_ih")):
            want_g = getattr(lstm, f"{name}_l{l}").grad
            np.testing.assert_allclose(got_l[l][k].numpy(), (want_g.T if k < 2 else want_g).numpy(),
                                       **GRAD_TOL)


def test_cpu_wrappers_take_plain_path():
    ls.reset_launches()
    x, layers = make_case()
    xt, lt = to_torch(x, layers, requires_grad=True)
    xt.requires_grad_(True)
    ls.lstm_stack(xt, lt).sum().backward()
    ls.lstm_stack_last(xt, lt).sum().backward()
    with torch.no_grad():
        ls.lstm_stack(xt, lt)
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES
    assert {"fwd_infer", "bwd_general"} <= set(ls.LAUNCHES)


def test_output_is_not_a_view_of_the_residuals():
    """The returned sequence is a copy: scaling it in place leaves the
    saved h_all as it was (a view would fail autograd's version check)."""
    x, layers = make_case(T=4, L=1, seed=80)
    xt, lt = to_torch(x, layers, requires_grad=True)
    ls.lstm_stack(xt, lt).sum().backward()
    first = [w.grad.clone() for w in lt[0]]
    for w in lt[0]:
        w.grad = None
    y = ls.lstm_stack(xt, lt)
    y.mul_(2.0)
    y.sum().backward()
    for a, w in zip(first, lt[0]):
        torch.testing.assert_close(w.grad, 2 * a)
