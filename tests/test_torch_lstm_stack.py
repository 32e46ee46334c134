"""The port's LSTM-stack kernels (plain versions and autograd wrapper, on the
CPU) against the JAX package's Pallas stack in interpret mode, and against
torch.nn.LSTM. Tolerances as tests/test_pallas_lstm_stack.py: f32 values
atol 1e-5, gradients atol 2e-5 / rtol 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_lstm_stack import _fwd_train_impl, lstm_stack_pallas_last_ndx
from cerebra_torch.models import lstm_stack as ls

torch.set_num_threads(1)


def make_case(T=6, B=5, C=5, H=4, L=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    layers = []
    for l in range(L):
        in_dim = C if l == 0 else H
        layers.append((
            (rng.normal(size=(in_dim, 4 * H)) * 0.4).astype(np.float32),
            (rng.normal(size=(H, 4 * H)) * 0.4).astype(np.float32),
            (rng.normal(size=(4 * H,)) * 0.1).astype(np.float32),
        ))
    return x, layers


def to_jax(x, layers, dtype=jnp.float32):
    return (jnp.asarray(x, dtype),
            tuple(tuple(jnp.asarray(w, dtype) for w in l) for l in layers))


def to_torch(x, layers, dtype=torch.float32, requires_grad=False):
    return (torch.from_numpy(x).to(dtype),
            [tuple(torch.from_numpy(w).to(dtype).requires_grad_(requires_grad) for w in l)
             for l in layers])


@pytest.mark.parametrize("L", [1, 2, 3])
def test_forward_matches_pallas(L):
    x, layers = make_case(L=L)
    want = np.asarray(lstm_stack_pallas_last_ndx(*to_jax(x, layers)))
    xt, lt = to_torch(x, layers)
    np.testing.assert_allclose(ls._fwd_infer_last_ref(xt, lt).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(ls._fwd_train_ref(xt, lt)[0][-1, -1].numpy(), want, atol=1e-5)
    np.testing.assert_allclose(ls.lstm_stack_last(xt, lt).numpy(), want, atol=1e-5)


def test_train_streams_match_pallas():
    """K1's residual streams (h_all, prefac, qf) carry the Pallas algebra."""
    x, layers = make_case(L=2, seed=4)
    outs = _fwd_train_impl(*to_jax(x, layers))
    got = ls._fwd_train_ref(*to_torch(x, layers))
    for l in range(2):
        for k, name in enumerate(("h_all", "prefac", "qf")):
            np.testing.assert_allclose(got[k][l].numpy(), np.asarray(outs[3 * l + k]),
                                       atol=1e-5, err_msg=f"{name}[{l}]")


@pytest.mark.parametrize("L", [1, 2, 3])
def test_weight_grads_match_pallas(L):
    """The autograd wrapper (plain K1 forward, plain K2 backward) against
    jax.grad through the Pallas stack, with a ragged batch of 5."""
    x, layers = make_case(T=5, L=L, seed=L)
    w_out = np.random.default_rng(7).normal(size=(5, 4)).astype(np.float32)
    xj, lj = to_jax(x, layers)
    want = jax.grad(lambda l: jnp.sum(lstm_stack_pallas_last_ndx(xj, l) * w_out))(lj)

    xt, lt = to_torch(x, layers, requires_grad=True)
    (ls.lstm_stack_last(xt, lt) * torch.from_numpy(w_out)).sum().backward()
    for l in range(L):
        for k in range(3):
            np.testing.assert_allclose(lt[l][k].grad.numpy(), np.asarray(want[l][k]),
                                       atol=2e-5, rtol=2e-4)


def test_forward_matches_torch_lstm():
    """torch.nn.LSTM as a second oracle (weights (4H, in), one bias)."""
    T, B, C, H, L = 7, 3, 6, 5, 2
    x, layers = make_case(T=T, B=B, C=C, H=H, L=L, seed=9)
    lstm = torch.nn.LSTM(C, H, num_layers=L)
    with torch.no_grad():
        for l, (w_ih, w_hh, b) in enumerate(layers):
            getattr(lstm, f"weight_ih_l{l}").copy_(torch.from_numpy(w_ih.T))
            getattr(lstm, f"weight_hh_l{l}").copy_(torch.from_numpy(w_hh.T))
            getattr(lstm, f"bias_ih_l{l}").copy_(torch.from_numpy(b))
            getattr(lstm, f"bias_hh_l{l}").zero_()
        want = lstm(torch.from_numpy(x))[0][-1]
    got = ls.lstm_stack_last(*to_torch(x, layers))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_bf16_forward_matches_pallas():
    """In bf16 both round at the same points; a flipped rounding in the
    recurrence moves h by a bf16 ulp or two."""
    x, layers = make_case(L=2, seed=5)
    want = np.asarray(lstm_stack_pallas_last_ndx(*to_jax(x, layers, jnp.bfloat16)),
                      dtype=np.float32)
    got = ls._fwd_infer_last_ref(*to_torch(x, layers, torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_cpu_wrapper_takes_plain_path():
    ls.reset_launches()
    x, layers = make_case()
    xt, lt = to_torch(x, layers, requires_grad=True)
    ls.lstm_stack_last(xt, lt).sum().backward()
    with torch.no_grad():
        ls.lstm_stack_last(xt, lt)
    ls.reduce_partials(torch.ones(3, 4))
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES


def test_wrapper_raises_on_input_grad():
    x, layers = make_case()
    xt, lt = to_torch(x, layers, requires_grad=True)
    with pytest.raises(NotImplementedError):
        ls.lstm_stack_last(xt.requires_grad_(True), lt)


def test_wrapper_rejects_bad_stacks():
    x, layers = make_case(L=2)
    xt, lt = to_torch(x, layers)
    with pytest.raises(ValueError):
        ls.lstm_stack_last(xt, [lt[0], (lt[1][0][:3], lt[1][1], lt[1][2])])
    with pytest.raises(TypeError):
        ls.lstm_stack_last(xt.double(), lt)
    with pytest.raises(TypeError):
        ls.lstm_stack_last(xt, [lt[0], tuple(w.to(torch.bfloat16) for w in lt[1])])


def test_reduce_and_unpack_layout():
    """The CUDA path's partial buffer [dW_ih0 | dW_ihr | dW_hh | db] splits
    back into per-layer gradients of the right shapes and values."""
    C, H, L = 5, 4, 3
    G = 4 * H
    grads = [(torch.randn(C if l == 0 else H, G), torch.randn(H, G), torch.randn(G))
             for l in range(L)]
    flat = torch.cat([grads[0][0].flatten()] + [g[0].flatten() for g in grads[1:]]
                     + [g[1].flatten() for g in grads] + [g[2] for g in grads])
    part = torch.stack([flat, 2 * flat])
    for l, got in enumerate(ls._unpack_grads(ls.reduce_partials(part), C, H, L)):
        for a, b in zip(got, grads[l]):
            torch.testing.assert_close(a, 3 * b)
