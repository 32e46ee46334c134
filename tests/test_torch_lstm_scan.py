"""The port's per-layer LSTM scan — K12 (`_scan_fwd_infer_ref`), K13
(`_scan_fwd_train_ref`), K14 (`_scan_bwd_ref`) and the autograd wrapper
`lstm_scan` on the CPU — against the JAX package's `lstm_scan_pallas` in
interpret mode. Tolerances as tests/test_torch_lstm_stack_seq.py: f32 values
atol 1e-5, gradients atol 2e-5 / rtol 2e-4, the bf16 forward atol 1e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models import pallas_lstm as pl_lstm
from cerebra_torch.kernels import reset_launches
from cerebra_torch.models import lstm_scan as sc
from tests.test_torch_lstm_stack_rc import BF16_BWD_REL, assert_rel_frob
from tests.test_torch_lstm_stack_seq import GRAD_TOL

torch.set_num_threads(1)


def make_case(T=7, B=8, H=6, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(T, B, 4 * H)) * 0.5).astype(np.float32),
            (rng.normal(size=(H, 4 * H)) * 0.3).astype(np.float32))


def both(xp, w, jdt=jnp.float32, tdt=torch.float32):
    return ((jnp.asarray(xp, jdt), jnp.asarray(w, jdt)),
            (torch.from_numpy(xp).to(tdt), torch.from_numpy(w).to(tdt)))


@pytest.mark.parametrize("B", [8, 5])
def test_forwards_match_pallas(B):
    """K12's h_all and K13's h_all, prefac and qf, over a full and a ragged
    batch."""
    xp, w = make_case(B=B, seed=B)
    (xj, wj), (xt, wt) = both(xp, w)
    want = pl_lstm._fwd_train_impl(xj, wj, 1024)
    np.testing.assert_allclose(sc._scan_fwd_infer_ref(xt, wt).numpy(),
                               np.asarray(pl_lstm._fwd_infer_impl(xj, wj, 1024)), atol=1e-5)
    for name, a, b in zip(("h_all", "prefac", "qf"), sc._scan_fwd_train_ref(xt, wt), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


def test_plain_backward_matches_pallas_vjp():
    """K14's plain version, fed the Pallas forward's residuals, and the
    dW_hh matmul against `_vjp_bwd`: dx_proj and dW_hh."""
    T, B, H = 8, 8, 6
    xp, w = make_case(T=T, B=B, H=H, seed=10)
    g = np.random.default_rng(11).normal(size=(T, B, H)).astype(np.float32)
    (xj, wj), (_, wt) = both(xp, w)
    h_all, prefac, qf = pl_lstm._fwd_train_impl(xj, wj, 1024)
    want_dx, want_dw = pl_lstm._vjp_bwd(1024, (wj, h_all, prefac, qf), jnp.asarray(g))
    res = [torch.from_numpy(np.array(r)) for r in (h_all, prefac, qf)]
    dx = sc._scan_bwd_ref(torch.from_numpy(g), res[1], res[2], wt)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **GRAD_TOL)
    np.testing.assert_allclose(sc._dw_hh(res[0], dx, wt).numpy(), np.asarray(want_dw),
                               **GRAD_TOL)


@pytest.mark.parametrize("tile", [None, 2])
def test_wrapper_matches_pallas_values_and_grads(tile):
    """`lstm_scan`'s values (K12 without grad) and both of jax.grad's
    gradients through `lstm_scan_pallas`, for a loss on every h."""
    T, B, H = 9, 8, 5
    xp, w = make_case(T=T, B=B, H=H, seed=20)
    w_out = np.random.default_rng(21).normal(size=(T, B, H)).astype(np.float32)
    (xj, wj), (xt, wt) = both(xp, w)
    np.testing.assert_allclose(sc.lstm_scan(xt, wt, tile).numpy(),
                               np.asarray(pl_lstm.lstm_scan_pallas(xj, wj)), atol=1e-5)
    want = jax.grad(lambda a, b: jnp.sum(pl_lstm.lstm_scan_pallas(a, b) * w_out),
                    argnums=(0, 1))(xj, wj)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    (sc.lstm_scan(xt, wt, tile) * torch.from_numpy(w_out)).sum().backward()
    for got, b in zip((xt.grad, wt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(b), **GRAD_TOL)


def test_one_gradient_at_a_time():
    """With only w_hh requiring grad, x_proj gets none and w_hh the same
    gradient; with only x_proj, the other way round."""
    xp, w = make_case(seed=30)
    grads = {}
    for which in ("both", "x", "w"):
        xt, wt = torch.from_numpy(xp).requires_grad_(which != "w"), torch.from_numpy(w)
        wt.requires_grad_(which != "x")
        sc.lstm_scan(xt, wt).square().sum().backward()
        grads[which] = (xt.grad, wt.grad)
    assert grads["x"][1] is None and grads["w"][0] is None
    torch.testing.assert_close(grads["x"][0], grads["both"][0], rtol=0, atol=0)
    torch.testing.assert_close(grads["w"][1], grads["both"][1], rtol=0, atol=0)


def test_bf16_forward_matches_pallas():
    """K12 in bf16: both round h at the same points; a flipped rounding in
    the recurrence moves h by a bf16 ulp or two."""
    xp, w = make_case(T=10, seed=40)
    (xj, wj), (xt, wt) = both(xp, w, jnp.bfloat16, torch.bfloat16)
    want = np.asarray(pl_lstm.lstm_scan_pallas(xj, wj), dtype=np.float32)
    np.testing.assert_allclose(sc._scan_fwd_infer_ref(xt, wt).float().numpy(), want, atol=1e-2)


def test_bf16_backward_matches_pallas_vjp():
    """K14's plain version in bf16, fed the Pallas forward's bf16 residuals,
    and the dW_hh matmul against `_vjp_bwd`: dx_proj and dW_hh in bf16 (the
    limit and its reason at BF16_BWD_REL)."""
    T, B, H = 10, 8, 8
    xp, w = make_case(T=T, B=B, H=H, seed=181)
    g = np.random.default_rng(182).normal(size=(T, B, H)).astype(np.float32)
    (xj, wj), (_, wt) = both(xp, w, jnp.bfloat16, torch.bfloat16)
    h_all, prefac, qf = pl_lstm._fwd_train_impl(xj, wj, 1024)
    want_dx, want_dw = pl_lstm._vjp_bwd(1024, (wj, h_all, prefac, qf),
                                        jnp.asarray(g, jnp.bfloat16))
    res = [torch.from_numpy(np.asarray(r, np.float32)).to(torch.bfloat16)
           for r in (h_all, prefac, qf)]
    dx = sc._scan_bwd_ref(torch.from_numpy(g).to(torch.bfloat16), res[1], res[2], wt)
    dw = sc._dw_hh(res[0], dx, wt)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert_rel_frob(dx.float(), want_dx, BF16_BWD_REL, "dx_proj")
    assert_rel_frob(dw.float(), want_dw, BF16_BWD_REL, "dW_hh")


def test_dw_hh_restores_the_callers_tf32_setting():
    """dW_hh turns TF32 off for its matmul and leaves the caller's setting
    as it was."""
    h, d = torch.randn(5, 3, 4), torch.randn(5, 3, 16)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            sc._dw_hh(h, d, torch.zeros(4, 16))
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_cpu_wrappers_take_plain_path():
    reset_launches()
    xp, w = make_case(seed=50)
    xt, wt = torch.from_numpy(xp).requires_grad_(True), torch.from_numpy(w)
    sc.lstm_scan(xt, wt).sum().backward()
    with torch.no_grad():
        sc.lstm_scan(xt, wt)
    assert all(v == 0 for v in sc.LAUNCHES.values()), sc.LAUNCHES
    assert {"scan_fwd_infer", "scan_fwd_train", "scan_bwd"} <= set(sc.LAUNCHES)


def test_wrapper_rejects_bad_inputs():
    xp, w = make_case(seed=60)
    xt, wt = torch.from_numpy(xp), torch.from_numpy(w)
    with pytest.raises(ValueError):
        sc.lstm_scan(xt[..., :-1], wt)
    with pytest.raises(ValueError):
        sc.lstm_scan(xt, wt[:, :-4])
    with pytest.raises(TypeError):
        sc.lstm_scan(xt.double(), wt.double())
    with pytest.raises(TypeError):
        sc.lstm_scan(xt, wt.to(torch.bfloat16))
