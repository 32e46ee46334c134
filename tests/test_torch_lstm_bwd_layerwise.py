"""The stack backward K2/K2g as the CUDA path composes it — one reverse scan
and one set of products a layer, top layer first (`_bwd_layerwise`) — through
its plain pieces on the CPU (`_scan_bwd_ref`, `_products_ref`), against the
per-step plain K2 (`_bwd_ref`) and the JAX package's Pallas `_vjp_bwd` in
interpret mode, in f32 and bf16; and `_bwd_ref` itself in bf16 against
`_vjp_bwd`. Tolerances: f32 gradients atol 2e-5 / rtol 2e-4
(tests/test_torch_lstm_stack_seq.py's GRAD_TOL); every bf16 comparison the
relative Frobenius limit BF16_BWD_REL (tests/test_torch_lstm_stack_rc.py,
with its reason)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_lstm_stack import _fwd_train_impl, _vjp_bwd
from cerebra_torch.models import lstm_stack as ls
from tests.test_torch_lstm_stack import make_case, to_jax, to_torch
from tests.test_torch_lstm_stack_rc import BF16_BWD_REL, assert_rel_frob
from tests.test_torch_lstm_stack_seq import GRAD_TOL, assert_grads

torch.set_num_threads(1)

FORMS = [(False, False), (False, True), (True, False), (True, True)]
FORM_IDS = ["g_last", "g_last_dx", "g_full", "g_full_dx"]


def pallas_case(T, B, C, H, L, seed, g_full, jdt, tdt):
    """Inputs made with numpy, the Pallas training forward's residuals in
    `jdt`, the same residuals stacked for the port in `tdt`, and a cotangent
    (T, B, H) or (B, H)."""
    x, layers = make_case(T=T, B=B, C=C, H=H, L=L, seed=seed)
    g = np.random.default_rng(seed + 1).normal(size=(T, B, H) if g_full else (B, H))
    g = g.astype(np.float32)
    xj, lj = to_jax(x, layers, jdt)
    outs = _fwd_train_impl(xj, lj)
    res = tuple(torch.from_numpy(np.stack([np.asarray(outs[3 * l + k], np.float32)
                                           for l in range(L)])).to(tdt) for k in range(3))
    return (xj, lj, outs), jnp.asarray(g, jdt), to_torch(x, layers, tdt), torch.from_numpy(g).to(tdt), res


@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("g_full,need_dx", FORMS, ids=FORM_IDS)
def test_layerwise_matches_bwd_ref_and_pallas(g_full, need_dx, L):
    """f32: the plain composition against `_bwd_ref` and `_vjp_bwd` on the
    Pallas forward's residuals, every dW and dx."""
    jres, gj, (xt, lt), gt, res = pallas_case(6, 5, 5, 4, L, 200 + L, g_full, jnp.float32,
                                              torch.float32)
    want_dx, want_l = _vjp_bwd(jres, gj, need_dx=need_dx, g_last_only=not g_full)
    dx, got_l = ls._bwd_layerwise_ref(gt, xt, lt, *res, need_dx)
    assert_grads(dx, got_l, want_dx if need_dx else None, want_l)
    ref_dx, ref_l = ls._bwd_ref(gt, xt, lt, *res, need_dx)
    assert_grads(dx, got_l, ref_dx, ref_l)


@pytest.mark.parametrize("g_full,need_dx", FORMS, ids=FORM_IDS)
def test_bf16_layerwise_matches_bwd_ref_and_pallas(g_full, need_dx):
    """bf16, 2 layers: the plain composition rounds where `_bwd_ref` and the
    Pallas kernel round (dgates, dx; the chain to the layer below stays
    f32), and sums dW over all rows in f32 in another order."""
    T, B, C, H, L = 6, 5, 5, 8, 2
    jres, gj, (xt, lt), gt, res = pallas_case(T, B, C, H, L, 210, g_full, jnp.bfloat16,
                                              torch.bfloat16)
    want_dx, want_l = _vjp_bwd(jres, gj, need_dx=need_dx, g_last_only=not g_full)
    dx, got_l = ls._bwd_layerwise_ref(gt, xt, lt, *res, need_dx)
    ref_dx, ref_l = ls._bwd_ref(gt, xt, lt, *res, need_dx)
    assert (dx is None) == (not need_dx)
    if need_dx:
        assert dx.dtype == torch.bfloat16
        assert_rel_frob(dx.float(), want_dx, BF16_BWD_REL, "dx vs Pallas")
        assert_rel_frob(dx.float(), ref_dx.float(), BF16_BWD_REL, "dx vs _bwd_ref")
    for l in range(L):
        for name, a, b, r in zip(("dW_ih", "dW_hh", "db"), got_l[l], want_l[l], ref_l[l]):
            assert a.dtype == torch.float32
            assert_rel_frob(a.to(torch.bfloat16).float(), b, BF16_BWD_REL, f"{name}[{l}] vs Pallas")
            assert_rel_frob(a, r, BF16_BWD_REL, f"{name}[{l}] vs _bwd_ref")


@pytest.mark.parametrize("g_full,need_dx", FORMS, ids=FORM_IDS)
def test_bf16_bwd_ref_matches_pallas_vjp(g_full, need_dx):
    """`_bwd_ref`, the kernel's yardstick, in bf16 against `_vjp_bwd` on the
    Pallas forward's bf16 residuals, 2 layers: dgates are bf16 products of
    the rounded dc and dh and the stored prefactors, the chain to layer 0 an
    f32 product added to dh unrounded, dx rounded once, dW f32 sums of exact
    products."""
    T, B, C, H, L = 6, 5, 5, 8, 2
    jres, gj, (xt, lt), gt, res = pallas_case(T, B, C, H, L, 220, g_full, jnp.bfloat16,
                                              torch.bfloat16)
    want_dx, want_l = _vjp_bwd(jres, gj, need_dx=need_dx, g_last_only=not g_full)
    dx, got_l = ls._bwd_ref(gt, xt, lt, *res, need_dx)
    if need_dx:
        assert dx.dtype == torch.bfloat16
        assert_rel_frob(dx.float(), want_dx, BF16_BWD_REL, "dx")
    for l in range(L):
        for name, a, b in zip(("dW_ih", "dW_hh", "db"), got_l[l], want_l[l]):
            assert_rel_frob(a.to(torch.bfloat16).float(), b, BF16_BWD_REL, f"{name}[{l}]")


def identity_input_case(L, dtype, seed):
    """A stack whose layer 0 reads x (T, B, 4H) through w_ih = I, so that
    `_bwd_ref`'s dx is layer 0's dgates stream (rnd(dgates·I) = dgates)."""
    T, B, H = 6, 5, 8
    x, layers = make_case(T=T, B=B, C=4 * H, H=H, L=L, seed=seed)
    layers[0] = (np.eye(4 * H, dtype=np.float32),) + tuple(layers[0][1:])
    xt, lt = to_torch(x, layers, dtype)
    return xt, lt, ls._fwd_train_ref(xt, lt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_with_f32_cotangent_matches_bwd_ref(dtype):
    """The scan of layer 0 under the f32 chain from layer 1 (dgates_1·W_ih1ᵀ,
    not rounded) against layer 0's dgates inside `_bwd_ref`."""
    xt, lt, (h_all, prefac, qf) = identity_input_case(2, dtype, 230)
    g = torch.from_numpy(np.random.default_rng(231).normal(size=(6, 5, 8)).astype(np.float32))
    g = g.to(dtype)
    want, _ = ls._bwd_ref(g, xt, lt, h_all, prefac, qf, need_dx=True)
    d1 = ls._scan_bwd_ref(g, prefac[1], qf[1], lt[1][1])
    gup = d1.float() @ lt[1][0].float().t()
    assert gup.dtype == torch.float32
    got = ls._scan_bwd_ref(gup, prefac[0], qf[0], lt[0][1])
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **GRAD_TOL)
    else:
        assert_rel_frob(got.float(), want.float(), BF16_BWD_REL, "dgates[0]")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_with_last_step_cotangent_matches_bwd_ref(dtype):
    """The scan with a (B, H) cotangent that reaches t = T−1 only (K2's
    h[−1] head) against the 1-layer `_bwd_ref`'s dgates, and against the
    scan of the same cotangent written out at every t (zeros before T−1):
    bit for bit."""
    xt, lt, (h_all, prefac, qf) = identity_input_case(1, dtype, 240)
    g = torch.from_numpy(np.random.default_rng(241).normal(size=(5, 8)).astype(np.float32))
    g = g.to(dtype)
    want, _ = ls._bwd_ref(g, xt, lt, h_all, prefac, qf, need_dx=True)
    got = ls._scan_bwd_ref(g, prefac[0], qf[0], lt[0][1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    full = torch.zeros(6, 5, 8, dtype=dtype)
    full[-1] = g
    torch.testing.assert_close(ls._scan_bwd_ref(full, prefac[0], qf[0], lt[0][1]), got,
                               rtol=0, atol=0)


def test_cpu_pieces_take_plain_path():
    """`bwd_scan` and `bwd_products` on CPU tensors are the plain pieces, and
    `bwd` the per-step `_bwd_ref`; no launch is counted."""
    ls.reset_launches()
    xt, lt, (h_all, prefac, qf) = identity_input_case(2, torch.float32, 250)
    g = torch.ones(5, 8)
    dg = ls.bwd_scan(g, prefac[1], qf[1], lt[1][1])
    torch.testing.assert_close(dg, ls._scan_bwd_ref(g, prefac[1], qf[1], lt[1][1]),
                               rtol=0, atol=0)
    got = ls.bwd_products(dg, h_all[0], h_all[1], lt[1][0], "gup")
    for a, b in zip(got, ls._products_ref(dg, h_all[0], h_all[1], lt[1][0], "gup")):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got[3].shape == (6, 5, 8) and got[3].dtype == torch.float32
    dx, grads = ls.bwd(g, xt, lt, h_all, prefac, qf, need_dx=True)
    ref_dx, ref = ls._bwd_ref(g, xt, lt, h_all, prefac, qf, need_dx=True)
    torch.testing.assert_close(dx, ref_dx, rtol=0, atol=0)
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES
    assert {"stack_bwd_scan", "stack_bwd_products", "stack_bwd_products_wgmma"} <= set(ls.LAUNCHES)


# The one-pass dW/db contraction's row chunks (`_dw_rows`) at (M = T·B, in,
# H): the headline layer (T 460, B 1024, C = H = 96), the CLI's B 16, the
# DINO-LSTM's layers at B 8 and 1024, the autoencoder's encoder and
# decoder, the card test's headline cut (T 20), one step, one row.
DW_SHAPES = [(460 * 1024, 96, 96), (460 * 16, 96, 96), (300 * 8, 96, 128), (300 * 8, 128, 128),
             (300 * 1024, 128, 128), (12 * 16, 96, 384), (12 * 13, 384, 96),
             (20 * 1024, 96, 96), (64, 96, 96), (1, 8, 8)]


@pytest.mark.parametrize("M, in_dim, H", DW_SHAPES, ids=str)
def test_dw_chunks_cover_every_row_once(M, in_dim, H):
    """Chunks of whole 64-row steps, at most 4096 rows and at least 8 steps
    where M has them; the chunks `stack_contract`'s grid makes
    (ceil(M / rows), chunk y over [y rows, (y + 1) rows) ∩ [0, M)) cover
    every row once, none is empty, and the scratch `_scratch_floats` sizes
    holds every chunk's [dW_ih | dW_hh | db] partial."""
    rows = ls._dw_rows(M, in_dim, H)
    steps = -(-M // 64)
    assert rows % 64 == 0 and 64 * min(8, steps) <= rows <= 4096
    chunks = -(-M // rows)
    seen = np.zeros(M, np.int64)
    for y in range(chunks):
        a, b = y * rows, min(M, (y + 1) * rows)
        assert b > a
        seen[a:b] += 1
    assert (seen == 1).all()
    assert ls._scratch_floats(in_dim, H, M, 1, True) >= chunks * (in_dim + H + 1) * 4 * H
    assert ls._scratch_floats(in_dim, H, M, 1, True) == ls._scratch_floats(in_dim, H, 1, M, True)


def test_dw_chunks_fill_the_card_at_the_headline():
    """B 1024, T 460: 132 chunks of 56 steps, so the 3 column tiles' 396
    CTAs are 3 whole waves of the 132 SMs."""
    rows = ls._dw_rows(460 * 1024, 96, 96)
    assert rows == 56 * 64 and -(-460 * 1024 // rows) == 132


def test_products_path_rule():
    """bf16 streams of widths the TMA reads (multiples of 8, 16-byte
    bases) take the one-pass contraction; f32 and other widths do not."""
    def z(*s, dtype=torch.bfloat16):
        return torch.zeros(*s, dtype=dtype)

    assert ls._products_wgmma(z(3, 5, 384), z(3, 5, 96), z(3, 5, 96))
    assert ls._products_wgmma(z(3, 5, 512), z(3, 5, 128), z(3, 5, 128))
    assert not ls._products_wgmma(z(3, 5, 384, dtype=torch.float32),
                                  z(3, 5, 96, dtype=torch.float32),
                                  z(3, 5, 96, dtype=torch.float32))
    assert not ls._products_wgmma(z(3, 5, 40), z(3, 5, 24), z(3, 5, 10))
    assert not ls._products_wgmma(z(3, 5, 256), z(3, 5, 300), z(3, 5, 64))
    shifted = z(3 * 5 * 96 + 1)[1:].view(3, 5, 96)  # a base 2 bytes past 16
    assert not ls._products_wgmma(z(3, 5, 384), shifted, z(3, 5, 96))
