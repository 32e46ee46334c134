"""The recompute backward K11 as the CUDA path composes it — time chunks, last
first, and in each the layers top first: the chunk's gates, its residuals,
the reverse scan with the dh/dc carries handed from chunk to chunk, and the
products into fixed dW groups (`_bwd_rc_chunked`) — through its plain pieces
on the CPU (`_rc_gates_ref`; `_rc_scan_ref`, which is `_scan_bwd_ref` with a
carry and an f32 qf on `_rc_residuals_ref`'s residuals; `_rc_products_ref`),
against the per-step plain K11
(`_bwd_rc_ref`) and the JAX package's Pallas `_vjp_bwd_rc` in interpret
mode, at chunks of 1, 3, T−1, T and more than T steps, a ragged batch and
1–3 layers. Tolerances: f32 gradients atol 2e-5 / rtol 2e-4
(tests/test_torch_lstm_stack_seq.py's GRAD_TOL); bf16 the relative
Frobenius limit BF16_BWD_REL (tests/test_torch_lstm_stack_rc.py, with its
reason); where only the cut into chunks differs, bit for bit."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_lstm_stack import _fwd_train_rc_impl, _vjp_bwd_rc
from cerebra_torch.models import lstm_stack as ls
from tests.test_torch_lstm_stack import make_case, to_jax, to_torch
from tests.test_torch_lstm_stack_rc import BF16_BWD_REL, assert_rel_frob, jax_residuals
from tests.test_torch_lstm_stack_seq import GRAD_TOL, assert_grads

torch.set_num_threads(1)

T, B, C, H = 7, 5, 5, 4
CHUNKS = [1, 3, T - 1, T, T + 2]
CHUNK_IDS = ["1", "3", "T-1", "T", "T+2"]


@functools.lru_cache(maxsize=None)
def pallas_case(L, bf16):
    """Inputs made with numpy, the Pallas recompute forward's residuals and
    `_vjp_bwd_rc`'s gradients in f32 or bf16, and the same inputs and
    residuals for the port."""
    x, layers = make_case(T=T, B=B, C=C, H=H, L=L, seed=300 + L)
    g = np.random.default_rng(301 + L).normal(size=(T, B, H)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    xj, lj = to_jax(x, layers, jdt)
    outs = _fwd_train_rc_impl(xj, lj)
    want = _vjp_bwd_rc((xj, lj, outs), jnp.asarray(g, jdt))
    xt, lt = to_torch(x, layers, tdt)
    res = tuple(r.to(tdt) for r in jax_residuals(outs, L))
    return want, torch.from_numpy(g).to(tdt), xt, lt, res


@pytest.mark.parametrize("chunk", CHUNKS, ids=CHUNK_IDS)
@pytest.mark.parametrize("L", [1, 2, 3])
def test_chunked_matches_bwd_rc_ref_and_pallas(L, chunk):
    """f32: the chunked composition against `_vjp_bwd_rc` and `_bwd_rc_ref`
    on the Pallas forward's residuals, dx and every dW."""
    (want_dx, want_l), g, xt, lt, res = pallas_case(L, False)
    dx, got_l = ls._bwd_rc_chunked_ref(g, xt, lt, *res, chunk)
    assert_grads(dx, got_l, want_dx, want_l)
    assert_grads(dx, got_l, *ls._bwd_rc_ref(g, xt, lt, *res))


@pytest.mark.parametrize("chunk", [1, 3, T], ids=["1", "3", "T"])
def test_bf16_chunked_matches_bwd_rc_ref_and_pallas(chunk):
    """bf16, 2 layers: the composition rounds where `_bwd_rc_ref` and the
    Pallas kernel round (prefactors, dc, dh, dgates, dx; q, f and the chain
    stay f32), and sums dW in f32 in another order."""
    (want_dx, want_l), g, xt, lt, res = pallas_case(2, True)
    dx, got_l = ls._bwd_rc_chunked_ref(g, xt, lt, *res, chunk)
    ref_dx, ref_l = ls._bwd_rc_ref(g, xt, lt, *res)
    assert dx.dtype == torch.bfloat16
    assert_rel_frob(dx.float(), want_dx, BF16_BWD_REL, "dx vs Pallas")
    assert_rel_frob(dx.float(), ref_dx.float(), BF16_BWD_REL, "dx vs _bwd_rc_ref")
    for l in range(2):
        for name, a, b, r in zip(("dW_ih", "dW_hh", "db"), got_l[l], want_l[l], ref_l[l]):
            assert a.dtype == torch.float32
            assert_rel_frob(a.to(torch.bfloat16).float(), b, BF16_BWD_REL, f"{name}[{l}] vs Pallas")
            assert_rel_frob(a, r, BF16_BWD_REL, f"{name}[{l}] vs _bwd_rc_ref")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 4], ids=str)
def test_chunks_share_the_dw_groups(chunk, dtype):
    """With dW groups of 2 steps, every chunk that is a multiple of the group
    gives the result of one chunk bit for bit (the groups do not move with
    the chunk), and a chunk that is not one is refused."""
    _, g, xt, lt, res = pallas_case(2, dtype == torch.bfloat16)
    if chunk % 2:
        with pytest.raises(ValueError):
            ls._bwd_rc_chunked_ref(g, xt, lt, *res, chunk, 2)
        return
    dx, got = ls._bwd_rc_chunked_ref(g, xt, lt, *res, chunk, 2)
    whole_dx, whole = ls._bwd_rc_chunked_ref(g, xt, lt, *res, T, 2)
    torch.testing.assert_close(dx, whole_dx, rtol=0, atol=0)
    for a, b in zip((w for l in got for w in l), (w for l in whole for w in l)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("cot", ["stream", "f32"])
@pytest.mark.parametrize("chunk", CHUNKS, ids=CHUNK_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_chunked_equals_one_scan(dtype, chunk, cot):
    """The plain reverse scan with K11's f32 qf, cut into chunks that hand
    their carries on, equals the scan of the whole sequence exactly."""
    _, _, xt, lt, (h_all, c_all) = pallas_case(1, dtype == torch.bfloat16)
    w_ih, w_hh, b = lt[0]
    gates = ls._rc_gates_ref(xt, ls._shifted(h_all[0, :-1], T), w_ih, w_hh, b)
    prefac, qf = ls._rc_residuals_ref(gates, c_all[0], ls._shifted(c_all[0, :-1], T))
    assert qf.dtype == torch.float32 and prefac.dtype == dtype
    rng = np.random.default_rng(310)
    g = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32))
    g = g if cot == "f32" else g.to(dtype)
    whole = ls._scan_bwd_ref(g, prefac, qf, w_hh)
    carry = torch.zeros(2, B, H)
    parts = [ls._scan_bwd_ref(g[t0:t0 + chunk], prefac[t0:t0 + chunk], qf[t0:t0 + chunk], w_hh,
                              carry) for t0 in reversed(range(0, T, chunk))]
    torch.testing.assert_close(torch.cat(parts[::-1]), whole, rtol=0, atol=0)


@pytest.mark.parametrize("t0", [0, 1, 4])
def test_pieces_match_the_per_step_recompute(t0):
    """The gate product and the residual pass of a 3-step chunk from t0 (the
    one at t = 0 with no step before it) give the per-step gates and K11's
    residuals of `_bwd_rc_ref`'s loop."""
    _, _, xt, lt, (h_all, c_all) = pallas_case(2, False)
    w_ih, w_hh, b = lt[1]
    t1, back = t0 + 3, slice(max(t0 - 1, 0), t0 + 2)
    h_prev, c_prev = ls._shifted(h_all[1, back], 3), ls._shifted(c_all[1, back], 3)
    assert h_prev.shape == (3, B, H) and (t0 > 0 or not h_prev[0].any())
    gates = ls._rc_gates_ref(h_all[0, t0:t1], h_prev, w_ih, w_hh, b)
    prefac, qf = ls._rc_residuals_ref(gates, c_all[1, t0:t1], c_prev)
    for k, t in enumerate(range(t0, t1)):
        h_prev = h_all[1, t - 1] if t else torch.zeros(B, H)
        c_prev = c_all[1, t - 1] if t else torch.zeros(B, H)
        want = ls._gates(h_all[0, t], h_prev, w_ih, w_hh, b, torch.float32)
        np.testing.assert_allclose(gates[k].numpy(), want.numpy(), atol=1e-6)
        i, f, o = (torch.sigmoid(want[:, j * H:(j + 1) * H]) for j in (0, 1, 3))
        gg, tc = torch.tanh(want[:, 2 * H:3 * H]), torch.tanh(c_all[1, t])
        np.testing.assert_allclose(
            prefac[k].numpy(), torch.cat([gg * (i - i * i), c_prev * (f - f * f),
                                          i - gg * (i * gg), tc * (o - o * o)], -1).numpy(),
            atol=1e-6)
        np.testing.assert_allclose(qf[k].numpy(), torch.cat([o - o * tc * tc, f], -1).numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("first", [True, False], ids=["t0", "later"])
def test_group_products_sum_to_the_layer_products(first):
    """The products of a chunk in groups of 2 steps: the groups add up to
    the products over the whole chunk (`_products_ref`, whose h pairs with
    the next step's dgates), at t = 0 with h_prev's zero step, and the
    chain is `_products_ref`'s."""
    rng = np.random.default_rng(320)
    dgates, inp, h = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                      for s in ((5, B, 4 * H), (5, B, C), (6, B, H)))
    w_ih = torch.from_numpy(rng.normal(size=(C, 4 * H)).astype(np.float32))
    h_prev = ls._shifted(h[1:5], 5) if first else h[:5]
    part, chain = ls._rc_products_ref(dgates, inp, h_prev, w_ih, "gup", 2 * B)
    assert part.shape == (3, (C + H + 1) * 4 * H)
    # _products_ref's h[s] pairs with dgates[s + 1]; its dgates[0] has no h term
    full = torch.cat([torch.zeros(1, B, 4 * H), dgates]) if not first else dgates
    hw = h[:6] if not first else h[1:6]
    want = ls._products_ref(full, torch.cat([torch.zeros(1, B, C), inp]) if not first else inp,
                            hw, w_ih, "gup")
    flat = part.sum(0)
    G = 4 * H
    np.testing.assert_allclose(flat[:C * G].view(C, G).numpy(), want[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(flat[C * G:(C + H) * G].view(H, G).numpy(), want[1].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(flat[(C + H) * G:].numpy(), want[2].numpy(), atol=1e-5)
    np.testing.assert_allclose(chain.numpy(), want[3][-5:].numpy(), atol=1e-5)


def test_rules_and_cpu_wrappers():
    """`rc_group` and `rc_chunk` give a chunk that is a multiple of the group
    or the whole sequence; the pieces' wrappers take their plain versions on
    CPU tensors and count no launch."""
    for T_, B_ in ((460, 1024), (300, 1024), (460, 16), (7, 5), (1, 1)):
        group = ls.rc_group(B_)
        chunk = ls.rc_chunk(T_, B_, group)
        assert chunk % group == 0 and chunk >= 1
    ls.reset_launches()
    _, g, xt, lt, (h_all, c_all) = pallas_case(1, False)
    w_ih, w_hh, b = lt[0]
    h_prev = ls._shifted(h_all[0, :-1], T)
    gates = ls.rc_gates(xt, h_prev, w_ih, w_hh, b)
    torch.testing.assert_close(gates, ls._rc_gates_ref(xt, h_prev, w_ih, w_hh, b),
                               rtol=0, atol=0)
    carry = torch.zeros(2, B, H)
    dg = ls.rc_scan(g, gates, c_all[0], ls._shifted(c_all[0, :-1], T), w_hh, carry)
    assert carry.abs().sum() > 0
    part, dx = ls.rc_products(dg, xt, h_prev, w_ih, "dx", B)
    assert part.shape == (T, (C + H + 1) * 4 * H) and dx.shape == (T, B, C)
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES
    assert {"rc_gates", "rc_scan", "rc_products"} <= set(ls.LAUNCHES)
