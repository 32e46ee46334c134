"""The stack forwards K1/K3 as the wavefront CUDA path composes them — the
batch in tiles of 16 rows, zero rows past B; at iteration s every layer l
running its step t = s − l on the input the layer below put into its ring
an iteration before — through its plain layer-step on the CPU
(`_fwd_wave_ref`), against the per-step plain K1/K3 (`_fwd_train_ref`,
`_fwd_infer_last_ref`) and the JAX package's Pallas `_fwd_train_impl` /
`_fwd_infer_last_impl` in interpret mode, over L of 1 to 3 and batches
ragged against the tile; and `fwd_path`'s choice of path. Tolerances as
tests/test_torch_lstm_fwd_layerwise.py: f32 values atol 1e-5; bf16 against
Pallas atol 1e-2 (a flipped rounding in the recurrence moves h by a bf16
ulp or two)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_lstm_stack import _fwd_infer_last_impl, _fwd_train_impl
from cerebra_torch.models import lstm_stack as ls
from tests.test_torch_lstm_stack import make_case, to_jax, to_torch

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
BF16, F32 = torch.bfloat16, torch.float32


def pallas_forwards(x, layers, jdt):
    """The Pallas training forward's (h_all, prefac, qf) stacked over the
    layers and the last-step forward's top h (B, H), as f32 numpy arrays."""
    xj, lj = to_jax(x, layers, jdt)
    outs = _fwd_train_impl(xj, lj)
    L = len(layers)
    train = [np.stack([np.asarray(outs[3 * l + k], np.float32) for l in range(L)])
             for k in range(3)]
    return train, np.asarray(_fwd_infer_last_impl(xj, lj), np.float32)


@pytest.mark.parametrize("B", [13, 17, 33])
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_wave_matches_refs_and_pallas(dt, L, B):
    """K1's h_all, prefac and qf and K3's h[T−1] through the wavefront
    composition, against the per-step plain versions and the Pallas
    kernels, with batches of one ragged tile, a tile and one row, and two
    tiles and one row; C ≠ H, so layer 0's input is wider than the rest."""
    jdt, tdt, atol = DTYPES[dt]
    x, layers = make_case(T=6, B=B, C=32, H=16, L=L, seed=400 + 10 * L + B)
    xt, lt = to_torch(x, layers, tdt)
    got = ls._fwd_wave_ref(xt, lt, "fwd_train")
    got_top = ls._fwd_wave_ref(xt, lt, "fwd_infer_last")
    want, want_top = pallas_forwards(x, layers, jdt)
    for name, a, b, r in zip(("h_all", "prefac", "qf"), got, want, ls._fwd_train_ref(xt, lt)):
        assert a.dtype == tdt and a.shape == r.shape
        np.testing.assert_allclose(a.float().numpy(), b, atol=atol, err_msg=f"{name} vs Pallas")
        np.testing.assert_allclose(a.float().numpy(), r.float().numpy(), atol=atol,
                                   err_msg=f"{name} vs _fwd_train_ref")
    assert got_top.dtype == tdt and got_top.shape == (B, 16)
    np.testing.assert_allclose(got_top.float().numpy(), want_top, atol=atol)
    np.testing.assert_allclose(got_top.float().numpy(),
                               ls._fwd_infer_last_ref(xt, lt).float().numpy(), atol=atol)
    torch.testing.assert_close(got_top, got[0][-1, -1], rtol=0, atol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_wave_step_is_a_step_of_the_plain_forward(dt):
    """One layer-step, (inp·W_ih + h·W_hh) + b and the f32 cell, from zero
    carries: K1's first step bit for bit, its residuals in the stream dtype,
    c in f32; without `res` the same h and c and no residuals."""
    _, tdt, _ = DTYPES[dt]
    x, layers = make_case(T=1, B=16, C=32, H=16, L=1, seed=420)
    xt, lt = to_torch(x, layers, tdt)
    h0, c0 = torch.zeros(16, 16, dtype=tdt), torch.zeros(16, 16)
    h, c, pf, q = ls._wave_step_ref(xt[0], h0, c0, *lt[0], res=True)
    assert h.dtype == tdt and c.dtype == torch.float32
    for a, r in zip((h, pf, q), ls._fwd_train_ref(xt, lt)):
        torch.testing.assert_close(a, r[0, 0], rtol=0, atol=0)
    h2, c2, pf2, q2 = ls._wave_step_ref(xt[0], h0, c0, *lt[0], res=False)
    assert pf2 is None and q2 is None
    torch.testing.assert_close(h2, h, rtol=0, atol=0)
    torch.testing.assert_close(c2, c, rtol=0, atol=0)


@pytest.mark.parametrize("L", [1, 2, 3])
def test_wave_runs_each_step_once_behind_the_layer_below(L):
    """The schedule over one ragged tile: T + L − 1 iterations, in which
    layer l, bottom first, runs step t = s − l once, on x_t with zero rows
    past B (layer 0) or the very h_t the layer below returned for that step,
    and on its own h_{t−1} (zeros at t = 0)."""
    T, B, C, H = 5, 13, 8, 4
    x, layers = make_case(T=T, B=B, C=C, H=H, L=L, seed=430 + L)
    xt, lt = to_torch(x, layers)
    calls, hs = [], {}

    def step(l, inp, h, c, res):
        t = sum(1 for k, _ in calls if k == l)
        calls.append((l, t))
        if l == 0:
            want = torch.zeros(16, C)
            want[:B] = xt[t]
            torch.testing.assert_close(inp, want, rtol=0, atol=0)
        else:
            assert inp is hs[l - 1, t]
        if t == 0:
            assert not h.any() and not c.any()
        else:
            assert h is hs[l, t - 1]
        out = ls._wave_step_ref(inp, h, c, *lt[l], res)
        hs[l, t] = out[0]
        return out

    got = ls._fwd_wave(xt, lt, "fwd_train", step)
    assert calls == [(l, s - l) for s in range(T + L - 1) for l in range(L) if 0 <= s - l < T]
    for a, r in zip(got, ls._fwd_train_ref(xt, lt)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_fwd_path_rule():
    """K1, K3, K4 and K10 in bf16 at the CLI's widths (C = H = 96, L = 2)
    take the wavefront path at every batch: the bench step's 1024, the
    CLI's validation 960 and 240, its train batch 16, a ragged 13 and 1.
    f32 and the widths whose weights overflow a CTA (the DINO-LSTM's H =
    128, the autoencoder's) keep the earlier paths for K1; K3 in f32 takes
    the layer-by-layer path at every batch; K3, K4 and K10 at H = 128 take
    the split layer (tests/test_torch_lstm_fwd_wave_modes.py holds the rest
    of the rule there)."""
    for B in (1024, 960, 240, 16, 13, 1):
        for kind in ("fwd_train", "fwd_infer_last", "fwd_infer", "fwd_train_rc"):
            assert ls.fwd_path(B, 96, 96, 2, BF16, kind) == "wave", (B, kind)
        assert ls.fwd_path(B, 96, 96, 2, F32, "fwd_infer_last") == "cluster"
        assert ls.fwd_path(B, 96, 96, 2, F32, "fwd_train_rc") == "stack"
    assert ls.fwd_path(16, 96, 96, 2, F32, "fwd_infer") == "cluster"
    assert ls.fwd_path(1024, 96, 96, 2, F32, "fwd_infer") == "stack"
    assert ls.fwd_path(16, 96, 96, 2, F32, "fwd_train") == "cluster"
    assert ls.fwd_path(1024, 96, 96, 2, F32, "fwd_train") == "stack"
    assert ls.fwd_path(1024, 96, 128, 4, BF16, "fwd_train") == "stack"
    for C, H in ((96, 384), (384, 96)):
        assert ls.fwd_path(16, C, H, 1, BF16, "fwd_train") == "cluster"
        assert ls.fwd_path(16, C, H, 1, BF16, "fwd_infer_last") == "stack"
    assert ls.fwd_path(1024, 96, 96, 3, BF16, "fwd_train") == "wave"
    assert ls.fwd_path(1024, 96, 96, 9, BF16, "fwd_train") == "stack"  # > 8 CTAs a cluster


def test_wave_fits_follows_the_kernel_layout():
    """`wave_smem` counts the kernel's shared memory: in bf16 the 4H
    columns of [W_ih; W_hh] padded to max(C, H) + H + 8 values, the input
    ring (4, 16, max(C, H) + 8) and h (2, 16, H + 8), then two 8-byte
    mbarriers a ring slot; `wave_fits` wants C and H multiples of 16, H ≤ 96
    (384 threads) and the bytes within one block."""
    assert ls.wave_smem(96, 96) == 2 * (384 * 200 + 4 * 16 * 104 + 2 * 16 * 104) + 64 == 173632
    assert ls.wave_smem(384, 96) == 2 * (384 * 488 + 4 * 16 * 392 + 2 * 16 * 104) + 64
    assert ls.wave_fits(96, 96, 2, BF16) and ls.wave_fits(32, 64, 3, BF16)
    assert ls.wave_fits(128, 48, 2, BF16)
    assert not ls.wave_fits(96, 96, 2, F32)
    assert not ls.wave_fits(96, 88, 2, BF16)  # H not a multiple of 16
    assert not ls.wave_fits(40, 96, 2, BF16)  # C not a multiple of 16
    assert not ls.wave_fits(96, 112, 2, BF16)  # 448 threads
    assert not ls.wave_fits(384, 96, 1, BF16) and ls.wave_smem(384, 96) > ls._MAX_SMEM
    assert not ls.wave_fits(96, 96, 9, BF16)


def test_cpu_forwards_take_plain_path():
    """On CPU tensors `fwd_train` and `fwd_infer_last` are the per-step plain
    versions whatever `fwd_path` would pick on the card; no launch is
    counted."""
    ls.reset_launches()
    x, layers = make_case(T=5, B=13, C=32, H=16, L=2, seed=440)
    xt, lt = to_torch(x, layers, torch.bfloat16)
    assert ls.fwd_path(13, 32, 16, 2, BF16, "fwd_train") == "wave"
    for a, b in zip(ls.fwd_train(xt, lt), ls._fwd_train_ref(xt, lt)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ls.fwd_infer_last(xt, lt), ls._fwd_infer_last_ref(xt, lt),
                               rtol=0, atol=0)
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES
    assert "fwd_wave" in ls.LAUNCHES
