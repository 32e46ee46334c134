"""The stack forwards K1/K4 as the layer-by-layer CUDA path composes them —
per layer, bottom first, the input product over all T·B rows and then the
recurrence over it (`_fwd_layerwise`) — through its plain pieces on the CPU
(`_in_product_ref`, `_fwd_scan_ref`), against the per-step plain K1/K4
(`_fwd_train_ref`, `_fwd_infer_ref`) and the JAX package's Pallas
`_fwd_train_impl` / `_fwd_infer_impl` in interpret mode, over L of 1 to 3
and ragged batches; K3 in f32 on the same path (the top layer's scan
writes only h at T−1) against `_fwd_infer_last_impl`, L of 1 to 4; and
`pick_fwd`'s choice of path. Tolerances: f32 values
atol 1e-5 (tests/test_torch_lstm_stack.py); bf16 against Pallas atol 1e-2
(tests/test_torch_lstm_stack_seq.py: a flipped rounding in the recurrence
moves h by a bf16 ulp or two)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_lstm_stack import (
    _fwd_infer_impl,
    _fwd_infer_last_impl,
    _fwd_train_impl,
)
from cerebra_torch.models import lstm_stack as ls
from tests.test_torch_lstm_stack import make_case, to_jax, to_torch

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def pallas_forwards(x, layers, jdt):
    """The Pallas training forward's (h_all, prefac, qf) stacked over the
    layers and the inference forward's top h, as f32 numpy arrays."""
    xj, lj = to_jax(x, layers, jdt)
    outs = _fwd_train_impl(xj, lj)
    L = len(layers)
    train = [np.stack([np.asarray(outs[3 * l + k], np.float32) for l in range(L)])
             for k in range(3)]
    return train, np.asarray(_fwd_infer_impl(xj, lj), np.float32)


@pytest.mark.parametrize("B", [5, 17])
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_layerwise_matches_refs_and_pallas(dt, L, B):
    """K1's h_all, prefac and qf and K4's top h through the plain pieces,
    against the per-step plain versions and the Pallas kernels, with a
    batch that is not a multiple of the 16-row tile."""
    jdt, tdt, atol = DTYPES[dt]
    x, layers = make_case(T=6, B=B, C=5, H=8, L=L, seed=300 + 10 * L + B)
    xt, lt = to_torch(x, layers, tdt)
    got = ls._fwd_layerwise_ref(xt, lt, train=True)
    got_top = ls._fwd_layerwise_ref(xt, lt, train=False)
    want, want_top = pallas_forwards(x, layers, jdt)
    for name, a, b, r in zip(("h_all", "prefac", "qf"), got, want, ls._fwd_train_ref(xt, lt)):
        assert a.dtype == tdt and a.shape == r.shape
        np.testing.assert_allclose(a.float().numpy(), b, atol=atol, err_msg=f"{name} vs Pallas")
        np.testing.assert_allclose(a.float().numpy(), r.float().numpy(), atol=atol,
                                   err_msg=f"{name} vs _fwd_train_ref")
    assert got_top.dtype == tdt
    np.testing.assert_allclose(got_top.float().numpy(), want_top, atol=atol)
    np.testing.assert_allclose(got_top.float().numpy(),
                               ls._fwd_infer_ref(xt, lt).float().numpy(), atol=atol)
    torch.testing.assert_close(got_top, got[0][-1], rtol=0, atol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_in_product_is_the_f32_product_of_the_stream_values(dt):
    """P = inp·W_ih over all T·B rows in f32, no bias and no rounding: each
    element within f32 summation error of the float64 product of the
    stream-dtype values."""
    _, tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(310)
    inp = torch.from_numpy(rng.normal(size=(6, 13, 24)).astype(np.float32)).to(tdt)
    w_ih = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32) * 0.3).to(tdt)
    P = ls._in_product_ref(inp, w_ih)
    assert P.dtype == torch.float32 and P.shape == (6, 13, 40)
    want = inp.double().numpy() @ w_ih.double().numpy()
    np.testing.assert_allclose(P.numpy(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_scan_adds_the_bias_last(dt):
    """The scan forms (P + h·W_hh) + b: over a P that carries x·W_ih it
    gives the 1-layer per-step K1 bit for bit (the same f32 operations), and
    without `res` it returns h alone."""
    _, tdt, _ = DTYPES[dt]
    x, layers = make_case(T=7, B=13, C=6, H=8, L=1, seed=320)
    xt, lt = to_torch(x, layers, tdt)
    w_ih, w_hh, b = lt[0]
    P = ls._in_product_ref(xt, w_ih)
    h, prefac, qf = ls._fwd_scan_ref(P, w_hh, b, res=True)
    for a, r in zip((h, prefac, qf), ls._fwd_train_ref(xt, lt)):
        torch.testing.assert_close(a, r[0], rtol=0, atol=0)
    h_only = ls._fwd_scan_ref(P, w_hh, b)
    assert h_only[1] is None and h_only[2] is None
    torch.testing.assert_close(h_only[0], h, rtol=0, atol=0)


def test_cpu_pieces_take_plain_path():
    """On CPU tensors `fwd_in_product` and `fwd_cluster_scan` are the plain
    pieces, `fwd_train` and `fwd_infer` the per-step plain versions; no
    launch is counted."""
    ls.reset_launches()
    x, layers = make_case(T=5, B=5, C=6, H=4, L=2, seed=330)
    xt, lt = to_torch(x, layers)
    P = ls.fwd_in_product(xt, lt[0][0])
    torch.testing.assert_close(P, ls._in_product_ref(xt, lt[0][0]), rtol=0, atol=0)
    for a, b in zip(ls.fwd_cluster_scan(P, lt[0][1], lt[0][2], res=True),
                    ls._fwd_scan_ref(P, lt[0][1], lt[0][2], res=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(ls.fwd_train(xt, lt), ls._fwd_train_ref(xt, lt)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ls.fwd_infer(xt, lt), ls._fwd_infer_ref(xt, lt), rtol=0, atol=0)
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES
    assert {"fwd_in_product", "fwd_cluster_scan"} <= set(ls.LAUNCHES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pick_fwd_choices(dtype):
    """Both autoencoder widths at B = 16 and 13 take the layer-by-layer
    path at a cluster size whose CTAs fit in shared memory (f32 at H = 384
    only with 16 CTAs); B = 1024 at the CLI's widths, and a width whose
    W_hh slice fits no CTA, get no cluster size (0). Under `fwd_path` K1 at
    the CLI's widths takes the wavefront path in bf16 at every batch, and
    otherwise `pick_fwd`'s cluster or `lstm_fwd_kernel`."""
    for C, H in ((96, 384), (384, 96)):
        for B in (16, 13):
            n = ls.pick_fwd(B, C, H, 1, dtype)
            assert n in ls.cluster_sizes(H, dtype), (C, H, B, n)
            assert H % n == 0 and ls.cluster_smem(H, n, dtype) <= ls._MAX_SMEM
    assert ls.cluster_sizes(384, torch.float32) == (16,)
    # the sizes the card timed fastest: 16 CTAs at H = 384; at H = 96, 8 in
    # bf16 (each CTA keeps 12 units) and 16 in f32
    assert ls.pick_fwd(16, 96, 384, 1, dtype) == 16
    assert ls.pick_fwd(16, 384, 96, 1, dtype) == (8 if dtype == torch.bfloat16 else 16)
    assert ls.pick_fwd(1024, 96, 96, 2, dtype) == 0
    bf16 = dtype == torch.bfloat16
    assert ls.fwd_path(1024, 96, 96, 2, dtype, "fwd_train") == ("wave" if bf16 else "stack")
    assert ls.fwd_path(16, 96, 96, 2, dtype, "fwd_train") == ("wave" if bf16 else "cluster")
    assert ls.pick_fwd(1024, 96, 384, 1, dtype) == 0
    assert ls.cluster_sizes(2048, dtype) == () and ls.pick_fwd(16, 96, 2048, 1, dtype) == 0
    # the CLI's shape (B = 16, C = H = 96, L = 2), which K4 and the f32 K1 run
    # on the cluster path: the size the card timed fastest
    assert ls.pick_fwd(16, 96, 96, 2, dtype) == ls.pick_fwd(16, 384, 96, 1, dtype)


def test_pick_fwd_sizes_follow_the_kernel_layout():
    """`cluster_smem` counts the kernels' shared memory. f32: the slice of
    W_hh (H x 4H/n), h double-buffered (2, H, 16), the gates (16, 4H/n) and
    c (16, H/n); 8 CTAs at H = 384 would need 288 KiB for W_hh alone. bf16:
    the slice (4H/n, H + 8) and h (2, 16, H + 8) in bf16, then the gates and
    c in f32; the tensor-core step needs H a multiple of 16 and H/n even."""
    assert ls.cluster_smem(384, 16, torch.float32) == 4 * (384 * 96 + 16 * (768 + 5 * 24))
    assert ls.cluster_smem(384, 8, torch.float32) > ls._MAX_SMEM
    assert ls.cluster_smem(384, 16, torch.bfloat16) == 2 * (96 + 32) * 392 + 4 * 16 * 5 * 24
    assert ls.cluster_sizes(10, torch.float32) == (2, 1)
    assert ls.cluster_sizes(10, torch.bfloat16) == ()
    assert ls.cluster_sizes(96, torch.bfloat16) == (16, 8, 4, 2, 1)
    assert ls.cluster_sizes(48, torch.bfloat16) == (8, 4, 2, 1)  # 16 CTAs: 3 units, odd


@pytest.mark.parametrize("B", [5, 21])
@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_k3_last_state_composition_matches_pallas(L, B):
    """K3 in f32 as the layer-by-layer path composes it (the lower layers'
    h in one buffer, the top layer's scan writing h at T−1 alone): against
    the Pallas `_fwd_infer_last_impl` in interpret mode and the per-step
    plain K3 at 1e-5, with batches ragged against the 16-row tile; the top
    layer's last-state scan is the full scan's last step bit for bit."""
    x, layers = make_case(T=7, B=B, C=6, H=8, L=L, seed=340 + 10 * L + B)
    xt, lt = to_torch(x, layers)
    got = ls._fwd_layerwise_ref(xt, lt, train=False, last=True)
    assert got.shape == (B, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(_fwd_infer_last_impl(*to_jax(x, layers))),
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ls._fwd_infer_last_ref(xt, lt).numpy(), atol=1e-5)
    torch.testing.assert_close(got, ls._fwd_layerwise_ref(xt, lt, train=False)[-1], rtol=0,
                               atol=0)
    P = ls._in_product_ref(xt, lt[0][0])
    h_last, prefac, qf = ls.fwd_cluster_scan(P, lt[0][1], lt[0][2], last=True)
    assert prefac is None and qf is None
    torch.testing.assert_close(h_last, ls._fwd_scan_ref(P, lt[0][1], lt[0][2])[0][-1], rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="residuals"):
        ls._fwd_scan_ref(P, lt[0][1], lt[0][2], res=True, last=True)


def test_k3_in_f32_takes_the_layerwise_path():
    """K3 in f32 runs the layer-by-layer path at every batch, with the
    largest cluster whose clusters all fit the card's 132 SMs at once: the
    eval's galleries (C 96, H 128, L 4) at B = 320 (20 tiles of 16) in
    clusters of 4 CTAs, at B = 80 (5 tiles) of 16; more tiles than 132
    single CTAs hold run the smallest cluster in waves. In bf16 K3 keeps
    the wavefront forward (split at H = 128) and never this path."""
    F32 = torch.float32
    for B, n in ((320, 4), (80, 16), (16, 16), (13, 16), (1024, 2)):
        assert ls.pick_fwd(B, 96, 128, 4, F32, "fwd_infer_last") == n, B
        assert ls.fwd_path(B, 96, 128, 4, F32, "fwd_infer_last") == "cluster", B
    assert ls.pick_fwd(320, 96, 96, 2, F32, "fwd_infer_last") == 4
    assert ls.pick_fwd(4000, 96, 128, 4, F32, "fwd_infer_last") == 2  # waves
    assert ls.pick_fwd(320, 96, 128, 4, F32) == 0  # K1 and K4 keep B <= 64
    assert ls.pick_fwd(320, 96, 128, 4, torch.bfloat16, "fwd_infer_last") == 0
    assert ls.fwd_path(320, 96, 128, 4, torch.bfloat16, "fwd_infer_last") == "split"
