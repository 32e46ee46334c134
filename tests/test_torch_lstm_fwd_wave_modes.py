"""The stack forwards K10 (the recompute stack's training forward, h_all
and c_all) and K4 (the whole-sequence no-grad forward, the top layer's h at
every t) as the wavefront CUDA path composes them (`_fwd_wave_ref`), with a
CTA a layer and with the split layer (two CTAs a layer, each computing the
gates of half the units from its own weight columns, `_split_step_ref`),
through their plain layer-steps on the CPU, against the per-step plain
K10/K4 (`_fwd_train_rc_ref`, `_fwd_infer_ref`) and the JAX package's Pallas
`_fwd_train_rc_impl` / `_fwd_infer_impl` in interpret mode, over L of 1 to
4 and batches ragged against the 16-row tile; `fwd_path`'s rule for them
and `wave_split_fits`. Tolerances as tests/test_torch_lstm_fwd_wave.py: f32
atol 1e-5; bf16 against Pallas atol 1e-2 (a flipped rounding in the
recurrence moves h by a bf16 ulp or two), and for c_all, whose values
exceed 1, also rtol 1e-2 (as tests/test_torch_lstm_stack_rc.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_lstm_stack import _fwd_infer_impl, _fwd_train_rc_impl
from cerebra_torch.models import lstm_stack as ls
from tests.test_torch_lstm_stack import make_case, to_jax, to_torch

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
BF16, F32 = torch.bfloat16, torch.float32
MODES = ("fwd_train_rc", "fwd_infer")


def pallas_modes(x, layers, jdt):
    """The Pallas recompute forward's (h_all, c_all) stacked over the layers
    and the sequence forward's top h (T, B, H), as f32 numpy arrays."""
    xj, lj = to_jax(x, layers, jdt)
    outs = _fwd_train_rc_impl(xj, lj)
    L = len(layers)
    rc = [np.stack([np.asarray(outs[2 * l + k], np.float32) for l in range(L)]) for k in (0, 1)]
    return rc, np.asarray(_fwd_infer_impl(xj, lj), np.float32)


@pytest.mark.parametrize("B", [13, 17, 33])
@pytest.mark.parametrize("L", [1, 2, 3, 4])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_modes_match_refs_and_pallas(dt, L, B):
    """K10's h_all and c_all and K4's top h through the wavefront
    composition and through the split one, against the per-step plain
    versions and the Pallas kernels, with batches of one ragged tile, a
    tile and one row, and two tiles and one row; C ≠ H, so layer 0's input
    is wider than the rest; H = 32, two CTAs of 16 units when split."""
    jdt, tdt, atol = DTYPES[dt]
    x, layers = make_case(T=6, B=B, C=48, H=32, L=L, seed=500 + 10 * L + B)
    xt, lt = to_torch(x, layers, tdt)
    (want_h, want_c), want_top = pallas_modes(x, layers, jdt)
    ref_h, ref_c = ls._fwd_train_rc_ref(xt, lt)
    ref_top = ls._fwd_infer_ref(xt, lt)
    for split in (False, True):
        tag = "split" if split else "wave"
        h_all, c_all = ls._fwd_wave_ref(xt, lt, "fwd_train_rc", split)
        top = ls._fwd_wave_ref(xt, lt, "fwd_infer", split)
        for name, a, b, r, rtol in (("h_all", h_all, want_h, ref_h, 0),
                                    ("c_all", c_all, want_c, ref_c, 0 if dt == "f32" else 1e-2),
                                    ("top h", top, want_top, ref_top, 0)):
            assert a.dtype == tdt and a.shape == r.shape, (tag, name)
            np.testing.assert_allclose(a.float().numpy(), b, atol=atol, rtol=rtol,
                                       err_msg=f"{tag} {name} vs Pallas")
            np.testing.assert_allclose(a.float().numpy(), r.float().numpy(), atol=atol,
                                       rtol=rtol, err_msg=f"{tag} {name} vs the per-step plain")
        assert top.shape == (6, B, 32)
        torch.testing.assert_close(top, h_all[-1], rtol=0, atol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_split_step_is_the_unsplit_step(dt):
    """One layer-step of the split layer, each half's gates from its own
    columns of W_ih, W_hh and b, then the halves concatenated: in bf16, the
    kernels' dtype, bit for bit the unsplit step (h, c and K1's residuals,
    which `[fwd paths]` times through the split); in f32 the CPU's matrix
    product may sum a narrower product in another order (atol 1e-6). From
    nonzero carries, so c and h at t − 1 take part."""
    _, tdt, _ = DTYPES[dt]
    x, layers = make_case(T=2, B=16, C=48, H=64, L=1, seed=520)
    xt, lt = to_torch(x, layers, tdt)
    rng = np.random.default_rng(521)
    h0 = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32) * 0.5).to(tdt)
    c0 = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    for res in (True, False):
        got = ls._split_step_ref(xt[0], h0, c0, *lt[0], res)
        want = ls._wave_step_ref(xt[0], h0, c0, *lt[0], res)
        for name, a, b in zip(("h", "c", "prefac", "qf"), got, want):
            if b is None:
                assert a is None, name
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, name
            torch.testing.assert_close(a, b, rtol=0, atol=0 if dt == "bf16" else 1e-6, msg=name)


@pytest.mark.parametrize("kind", ["fwd_train", "fwd_infer_last"])
def test_split_composition_runs_k1_and_k3(kind):
    """K1, which `fwd_path` does not send to the split layer (the card times
    it there as a record), and K3, which it sends there at H = 128, through
    the split composition in bf16: the wavefront composition's bits."""
    x, layers = make_case(T=5, B=19, C=48, H=32, L=3, seed=530)
    xt, lt = to_torch(x, layers, BF16)
    got, want = (ls._fwd_wave_ref(xt, lt, kind, split) for split in (True, False))
    for a, b in zip(*((got, want) if kind == "fwd_train" else ((got,), (want,)))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wave_refuses_other_kinds():
    x, layers = make_case(T=3, B=4, C=16, H=16, L=1, seed=540)
    xt, lt = to_torch(x, layers, BF16)
    with pytest.raises(ValueError):
        ls._fwd_wave_ref(xt, lt, "bwd")


@pytest.mark.parametrize("B", [1024, 960, 16, 13, 1])
def test_fwd_path_rule_for_k4_and_k10(B):
    """At the headline widths (C = H = 96, L = 2) K4 and K10 take the
    wavefront path at every batch, as K1 and K3 do; at the DINO-LSTM's
    (C 96, H 128, L 4) the split layer, as K3 does in bf16 there and at the
    Spampinato rig's C = H = 128, while K1 keeps its path (the
    layer-by-layer one at B ≤ 64, else `lstm_fwd_kernel`); at the
    autoencoder's widths K4 keeps the layer-by-layer path at B ≤ 64 and K10
    `lstm_fwd_kernel`; 5 layers at H = 128 (10 CTAs, no portable cluster)
    and f32 keep the earlier paths, but for K3 in f32, which takes the
    layer-by-layer path at every batch (the eval's galleries of 320 and 80
    among them)."""
    for kind in ("fwd_train", "fwd_infer_last", "fwd_infer", "fwd_train_rc"):
        assert ls.fwd_path(B, 96, 96, 2, BF16, kind) == "wave", kind
    for kind in MODES:
        assert ls.fwd_path(B, 96, 128, 4, BF16, kind) == "split", kind
        five = "cluster" if kind == "fwd_infer" and B <= 64 else "stack"
        assert ls.fwd_path(B, 96, 128, 5, BF16, kind) == five, kind
    small = B <= 64
    assert ls.fwd_path(B, 96, 128, 4, BF16, "fwd_train") == ("cluster" if small else "stack")
    assert ls.fwd_path(B, 96, 128, 4, BF16, "fwd_infer_last") == "split"
    assert ls.fwd_path(B, 128, 128, 4, BF16, "fwd_infer_last") == "split"
    assert ls.fwd_path(B, 96, 128, 4, F32, "fwd_infer_last") == "cluster"
    for C, H in ((96, 384), (384, 96)):
        assert ls.fwd_path(B, C, H, 1, BF16, "fwd_infer") == ("cluster" if small else "stack")
        assert ls.fwd_path(B, C, H, 1, BF16, "fwd_train_rc") == "stack"
    for C, H, L in ((96, 96, 2), (96, 128, 4)):
        assert ls.fwd_path(B, C, H, L, F32, "fwd_train_rc") == "stack"
        assert ls.fwd_path(B, C, H, L, F32, "fwd_infer") == ("cluster" if small else "stack")


def test_wave_split_fits_follows_the_kernel_layout():
    """`wave_split_smem` counts the split CTA's shared memory: the 2H
    columns of half the units padded to max(C, H) + H + 8 values, the same
    ring and h as `wave_smem`, and ten 8-byte mbarriers (full and empty a
    ring slot, one an h buffer); `wave_split_fits` wants bf16, C a multiple
    of 16, H of 32, H ≤ 192 (2H threads within 384), L ≤ 4 (8 CTAs) and
    the bytes within one block."""
    assert ls.wave_split_smem(96, 128) == 2 * (256 * 264 + 4 * 16 * 136 + 2 * 16 * 136) + 80
    assert ls.wave_split_smem(96, 128) == 161360
    assert ls.wave_split_smem(96, 96) == ls.wave_smem(96, 96) - 2 * 192 * 200 + 16
    assert ls.wave_split_fits(96, 128, 4, BF16) and ls.wave_split_fits(48, 32, 1, BF16)
    assert ls.wave_split_fits(96, 96, 2, BF16)  # fits both; fwd_path takes "wave" there
    assert not ls.wave_fits(96, 128, 4, BF16)
    assert not ls.wave_split_fits(96, 128, 4, F32)
    assert not ls.wave_split_fits(96, 128, 5, BF16)  # 10 CTAs a cluster
    assert not ls.wave_split_fits(96, 112, 2, BF16)  # H not a multiple of 32
    assert not ls.wave_split_fits(40, 128, 2, BF16)  # C not a multiple of 16
    assert not ls.wave_split_fits(96, 224, 1, BF16)  # 448 threads
    assert not ls.wave_split_fits(384, 96, 1, BF16) and ls.wave_split_smem(384, 96) > ls._MAX_SMEM
    assert not ls.wave_split_fits(96, 384, 1, BF16)


@pytest.mark.parametrize("C, H, L", [(32, 16, 2), (96, 128, 4)])
def test_cpu_forwards_take_plain_path(C, H, L):
    """On CPU tensors `fwd_train_rc` and `fwd_infer` (and `lstm_stack_rc`
    with and without grad) are the per-step plain versions whatever
    `fwd_path` would pick on the card; no launch is counted."""
    ls.reset_launches()
    x, layers = make_case(T=5, B=13, C=C, H=H, L=L, seed=550 + L)
    xt, lt = to_torch(x, layers, BF16)
    assert ls.fwd_path(13, C, H, L, BF16, "fwd_infer") == ("wave" if H == 16 else "split")
    for a, b in zip(ls.fwd_train_rc(xt, lt), ls._fwd_train_rc_ref(xt, lt)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ls.fwd_infer(xt, lt), ls._fwd_infer_ref(xt, lt), rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(ls.lstm_stack_rc(xt, lt), ls._fwd_infer_ref(xt, lt),
                                   rtol=0, atol=0)
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES
    assert "fwd_wave_split" in ls.LAUNCHES


@pytest.mark.parametrize("mt", [2, 3])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_split_tiles_of_more_rows(dt, mt):
    """The split layer in tiles of 32 or 48 rows (`split_tiles`' choice at
    large batches): rows are independent, so K10 and K4 are the 16-row
    tiles' values, bit for bit in bf16 (f32: the CPU's matrix product may
    block more rows otherwise, atol 1e-6), over batches ragged against
    every tile; and the per-step plain versions within the stated limits."""
    jdt, tdt, atol = DTYPES[dt]
    for B in (13, 40, 70):
        x, layers = make_case(T=5, B=B, C=48, H=32, L=2, seed=560 + B)
        xt, lt = to_torch(x, layers, tdt)
        for kind, ref in (("fwd_train_rc", ls._fwd_train_rc_ref), ("fwd_infer", ls._fwd_infer_ref)):
            got = ls._fwd_wave_ref(xt, lt, kind, True, mt)
            one = ls._fwd_wave_ref(xt, lt, kind, True, 1)
            want = ref(xt, lt)
            got, one, want = ((v,) if kind == "fwd_infer" else v for v in (got, one, want))
            for a, b, r in zip(got, one, want):
                torch.testing.assert_close(a, b, rtol=0, atol=0 if dt == "bf16" else 1e-6)
                np.testing.assert_allclose(a.float().numpy(), r.float().numpy(), atol=atol,
                                           rtol=0 if dt == "f32" else 1e-2)


def test_split_tiles_rule():
    """The fewest waves, then the fewest rows: with 15 clusters of 8 CTAs at
    once (the DINO-LSTM's 4 layers on an H100), B = 1024 (64 tiles of 16)
    takes 48 rows a cluster (2 waves; 32 rows: 3, 16 rows: 5), 960 takes
    32 (2 waves, as 48), 720 48 (1), 480 32 (1), 240 and the CLI's 16
    rows of 16; a tile that does not fit (0 clusters) is never taken."""
    q = (15, 15, 15)
    for B, mt in ((1024, 3), (960, 2), (720, 3), (480, 2), (241, 2), (240, 1), (16, 1), (13, 1)):
        assert ls.split_tiles(B, q) == mt, B
    assert ls.split_tiles(1024, (30, 30, 30)) == 3  # 2 layers: 30 clusters, 1 wave
    assert ls.split_tiles(1024, (15, 15, 0)) == 2
    assert ls.split_tiles(1024, (15, 0, 0)) == 1
    with pytest.raises(ValueError):
        ls.split_tiles(16, (0, 0, 0))
    assert ls.wave_split_smem(96, 128, 3) <= ls._MAX_SMEM < ls._wave_cta_smem(96, 128, 2, 4)
