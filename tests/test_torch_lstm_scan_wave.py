"""K12 and K13 as the scan's wavefront CUDA forward composes them
(`_scan_wave_ref`: 16-row tiles, zero rows past B; with two CTAs a tile,
each half of the units from its own columns of x_proj and W_hh) against the
JAX package's Pallas kernels in interpret mode and against the port's plain
versions, at ragged and whole tiles, H 16 and 32, one and two CTAs a tile;
the rules that route K12/K13 (`scan_wave_fits`, `scan_wave_smem`,
`scan_path`); the CPU wrappers' plain path. Tolerances as
tests/test_torch_lstm_scan.py: f32 atol 1e-5, bf16 atol 1e-2 (a flipped
bf16 rounding of h moves it by an ulp or two)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models import pallas_lstm as pl_lstm
from cerebra_torch.kernels import reset_launches
from cerebra_torch.models import lstm_scan as sc

torch.set_num_threads(1)

BF16 = torch.bfloat16
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, BF16)}
ATOL = {"f32": 1e-5, "bf16": 1e-2}
T = 5


def make_case(B, H, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(T, B, 4 * H)) * 0.5).astype(np.float32),
            (rng.normal(size=(H, 4 * H)) * 0.3).astype(np.float32))


def torch_case(dt, B, H, seed):
    xp, w = make_case(B, H, seed)
    tdt = DTYPES[dt][1]
    return torch.from_numpy(xp).to(tdt), torch.from_numpy(w).to(tdt)


@functools.lru_cache(maxsize=None)
def pallas_outputs(dt, B, H, seed):
    """K12's h_all and K13's (h_all, prefac, qf) from the Pallas kernels in
    interpret mode, as f32 numpy arrays."""
    xp, w = make_case(B, H, seed)
    jdt = DTYPES[dt][0]
    xj, wj = jnp.asarray(xp, jdt), jnp.asarray(w, jdt)
    infer = np.asarray(pl_lstm._fwd_infer_impl(xj, wj, 1024), np.float32)
    train = tuple(np.asarray(a, np.float32) for a in pl_lstm._fwd_train_impl(xj, wj, 1024))
    return infer, train


@pytest.mark.parametrize("H", [16, 32])
@pytest.mark.parametrize("B", [16, 13, 40])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_wave_composition_matches_pallas(dt, ns, B, H):
    """K12's h_all and K13's h_all, prefac and qf through the composition,
    one tile, a ragged tile and a whole plus a ragged one."""
    xt, wt = torch_case(dt, B, H, seed=B + H)
    want_infer, want_train = pallas_outputs(dt, B, H, B + H)
    got = sc._scan_wave_ref(xt, wt, False, ns)
    assert got.dtype == xt.dtype and tuple(got.shape) == (T, B, H)
    np.testing.assert_allclose(got.float().numpy(), want_infer, atol=ATOL[dt])
    for name, a, b in zip(("h_all", "prefac", "qf"), sc._scan_wave_ref(xt, wt, True, ns),
                          want_train):
        np.testing.assert_allclose(a.float().numpy(), b, atol=ATOL[dt], err_msg=name)


@pytest.mark.parametrize("B", [16, 13, 40])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_wave_composition_matches_plain(dt, ns, B):
    """The composition against `_scan_fwd_infer_ref` / `_scan_fwd_train_ref`
    (one batch, all 4H columns at once): the tiles and the split change only
    the order of f32 sums."""
    xt, wt = torch_case(dt, B, 32, seed=100 + B)
    np.testing.assert_allclose(sc._scan_wave_ref(xt, wt, False, ns).float().numpy(),
                               sc._scan_fwd_infer_ref(xt, wt).float().numpy(), atol=ATOL[dt])
    for name, a, b in zip(("h_all", "prefac", "qf"), sc._scan_wave_ref(xt, wt, True, ns),
                          sc._scan_fwd_train_ref(xt, wt)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=ATOL[dt],
                                   err_msg=name)


def test_wave_composition_rejects_an_uneven_split():
    xt, wt = torch_case("f32", 4, 6, seed=1)
    with pytest.raises(ValueError):
        sc._scan_wave_ref(xt, wt, False, 4)


def test_scan_wave_fits_follows_the_kernel_layout():
    """`scan_wave_smem` counts the kernel's shared memory: in bf16 the 4H/ns
    columns of w_hh padded to H + 8 values, the 4-slot x_proj ring of 16 rows
    padded to 4H/ns + 8, h (2, 16, H + 8) and, split, two 8-byte mbarriers;
    `scan_wave_fits` takes bf16, H a multiple of 16 ns and 4H/ns threads
    within 384."""
    assert sc.scan_wave_smem(96, 1) == 2 * (384 * 104 + 4 * 16 * 392 + 2 * 16 * 104) == 136704
    assert sc.scan_wave_smem(96, 2) == 2 * (192 * 104 + 4 * 16 * 200 + 2 * 16 * 104) + 16 == 72208
    assert sc.scan_wave_fits(96, BF16, 1) and sc.scan_wave_fits(96, BF16, 2)
    assert not sc.scan_wave_fits(96, torch.float32, 1)
    assert not sc.scan_wave_fits(96, torch.float32, 2)
    assert not sc.scan_wave_fits(128, BF16, 1) and sc.scan_wave_fits(128, BF16, 2)  # 512 threads
    assert not sc.scan_wave_fits(384, BF16, 1) and not sc.scan_wave_fits(384, BF16, 2)
    assert sc.scan_wave_fits(48, BF16, 1) and not sc.scan_wave_fits(48, BF16, 2)  # U = 24
    assert not sc.scan_wave_fits(40, BF16, 1) and not sc.scan_wave_fits(96, BF16, 3)
    assert all(sc.scan_wave_smem(H, ns) <= sc._MAX_SMEM
               for H in range(16, 97, 16) for ns in (1, 2) if sc.scan_wave_fits(H, BF16, ns))


@pytest.mark.parametrize("B, H, dtype, clusters, want", [
    (1024, 96, BF16, (132, 132), 2),  # one wave either way: two CTAs a tile
    (16, 96, BF16, (132, 132), 2),
    (2048, 96, BF16, (132, 132), 2),
    (4096, 96, BF16, (300, 100), 1),  # 256 tiles: one wave of one CTA, three of two
    (1024, 96, torch.float32, (132, 132), 0),  # f32 keeps scan_fwd_kernel
    (1024, 128, BF16, (0, 132), 2),  # 512 threads unsplit
    (1024, 48, BF16, (132, 0), 1),  # U = 24 does not split
    (1024, 384, BF16, (0, 0), 0),
    (13, 40, BF16, (0, 0), 0),
    (1024, 96, BF16, (132, 0), 1),  # the card holds no split cluster
])
def test_scan_path_rule(B, H, dtype, clusters, want):
    assert sc.scan_path(B, H, dtype, clusters) == want


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cpu_wrappers_take_plain_path(dt):
    """On CPU tensors K12, K13 and lstm_scan's gradient run the plain
    versions, with no launch counted, at a width the wavefront forward takes."""
    xt, wt = torch_case(dt, 16, 32, seed=7)
    reset_launches()
    assert torch.equal(sc.scan_fwd_infer(xt, wt), sc._scan_fwd_infer_ref(xt, wt))
    for a, b in zip(sc.scan_fwd_train(xt, wt), sc._scan_fwd_train_ref(xt, wt)):
        assert torch.equal(a, b)
    xs = xt.clone().requires_grad_(True)
    sc.lstm_scan(xs, wt).float().sum().backward()
    assert torch.isfinite(xs.grad.float()).all()
    assert {"scan_fwd_wave", "scan_fwd_wave_split"} <= set(sc.LAUNCHES)
    assert all(v == 0 for v in sc.LAUNCHES.values()), sc.LAUNCHES
