"""K8, the fused ViT MLP backward, as the CUDA path composes it in bf16: dn
and db2 in one pass, the fused dh piece (gh, dhn and db1's partials per row
tile, h and dh never stored), the split-row contractions dW2 = ghᵀ·dn and
dW1 = yᵀ·dhn, dy = dhn·W1ᵀ and the LN backward. Run through the pieces'
plain versions, as a CPU tensor takes them, and held against the port's
plain K8 (`_mlp_bwd_ref`) and against the JAX package's Pallas
`fused_mlp_residual` VJP in interpret mode, at D 32, F 96, M 32 and 37
(ragged), f32 and bf16, with and without the drop-path scale.

Tolerances. Against `_mlp_bwd_ref` with one row tile and one row chunk:
bit for bit (the same operations in the same order). With several tiles
and chunks only the order of the f32 sums over rows moves: each gradient
within 1e-6 of its largest entry. Against JAX, tests/test_torch_vit_kernels.py's
limits for its reasons: f32 values 2e-5 abs and each gradient 2e-5 of its
largest entry; bf16 every output relative Frobenius 1e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_vit_mlp import fused_mlp_residual as jax_mlp
from cerebra_torch.kernels import LAUNCHES
from cerebra_torch.models import vit_mlp as vm

torch.set_num_threads(1)

D, F = 32, 96
KEEP = 0.9
DTYPES = {"f32": (None, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ["dx", "dg", "db", "dw1", "db1", "dw2", "db2"]
CHUNKED = dict(rows=16, splits=3)  # several row tiles and chunks, the last ones ragged


def _inputs(M, scaled, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, D)).astype(np.float32)
    shapes = [(D,), (D,), (D, F), (F,), (F, D), (D,)]
    scales = [0.1, 0.1, 0.1, 0.05, 0.1, 0.05]
    params = [(rng.normal(size=sh) * sc + (1.0 if i == 0 else 0.0)).astype(np.float32)
              for i, (sh, sc) in enumerate(zip(shapes, scales))]
    ct = rng.normal(size=(M, D)).astype(np.float32)
    s = None
    if scaled:
        s = np.full(M, 1.0 / KEEP, np.float32)
        s[0] = 0.0  # one row dropped
    return x, params, ct, s


def _torch_case(M, scaled, cdt, seed):
    x, params, ct, s = _inputs(M, scaled, seed)
    p = vm._prep(*[torch.from_numpy(a) for a in params], cdt)
    return (torch.from_numpy(x), torch.from_numpy(ct),
            None if s is None else torch.from_numpy(s), p)


def _compare(got, want, bf16, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    if bf16:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-2, (what, rel)
    else:
        limit = 2e-5 * max(1.0, np.abs(want).max())
        assert np.abs(got - want).max() <= limit, (what, np.abs(got - want).max())


@pytest.mark.parametrize("scaled", [False, True], ids=["no_s", "s"])
@pytest.mark.parametrize("M", [32, 37])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pieces_compose_the_plain_backward_bit_for_bit(dtype, M, scaled):
    x, ct, s, p = _torch_case(M, scaled, DTYPES[dtype][1], M)
    got = vm._mlp_bwd_pieces(ct, x, s, p, rows=M, splits=1)
    for name, a, b in zip(NAMES, got, vm._mlp_bwd_ref(ct, x, s, p)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("scaled", [False, True], ids=["no_s", "s"])
@pytest.mark.parametrize("M", [32, 37])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_pieces_move_only_the_order_of_sums(dtype, M, scaled):
    x, ct, s, p = _torch_case(M, scaled, DTYPES[dtype][1], M)
    got = vm._mlp_bwd_pieces(ct, x, s, p, **CHUNKED)
    for name, a, b in zip(NAMES, got, vm._mlp_bwd_ref(ct, x, s, p)):
        if name in ("dw1", "db1", "dw2"):
            assert (a - b).abs().max() <= 1e-6 * b.abs().max(), name
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("scaled", [False, True], ids=["no_s", "s"])
@pytest.mark.parametrize("M", [32, 37])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pieces_match_jax(dtype, M, scaled):
    """The chunked composition against the Pallas VJP (interpret mode)."""
    x, params, ct, s = _inputs(M, scaled, M + 1)
    cdt_j, cdt = DTYPES[dtype]

    def f(x_, *p_):
        scale = None if s is None else jnp.asarray(s)
        return jax_mlp(x_, *p_, 16, compute_dtype=cdt_j, scale=scale)

    out_j, vjp = jax.vjp(f, jnp.asarray(x), *[jnp.asarray(a) for a in params])
    grads_j = vjp(jnp.asarray(ct))
    xt, st = torch.from_numpy(x), None if s is None else torch.from_numpy(s)
    p = vm._prep(*[torch.from_numpy(a) for a in params], cdt)
    bf16 = dtype == "bf16"
    _compare(vm._mlp_fwd_ref(xt, st, p)[0], out_j, bf16, "out")
    got = vm._mlp_bwd_pieces(torch.from_numpy(ct), xt, st, p, **CHUNKED)
    for name, a, b in zip(NAMES, got, grads_j):
        _compare(a, b, bf16, name)


@pytest.mark.parametrize("rows", [1, 16, 64])
def test_dh_piece_partials_are_the_row_tiles_sums(rows):
    """gh and dhn do not depend on the tile; partial t sums dh over rows
    [t·rows, (t+1)·rows), the last tile ragged."""
    x, ct, s, p = _torch_case(37, True, torch.bfloat16, 5)
    g, b, w1, b1, w2, _ = p
    _, _, y = vm._ln_y(x, g, b)
    dn, _ = vm._dn_ref(ct, s, w1.dtype)
    gh, dhn, parts = vm.mlp_dh_ref(y, dn, w1, b1, w2, rows)
    gh1, dhn1, whole = vm.mlp_dh_ref(y, dn, w1, b1, w2, 37)
    assert torch.equal(gh, gh1) and torch.equal(dhn, dhn1)
    assert parts.shape == (-(-37 // rows), F) and parts.dtype == torch.float32
    dh = vm.mm(dn, w2.t()) * vm._dgelu(vm.mm(y, w1) + b1.float())
    assert torch.equal(parts[-1], dh[(len(parts) - 1) * rows:].sum(0))
    torch.testing.assert_close(vm.sum_in_order(parts), whole[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("M", [37, 96, 200])
def test_row_chunks_are_whole_k_steps(M, splits):
    """A contraction's row chunks cover the rows once, in order, each but
    the one that reaches M a whole number of 64-row steps (chunks past M
    are empty); the partials sum to aᵀb."""
    chunks = vm.row_chunks(M, splits)
    assert len(chunks) == splits and chunks[0][0] == 0 and chunks[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all((r1 - r0) % vm.K_STEP == 0 for r0, r1 in chunks if r1 < M)
    gen = torch.Generator().manual_seed(M)
    a = torch.randn(M, 24, generator=gen).to(torch.bfloat16)
    b = torch.randn(M, 40, generator=gen).to(torch.bfloat16)
    parts = vm.contract_rows_ref(a, b, splits)
    assert parts.shape == (splits, 24, 40)
    torch.testing.assert_close(vm.sum_in_order(parts), vm.mm(a.t(), b), rtol=1e-6, atol=1e-5)


def test_product_ref_is_each_piece():
    """`mlp_product_ref` in each orientation and epilogue the CUDA path uses
    is the piece it stands for."""
    x, ct, s, p = _torch_case(37, True, torch.bfloat16, 9)
    g, b, w1, b1, w2, b2 = p
    _, _, y = vm._ln_y(x, g, b)
    dn, _ = vm._dn_ref(ct, s, w1.dtype)
    gh, dhn, _ = vm.mlp_dh_ref(y, dn, w1, b1, w2)
    assert torch.equal(vm.mlp_product_ref(y, w1, epi="gelu", bias=b1),
                       vm._gelu(vm.mm(y, w1) + b1.float()).to(torch.bfloat16))
    assert torch.equal(vm.mlp_product_ref(gh, w2, epi="residual", bias=b2, x=x, s=s),
                       (x + (vm.mm(gh, w2) + b2.float()) * s[:, None]))
    assert torch.equal(vm.mlp_product_ref(dhn, w1, b_t=True), vm.mlp_dy_ref(dhn, w1))
    assert torch.equal(vm.mlp_product_ref(gh, dn, a_t=True, epi="partial", splits=2),
                       vm.contract_rows_ref(gh, dn, 2))
    with pytest.raises(ValueError):
        vm.mlp_product(y, w1, epi="nope")


def test_cpu_pieces_take_the_plain_versions():
    """On the CPU the piece wrappers are their plain versions and launch
    nothing."""
    x, ct, s, p = _torch_case(37, False, torch.bfloat16, 11)
    g, b, w1, b1, w2, _ = p
    _, _, y = vm._ln_y(x, g, b)
    dn, _ = vm._dn_ref(ct, s, w1.dtype)
    before = dict(LAUNCHES)
    for a, want in zip(vm.mlp_dh(y, dn, w1, b1, w2), vm.mlp_dh_ref(y, dn, w1, b1, w2)):
        assert torch.equal(a, want)
    assert vm.mlp_dh(y, dn, w1, b1, w2)[2].shape == (1, F)
    assert torch.equal(vm.mlp_product(dn, w1.t().contiguous(), b_t=True, splits=1),
                       vm.mlp_product_ref(dn, w1.t().contiguous(), b_t=True))
    assert dict(LAUNCHES) == before
