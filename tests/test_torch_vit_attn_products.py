"""K5/K6's dense products as the CUDA half-block chooses and cuts them, on
the CPU: the rule that sends a call's products to the TMA + wgmma pipeline
and refuses operands the TMA cannot read (`_products_wgmma`), the row chunks
of K6's dWp and dWqkv contraction on it (`vit_mlp.row_chunks`; the count,
`dw_splits`, is the card's and is tested there), the bias-round epilogue's
plain product, and the plain path a CPU tensor takes, which moves no launch
count and takes any width."""

import pytest
import torch

from cerebra_torch.kernels import LAUNCHES
from cerebra_torch.models import vit_attn as va
from cerebra_torch.models import vit_mlp as vm

torch.set_num_threads(1)

# the cell's student rows a K6 call: 128 trials x 2 global views of 785
# tokens, x 4 local views of 145 tokens
CELL_ROWS = (128 * 2 * 785, 128 * 4 * 145)


def _weights(D, dtype, offset=0):
    """A (D, 3D) wqkv and a (D, D) wproj of `dtype`, wqkv's base `offset`
    values past an aligned allocation."""
    wqkv = torch.zeros(D * 3 * D + offset, dtype=dtype)[offset:].view(D, 3 * D)
    return wqkv, torch.zeros(D, D, dtype=dtype)


@pytest.mark.parametrize("D, dtype, offset, want", [
    (384, torch.bfloat16, 0, True),         # main_dino's width
    (192, torch.bfloat16, 0, True),         # noise_probe's
    (32, torch.bfloat16, 0, True),
    (384, torch.float32, 0, False),         # f32 compute: the DINOv2 teacher
    (36, torch.bfloat16, 0, "refused"),     # rows of 36 and 108 values: not 16-byte multiples
    (30, torch.bfloat16, 0, "refused"),
    (384, torch.bfloat16, 1, "refused"),    # a base 2 bytes past alignment
], ids=str)
def test_products_take_wgmma_where_the_tma_reads_them(D, dtype, offset, want):
    """bf16 compute takes the wgmma path and refuses operands the TMA cannot
    read, as K7/K8 do; f32 compute keeps its f32 bodies at any width."""
    wqkv, wp = _weights(D, dtype, offset)
    misaligned = torch.zeros(D * D + 1, dtype=dtype)[1:].view(D, D)
    if want == "refused":
        with pytest.raises(ValueError, match="16-byte aligned"):
            va._products_wgmma(wqkv, wp)
        return
    assert va._products_wgmma(wqkv, wp) is want
    # every operand's base counts, not only the weights'
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="16-byte aligned"):
            va._products_wgmma(wqkv, wp, misaligned)
    else:
        assert va._products_wgmma(wqkv, wp, misaligned) is False


@pytest.mark.parametrize("M", [CELL_ROWS[0], CELL_ROWS[1], 16 * 785, 32 * 145, 16 * 17, 300,
                               37], ids=str)
def test_dw_chunks_cover_each_row_once_in_whole_steps(M):
    """For every count the chunk rule may give at M rows (1 to 32, and M /
    256 at most, so that a chunk holds four 64-row steps), the dW row chunks
    cover every row once, in order; every chunk but the one that reaches M
    is whole 64-row steps, and any empty chunk comes last."""
    for s in range(1, max(1, min(32, M // (4 * vm.K_STEP))) + 1):
        chunks = vm.row_chunks(M, s)
        assert len(chunks) == s and chunks[0][0] == 0 and chunks[-1][1] == M
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(r0 % vm.K_STEP == 0 for r0, _ in chunks if r0 < M)
        assert all((r1 - r0) % vm.K_STEP == 0 for r0, r1 in chunks if r1 < M)
        sizes = [r1 - r0 for r0, r1 in chunks]
        assert sizes == sorted(sizes, key=lambda n: n == 0)


def test_dw_partials_sum_to_the_contraction():
    """dWp and dWqkv as the wgmma path forms them: each chunk's partial of
    oᵀ·dn and yᵀ·dqkv, added in chunk order, is the plain contraction up to
    the order of its f32 sums (700 terms of about 1, so sums of about 26
    whose ulp is 2e-6: 1e-4 absolute)."""
    gen = torch.Generator().manual_seed(3)
    M, D, s = 700, 32, 2
    o, dn, y = (torch.randn(M, D, generator=gen).to(torch.bfloat16) for _ in range(3))
    dqkv = torch.randn(M, 3 * D, generator=gen).to(torch.bfloat16)
    for a, b in ((o, dn), (y, dqkv)):
        parts = vm.mlp_product_ref(a, b, a_t=True, epi="partial", splits=s)
        assert parts.shape == (s, D, b.shape[1])
        torch.testing.assert_close(vm.sum_in_order(parts), vm.mm(a.t(), b), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("b_t", [False, True], ids=["ab", "abt"])
def test_bias_round_product_is_the_half_blocks_rounding(b_t, bias):
    """The bias-round epilogue's plain product: K5's qkv = y·Wqkv + bqkv and
    K6's do = dn·Wpᵀ (no bias), each f32 sum rounded once to bf16."""
    gen = torch.Generator().manual_seed(int(b_t) + 2 * int(bias))
    M, K, N = 37, 32, 96
    a = torch.randn(M, K, generator=gen).to(torch.bfloat16)
    b = torch.randn(*((N, K) if b_t else (K, N)), generator=gen).to(torch.bfloat16)
    bi = torch.randn(N, generator=gen).mul(0.1).to(torch.bfloat16) if bias else None
    got = vm.mlp_product(a, b, b_t=b_t, epi="bias_round", bias=bi)
    c = vm.mm(a, b.t() if b_t else b)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(got, (c + bi.float() if bias else c).to(torch.bfloat16))


@pytest.mark.parametrize("D", [32, 36], ids=["D32", "D36"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cpu_half_block_takes_the_plain_path(dtype, D):
    """On the CPU K5/K6 are their plain versions: no launch counts move, the
    wgmma and one-pass ones included, with or without autograd, and a width
    whose rows the TMA could not read (D 36) is no fault there."""
    gen = torch.Generator().manual_seed(5)
    B, N, H = 2, 9, 4
    x = torch.randn(B, N, D, generator=gen, requires_grad=True)
    params = [torch.randn(*sh, generator=gen).mul(0.1).requires_grad_(True)
              for sh in ((D,), (D,), (D, 3 * D), (3 * D,), (D, D), (D,))]
    before = dict(LAUNCHES)
    p = va._prep(*[t.detach() for t in params], H, dtype)
    out, saved = va.attn_fwd(x.detach(), None, p, H)
    assert saved == () and torch.equal(out, va._attn_fwd_ref(x.detach(), None, p, H)[0])
    y = va.fused_attn_residual(x, *params, H, compute_dtype=dtype)
    y.square().sum().backward()
    assert all(t.grad is not None for t in (x, *params))
    assert {"vit_attn_products_wgmma", "vit_attn_core_one_pass"} <= before.keys()
    assert dict(LAUNCHES) == before
