"""K15 over the qkv rows (`flash_mha_qkv`, the flash attention of
`Attention(use_flash=True)`) through its plain pieces on the CPU: the
one-pass online softmax over key tiles of 64 (`flash_fwd_ref`) and the
backward with di = Σ o·do (`flash_bwd_ref`) against the two-pass plain
pieces of K5/K6's attention cores (`attn_core_fwd_ref` /
`attn_core_bwd_ref`, q scaled by a power of two so both see the same
scores) in f32 at 1e-6, ragged against the 64-key tile; a bf16 case against
the f32 softmax formula (relative Frobenius 1.5e-2, the ViT bf16 gate);
the gradient is that of the qkv rows; `flash_mha(q, k, v)` packs its inputs
into the same rows. The JAX comparison is tests/test_torch_dino_analysis.py
(`Attention` against the JAX softmax path)."""

import numpy as np
import pytest
import torch

from cerebra_torch.models import vit_attn as va

torch.set_num_threads(1)


def rows(B, N, D, seed, dtype=torch.float32, sc=0.5):
    gen = np.random.default_rng(seed)
    return torch.from_numpy((gen.normal(size=(B, N, D)) * sc).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("N", [1, 64, 150])
@pytest.mark.parametrize("H,dh", [(2, 16), (3, 8)])
def test_one_pass_matches_the_two_pass_pieces_in_f32(N, H, dh):
    """The forward's o and (m, l) and the backward's dq, dk, dv within 1e-6
    of the two-pass pieces (which take q pre-scaled: with a scale of 2^-k
    the scores are the same f32 values), at N below, at and above a tile."""
    B, D = 2, H * dh
    scale = 0.25
    qkv, do = rows(B, N, 3 * D, 10 + N), rows(B, N, D, 20 + N)
    o, stats = va.flash_fwd_ref(qkv, H, scale)
    q_scaled = torch.cat([qkv[..., :D] * scale, qkv[..., D:]], -1).reshape(B * N, 3 * D)
    o2, stats2 = va.attn_core_fwd_ref(q_scaled, B, N, H)
    assert o.shape == (B, N, D) and stats.shape == (B, H, N, 2)
    np.testing.assert_allclose(o.reshape(B * N, D).numpy(), o2.numpy(), atol=1e-6)
    np.testing.assert_allclose(stats[..., 0].numpy(), stats2[..., 0].numpy(), atol=1e-6)
    np.testing.assert_allclose(stats[..., 1].numpy(), stats2[..., 1].numpy(), rtol=1e-6)
    dqkv = va.flash_bwd_ref(qkv, o, do, stats, H, scale)
    dqkv32, _, _ = va.attn_core_bwd_ref(q_scaled, do.reshape(B * N, D), stats2, B, N, H)
    want = torch.cat([dqkv32[:, :D] * scale, dqkv32[:, D:]], -1).reshape(B, N, 3 * D)
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.float32
    np.testing.assert_allclose(dqkv.numpy(), want.numpy(), atol=1e-6)


def test_qkv_rows_gradient_is_the_pieces():
    """Through autograd `flash_mha_qkv` returns the forward piece's o and,
    for the qkv rows, the backward piece's dqkv; on the CPU it is
    `flash_mha_qkv_ref` exactly, and no launch is counted."""
    va.LAUNCHES.update(vit_attn_flash_fwd=0, vit_attn_flash_bwd=0)
    B, N, H, dh = 2, 70, 2, 16
    qkv, do = rows(B, N, 3 * H * dh, 30), rows(B, N, H * dh, 31)
    outs = []
    for fn in (va.flash_mha_qkv, va.flash_mha_qkv_ref):
        x = qkv.clone().requires_grad_(True)
        out = fn(x, H, dh ** -0.5)
        (g,) = torch.autograd.grad(out, x, do)
        outs.append((out, g))
    o, stats = va.flash_fwd_ref(qkv, H, dh ** -0.5)
    torch.testing.assert_close(outs[0][0], o, rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], va.flash_bwd_ref(qkv, o, do, stats, H, dh ** -0.5),
                               rtol=0, atol=0)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert va.LAUNCHES["vit_attn_flash_fwd"] == va.LAUNCHES["vit_attn_flash_bwd"] == 0


@pytest.mark.parametrize("N", [100, 129])
def test_bf16_on_the_cpu(N):
    """In bf16 (p rounded at each tile's running max, dS and the gradients
    rounded once) the value and the qkv gradient against the f32 softmax
    formula on the same bf16 inputs: relative Frobenius 1.5e-2."""
    B, H, dh = 2, 3, 16
    D = H * dh
    qkv = rows(B, N, 3 * D, 40 + N, torch.bfloat16, sc=1.0).requires_grad_(True)
    do = rows(B, N, D, 50 + N, torch.bfloat16, sc=1.0)
    out = va.flash_mha_qkv(qkv, H, dh ** -0.5)
    (g,) = torch.autograd.grad(out, qkv, do)
    assert out.dtype == g.dtype == torch.bfloat16
    x = qkv.detach().float().requires_grad_(True)
    q, k, v = (va._heads(x[..., i * D:(i + 1) * D], B, N, H) for i in range(3))
    want = (torch.softmax((q @ k.transpose(-1, -2)) * dh ** -0.5, -1) @ v)
    want = want.transpose(1, 2).reshape(B, N, D)
    (want_g,) = torch.autograd.grad(want, x, do.float())
    for a, b in ((out, want), (g, want_g)):
        rel = ((a.float() - b).norm() / b.norm()).item()
        assert rel <= 1.5e-2, rel


def test_flash_mha_packs_its_inputs_into_qkv_rows():
    """`flash_mha(q, k, v, scale)` over (B, H, N, dh) is `flash_mha_qkv` on
    the rows [q | k | v] (feature i·D + h·dh + c), head-split back, with
    gradients through the packing to q, k and v."""
    B, H, N, dh = 2, 2, 37, 8
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(B, H, N, dh, generator=gen).requires_grad_(i < 3)
                   for i in range(4))
    out = va.flash_mha(q, k, v, dh ** -0.5)
    grads = torch.autograd.grad(out, (q, k, v), do)
    qkv = torch.cat([va._rows(t, B, N) for t in (q, k, v)], 1).view(B, N, -1).detach()
    qkv.requires_grad_(True)
    rows_out = va.flash_mha_qkv(qkv, H, dh ** -0.5)
    torch.testing.assert_close(out, va._heads(rows_out, B, N, H), rtol=0, atol=0)
    (g,) = torch.autograd.grad(rows_out, qkv, va._rows(do, B, N).view(B, N, -1))
    for i, a in enumerate(grads):
        torch.testing.assert_close(a, va._heads(g[..., i * H * dh:(i + 1) * H * dh], B, N, H),
                                   rtol=0, atol=0)
