"""The port's CUDA LSTM-stack kernels (K1, K2/K2g with the dW reduction, K3,
K4) against their plain PyTorch versions on the card, over shapes and tiles
the main paths do not reach: L of 1 to 3, ragged batches, T = 1, C ≠ H, 4H
below one warp's multiple, and the recurrent autoencoder's widths (encoder
C = 96, H = 384, with 4H above the block's 512 threads; decoder C = 384,
H = 96). They need an NVIDIA GPU and nvcc, and skip without them. On a GPU
machine:

    python -m pytest tests/test_torch_cuda_kernels.py

Tolerances as chip_smoke.py, which gives their reasons: f32 values max-abs
1e-5; f32 weight gradients relative Frobenius 1e-5; every bf16 output
relative Frobenius 5e-3."""

import math

import pytest
import torch

from cerebra_torch.models import lstm_stack as ls

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

# (T, B, C, H, L)
SHAPES = [(1, 1, 96, 96, 2), (7, 13, 24, 10, 1), (9, 40, 96, 96, 3), (5, 3, 300, 64, 2),
          (12, 16, 96, 384, 1), (12, 13, 384, 96, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_stack(shape, dtype, device, seed=0):
    T, B, C, H, L = shape
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*s):
        return ((torch.rand(*s, generator=gen) * 2 - 1) * bound).to(device, dtype)

    x = torch.randn(T, B, C, generator=gen).to(device, dtype)
    layers = [(u(C if l == 0 else H, 4 * H), u(H, 4 * H), u(4 * H)) for l in range(L)]
    g = torch.randn(B, H, generator=gen).to(device, dtype)
    return x, layers, g


def assert_close(got, want, dtype, grad=False):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32 and not grad:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        assert rel <= (1e-5 if dtype == torch.float32 else 5e-3), rel


@pytest.mark.parametrize("tile", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_match_plain(cuda, dtype, shape, tile):
    x, layers, g = make_stack(shape, dtype, cuda)
    assert_close(ls.fwd_infer_last(x, layers, tile), ls._fwd_infer_last_ref(x, layers), dtype)
    want = ls._fwd_train_ref(x, layers)
    for a, b in zip(ls.fwd_train(x, layers, tile), want):
        assert_close(a, b, dtype)
    _, got_g = ls.bwd(g, x, layers, *want, tile=tile)
    for got_l, want_l in zip(got_g, ls._bwd_ref(g, x, layers, *want)[1]):
        for a, b in zip(got_l, want_l):
            assert_close(a, b, dtype, grad=True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("form", ["g_last_dx", "g_full", "g_full_dx"])
@pytest.mark.parametrize("tile", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sequence_kernels_match_plain(cuda, dtype, shape, tile, form):
    """K4, and K2g in its three forms beyond K2's: a (B, H) cotangent with
    dx, a full (T, B, H) cotangent without and with dx."""
    x, layers, g = make_stack(shape, dtype, cuda)
    assert_close(ls.fwd_infer(x, layers, tile), ls._fwd_infer_ref(x, layers), dtype)
    if form != "g_last_dx":
        g = torch.randn(x.shape[0], *g.shape, generator=torch.Generator().manual_seed(1)).to(
            cuda, dtype)
    need_dx = form.endswith("dx")
    res = ls._fwd_train_ref(x, layers)
    dx, got_g = ls.bwd(g, x, layers, *res, need_dx=need_dx, tile=tile)
    want_dx, want_g = ls._bwd_ref(g, x, layers, *res, need_dx=need_dx)
    assert (dx is None) == (not need_dx)
    if need_dx:
        assert_close(dx, want_dx, dtype, grad=True)
    for got_l, want_l in zip(got_g, want_g):
        for a, b in zip(got_l, want_l):
            assert_close(a, b, dtype, grad=True)
    torch.cuda.synchronize()


def test_autograd_wrapper_launches_the_kernels(cuda):
    x, layers, _ = make_stack((11, 6, 96, 96, 2), torch.float32, cuda, seed=1)
    w_out = torch.randn(6, 96, device=cuda)
    grads = []
    for fn in (ls.lstm_stack_last, ls.lstm_stack_last_ref):
        ws = [tuple(w.clone().requires_grad_(True) for w in l) for l in layers]
        (fn(x, ws) * w_out).sum().backward()
        grads.append([w.grad for l in ws for w in l])
    for a, b in zip(*grads):
        assert_close(a, b, torch.float32, grad=True)
    ls.reset_launches()
    ws = [tuple(w.clone().requires_grad_(True) for w in l) for l in layers]
    ls.lstm_stack_last(x, ws).sum().backward()
    with torch.no_grad():
        ls.lstm_stack_last(x, ws)
    names = ("fwd_train", "bwd", "fwd_infer_last", "bwd_reduce")
    assert {k: ls.LAUNCHES[k] for k in names} == dict.fromkeys(names, 1)
    assert ls.LAUNCHES["fwd_infer"] == ls.LAUNCHES["bwd_general"] == 0


def test_sequence_wrapper_gives_the_plain_gradients_and_launches(cuda):
    """lstm_stack with x requiring grad: K1 + K2g (full cotangent, dx), and K4
    without grad; x's and the weights' gradients as through the plain
    versions."""
    x, layers, _ = make_stack((11, 6, 96, 384, 1), torch.float32, cuda, seed=3)
    w_out = torch.randn(11, 6, 384, device=cuda)
    grads = []
    for fn in (ls.lstm_stack, ls.lstm_stack_ref):
        xs = x.clone().requires_grad_(True)
        ws = [tuple(w.clone().requires_grad_(True) for w in l) for l in layers]
        (fn(xs, ws) * w_out).sum().backward()
        grads.append([xs.grad] + [w.grad for l in ws for w in l])
    for a, b in zip(*grads):
        assert_close(a, b, torch.float32, grad=True)
    ls.reset_launches()
    xs = x.clone().requires_grad_(True)
    ls.lstm_stack(xs, layers).sum().backward()
    with torch.no_grad():
        ls.lstm_stack(x, layers)
    names = ("fwd_train", "bwd_general", "fwd_infer", "bwd_reduce")
    assert {k: ls.LAUNCHES[k] for k in names} == dict.fromkeys(names, 1)
    assert ls.LAUNCHES["bwd"] == ls.LAUNCHES["fwd_infer_last"] == 0


@pytest.mark.parametrize("g_full", [False, True], ids=["g_last", "g_full"])
@pytest.mark.parametrize("need_dx", [False, True], ids=["no_dx", "dx"])
def test_weight_gradients_are_deterministic(cuda, need_dx, g_full):
    """Every backward form, K2's (g at T-1, no dx) and K2g's, gives
    bitwise-repeatable weight gradients and dx."""
    x, layers, g = make_stack((20, 37, 96, 96, 2), torch.bfloat16, cuda, seed=2)
    if g_full:
        g = torch.randn(x.shape[0], *g.shape, generator=torch.Generator().manual_seed(1)).to(
            cuda, torch.bfloat16)
    res = ls.fwd_train(x, layers)
    (dx1, first), (dx2, second) = (ls.bwd(g, x, layers, *res, need_dx=need_dx)
                                   for _ in range(2))
    assert (dx1 is None and dx2 is None) if not need_dx else torch.equal(dx1, dx2)
    for a, b in zip(first, second):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    x, layers, _ = make_stack((4, 5, 8, 8, 2), torch.float32, cuda)
    with pytest.raises(ValueError):
        ls.fwd_train(x.transpose(0, 1).contiguous().transpose(0, 1), layers)
    with pytest.raises(RuntimeError):
        ls.fwd_infer_last(x.cpu(), layers)
    with pytest.raises(ValueError):
        ls.fwd_train(x, layers, tile=3)


# ------------------------------------------------ fused ViT half-blocks K5–K8
# (B, N, D, H): dh 8 with a ragged tile, dh 64 over two key tiles, the
# locals' width at a small batch. Tolerances as chip_smoke.py's ViT phase:
# f32 values max-abs 1e-4, f32 gradients relative Frobenius 2e-5, every bf16
# output relative Frobenius 1.5e-2.
VIT_SHAPES = [(2, 13, 32, 4), (3, 70, 64, 1), (2, 145, 384, 6)]
VIT_DTYPES = {"f32": (torch.float32, torch.float32), "f32_bf16": (torch.float32, torch.bfloat16),
              "bf16": (torch.bfloat16, torch.bfloat16)}


def vit_close(got, want, cdt, grad):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if cdt == torch.float32 and not grad:
        assert (got - want).abs().max().item() <= 1e-4
    else:
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        assert rel <= (2e-5 if cdt == torch.float32 else 1.5e-2), rel


def vit_inputs(B, rows, D, F, sd, cuda, seed, scaled, attn):
    gen = torch.Generator().manual_seed(seed)

    def r(*s, sc=0.1, base=0.0):
        return (torch.randn(*s, generator=gen) * sc + base).to(cuda)

    shape = (B, rows, D) if attn else (B * rows, D)
    x = r(*shape, sc=1.0).to(sd)
    if attn:
        params = [r(D, base=1.0), r(D), r(D, 3 * D), r(3 * D, sc=0.05), r(D, D), r(D, sc=0.05)]
    else:
        params = [r(D, base=1.0), r(D), r(D, F), r(F, sc=0.05), r(F, D), r(D, sc=0.05)]
    dout = r(*shape, sc=1.0).to(sd)
    s = None
    if scaled:
        s = torch.full((B,), 1 / 0.9, device=cuda)
        s[0] = 0.0
        if not attn:
            s = s.repeat_interleave(rows)
    return x, params, dout, s


@pytest.mark.parametrize("scaled", [False, True], ids=["no_s", "s"])
@pytest.mark.parametrize("dt", list(VIT_DTYPES))
@pytest.mark.parametrize("shape", VIT_SHAPES, ids=str)
def test_vit_attn_kernels_match_plain(cuda, shape, dt, scaled):
    from cerebra_torch.models import vit_attn as va

    B, N, D, H = shape
    sd, cdt = VIT_DTYPES[dt]
    x, params, dout, s = vit_inputs(B, N, D, 0, sd, cuda, 3, scaled, attn=True)
    p = va._prep(*params, H, cdt)
    out, saved = va.attn_fwd(x, s, p, H)
    vit_close(out, va._attn_fwd_ref(x, s, p, H)[0], cdt, grad=False)
    got = va.attn_bwd(dout, x, s, p, H, saved)
    want = va._attn_bwd_ref(dout, x, s, p, H)
    for a, b in zip(got, want):
        vit_close(a, b, cdt, grad=True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("scaled", [False, True], ids=["no_s", "s"])
@pytest.mark.parametrize("dt", list(VIT_DTYPES))
@pytest.mark.parametrize("shape", [(1, 37, 32, 96), (2, 145, 384, 1536)], ids=str)
def test_vit_mlp_kernels_match_plain(cuda, shape, dt, scaled):
    from cerebra_torch.models import vit_mlp as vm

    B, N, D, F = shape
    sd, cdt = VIT_DTYPES[dt]
    x, params, dout, s = vit_inputs(B, N, D, F, sd, cuda, 4, scaled, attn=False)
    p = vm._prep(*params, cdt)
    out, saved = vm.mlp_fwd(x, s, p)
    vit_close(out, vm._mlp_fwd_ref(x, s, p)[0], cdt, grad=False)
    got = vm.mlp_bwd(dout, x, s, p, saved)
    want = vm._mlp_bwd_ref(dout, x, s, p)
    for a, b in zip(got, want):
        vit_close(a, b, cdt, grad=True)
    torch.cuda.synchronize()


def test_vit_wrappers_launch_the_kernels_and_are_deterministic(cuda):
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    gen = torch.Generator().manual_seed(5)
    D, H, F = 64, 2, 128
    x = torch.randn(2, 20, D, generator=gen).to(cuda).requires_grad_(True)
    pa = [torch.randn(*s, generator=gen).mul(0.1).to(cuda).requires_grad_(True)
          for s in ((D,), (D,), (D, 3 * D), (3 * D,), (D, D), (D,))]
    pm = [torch.randn(*s, generator=gen).mul(0.1).to(cuda).requires_grad_(True)
          for s in ((D,), (D,), (D, F), (F,), (F, D), (D,))]
    grads = []
    reset_launches()
    for _ in range(2):
        for t in (x, *pa, *pm):
            t.grad = None
        y = va.fused_attn_residual(x, *pa, H)
        y = vm.fused_mlp_residual(y.reshape(-1, D), *pm).reshape(2, 20, D)
        y.square().sum().backward()
        grads.append([t.grad.clone() for t in (x, *pa, *pm)])
    assert {k: LAUNCHES[k] for k in ("vit_attn_fwd", "vit_attn_bwd", "vit_mlp_fwd",
                                     "vit_mlp_bwd")} == dict.fromkeys(
        ("vit_attn_fwd", "vit_attn_bwd", "vit_mlp_fwd", "vit_mlp_bwd"), 2)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError):
        va.fused_attn_residual(x.detach().cpu(), *pa, H)
    with pytest.raises(ValueError):  # not contiguous
        va.fused_attn_residual(x.detach()[:, ::2], *[t.detach() for t in pa], H)
