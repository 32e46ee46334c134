"""The port's CUDA LSTM-stack kernels (K1, K2 with its dW reduction, K3)
against their plain PyTorch versions on the card, over shapes and tiles the
main path does not reach: L of 1 to 3, ragged batches, T = 1, C ≠ H, and
4H below one warp's multiple. They need an NVIDIA GPU and nvcc, and skip
without them. On a GPU machine:

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
SHAPES = [(1, 1, 96, 96, 2), (7, 13, 24, 10, 1), (9, 40, 96, 96, 3), (5, 3, 300, 64, 2)]


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
    got_g = ls.bwd(g, x, layers, *want, tile=tile)
    for got_l, want_l in zip(got_g, ls._bwd_ref(g, x, layers, *want)):
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
    assert ls.LAUNCHES == {"fwd_train": 1, "bwd": 1, "fwd_infer_last": 1, "bwd_reduce": 1}


def test_weight_gradients_are_deterministic(cuda):
    x, layers, g = make_stack((20, 37, 96, 96, 2), torch.bfloat16, cuda, seed=2)
    res = ls.fwd_train(x, layers)
    first, second = ls.bwd(g, x, layers, *res), ls.bwd(g, x, layers, *res)
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
