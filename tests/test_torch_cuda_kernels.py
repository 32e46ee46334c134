"""The port's CUDA LSTM kernels (the stack's K1, K2/K2g and their two pieces,
each layer's reverse scan and products, K3, K4, K1/K4's layer-by-layer path
and its two pieces, the input product and the cluster scan, K1/K3's
wavefront forward (K1, K3, K4, K10; K3, K4 and K10 also on its split
layer), K3 in f32 layer by layer, K10, K11 and its
pieces per
time chunk; the scan's K12-K14, K12/K13 also on its wavefront forward) and
the ViT kernels (K5-K8, K15) and the IIR cascade (sos_scan) against
their plain PyTorch versions on the card (K7/K8 also piece by piece: the
fused dh kernel and each product alone; K5/K6's products on the TMA + wgmma
path in bf16 and on their f32 bodies in f32), over shapes and tiles
the main paths do not reach: L of 1 to 3, ragged batches, T = 1, C ≠ H, 4H
below one warp's multiple, and the recurrent autoencoder's widths (encoder
C = 96, H = 384, with 4H above the block's 512 threads; decoder C = 384,
H = 96); and over the shapes the main paths run, at the tile they run (the
`*_MAIN_SHAPES` lists: the CLI's and the bench step's stack, the
autoencoder's, the LSTM CLI family's, the recompute stack's, the scan's;
and main_dino's, eeg_retrieval_dino's and the teachers' half-blocks and
attention cores, K15 at main_dino's globals, remove_noise's filter, the
autoencoder's gradients). chip_smoke.py holds each kernel to these limits
only at the main path's shape it times, on its timing row's inputs
(ROW_LIMITS there). They need an NVIDIA GPU and nvcc, and skip
without them. On a GPU machine (tests/conftest.py imports JAX, which the
port does not need):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

The limits. Both sides of a comparison run the same formulas with the same
rounding points and differ in the order of their sums (and, in bf16, in a
sum that lands the other side of a rounding, which moves that element by
an ulp, 2^-8 relative, and the recurrence carries on):

- The LSTM kernels (K1-K4, K10-K14 and their pieces): f32 values max-abs
  1e-5; f32 weight gradients, dx and dgates relative Frobenius 1e-5; every
  bf16 output relative Frobenius 5e-3. First set at 1e-4, 1e-4 and 2e-2,
  then tightened to 20x over what K1-K3 showed on an H100 (C = H = 96,
  L = 2: at most 2.4e-7, 4.3e-7, 1.5e-4). K4 and K2g at the autoencoder's
  widths show more (at most 1.2e-6, K4 at C 384 / H 96; 6.8e-7 and 1.3e-3,
  K2g's dx at C 96 / H 384): margins of 8x, 15x and 3.9x.
- The full-width RecurrentAutoencoder(460, 96, 384), every gradient of a
  loss on both outputs through the kernels against the plain stack: the
  LSTM limits. Its bf16 chain (the decoder's dx over 460 repeated latents,
  summed, then 460 encoder steps) carries flipped roundings further than
  one kernel. On an H100 over five seeds the sound run read at most 6.7e-7
  (f32) and 3.4e-3 (bf16); planted faults read, in bf16: one step of the
  decoder's dx dropped 2.7e-2, one batch row's dx dropped 0.23, the
  cotangent's first step dropped 2.3e-2; a half-ulp low bias on dx
  7.2e-3, on dW_ih 5.2e-3; against the f32 plain versions (a precision
  control) 6.7e-3. In f32 every fault read 3.9e-3 or more. 5e-3 lies
  between the sound bf16 drift and the faults; the f32 check is the sharp
  one.
- cuDNN's nn.LSTM(4H, H) with weight_ih = I against lstm_scan's plain
  versions in f32 (the library column of the scan's timing rows): ten
  times the kernels' f32 limits (1e-4, 1e-4), since it only has to show
  that the call computes the same function, and cuDNN sums in its own
  order.
- The ViT kernels (K5-K8, K15, the attention cores): f32 values max-abs
  1e-4, f32 gradients relative Frobenius 2e-5, every bf16 output relative
  Frobenius 1.5e-2 (dW sums over up to 12,560 rows; the bf16 products on
  the tensor cores). First set at 1e-4 / 1e-4 / 2e-2; an H100 showed at
  most 1.5e-5 (f32 values, K7, whose outputs reach ~10), 1.1e-6 (f32
  gradients) and 6.3e-4 (bf16, K6 dWqkv). f32 values keep 1e-4 (6.8x); the
  others were tightened to ~20x. With K5/K6's attention cores on mma.sync
  (ex2 and a per-row 1/l in the softmax) the worst case read 1.2e-6 (f32
  values, K5), 1.1e-6 (f32 gradients, K6 dg) and 6.3e-4 (bf16, K6 dWqkv);
  the cores alone at most 1.1e-4 (bf16, relative).
- The IIR cascade (sos_scan): the kernel and its plain loop run the same
  per-section updates; nvcc contracts them into FMAs, and the 1 Hz poles
  of remove_noise's 1-50 Hz Butterworth carry a rounding difference on: on
  the CPU each f32 side lies 1.7-1.9e-4 of the peak from f64, and the
  card's first runs showed 9-10e-5 between kernel and plain. Relative to
  the output's peak: 5e-4 in f32, 1e-9 in f64 against scipy (the same
  recurrence in the same dtype)."""

import math

import pytest
import torch

from cerebra_torch.models import lstm_stack as ls

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

# (T, B, C, H, L)
SHAPES = [(1, 1, 96, 96, 2), (7, 13, 24, 10, 1), (9, 40, 96, 96, 3), (5, 3, 300, 64, 2),
          (12, 16, 96, 384, 1), (12, 13, 384, 96, 1)]
TILES = [None, 1, 2, 4, 8, 16]
# The main paths' stacks over T = 460 (the CLI's crop of [20, 480)): the
# CLI's and the bench step's C = H = 96, L = 2 at B = 1024, 16 and 13; the
# recurrent autoencoder's encoder (C 96, H 384) and decoder (C 384, H 96)
# at B = 16 and 13
HEADLINE_MAIN_SHAPES = [(460, B, 96, 96, 2) for B in (1024, 16, 13)]
AE_MAIN_SHAPES = [(460, B, c, h, 1) for c, h in ((96, 384), (384, 96)) for B in (16, 13)]
# the LSTM CLI family's: the DINO-LSTM backbone Model(96, 128, 4) over its
# 300- and 200-sample crops (batch 8: 2 and 4 crops a trial),
# `lstm_distill`'s C = H = 96, L 4 and the Spampinato rig's C = H = 128,
# L 4 at batch 16; K3 at the eval's gallery and query (40 x 10 trials: 320
# and 80) and `lstm_distill`'s validation gallery
FAMILY_MAIN_SHAPES = [(300, 16, 96, 128, 4), (200, 32, 96, 128, 4), (460, 16, 96, 96, 4),
                      (460, 16, 128, 128, 4), (460, 320, 96, 128, 4), (460, 80, 96, 128, 4),
                      (460, 320, 96, 96, 4)]
STACK_MAIN_SHAPES = HEADLINE_MAIN_SHAPES + AE_MAIN_SHAPES + FAMILY_MAIN_SHAPES


def tiled(shapes, main=(), tiles=TILES):
    """(shape, tile) cases: every tile at `shapes`, and the main paths'
    shapes at the tile they run (None: the wrapper's own)."""
    return [(s, t) for s in shapes for t in tiles] + [(s, None) for s in main]


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


@pytest.mark.parametrize("shape,tile", tiled(SHAPES, STACK_MAIN_SHAPES), ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_match_plain(cuda, dtype, shape, tile):
    """K3, K1 and K2 (on the plain forward's residuals) against their plain
    versions."""
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
@pytest.mark.parametrize("shape,tile", tiled(SHAPES, AE_MAIN_SHAPES), ids=str)
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
    names = ("fwd_train", "bwd", "fwd_infer_last")
    assert {k: ls.LAUNCHES[k] for k in names} == dict.fromkeys(names, 1)
    # K2 is one reverse scan and one set of products for each of the 2 layers
    assert ls.LAUNCHES["stack_bwd_scan"] == ls.LAUNCHES["stack_bwd_products"] == 2
    assert ls.LAUNCHES["fwd_infer"] == ls.LAUNCHES["bwd_general"] == ls.LAUNCHES["rc_scan"] == 0


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
    names = ("fwd_train", "bwd_general", "fwd_infer", "stack_bwd_scan", "stack_bwd_products")
    assert {k: ls.LAUNCHES[k] for k in names} == dict.fromkeys(names, 1)
    assert ls.LAUNCHES["bwd"] == ls.LAUNCHES["fwd_infer_last"] == ls.LAUNCHES["rc_scan"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autoencoder_gradients_match_plain(cuda, dtype):
    """The full-width RecurrentAutoencoder(460, 96, 384) at B = 16: both
    outputs and every gradient of a loss on both through the kernels (K1,
    K2g with a cotangent at every t, the decoder's with dx) against the
    plain stack, at the LSTM limits (the module docstring gives the planted
    faults they were set against)."""
    from unittest import mock

    from cerebra_torch.models import RecurrentAutoencoder
    from cerebra_torch.models import lstm as lstm_mod

    T, C, E, B = 460, 96, 384, 16
    gen = torch.Generator().manual_seed(3)
    eeg = torch.randn(B, T, C, generator=gen).to(cuda)
    w_enc = torch.randn(B, E, generator=gen).to(cuda)
    w_dec = torch.randn(B, T, C, generator=gen).to(cuda)
    outs = []
    for stack in (ls.lstm_stack, ls.lstm_stack_ref):
        model = RecurrentAutoencoder(T, C, E, dtype=dtype, device=cuda,
                                     generator=torch.Generator().manual_seed(0))
        with mock.patch.object(lstm_mod, "lstm_stack", stack):
            enc, dec = model(eeg)
            ((enc.float() * w_enc).sum() + (dec.float() * w_dec).sum()).backward()
        outs.append([enc, dec] + [p.grad for p in model.parameters()])
    for i, (a, b) in enumerate(zip(*outs)):
        assert_close(a, b, dtype, grad=i > 1)


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


# K2/K2g's pieces. The scan's (T, B, H) as SCAN_SHAPES, and H = 128 at a
# ragged batch, where w_hhᵀ (4H x H) sits in shared memory in bf16 (128 KiB)
# and is read through L2 in f32 (256 KiB, over the 227 KB a block may use).
STACK_SCAN_SHAPES = [(1, 1, 96), (7, 13, 10), (9, 40, 96), (12, 16, 384), (30, 37, 128)]
# and the headline stack's layers: (T, B, H) of HEADLINE_MAIN_SHAPES
HEADLINE_SCAN_SHAPES = [(T, B, H) for T, B, _, H, _ in HEADLINE_MAIN_SHAPES]


@pytest.mark.parametrize("cot", ["stream", "f32", "last"])
@pytest.mark.parametrize("shape,tile", tiled(STACK_SCAN_SHAPES, HEADLINE_SCAN_SHAPES,
                                             [None, 1, 4, 16]), ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stack_scan_matches_plain(cuda, dtype, shape, tile, cot):
    """K2/K2g's reverse scan of one layer under each cotangent it takes: the
    caller's g at every t in the stream dtype, the f32 chain from the layer
    above, and a (B, H) g that reaches T-1 only."""
    from cerebra_torch.models import lstm_scan as sc

    x_proj, w_hh, g = scan_case(shape, dtype, cuda)
    _, prefac, qf = sc._scan_fwd_train_ref(x_proj, w_hh)
    if cot == "f32":
        g = torch.randn(g.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    elif cot == "last":
        g = g[0].contiguous()
    got = ls.bwd_scan(g, prefac, qf, w_hh, tile)
    assert got.dtype == dtype
    assert_close(got, ls._scan_bwd_ref(g, prefac, qf, w_hh), dtype, grad=True)
    torch.cuda.synchronize()


# SHAPES, and the one-pass contraction's main users: the headline layer
# (C = H = 96, B 1024; T 20 gives 40 row chunks), the DINO-LSTM's H 128 at
# B 8 (its first layer, in 96, and the rest, in 128); and the headline
# stack's layers at T = 460 (chain dx at layer 0, gup above)
PRODUCT_SHAPES = SHAPES + [(20, 1024, 96, 96, 1), (30, 8, 96, 128, 1), (30, 8, 128, 128, 1)] + [
    (T, B, C, H, 1) for T, B, C, H, _ in HEADLINE_MAIN_SHAPES]


def products_case(shape, dtype, device, chain=None, seed=3):
    T, B, C, H, _ = shape
    gen = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(*s, generator=gen).to(device, dtype)

    return r(T, B, 4 * H), r(T, B, C), r(T, B, H), r(C, 4 * H) / math.sqrt(C), chain


@pytest.mark.parametrize("chain", [None, "gup", "dx"])
@pytest.mark.parametrize("shape", PRODUCT_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stack_products_match_plain(cuda, dtype, shape, chain):
    """K2/K2g's products of one layer: dW_ih, dW_hh, db and the chain to the
    layer below (f32, or dx in the stream dtype), T = 1 included (no dW_hh
    term: h's rows lie wholly before 0 there). bf16 at widths the TMA reads
    (C and H multiples of 8) takes the one-pass TMA + wgmma contraction,
    f32 and the other widths do not."""
    _, _, C, H, _ = shape
    args = products_case(shape, dtype, cuda, chain)
    ls.reset_launches()
    got, want = ls.bwd_products(*args), ls._products_ref(*args)
    wgmma = dtype == torch.bfloat16 and C % 8 == 0 and H % 8 == 0
    assert ls.LAUNCHES["stack_bwd_products"] == 1
    assert ls.LAUNCHES["stack_bwd_products_wgmma"] == int(wgmma)
    assert (got[3] is None) == (chain is None)
    if chain is not None:
        assert got[3].dtype == (torch.float32 if chain == "gup" else dtype)
    for a, b in zip(got, want):
        if b is not None:
            assert_close(a, b, dtype, grad=True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(20, 1024, 96, 96, 1), (30, 8, 128, 128, 1),
                                   (12, 16, 96, 384, 1), (1, 1, 96, 96, 1)], ids=str)
def test_stack_products_repeat_bit_for_bit(cuda, shape):
    """The one-pass contraction's dW_ih, dW_hh and db are the same bits on
    every call: fixed chunks, fixed column-sum strands, partials added in
    order."""
    args = products_case(shape, torch.bfloat16, cuda, "gup", seed=5)
    ls.reset_launches()
    first, second = ls.bwd_products(*args), ls.bwd_products(*args)
    assert ls.LAUNCHES["stack_bwd_products_wgmma"] == 2
    for a, b in zip(first, second):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_stack_backward_calls_no_library_product(cuda):
    """K2/K2g on the card run only the port's kernels: no cuBLAS or cuDNN
    product appears among the operators of a backward with dx."""
    from torch.profiler import ProfilerActivity, profile

    x, layers, g = make_stack((9, 40, 96, 96, 3), torch.bfloat16, cuda, seed=4)
    res = ls.fwd_train(x, layers)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ls.bwd(g, x, layers, *res, need_dx=True)
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::mm", "aten::matmul", "aten::bmm", "aten::addmm", "aten::linear",
                      "aten::_cudnn_rnn"}, ops


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    x, layers, _ = make_stack((4, 5, 8, 8, 2), torch.float32, cuda)
    with pytest.raises(ValueError):
        ls.fwd_train(x.transpose(0, 1).contiguous().transpose(0, 1), layers)
    with pytest.raises(RuntimeError):
        ls.fwd_infer_last(x.cpu(), layers)
    with pytest.raises(ValueError):
        ls.fwd_train(x, layers, tile=3)
    h_all, prefac, qf = ls.fwd_train(x, layers)
    with pytest.raises(ValueError):  # a cotangent of another batch
        ls.bwd_scan(torch.zeros(3, 8, device=cuda), prefac[1], qf[1], layers[1][1])
    with pytest.raises(ValueError):
        ls.bwd(torch.zeros(5, 8, device=cuda), x, layers, h_all, prefac, qf, tile=3)
    with pytest.raises(ValueError):  # the chain's kind
        ls.bwd_products(torch.zeros(4, 5, 32, device=cuda), x, h_all[0], layers[0][0], "dh")


# ------------------------------ K1/K4's layer-by-layer path at small batches
# The autoencoder's widths (encoder C 96, H 384; decoder C 384, H 96) at
# B = 16 and a ragged 13, T = 12 (and the main path's 460 for the pieces
# alone): the input product and the cluster scan alone, at every cluster
# size the scan can run the width at (`pick_fwd` takes one of them), and
# the composed K1/K4.
AE_WIDTHS = [(96, 384), (384, 96)]


def fwd_piece_case(B, C, H, dtype, device, seed=0, T=12):
    x, layers, _ = make_stack((T, B, C, H, 1), dtype, device, seed)
    return x, layers[0]


@pytest.mark.parametrize("T", [12, 460])
@pytest.mark.parametrize("B", [16, 13])
@pytest.mark.parametrize("width", AE_WIDTHS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fwd_pieces_match_plain(cuda, dtype, width, B, T):
    """The input product (f32 P, no bias) and the cluster scan at each
    cluster size, with and without K1's residuals, against their plain
    versions on the same inputs."""
    C, H = width
    x, (w_ih, w_hh, b) = fwd_piece_case(B, C, H, dtype, cuda, T=T)
    P = ls.fwd_in_product(x, w_ih)
    want_P = ls._in_product_ref(x, w_ih)
    assert P.dtype == torch.float32
    rel = ((P - want_P).norm() / want_P.norm()).item()
    assert rel <= 1e-6, rel  # f32 sums of exact products in another order
    assert ls.pick_fwd(B, C, H, 1, dtype) in ls.cluster_sizes(H, dtype)
    for n in ls.cluster_sizes(H, dtype):
        for res in (False, True):
            got = ls.fwd_cluster_scan(want_P, w_hh, b, res=res, n=n)
            for a, w in zip(got, ls._fwd_scan_ref(want_P, w_hh, b, res)):
                if w is None:
                    assert a is None
                else:
                    assert a.dtype == dtype
                    assert_close(a, w, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B", [16, 13])
@pytest.mark.parametrize("width", AE_WIDTHS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fwd_layerwise_matches_plain_and_repeats(cuda, dtype, width, B):
    """K1 and K4 through `pick_fwd`'s path (the layer-by-layer one here)
    against the per-step plain versions, one launch of each piece a layer,
    and bit for bit the same on a second run."""
    C, H = width
    x, layers, _ = make_stack((12, B, C, H, 1), dtype, cuda, seed=1)
    ls.reset_launches()
    got = ls.fwd_train(x, layers)
    top = ls.fwd_infer(x, layers)
    assert ls.LAUNCHES["fwd_in_product"] == ls.LAUNCHES["fwd_cluster_scan"] == 2
    for a, b in zip(got, ls._fwd_train_ref(x, layers)):
        assert_close(a, b, dtype)
    assert_close(top, ls._fwd_infer_ref(x, layers), dtype)
    for a, b in zip(got, ls.fwd_train(x, layers)):
        assert torch.equal(a, b)
    assert torch.equal(top, ls.fwd_infer(x, layers))


@pytest.mark.parametrize("L", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fwd_layerwise_stacks(cuda, dtype, L):
    """Several layers at the CLI's widths and at H = 128: each layer's h is
    the next one's input product; K4 keeps the layers below the top in one
    scratch buffer."""
    for shape in ((9, 16, 96, 96, L), (7, 13, 96, 128, L)):
        x, layers, _ = make_stack(shape, dtype, cuda, seed=2)
        B, C, H = shape[1:4]
        for n in ls.cluster_sizes(H, dtype):
            got = ls._fwd_cluster_cuda(x, layers, "fwd_train", n)
            for a, b in zip(got, ls._fwd_train_ref(x, layers)):
                assert_close(a, b, dtype)
            assert_close(ls._fwd_cluster_cuda(x, layers, "fwd_infer", n),
                         ls._fwd_infer_ref(x, layers), dtype)
    torch.cuda.synchronize()


def test_fwd_old_path_keeps_the_shapes_pick_fwd_leaves_it(cuda):
    """At B = 1024 in f32 K4 (`fwd_infer`) and K10 (`fwd_train_rc`) run
    `lstm_fwd_kernel`: bit for bit `_fwd_cuda`'s outputs, no layer-by-layer
    or wavefront launch; in bf16 all four forwards there take the wavefront
    path, one launch each; and at the CLI's B = 16 the old kernel still
    holds to the plain K1 and repeats bit for bit."""
    x, layers, _ = make_stack((8, 1024, 96, 96, 2), torch.float32, cuda, seed=3)
    assert ls.pick_fwd(1024, 96, 96, 2, torch.float32) == 0
    ls.reset_launches()
    top = ls.fwd_infer(x, layers)
    rc = ls.fwd_train_rc(x, layers)
    assert ls.LAUNCHES["fwd_in_product"] == ls.LAUNCHES["fwd_cluster_scan"] == 0
    assert ls.LAUNCHES["fwd_wave"] == ls.LAUNCHES["fwd_wave_split"] == 0
    assert torch.equal(top, ls._fwd_cuda(x, layers, "fwd_infer"))
    for a, b in zip(rc, ls._fwd_cuda(x, layers, "fwd_train_rc")):
        assert torch.equal(a, b)
    xb, lb = x.to(torch.bfloat16), [tuple(w.to(torch.bfloat16) for w in l) for l in layers]
    for kind in ("fwd_train", "fwd_infer_last", "fwd_infer", "fwd_train_rc"):
        getattr(ls, kind)(xb, lb)
    assert ls.LAUNCHES["fwd_wave"] == 4 and ls.LAUNCHES["fwd_wave_split"] == 0
    x, layers, _ = make_stack((8, 16, 96, 96, 2), torch.bfloat16, cuda, seed=4)
    old = ls._fwd_cuda(x, layers, "fwd_train")
    for a, b, c in zip(old, ls._fwd_train_ref(x, layers), ls._fwd_cuda(x, layers, "fwd_train")):
        assert_close(a, b, torch.bfloat16)
        assert torch.equal(a, c)


def test_refused_cluster_raises(cuda):
    """A cluster the card cannot place (32 CTAs, over the 16 a cluster may
    hold) raises and counts no launch; no other path runs in its stead."""
    x, (w_ih, w_hh, b) = fwd_piece_case(16, 384, 96, torch.bfloat16, cuda)
    P = ls.fwd_in_product(x, w_ih)
    ls.reset_launches()
    with pytest.raises(RuntimeError, match="fwd_cluster_scan"):
        ls.fwd_cluster_scan(P, w_hh, b, n=32)
    assert ls.LAUNCHES["fwd_cluster_scan"] == 0
    with pytest.raises(ValueError):  # 7 CTAs do not split 96 units
        ls.fwd_cluster_scan(P, w_hh, b, n=7)
    # the next launch runs clean: the refusal left no error behind
    h, _, _ = ls.fwd_cluster_scan(P, w_hh, b)
    assert_close(h, ls._fwd_scan_ref(P, w_hh, b)[0], torch.bfloat16)


def test_fwd_layerwise_calls_no_library_product(cuda):
    """The layer-by-layer K1/K4 run only the port's kernels: no cuBLAS or
    cuDNN product appears among the operators."""
    from torch.profiler import ProfilerActivity, profile

    x, layers, _ = make_stack((9, 16, 96, 384, 1), torch.bfloat16, cuda, seed=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ls.fwd_train(x, layers)
        ls.fwd_infer(x, layers)
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::mm", "aten::matmul", "aten::bmm", "aten::addmm", "aten::linear",
                      "aten::_cudnn_rnn"}, ops


# ------------------------------------------- K1/K3's wavefront forward
# bf16 at the widths `wave_fits` takes: the bench step's and the CLI's
# batches (1024, its validation's 960), a ragged 13 and a single row, L of 1
# to 3, and two widths with C != H, and the headline stack over T = 460 at
# all four batches; in f32 `fwd_path` keeps K1 on
# `lstm_fwd_kernel` and sends K3 layer by layer, which the same test holds
# to the plain versions.
WAVE_SHAPES = [(40, 1024, 96, 96, 2), (40, 960, 96, 96, 2), (33, 13, 96, 96, 1),
               (25, 1, 96, 96, 3), (19, 40, 32, 64, 3), (11, 17, 128, 48, 2)] + [
    *HEADLINE_MAIN_SHAPES, (460, 960, 96, 96, 2)]


@pytest.mark.parametrize("shape", WAVE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fwd_wave_matches_plain_and_repeats(cuda, dtype, shape):
    """K1 and K3 through `fwd_path`'s path (the wavefront one in bf16, one
    launch each) against the per-step plain versions, bit for bit the same
    on a second run; and K2 on the new K1's residuals against the plain K2
    on the plain residuals."""
    T, B, C, H, L = shape
    x, layers, g = make_stack(shape, dtype, cuda, seed=B + L)
    wave = dtype == torch.bfloat16
    assert (ls.fwd_path(B, C, H, L, dtype, "fwd_train") == "wave") == wave
    ls.reset_launches()
    got = ls.fwd_train(x, layers)
    top = ls.fwd_infer_last(x, layers)
    assert ls.LAUNCHES["fwd_wave"] == (2 if wave else 0)
    assert ls.LAUNCHES["fwd_train"] == ls.LAUNCHES["fwd_infer_last"] == 1
    want = ls._fwd_train_ref(x, layers)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert_close(a, b, dtype)
    assert_close(top, ls._fwd_infer_last_ref(x, layers), dtype)
    for a, b in zip(got, ls.fwd_train(x, layers)):
        assert torch.equal(a, b)
    assert torch.equal(top, ls.fwd_infer_last(x, layers))
    _, got_g = ls.bwd(g, x, layers, *got)
    for got_l, want_l in zip(got_g, ls._bwd_ref(g, x, layers, *want)[1]):
        for a, b in zip(got_l, want_l):
            assert_close(a, b, dtype, grad=True)
    torch.cuda.synchronize()


def test_fwd_wave_takes_unaligned_inputs_and_refuses_other_shapes(cuda):
    """x at an offset that is not a multiple of 16 bytes (layer 0 copies it
    16 bytes at a time) gives the same bits as an aligned copy; f32, a
    width the kernel does not take and K4 raise instead of running another
    path; the occupancy query answers for the CLI's stack."""
    x, layers, _ = make_stack((9, 21, 96, 96, 2), torch.bfloat16, cuda, seed=6)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    for a, b in zip(ls.fwd_train(shifted, layers), ls.fwd_train(x, layers)):
        assert torch.equal(a, b)
    assert ls.wave_clusters(96, 96, 2) >= 1
    assert ls.wave_clusters(96, 128, 4, split=True) >= 1
    ls.reset_launches()
    with pytest.raises(ValueError):
        ls._fwd_wave_cuda(x.float(), [tuple(w.float() for w in l) for l in layers], "fwd_train")
    xa, la, _ = make_stack((9, 21, 40, 96, 2), torch.bfloat16, cuda, seed=7)
    with pytest.raises(ValueError):
        ls._fwd_wave_cuda(xa, la, "fwd_infer_last")
    with pytest.raises(ValueError):
        ls._fwd_wave_cuda(x, layers, "bwd")
    xd, ld, _ = make_stack((9, 21, 96, 128, 5), torch.bfloat16, cuda, seed=7)
    with pytest.raises(ValueError):  # 10 CTAs a cluster
        ls._fwd_wave_cuda(xd, ld, "fwd_train_rc", split=True)
    with pytest.raises(ValueError):  # H = 128 needs the split layer
        ls._fwd_wave_cuda(xd, ld[:4], "fwd_infer")
    assert ls.LAUNCHES["fwd_wave"] == ls.LAUNCHES["fwd_wave_split"] == 0


def test_fwd_wave_calls_no_library_product(cuda):
    """The wavefront K1, K3, K4 and K10, and the split K4 and K10, run only
    the port's kernel: no cuBLAS or cuDNN product appears among the
    operators."""
    from torch.profiler import ProfilerActivity, profile

    x, layers, _ = make_stack((9, 40, 96, 96, 2), torch.bfloat16, cuda, seed=8)
    xd, ld, _ = make_stack((9, 40, 96, 128, 4), torch.bfloat16, cuda, seed=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for kind in ("fwd_train", "fwd_infer_last", "fwd_infer", "fwd_train_rc"):
            getattr(ls, kind)(x, layers)
        ls.fwd_infer(xd, ld)
        ls.fwd_train_rc(xd, ld)
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::mm", "aten::matmul", "aten::bmm", "aten::addmm", "aten::linear",
                      "aten::_cudnn_rnn"}, ops


# -------------------------------- K10/K4 on the wavefront forward and its split
# K10 and K4 through `fwd_path`'s path: the wavefront one at the CLI's
# widths (and two with C != H), the split layer at the DINO-LSTM's C 96,
# H 128 (L 4, and 2), at the bench batch, a ragged 13, the CLI's 16 and one
# row, and RC_MAIN_SHAPES; f32 keeps `lstm_fwd_kernel`.
# The recompute stack's main shapes: the headline widths over T = 460 at
# B = 1024 and 13, the DINO-LSTM backbone's over its 300-sample crops at
# B = 1024, 16 and 13.
RC_MAIN_SHAPES = [(460, 1024, 96, 96, 2), (460, 13, 96, 96, 2), (300, 1024, 96, 128, 4),
                  (300, 16, 96, 128, 4), (300, 13, 96, 128, 4)]
MODE_SHAPES = [(40, 1024, 96, 96, 2), (33, 13, 96, 96, 1), (19, 40, 32, 64, 3),
               (30, 1024, 96, 128, 4), (33, 13, 96, 128, 4), (25, 16, 96, 128, 2),
               (11, 1, 96, 128, 3)] + RC_MAIN_SHAPES


@pytest.mark.parametrize("kind", ["fwd_train_rc", "fwd_infer"])
@pytest.mark.parametrize("shape", MODE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fwd_wave_modes_match_plain_and_repeats(cuda, dtype, shape, kind):
    """K10 (h_all, c_all) or K4 (the top h at every t) through `fwd_path`'s
    path (in bf16 the wavefront forward or its split layer, one launch)
    against the per-step plain versions, bit for bit the same on a second
    run; K10 feeds K11, which gives the plain K11's gradients on it."""
    T, B, C, H, L = shape
    x, layers, _ = make_stack(shape, dtype, cuda, seed=B + L)
    path = ls.fwd_path(B, C, H, L, dtype, kind)
    if dtype == torch.bfloat16:
        assert path == ("split" if H == 128 else "wave")
    ls.reset_launches()
    got = getattr(ls, kind)(x, layers)
    assert ls.LAUNCHES[kind] == 1
    assert ls.LAUNCHES["fwd_wave"] == (path == "wave")
    assert ls.LAUNCHES["fwd_wave_split"] == (path == "split")
    if kind == "fwd_train_rc":
        want = ls._fwd_train_rc_ref(x, layers)
        for a, b in zip(got, want):
            assert a.dtype == dtype
            assert_close(a, b, dtype)
        for a, b in zip(got, ls.fwd_train_rc(x, layers)):
            assert torch.equal(a, b)
        g = torch.randn(T, B, H, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
        dx, got_g = ls.bwd_rc(g, x, layers, *got)
        want_dx, want_g = ls._bwd_rc_ref(g, x, layers, *want)
        assert_close(dx, want_dx, dtype, grad=True)
        for got_l, want_l in zip(got_g, want_g):
            for a, b in zip(got_l, want_l):
                assert_close(a, b, dtype, grad=True)
    else:
        assert got.dtype == dtype and got.shape == (T, B, H)
        assert_close(got, ls._fwd_infer_ref(x, layers), dtype)
        assert torch.equal(got, ls.fwd_infer(x, layers))
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(19, 40, 32, 64, 3), (11, 17, 96, 96, 2), (9, 33, 48, 32, 4)],
                         ids=str)
def test_fwd_wave_split_is_the_unsplit_kernel(cuda, shape):
    """Where a layer fits one CTA, the split layer (two CTAs a layer, the
    halves of h exchanged every step) gives the unsplit kernel's bits in
    every mode: each CTA computes its units' columns over the same k-steps."""
    x, layers, _ = make_stack(shape, torch.bfloat16, cuda, seed=5)
    for kind in ("fwd_train", "fwd_infer_last", "fwd_infer", "fwd_train_rc"):
        one, two = (ls._fwd_wave_cuda(x, layers, kind, split) for split in (False, True))
        for a, b in zip(*((one, two) if isinstance(one, tuple) else ((one,), (two,)))):
            assert torch.equal(a, b), kind
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(17, 70, 96, 128, 4), (9, 1024, 96, 128, 3), (7, 13, 48, 32, 2)],
                         ids=str)
def test_fwd_wave_split_tiles_give_the_same_bits(cuda, shape):
    """The split layer in clusters of 1, 2 and 3 row tiles of 16 (the
    batch then ragged against 32 and 48 rows) gives the same bits in every
    mode; the card holds at least one cluster of each, and `split_tiles`
    picks one of them at this batch."""
    T, B, C, H, L = shape
    x, layers, _ = make_stack(shape, torch.bfloat16, cuda, seed=10)
    clusters = [ls.wave_clusters(C, H, L, True, mt) for mt in (1, 2, 3)]
    assert min(clusters) >= 1, clusters
    assert ls.split_tiles(B, clusters) in (1, 2, 3)
    for kind in ("fwd_train", "fwd_infer_last", "fwd_infer", "fwd_train_rc"):
        outs = [ls._fwd_wave_cuda(x, layers, kind, True, mt) for mt in (1, 2, 3)]
        for other in outs[1:]:
            for a, b in zip(*((outs[0], other) if isinstance(other, tuple)
                              else ((outs[0],), (other,)))):
                assert torch.equal(a, b), kind
    with pytest.raises(ValueError):
        ls._fwd_wave_cuda(x, layers, "fwd_infer", True, 4)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B", [1024, 13])
def test_fwd_wave_split_runs_k1_and_k3(cuda, B):
    """K1 (which `fwd_path` does not route there; chip_smoke.py times it as
    a record) and K3 through the split layer at the DINO-LSTM's widths:
    against the plain versions, and K2 on the split K1's residuals."""
    x, layers, g = make_stack((30, B, 96, 128, 4), torch.bfloat16, cuda, seed=9)
    got = ls._fwd_wave_cuda(x, layers, "fwd_train", split=True)
    want = ls._fwd_train_ref(x, layers)
    for a, b in zip(got, want):
        assert_close(a, b, torch.bfloat16)
    assert_close(ls._fwd_wave_cuda(x, layers, "fwd_infer_last", split=True),
                 ls._fwd_infer_last_ref(x, layers), torch.bfloat16)
    _, got_g = ls.bwd(g, x, layers, *got)
    for got_l, want_l in zip(got_g, ls._bwd_ref(g, x, layers, *want)[1]):
        for a, b in zip(got_l, want_l):
            assert_close(a, b, torch.bfloat16, grad=True)
    torch.cuda.synchronize()


# ---------------------------------------------------- K3 at H = 128
# The DINO-LSTM teacher's widths (C 96, H 128, L 4) and the Spampinato rig's
# (C = H = 128, L 4) in bf16 on the split wavefront; the eval's (C 96, H 128,
# L 4) in f32 at its gallery and query batches (320, 80) and a ragged 21 at
# L 3 on the layer-by-layer path (the top layer's scan writing h at T-1
# alone); T short.
K3_SHAPES = [((13, 16, 96, 128, 4), torch.bfloat16), ((11, 16, 128, 128, 4), torch.bfloat16),
             ((9, 320, 96, 128, 4), torch.float32), ((9, 80, 96, 128, 4), torch.float32),
             ((7, 21, 96, 128, 3), torch.float32)]


@pytest.mark.parametrize("shape,dtype", K3_SHAPES, ids=str)
def test_k3_at_h128_takes_its_path_and_matches_plain(cuda, shape, dtype):
    """K3 through `fwd_path`'s path (bf16: one `fwd_wave_split` launch; f32:
    an input product and a cluster scan a layer, no wavefront launch)
    against the per-step plain K3, bit for bit the same on a second run; in
    f32 every cluster size the width fits gives the plain K3 and the top h
    of the sequence form (`fwd_infer`'s last step) bit for bit."""
    T, B, C, H, L = shape
    x, layers, _ = make_stack(shape, dtype, cuda, seed=B + C)
    bf16 = dtype == torch.bfloat16
    assert ls.fwd_path(B, C, H, L, dtype, "fwd_infer_last") == ("split" if bf16 else "cluster")
    ls.reset_launches()
    got = ls.fwd_infer_last(x, layers)
    n = ls.LAUNCHES
    assert (n["fwd_infer_last"], n["fwd_wave_split"], n["fwd_wave"]) == (1, int(bf16), 0)
    assert n["fwd_in_product"] == n["fwd_cluster_scan"] == (0 if bf16 else L)
    want = ls._fwd_infer_last_ref(x, layers)
    assert got.dtype == dtype and got.shape == (B, H)
    assert_close(got, want, dtype)
    assert torch.equal(got, ls.fwd_infer_last(x, layers))
    if not bf16:
        for m in ls.cluster_sizes(H, dtype):
            last = ls._fwd_cluster_cuda(x, layers, "fwd_infer_last", m)
            assert_close(last, want, dtype)
            assert torch.equal(last, ls._fwd_cluster_cuda(x, layers, "fwd_infer", m)[-1])
    torch.cuda.synchronize()


def test_rc_stack_launches_the_wavefront_forward(cuda):
    """lstm_stack_rc in bf16 at the headline and DINO widths: a grad call
    launches K10 and K11 once, K10 on the wavefront forward (its split layer
    at H = 128), and a no-grad call K4 on the same path."""
    for shape, name in (((12, 20, 96, 96, 2), "fwd_wave"),
                        ((12, 20, 96, 128, 4), "fwd_wave_split")):
        x, layers, _ = make_stack(shape, torch.bfloat16, cuda, seed=6)
        ls.reset_launches()
        xs = x.clone().requires_grad_(True)
        ls.lstm_stack_rc(xs, layers).float().sum().backward()
        with torch.no_grad():
            top = ls.lstm_stack_rc(x, layers)
        assert {k: ls.LAUNCHES[k] for k in ("fwd_train_rc", "bwd_rc", "fwd_infer", name)} == {
            "fwd_train_rc": 1, "bwd_rc": 1, "fwd_infer": 1, name: 2}, ls.LAUNCHES
        assert ls.LAUNCHES["fwd_train"] == ls.LAUNCHES["fwd_in_product"] == 0
        assert_close(top, ls._fwd_infer_ref(x, layers), torch.bfloat16)
        assert torch.isfinite(xs.grad.float()).all()


# ------------------------------------- recompute stack K10/K11, scan K12–K14
# The stack shapes above and the DINO-LSTM backbone's depth and width (C 96,
# H 128, L 4); the scan's (T, B, H) with a ragged batch, T = 1, 4H below one
# warp's multiple and above the block's 512 threads.
RC_SHAPES = SHAPES + [(5, 9, 96, 128, 4)]
SCAN_SHAPES = [(1, 1, 96), (7, 13, 10), (9, 40, 96), (12, 16, 384), (6, 5, 128)]


@pytest.mark.parametrize("shape,tile", tiled(RC_SHAPES, RC_MAIN_SHAPES), ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rc_kernels_match_plain(cuda, dtype, shape, tile):
    """K10's h_all and c_all, and K11 on the plain forward's residuals: dx and
    every dW."""
    x, layers, _ = make_stack(shape, dtype, cuda)
    g = torch.randn(*x.shape[:2], shape[3], generator=torch.Generator().manual_seed(1)).to(
        cuda, dtype)
    want = ls._fwd_train_rc_ref(x, layers)
    for a, b in zip(ls.fwd_train_rc(x, layers, tile), want):
        assert_close(a, b, dtype)
    dx, got_g = ls.bwd_rc(g, x, layers, *want, tile=tile)
    want_dx, want_g = ls._bwd_rc_ref(g, x, layers, *want)
    assert_close(dx, want_dx, dtype, grad=True)
    for got_l, want_l in zip(got_g, want_g):
        for a, b in zip(got_l, want_l):
            assert_close(a, b, dtype, grad=True)
    torch.cuda.synchronize()


def test_rc_wrapper_gives_the_plain_gradients_and_launches(cuda):
    """lstm_stack_rc under grad: K10 + K11 once each, the gradients of the
    plain pair; without grad: K4."""
    x, layers, _ = make_stack((11, 6, 96, 128, 3), torch.float32, cuda, seed=3)
    w_out = torch.randn(11, 6, 128, device=cuda)
    grads = []
    for fn in (ls.lstm_stack_rc, ls.lstm_stack_rc_ref):
        xs = x.clone().requires_grad_(True)
        ws = [tuple(w.clone().requires_grad_(True) for w in l) for l in layers]
        (fn(xs, ws) * w_out).sum().backward()
        grads.append([xs.grad] + [w.grad for l in ws for w in l])
    for a, b in zip(*grads):
        assert_close(a, b, torch.float32, grad=True)
    ls.reset_launches()
    xs = x.clone().requires_grad_(True)
    ls.lstm_stack_rc(xs, layers).sum().backward()
    with torch.no_grad():
        ls.lstm_stack_rc(x, layers)
    names = ("fwd_train_rc", "bwd_rc", "fwd_infer")
    assert {k: ls.LAUNCHES[k] for k in names} == dict.fromkeys(names, 1)
    # K11 is one gate product, scan and products a chunk and layer
    chunks = -(-11 // ls.rc_chunk(11, 6, ls.rc_group(6)))
    pieces = ("rc_gates", "rc_scan", "rc_products")
    assert {k: ls.LAUNCHES[k] for k in pieces} == dict.fromkeys(pieces, 3 * chunks)
    assert ls.LAUNCHES["fwd_train"] == ls.LAUNCHES["bwd_general"] == 0
    assert ls.LAUNCHES["stack_bwd_scan"] == 0


def test_rc_gradients_are_deterministic(cuda):
    """K11 gives bitwise-repeatable dx and weight gradients."""
    x, layers, _ = make_stack((20, 37, 96, 128, 2), torch.bfloat16, cuda, seed=2)
    g = torch.randn(20, 37, 128, generator=torch.Generator().manual_seed(1)).to(
        cuda, torch.bfloat16)
    res = ls.fwd_train_rc(x, layers)
    (dx1, first), (dx2, second) = (ls.bwd_rc(g, x, layers, *res) for _ in range(2))
    assert torch.equal(dx1, dx2)
    for a, b in zip(first, second):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.parametrize("chunk", [1, 3, -1], ids=["chunk1", "chunk3", "chunkT-1"])
@pytest.mark.parametrize("shape", RC_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rc_chunks_match_plain(cuda, dtype, shape, chunk):
    """K11 cut into time chunks of 1, 3 and T-1 steps (dW groups of one
    step) against the plain K11, and bit for bit the same as one chunk of
    the whole sequence: the chunked scan is the unchunked one, and the dW
    groups do not move with the chunk."""
    x, layers, _ = make_stack(shape, dtype, cuda)
    T = shape[0]
    g = torch.randn(*x.shape[:2], shape[3], generator=torch.Generator().manual_seed(1)).to(
        cuda, dtype)
    res = ls._fwd_train_rc_ref(x, layers)
    dx, got_g = ls._bwd_rc_cuda(g, x, layers, *res, chunk=chunk % T or T, group=1)
    want_dx, want_g = ls._bwd_rc_ref(g, x, layers, *res)
    assert_close(dx, want_dx, dtype, grad=True)
    for got_l, want_l in zip(got_g, want_g):
        for a, b in zip(got_l, want_l):
            assert_close(a, b, dtype, grad=True)
    whole_dx, whole_g = ls._bwd_rc_cuda(g, x, layers, *res, chunk=T, group=1)
    assert torch.equal(dx, whole_dx)
    for got_l, whole_l in zip(got_g, whole_g):
        for a, b in zip(got_l, whole_l):
            assert torch.equal(a, b)


# (n steps of a chunk, B, in, H, starting at t = 0, steps of a dW group): a
# first chunk (h_prev and c_prev zero at its first step) and a later one, a
# one-step first chunk, a ragged batch, C = 300 and H = 384, in groups of 2
# steps; and the headline stack's chunks at B = 1024 (T = 460: chunks of 64
# steps, the last one 12, in groups of 4, as `rc_chunk` and `rc_group` cut
# them)
RC_PIECE_SHAPES = [(5, 8, 96, 96, True, 2), (5, 8, 96, 96, False, 2), (1, 13, 24, 10, True, 2),
                   (4, 13, 300, 64, False, 2), (3, 16, 96, 384, True, 2),
                   (6, 9, 96, 128, False, 2), (64, 1024, 96, 96, True, 4),
                   (64, 1024, 96, 96, False, 4), (12, 1024, 96, 96, False, 4)]


def rc_piece_case(shape, dtype, device, seed=0):
    n, B, in_dim, H, first, _ = shape
    gen = torch.Generator().manual_seed(seed)

    def r(*s, sc=1.0):
        return (torch.randn(*s, generator=gen) * sc).to(device, dtype)

    back = n - 1 if first else n
    return (r(n, B, in_dim), ls._shifted(r(back, B, H, sc=0.5), n),
            r(in_dim, 4 * H, sc=in_dim ** -0.5), r(H, 4 * H, sc=H ** -0.5), r(4 * H, sc=0.1),
            r(n, B, H), ls._shifted(r(back, B, H), n))


@pytest.mark.parametrize("shape", RC_PIECE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rc_gates_and_scan_match_plain(cuda, dtype, shape):
    """K11's gate recompute (f32 gates of a chunk, h one step back, zero at
    t = 0) and its scan, which forms the residuals (prefactors in the stream
    dtype, q and f in f32) from the gates as it goes, under a cotangent in
    the stream dtype and in f32 with a carry in and out, against their
    plain versions, each on the same inputs."""
    inp, h_prev, w_ih, w_hh, b, c, c_prev = rc_piece_case(shape, dtype, cuda)
    gates = ls.rc_gates(inp, h_prev, w_ih, w_hh, b)
    assert gates.dtype == torch.float32
    want = ls._rc_gates_ref(inp, h_prev, w_ih, w_hh, b)
    rel = ((gates - want).norm() / want.norm()).item()
    assert rel <= 1e-6, rel  # f32 sums of exact products in another order
    n, B, _, H, _, _ = shape
    gen = torch.Generator().manual_seed(5)
    carry = torch.randn(2, B, H, generator=gen).to(cuda)
    for g in (torch.randn(n, B, H, generator=gen).to(cuda, dtype),
              torch.randn(n, B, H, generator=gen).to(cuda)):
        got_carry, want_carry = carry.clone(), carry.clone()
        dg = ls.rc_scan(g, want, c, c_prev, w_hh, got_carry)
        assert dg.dtype == dtype
        assert_close(dg, ls._rc_scan_ref(g, want, c, c_prev, w_hh, want_carry), dtype, grad=True)
        assert_close(got_carry, want_carry, dtype, grad=True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("chain", ["gup", "dx"])
@pytest.mark.parametrize("shape", RC_PIECE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rc_products_match_plain(cuda, dtype, shape, chain):
    """K11's products of one chunk: dW partials per group of the case's
    steps (from sub-groups of the rows) and the chain, against the plain
    version; and groups of 600 rows, which split into sub-groups of 600 and
    fold nothing."""
    inp, h_prev, w_ih, _, _, _, _ = rc_piece_case(shape, dtype, cuda, seed=1)
    n, B, _, H, _, group = shape
    dgates = torch.randn(n, B, 4 * H, generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    part, out = ls.rc_products(dgates, inp, h_prev, w_ih, chain, group * B)
    want_part, want_out = ls._rc_products_ref(dgates, inp, h_prev, w_ih, chain, group * B)
    assert part.shape == want_part.shape and out.dtype == want_out.dtype
    for a, b in zip(part, want_part):
        assert_close(a, b, dtype, grad=True)
    assert_close(out, want_out, dtype, grad=True)
    for a, b in zip(ls.rc_products(dgates, inp, h_prev, w_ih, chain, 600)[0],
                    ls._rc_products_ref(dgates, inp, h_prev, w_ih, chain, 600)[0]):
        assert_close(a, b, dtype, grad=True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("cot", ["stream", "f32"])
@pytest.mark.parametrize("shape", STACK_SCAN_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rc_scan_chunks_equal_one_scan(cuda, dtype, shape, cot):
    """K11's scan over a sequence's gates and c, cut into chunks of 1 and 3
    steps that hand the carries on, gives one launch's dgates bit for bit,
    and holds to the plain scan."""
    x_proj, w_hh, g = scan_case(shape, dtype, cuda)
    T, B, H = shape
    gates = x_proj.float() * 2
    c = torch.randn(T, B, H, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    c_prev = ls._shifted(c[:-1], T)
    if cot == "f32":
        g = torch.randn(g.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    zero = torch.zeros(2, B, H, device=cuda)
    whole = ls.rc_scan(g, gates, c, c_prev, w_hh, zero.clone())
    assert_close(whole, ls._rc_scan_ref(g, gates, c, c_prev, w_hh, zero.clone()), dtype,
                 grad=True)
    for chunk in (1, 3):
        carry = zero.clone()
        parts = [ls.rc_scan(g[t0:t0 + chunk], gates[t0:t0 + chunk], c[t0:t0 + chunk],
                            c_prev[t0:t0 + chunk], w_hh, carry)
                 for t0 in reversed(range(0, T, chunk))]
        assert torch.equal(torch.cat(parts[::-1]), whole)


def test_rc_backward_calls_no_library_product(cuda):
    """K11 on the card runs only the port's kernels: no cuBLAS or cuDNN
    product appears among the operators of one backward."""
    from torch.profiler import ProfilerActivity, profile

    x, layers, _ = make_stack((9, 40, 96, 96, 3), torch.bfloat16, cuda, seed=4)
    g = torch.randn(9, 40, 96, device=cuda).to(torch.bfloat16)
    res = ls.fwd_train_rc(x, layers)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ls.bwd_rc(g, x, layers, *res)
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::mm", "aten::matmul", "aten::bmm", "aten::addmm", "aten::linear",
                      "aten::_cudnn_rnn"}, ops


def scan_case(shape, dtype, device, seed=0):
    T, B, H = shape
    gen = torch.Generator().manual_seed(seed)
    x_proj = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(device, dtype)
    w_hh = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) / math.sqrt(H)).to(device, dtype)
    g = torch.randn(T, B, H, generator=gen).to(device, dtype)
    return x_proj, w_hh, g


@pytest.mark.parametrize("shape,tile", tiled(SCAN_SHAPES, HEADLINE_SCAN_SHAPES), ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_kernels_match_plain(cuda, dtype, shape, tile):
    """K12's h_all, K13's h_all, prefac and qf, and K14's dgates on the plain
    forward's residuals."""
    from cerebra_torch.models import lstm_scan as sc

    x_proj, w_hh, g = scan_case(shape, dtype, cuda)
    assert_close(sc.scan_fwd_infer(x_proj, w_hh, tile), sc._scan_fwd_infer_ref(x_proj, w_hh),
                 dtype)
    want = sc._scan_fwd_train_ref(x_proj, w_hh)
    for a, b in zip(sc.scan_fwd_train(x_proj, w_hh, tile), want):
        assert_close(a, b, dtype)
    assert_close(sc.scan_bwd(g, *want[1:], w_hh, tile), sc._scan_bwd_ref(g, *want[1:], w_hh),
                 dtype, grad=True)
    torch.cuda.synchronize()


def test_scan_wrapper_gives_the_plain_gradients_and_launches(cuda):
    """lstm_scan under grad: K13 + K14 once each, both gradients as through
    the plain versions; without grad: K12."""
    from cerebra_torch.models import lstm_scan as sc

    x_proj, w_hh, g = scan_case((11, 6, 96), torch.float32, cuda, seed=4)
    grads = []
    for fn in (sc.lstm_scan, sc.lstm_scan_ref):
        xs, ws = x_proj.clone().requires_grad_(True), w_hh.clone().requires_grad_(True)
        (fn(xs, ws) * g).sum().backward()
        grads.append((xs.grad, ws.grad))
    for a, b in zip(*grads):
        assert_close(a, b, torch.float32, grad=True)
    ls.reset_launches()
    xs = x_proj.clone().requires_grad_(True)
    sc.lstm_scan(xs, w_hh).sum().backward()
    with torch.no_grad():
        sc.lstm_scan(x_proj, w_hh)
    names = ("scan_fwd_infer", "scan_fwd_train", "scan_bwd")
    assert {k: ls.LAUNCHES[k] for k in names} == dict.fromkeys(names, 1)


def test_scan_dw_hh_keeps_tf32_off(cuda):
    """lstm_scan's dW_hh sums in f32 on the card where the caller turned TF32
    on, bit for bit as where it is off, and the caller's setting survives."""
    from cerebra_torch.models import lstm_scan as sc

    x_proj, w_hh, g = scan_case((40, 64, 96), torch.float32, cuda, seed=6)
    grads = []
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            ws = w_hh.clone().requires_grad_(True)
            (sc.lstm_scan(x_proj, ws) * g).sum().backward()
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
            grads.append(ws.grad)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(*grads)


def test_rc_and_scan_wrappers_raise_instead_of_falling_back(cuda):
    from cerebra_torch.models import lstm_scan as sc

    x, layers, _ = make_stack((4, 5, 8, 8, 2), torch.float32, cuda)
    with pytest.raises(ValueError):
        ls.fwd_train_rc(x.transpose(0, 1).contiguous().transpose(0, 1), layers)
    with pytest.raises(RuntimeError):
        ls.fwd_train_rc(x.cpu(), layers)
    res = ls.fwd_train_rc(x, layers)
    with pytest.raises(ValueError):
        ls.bwd_rc(torch.zeros(5, 8, device=cuda), x, layers, *res)  # a (B, H) cotangent
    with pytest.raises(ValueError):
        ls.bwd_rc(torch.zeros(4, 5, 8, device=cuda), x, layers, *res, tile=3)
    x_proj, w_hh, g = scan_case((4, 5, 8), torch.float32, cuda)
    with pytest.raises(RuntimeError):
        sc.scan_fwd_infer(x_proj, w_hh.cpu())
    with pytest.raises(ValueError):
        sc.scan_fwd_train(x_proj.transpose(0, 1).contiguous().transpose(0, 1), w_hh)
    with pytest.raises(ValueError):
        sc.scan_fwd_train(x_proj, w_hh, tile=3)
    with pytest.raises(ValueError):
        sc.scan_bwd(g[:, :, :-1].contiguous(), *sc.scan_fwd_train(x_proj, w_hh)[1:], w_hh)



# The scan's wavefront forward (K12/K13 in bf16): (T, B, H) at the bench
# batch, the CLI's and a ragged one at the Perils width (T = 20 and 460),
# the DINO-LSTM's H = 128 (two CTAs a tile only) and H = 48 (one only), each
# with every CTA count the width takes.
WAVE_SCAN_SHAPES = [(20, 1024, 96), (20, 16, 96), (20, 13, 96), (9, 13, 128), (7, 40, 48)] + \
    HEADLINE_SCAN_SHAPES
WAVE_SCAN_CASES = [(shape, ns) for shape in WAVE_SCAN_SHAPES for ns in (1, 2)
                   if shape[2] % (16 * ns) == 0 and 4 * shape[2] // ns <= 384]


@pytest.mark.parametrize("shape, ns", WAVE_SCAN_CASES, ids=str)
def test_scan_wave_matches_its_composition_and_plain(cuda, shape, ns):
    """K12 and K13 on the scan's wavefront forward with `ns` CTAs a tile
    against its plain composition and the plain versions, every output; K14
    on its residuals; a second run gives the same bits."""
    from cerebra_torch.models import lstm_scan as sc

    bf = torch.bfloat16
    x_proj, w_hh, g = scan_case(shape, bf, cuda, seed=ns)
    ls.reset_launches()
    h = sc._fwd_cuda(x_proj, w_hh, False, ns=ns)
    res = sc._fwd_cuda(x_proj, w_hh, True, ns=ns)
    name = "scan_fwd_wave_split" if ns == 2 else "scan_fwd_wave"
    assert ls.LAUNCHES[name] == 2 and ls.LAUNCHES["scan_fwd_wave" if ns == 2 else
                                                   "scan_fwd_wave_split"] == 0
    comp = sc._scan_wave_ref(x_proj, w_hh, True, ns)
    plain = sc._scan_fwd_train_ref(x_proj, w_hh)
    for want in (comp, plain):
        assert_close(h, want[0], bf)
        for a, b in zip(res, want):
            assert_close(a, b, bf)
    assert_close(sc.scan_bwd(g, *res[1:], w_hh), sc._scan_bwd_ref(g, *res[1:], w_hh), bf,
                 grad=True)
    assert torch.equal(h, sc._fwd_cuda(x_proj, w_hh, False, ns=ns))
    assert all(torch.equal(a, b) for a, b in zip(res, sc._fwd_cuda(x_proj, w_hh, True, ns=ns)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(30, 1024, 96), (30, 13, 96)] + HEADLINE_SCAN_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_scan_wave_routes_and_gives_the_plain_gradients(cuda, dtype, shape):
    """lstm_scan at H = 96: K13 (in bf16 on the wavefront forward with the
    CTAs a tile `scan_ns` picks, in f32 on scan_fwd_kernel), then K14, both
    gradients as through the plain versions; without grad K12 on the same
    kernel."""
    from cerebra_torch.models import lstm_scan as sc

    B = shape[1]
    x_proj, w_hh, g = scan_case(shape, dtype, cuda, seed=B)
    ns = sc.scan_ns(B, 96, dtype)
    assert ns in ((1, 2) if dtype == torch.bfloat16 else (0,))
    grads = []
    ls.reset_launches()
    for fn in (sc.lstm_scan, sc.lstm_scan_ref):
        xs, ws = x_proj.clone().requires_grad_(True), w_hh.clone().requires_grad_(True)
        (fn(xs, ws) * g).sum().backward()
        grads.append((xs.grad, ws.grad))
    for a, b in zip(*grads):
        assert_close(a, b, dtype, grad=True)
    with torch.no_grad():
        assert_close(sc.lstm_scan(x_proj, w_hh), sc._scan_fwd_infer_ref(x_proj, w_hh), dtype)
    want = {"scan_fwd_train": 1, "scan_bwd": 1, "scan_fwd_infer": 1,
            "scan_fwd_wave": 2 * (ns == 1), "scan_fwd_wave_split": 2 * (ns == 2)}
    assert {k: ls.LAUNCHES[k] for k in want} == want, ls.LAUNCHES


def test_scan_library_call_computes_lstm_scan(cuda):
    """The library column of the scan's timing rows, cuDNN's nn.LSTM(4H, H)
    with weight_ih = I and zero biases over x_proj (W_hh transposed),
    computes lstm_scan's function: h_all and both gradients against the
    plain versions in f32 at H = 96, T = 460, B = 13, within ten times the
    kernels' f32 limits."""
    from cerebra_torch.models import lstm_scan as sc

    x_proj, w_hh, g = scan_case((460, 13, 96), torch.float32, cuda, seed=13)
    lstm = torch.nn.LSTM(4 * 96, 96).to(cuda)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * 96))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
        lstm.weight_hh_l0.copy_(w_hh.t())
    xs = x_proj.clone().requires_grad_(True)
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        h = lstm(xs)[0]
        d_x, d_wT = torch.autograd.grad(h, (xs, lstm.weight_hh_l0), g)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    xr, wr = x_proj.clone().requires_grad_(True), w_hh.clone().requires_grad_(True)
    want = sc.lstm_scan_ref(xr, wr)
    want_d = torch.autograd.grad(want, (xr, wr), g)
    assert (h - want).abs().max().item() <= 1e-4
    for a, b in ((d_x, want_d[0]), (d_wT.t(), want_d[1])):
        assert ((a - b).norm() / b.norm()).item() <= 1e-4


def test_scan_wave_layout_and_refusals(cuda):
    """The kernel's shared memory is `scan_wave_smem`'s at every width it
    takes; a width it does not take raises before any launch."""
    from cerebra_torch.models import lstm_scan as sc

    lib = sc._lib()
    for H in range(16, 129, 16):
        for ns in (1, 2):
            if sc.scan_wave_fits(H, torch.bfloat16, ns):
                assert lib.cerebra_scan_wave_smem(H, ns) == sc.scan_wave_smem(H, ns)
                assert sc.scan_wave_clusters(H, ns) > 0
    x_proj, w_hh, _ = scan_case((3, 5, 128), torch.bfloat16, cuda)
    ls.reset_launches()
    with pytest.raises(ValueError):
        sc._fwd_cuda(x_proj, w_hh, False, ns=1)  # 512 threads
    with pytest.raises(ValueError):
        sc._fwd_cuda(x_proj.float(), w_hh.float(), False, ns=2)  # f32
    assert ls.LAUNCHES["scan_fwd_wave"] == ls.LAUNCHES["scan_fwd_wave_split"] == 0


# ------------------------------------------------ fused ViT half-blocks K5–K8
# (B, N, D, H): dh 8 with a ragged tile, dh 64 over two key tiles, the
# locals' width at a small batch, main_dino's globals (12,560 rows: ragged
# 128-row tiles of the wgmma products, which the TMA's zero fill pads);
# and the main paths' ViT-S half-blocks: main_dino's locals (B 32, N 145)
# and a ragged N 37; eeg_retrieval_dino's ViT-Ti/16 (B 64, N 197, D 192);
# the DINOv2 ViT-S/14 teacher at 224 px (B 64, N 257) and 518 px (B 40,
# N 1370), and noise_probe's ViT-Ti/16 at 64 px (B 16, N 17). Limits: the
# ViT kernels' (the module docstring).
VIT_SHAPES = [(2, 13, 32, 4), (3, 70, 64, 1), (2, 145, 384, 6), (16, 785, 384, 6),
              (32, 145, 384, 6), (3, 37, 384, 6), (64, 197, 192, 3), (64, 257, 384, 6),
              (40, 1370, 384, 6), (16, 17, 192, 3)]
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


@pytest.mark.parametrize("counter", ["vit_attn_products_wgmma", "vit_attn_core_one_pass"])
@pytest.mark.parametrize("dt", list(VIT_DTYPES))
@pytest.mark.parametrize("shape", [(2, 145, 384, 6), (2, 13, 36, 4)], ids=str)
def test_vit_attn_products_take_wgmma_in_bf16(cuda, shape, dt, counter):
    """K5/K6's products take the TMA + wgmma path and their attention cores
    the one-pass path, each counted once a call (`counter`), exactly where
    the compute dtype is bf16; f32 keeps its f32 bodies and two-pass cores
    at any width and leaves both counts; bf16 at D 36, whose rows the TMA
    cannot read, is refused with a ValueError before any launch."""
    from cerebra_torch.kernels import LAUNCHES
    from cerebra_torch.models import vit_attn as va

    B, N, D, H = shape
    sd, cdt = VIT_DTYPES[dt]
    x, params, dout, s = vit_inputs(B, N, D, 0, sd, cuda, 8, True, attn=True)
    p = va._prep(*params, H, cdt)
    before = dict(LAUNCHES)
    if cdt == torch.bfloat16 and D % 8:
        with pytest.raises(ValueError, match="16-byte aligned"):
            va.attn_fwd(x, s, p, H)
        assert dict(LAUNCHES) == before
        return
    _, saved = va.attn_fwd(x, s, p, H)
    va.attn_bwd(dout, x, s, p, H, saved)
    want = 2 if cdt == torch.bfloat16 else 0
    assert LAUNCHES[counter] == before[counter] + want
    torch.cuda.synchronize()


@pytest.mark.parametrize("M", [128 * 2 * 785, 128 * 4 * 145], ids=str)
def test_vit_attn_dw_splits_fill_the_card(cuda, M):
    """At main_dino's batch-128 rows K6's dW chunk count on this card puts
    the 36 output tiles of dWp (D, D) and dWqkv (D, 3D), D 384, times the
    chunks on every SM and in one wave at two CTAs an SM, as full as whole
    chunks make it (7 on a 132-SM H100); no chunk is empty."""
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    s = va.dw_splits(M, 384)
    tiles, slots = 3 * 3 + 3 * 9, 2 * sms
    assert sms <= tiles * s <= slots < tiles * (s + 1)
    assert all(r1 > r0 for r0, r1 in vm.row_chunks(M, s))


def test_vit_attn_bf16_calls_run_no_gemm_tc(cuda):
    """A bf16 K5 + K6 at main_dino's width runs its products as
    wgmma_gemm.cuh's tma_gemm and no vit_common.cuh gemm_tc kernel."""
    from torch.profiler import ProfilerActivity, profile

    from cerebra_torch.models import vit_attn as va

    B, N, D, H = 2, 145, 384, 6
    x, params, dout, s = vit_inputs(B, N, D, 0, torch.float32, cuda, 9, True, attn=True)
    p = va._prep(*params, H, torch.bfloat16)
    _, saved = va.attn_fwd(x, s, p, H)
    va.attn_bwd(dout, x, s, p, H, saved)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):  # the tracer can miss its first kernel
            _, saved = va.attn_fwd(x, s, p, H)
            va.attn_bwd(dout, x, s, p, H, saved)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert not [n for n in names if "gemm_tc" in n], names
    assert len([n for n in names if "tma_gemm" in n]) == 5, names  # 5 epilogues


def test_vit_attn_repeats_bit_for_bit(cuda):
    """K5 and K6 in bf16 at main_dino's globals give the same bits on a
    second call: fixed dW chunks and orders of sums, no atomics."""
    from cerebra_torch.models import vit_attn as va

    B, N, D, H = 16, 785, 384, 6
    x, params, dout, s = vit_inputs(B, N, D, 0, torch.float32, cuda, 10, True, attn=True)
    p = va._prep(*params, H, torch.bfloat16)
    runs = []
    for _ in range(2):
        out, saved = va.attn_fwd(x, s, p, H)
        runs.append((out, *saved, *va.attn_bwd(dout, x, s, p, H, saved)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scaled", [False, True], ids=["no_s", "s"])
@pytest.mark.parametrize("dt", list(VIT_DTYPES))
@pytest.mark.parametrize("shape", [(1, 37, 32, 96), (2, 145, 384, 1536)] + [
    (B, N, D, 4 * D) for B, N, D, _ in VIT_SHAPES[3:]], ids=str)
def test_vit_mlp_kernels_match_plain(cuda, shape, dt, scaled):
    """K7 and K8 (B, N, D, F) at a small width, main_dino's locals' at a
    small batch and the main paths' half-blocks of VIT_SHAPES."""
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


# K7/K8's products alone (TMA + wgmma) against their plain version (f32
# products of the same bf16 operands), in each orientation the half-blocks
# use (fc1/fc2: A·B; dy: A·Bᵀ; dW: Aᵀ·B), with each epilogue, at ragged M, N
# and K: (77, 200, 72) and (300, 260, 200) with 16-byte aligned rows (K not
# a multiple of the 64-deep k step); (45, 130, 45), whose odd rows the TMA
# cannot read, is refused with a ValueError. f32 outputs relative Frobenius
# 2e-5, bf16 ones 1.5e-2 (TOL_VIT's).
MLP_ORIENT = {"ab": (False, False), "abt": (False, True), "atb": (True, False)}
MLP_PRODUCT_SHAPES = [(77, 200, 72), (300, 260, 200), (45, 130, 45)]


def mlp_product_inputs(M, N, K, a_t, b_t, cuda, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def r(*s, sc=0.5):
        return (torch.randn(*s, generator=gen) * sc).to(cuda)

    a = r(*((K, M) if a_t else (M, K))).to(torch.bfloat16)
    b = r(*((N, K) if b_t else (K, N))).to(torch.bfloat16)
    bias = r(N, sc=0.1).to(torch.bfloat16)
    x = r(M, N, sc=1.0)
    s = torch.full((M,), 1 / 0.9, device=cuda)
    s[0] = 0.0
    return a, b, bias, x, s


@pytest.mark.parametrize("epi", ["f32", "gelu", "residual", "partial"])
@pytest.mark.parametrize("orient", list(MLP_ORIENT))
@pytest.mark.parametrize("shape", MLP_PRODUCT_SHAPES, ids=str)
def test_vit_mlp_product_matches_plain(cuda, shape, orient, epi):
    from cerebra_torch.kernels import LAUNCHES
    from cerebra_torch.models import vit_mlp as vm

    a_t, b_t = MLP_ORIENT[orient]
    a, b, bias, x, s = mlp_product_inputs(*shape, a_t, b_t, cuda)
    kw = dict(a_t=a_t, b_t=b_t, epi=epi, bias=bias, x=x, s=s, splits=3)
    before = LAUNCHES["vit_mlp_product"]
    if a.shape[1] % 8 or b.shape[1] % 8:  # rows the TMA cannot read
        with pytest.raises(ValueError):
            vm.mlp_product(a, b, **kw)
        assert LAUNCHES["vit_mlp_product"] == before
        return
    got = vm.mlp_product(a, b, **kw)
    want = vm.mlp_product_ref(a, b, **kw)
    assert LAUNCHES["vit_mlp_product"] == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    vit_close(got, want, torch.bfloat16 if epi == "gelu" else torch.float32, grad=True)
    torch.cuda.synchronize()


# K5's qkv and K6's do epilogue on the same products: C + bias (or C alone)
# rounded once to bf16, in every orientation, against the plain product, at
# ragged M, N and K; (304, 264, 200) has 16-byte aligned rows in every
# orientation, and operands whose rows are not are refused as above.
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("orient", list(MLP_ORIENT))
@pytest.mark.parametrize("shape", [(77, 200, 72), (304, 264, 200)], ids=str)
def test_vit_bias_round_product_matches_plain(cuda, shape, orient, bias):
    from cerebra_torch.kernels import LAUNCHES
    from cerebra_torch.models import vit_mlp as vm

    a_t, b_t = MLP_ORIENT[orient]
    a, b, bi, _, _ = mlp_product_inputs(*shape, a_t, b_t, cuda)
    kw = dict(a_t=a_t, b_t=b_t, epi="bias_round", bias=bi if bias else None)
    before = LAUNCHES["vit_mlp_product"]
    if a.shape[1] % 8 or b.shape[1] % 8:  # rows the TMA cannot read
        with pytest.raises(ValueError):
            vm.mlp_product(a, b, **kw)
        assert LAUNCHES["vit_mlp_product"] == before
        return
    got = vm.mlp_product(a, b, **kw)
    want = vm.mlp_product_ref(a, b, **kw)
    assert LAUNCHES["vit_mlp_product"] == before + 1
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    vit_close(got, want, torch.bfloat16, grad=True)
    torch.cuda.synchronize()


# K8's fused dh kernel alone against its plain piece at main_dino's globals
# and locals (M = 16·785 and 32·145 rows, D 384, F 1536) and a ragged small
# shape; one whose rows are not 16-byte aligned (F 100) is refused with a
# ValueError.
@pytest.mark.parametrize("shape", [(16 * 785, 384, 1536), (32 * 145, 384, 1536), (37, 32, 96),
                                   (45, 40, 100)], ids=str)
def test_vit_mlp_dh_matches_plain(cuda, shape):
    from cerebra_torch.kernels import LAUNCHES
    from cerebra_torch.models import vit_mlp as vm

    M, D, F = shape
    gen = torch.Generator().manual_seed(M)

    def r(*s, sc):
        return (torch.randn(*s, generator=gen) * sc).to(cuda, torch.bfloat16)

    y, dn = r(M, D, sc=1.0), r(M, D, sc=1.0)
    w1, b1, w2 = r(D, F, sc=0.05), r(F, sc=0.05), r(F, D, sc=0.05)
    before = LAUNCHES["vit_mlp_dh"]
    if F % 8:  # rows the TMA cannot read
        with pytest.raises(ValueError):
            vm.mlp_dh(y, dn, w1, b1, w2)
        assert LAUNCHES["vit_mlp_dh"] == before
        return
    got = vm.mlp_dh(y, dn, w1, b1, w2)
    assert LAUNCHES["vit_mlp_dh"] == before + 1
    want = vm.mlp_dh_ref(y, dn, w1, b1, w2)
    assert got[2].shape == want[2].shape == (-(-M // vm.DH_ROWS), F)
    vit_close(got[0], want[0], torch.bfloat16, grad=True)
    vit_close(got[1], want[1], torch.bfloat16, grad=True)
    vit_close(got[2], want[2], torch.float32, grad=True)
    torch.cuda.synchronize()


def test_vit_mlp_pieces_repeat_bit_for_bit(cuda):
    """The dh kernel, a split contraction and K8 whole give the same bits on
    a second run (fixed chunks and orders, no atomics)."""
    from cerebra_torch.models import vit_mlp as vm

    B, N, D, F = 2, 145, 384, 1536
    x, params, dout, s = vit_inputs(B, N, D, F, torch.float32, cuda, 6, True, attn=False)
    p = vm._prep(*params, torch.bfloat16)
    runs = []
    for _ in range(2):
        out, saved = vm.mlp_fwd(x, s, p)
        y = saved[0]
        dn = (dout * s[:, None]).to(torch.bfloat16)
        gh, dhn, parts = vm.mlp_dh(y, dn, p[2], p[3], p[4])
        dw = vm.mlp_product(gh, dn, a_t=True, epi="partial", splits=vm.contraction_splits(
            B * N, D, F))
        runs.append((out, gh, dhn, parts, dw, *vm.mlp_bwd(dout, x, s, p, saved)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# The attention cores alone (K5's forward core; K6's dq and dk/dv cores),
# against their plain pieces over N on both sides of the 64-row tiles, up to
# the globals' 785 tokens, and head dims 8, 24 and 64, and 6 (D 30, H 5: rows
# not 16-byte aligned, so the tiles are copied value by value), at B = 2;
# and main_dino's (B 16, N 785 and B 32, N 145; 6 heads of 64).
CORE_HEADS = {8: (16, 2), 24: (48, 2), 64: (128, 2), 6: (30, 5)}  # dh → (D, H)
CORE_NS = [1, 63, 64, 65, 127, 128, 129, 785]
CORE_SHAPES = [(2, N, *CORE_HEADS[dh]) for N in CORE_NS for dh in sorted(CORE_HEADS)] + [
    (16, 785, 384, 6), (32, 145, 384, 6)]  # (B, N, D, H)


def core_inputs(shape, cdt, cuda, seed=7):
    B, N, D, H = shape
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B * N, 3 * D, generator=gen).mul(0.5).to(cuda, cdt)
    dob = torch.randn(B * N, D, generator=gen).mul(0.1).to(cuda, cdt)
    return qkv, dob, B, N, H


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", CORE_SHAPES, ids=str)
def test_vit_attn_cores_match_plain(cuda, shape, dt):
    from cerebra_torch.kernels import LAUNCHES
    from cerebra_torch.models import vit_attn as va

    cdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    qkv, dob, B, N, H = core_inputs(shape, cdt, cuda)
    before = LAUNCHES["vit_attn_core_fwd"], LAUNCHES["vit_attn_core_bwd"]
    o, stats = va.attn_core_fwd(qkv, B, N, H)
    o_r, stats_r = va.attn_core_fwd_ref(qkv, B, N, H)
    vit_close(o, o_r, cdt, grad=False)
    vit_close(stats, stats_r, torch.float32, grad=False)
    got = va.attn_core_bwd(qkv, dob, o, stats, B, N, H)
    for a, b in zip(got, va.attn_core_bwd_ref(qkv, dob, stats, B, N, H)):
        vit_close(a, b, cdt, grad=True)
    assert (LAUNCHES["vit_attn_core_fwd"], LAUNCHES["vit_attn_core_bwd"]) == (
        before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", CORE_SHAPES, ids=str)
def test_vit_attn_backward_recomputes_the_forward_scores(cuda, shape):
    """dk/dv forms S^T = K Q^T with the key rows as the A operand; it must
    equal dq's S = Q K^T bit for bit, and the forward's saved row max (its
    scores on wgmma) must be the max of those scores, so both backward
    cores form the same p from the forward's m and l."""
    from cerebra_torch.models import vit_attn as va

    qkv, _, B, N, H = core_inputs(shape, torch.bfloat16, cuda, seed=shape[1])
    S, St = va.attn_scores_cuda(qkv, B, N, H)
    assert torch.equal(S, St.transpose(-1, -2))
    q, k, _ = va._qkv_heads(qkv, B, N, H)
    vit_close(S, q.float() @ k.float().transpose(-1, -2), torch.float32, grad=False)
    _, stats = va.attn_core_fwd(qkv, B, N, H)
    assert torch.equal(stats[..., 0], S.amax(-1))


# K5's bf16 forward core is K15's at scale 1 (K5 folds its scale into Wq):
# the core alone and the half-block's saved o and stats against K15's
# forward on the same qkv rows, bit for bit, at main_dino's globals and
# locals and at a ragged shape of head dim 8.
@pytest.mark.parametrize("shape", [(16, 785, 384, 6), (32, 145, 384, 6), (2, 13, 32, 4)],
                         ids=str)
def test_vit_attn_bf16_core_is_flash_at_scale_one(cuda, shape):
    from cerebra_torch.models import vit_attn as va

    B, N, D, H = shape
    qkv, _, _, _, _ = core_inputs(shape, torch.bfloat16, cuda, seed=N)
    o, stats = va.attn_core_fwd(qkv, B, N, H)
    o_f, stats_f = va.flash_fwd(qkv.view(B, N, 3 * D), H, 1.0)
    assert torch.equal(o, o_f.view(B * N, D)) and torch.equal(stats, stats_f)
    x, params, _, s = vit_inputs(B, N, D, 0, torch.float32, cuda, N, True, attn=True)
    _, saved = va.attn_fwd(x, s, va._prep(*params, H, torch.bfloat16), H)
    qkv_h, o_h, stats_h = saved[3:]
    o_f, stats_f = va.flash_fwd(qkv_h.view(B, N, 3 * D), H, 1.0)
    assert torch.equal(o_h, o_f.view(B * N, D)) and torch.equal(stats_h, stats_f)


# K15, the flash attention of `Attention(use_flash=True)`, through
# `flash_mha(q, k, v)`: the value and the q, k, v gradients against the
# softmax formula (the scale on the f32 scores), at main_dino's globals (N
# 785, dh 64) and around the 512-token gate, f32 and bf16; a head dim the
# kernels do not take raises rather than falling back.
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("N,dh", [(512, 64), (785, 64), (600, 32)])
def test_flash_mha_matches_plain(cuda, N, dh, dt):
    from cerebra_torch.kernels import LAUNCHES
    from cerebra_torch.models.vit_attn import flash_mha

    cdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    gen = torch.Generator().manual_seed(N)
    q, k, v, do = (torch.randn(2, 3, N, dh, generator=gen).to(cuda, cdt) for _ in range(4))
    scale = dh ** -0.5
    before = LAUNCHES["vit_attn_flash_fwd"], LAUNCHES["vit_attn_flash_bwd"]
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_mha(qg, kg, vg, scale)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    assert (LAUNCHES["vit_attn_flash_fwd"], LAUNCHES["vit_attn_flash_bwd"]) == (
        before[0] + 1, before[1] + 1)
    qr, kr, vr = (t.float().requires_grad_(True) for t in (q, k, v))
    want = torch.softmax((qr @ kr.transpose(-1, -2)) * scale, -1) @ vr
    want_g = torch.autograd.grad(want, (qr, kr, vr), do.float())
    vit_close(out, want, cdt, grad=False)
    for a, b in zip(got, want_g):
        assert a.dtype == cdt
        vit_close(a, b, cdt, grad=True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,N,dh", [(2, 785, 64), (2, 600, 32), (2, 130, 64), (2, 77, 6),
                                    (16, 785, 64)])
def test_flash_qkv_kernels_match_their_plain_pieces(cuda, B, N, dh, dt):
    """K15's forward core (bf16: one pass on wgmma, the tiles through the
    TMA where dh % 8 == 0, else copied by the producer warp; f32: the FMA
    core) and its backward cores over the qkv rows against the plain pieces
    (`flash_fwd_ref`, `flash_bwd_ref`; o, m, l, dq, dk and dv each) and
    through autograd against `flash_mha_qkv_ref`, at N ragged against the
    64-row tiles and dh 64, 32 and 6, and main_dino's globals (B 16, 6
    heads); `flash_mha(q, k, v)` is the kernel on its packed rows, bit for
    bit; two runs bit-equal (fixed order, no atomics)."""
    from cerebra_torch.models import vit_attn as va

    cdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    H = {64: 6, 32: 3, 6: 5}[dh]
    D, scale = H * dh, dh ** -0.5
    gen = torch.Generator().manual_seed(N + dh)
    qkv = torch.randn(B, N, 3 * D, generator=gen).to(cuda, cdt)
    do = torch.randn(B, N, D, generator=gen).to(cuda, cdt)
    o, stats = va.flash_fwd(qkv, H, scale)
    assert va.FLASH_ROUTE["tma"] == (dt == "bf16" and dh % 8 == 0)
    o_r, stats_r = va.flash_fwd_ref(qkv, H, scale)
    vit_close(o, o_r, cdt, grad=False)
    # m and l: f32 sums of up to N terms (l reaches ~N), held relatively
    for i in range(2):
        vit_close(stats[..., i], stats_r[..., i], torch.float32, grad=True)
    dqkv = va.flash_bwd(qkv, o, do, stats, H, scale)
    assert dqkv.dtype == cdt and dqkv.shape == qkv.shape
    want = va.flash_bwd_ref(qkv, o, do, stats, H, scale)
    for i in range(3):  # dq, dk, dv
        vit_close(dqkv[..., i * D:(i + 1) * D], want[..., i * D:(i + 1) * D], cdt, grad=True)
    q, k, v = (va._heads(qkv[..., i * D:(i + 1) * D], B, N, H) for i in range(3))
    assert torch.equal(va._rows(va.flash_mha(q, k, v, scale), B, N).view(B, N, D), o)
    assert torch.equal(o, va.flash_fwd(qkv, H, scale)[0])
    assert torch.equal(dqkv, va.flash_bwd(qkv, o, do, stats, H, scale))
    outs = []
    for fn in (va.flash_mha_qkv, va.flash_mha_qkv_ref):
        x = qkv.clone().requires_grad_(True)
        out = fn(x, H, scale)
        outs.append((out, *torch.autograd.grad(out, x, do)))
    for i, (a, b) in enumerate(zip(*outs)):
        vit_close(a, b, cdt, grad=i > 0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_flash_branch_matches_its_softmax_path(cuda, dt):
    """`Attention(use_flash=True)` at main_dino's globals (B 16, N 785, D
    384, 6 heads): the qkv layer, K15 and proj against the module's softmax
    path on the same parameters, the value and the gradients of x and of
    every parameter."""
    from cerebra_torch.models import vit as tv

    cdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    B, N, D, H = 16, 785, 384, 6
    gen = torch.Generator().manual_seed(N)
    attn = tv.Attention(D, H, dtype=None if dt == "f32" else cdt, use_flash=True).to(cuda)
    x = torch.randn(B, N, D, generator=gen).to(cuda)
    cot = torch.randn(B, N, D, generator=gen).to(cuda)
    outs = []
    for flash in (True, False):
        attn.use_flash = flash
        xg = x.clone().requires_grad_(True)
        out, _ = attn(xg, need_weights=False)
        outs.append((out, *torch.autograd.grad(out, (xg, *attn.parameters()), cot.to(out.dtype))))
    for i, (a, b) in enumerate(zip(*outs)):
        vit_close(a, b, cdt, grad=i > 0)


def test_flash_mha_refuses_a_wide_head(cuda):
    from cerebra_torch.models.vit_attn import flash_mha

    q = torch.randn(1, 2, 600, 96, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_mha(q, q, q, 96 ** -0.5)


# The IIR cascade (csrc/sos_scan.cu) against its plain loop on the card:
# lanes not a multiple of a warp, T not a multiple of the 32-step tile, 1, 4
# and 8 sections of a 14-71 Hz band-pass, and remove_noise's filter
# (Butterworth(4) 1-50 Hz at 1000 Hz) over its lanes: a batch of 64 Perils
# trials after the odd extension ((64, 96, 512) to 566 samples) and (96,
# 4096); both directions, from zero and from zi, f32 and f64 (the limits of
# the module docstring, here of the larger of the output's and the input's
# peak; remove_noise's of the output's own); two runs bit-equal.
NOISE_BAND = (1.0, 50.0)
SOS_CASES = [(shape, order, (14.0, 71.0)) for shape in [(1, 1), (3, 31), (33, 100), (2, 40, 257)]
             for order in (1, 4, 8)] + [((64, 96, 566), 4, NOISE_BAND), ((96, 4096), 4, NOISE_BAND)]


@pytest.mark.parametrize("shape,order,band", SOS_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sos_scan_matches_plain(cuda, shape, order, band, dtype):
    from cerebra_torch.kernels import LAUNCHES
    from cerebra_torch.signal import filters as flt

    spec = flt.design_bandpass(*band, 1000.0, order=order)  # `order` sections
    gen = torch.Generator().manual_seed(len(shape))
    x = torch.randn(*shape, generator=gen, dtype=dtype).to(cuda)
    tol = 5e-4 if dtype == torch.float32 else 1e-9
    for reverse in (False, True):
        for zi in (None, spec.zi):
            scale = None if zi is None else x[..., -1 if reverse else 0]
            before = LAUNCHES["sos_scan"]
            got = flt.sos_scan(spec.sos, x, zi, scale, reverse=reverse)
            assert LAUNCHES["sos_scan"] == before + 1
            want = flt._sos_scan_ref(spec.sos, x, zi, scale, reverse=reverse)
            # relative to the larger of the output's and the input's peak (at
            # T = 1 from zi a band-pass returns its steady state for a
            # constant, 0 up to rounding); remove_noise's to the output's own
            peak = want.abs().max()
            if band != NOISE_BAND:
                peak = torch.maximum(peak, x.abs().max())
            err = ((got - want).abs().max() / peak).item()
            assert got.dtype == dtype and err <= tol, err
    once = flt.sos_scan(spec.sos, x, spec.zi, x[..., 0])
    assert torch.equal(once, flt.sos_scan(spec.sos, x, spec.zi, x[..., 0]))
    torch.cuda.synchronize()


def test_sos_scan_refuses_what_it_does_not_run(cuda):
    from cerebra_torch.signal import filters as flt

    spec = flt.design_bandpass(14.0, 71.0, 1000.0, order=9)  # 9 sections: more than 8
    with pytest.raises(ValueError, match="sections"):
        flt.sos_scan(spec.sos, torch.randn(2, 50, device=cuda))
    with pytest.raises(ValueError, match="float32 and float64"):
        flt.sos_scan(spec.sos[:4], torch.randn(2, 50, device=cuda, dtype=torch.bfloat16))


def test_filtfilt_f64_matches_scipy(cuda):
    """filtfilt in f64 over a long recording (the ingest's 137 channels at
    2048 Hz, 152,000 samples) against scipy's sosfiltfilt on the host: 1e-9
    of the output's peak; and remove_noise's filtfilt in f32 over a batch of
    64 Perils trials (64, 96, 512), two launches, against its composition
    from the plain loop (the odd extension, a pass each way from zi scaled
    by the lane's end sample): 5e-4 of the output's peak."""
    from scipy import signal as sps

    from cerebra_torch.kernels import LAUNCHES
    from cerebra_torch.signal import filters as flt

    spec = flt.design_bandpass(*NOISE_BAND, fs=1000.0, order=4)
    gen = torch.Generator().manual_seed(19)
    x = torch.randn(137, 152_000, generator=gen, dtype=torch.float64)
    got = flt.filtfilt(spec, x.to(cuda)).cpu()
    want = torch.from_numpy(sps.sosfiltfilt(spec.sos, x.numpy(), axis=-1).copy())
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-9

    x = torch.randn(64, 96, 512, generator=gen).to(cuda)
    p = spec.default_padlen
    ext = flt._odd_ext(x, p)
    y = flt._sos_scan_ref(spec.sos, ext, spec.zi, ext[..., 0])
    want = flt._sos_scan_ref(spec.sos, y, spec.zi, y[..., -1], reverse=True)[..., p:p + 512]
    before = LAUNCHES["sos_scan"]
    got = flt.filtfilt(spec, x)
    assert LAUNCHES["sos_scan"] == before + 2
    assert ((got - want).abs().max() / want.abs().max()).item() <= 5e-4
