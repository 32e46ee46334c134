"""Fused ViT MLP half-block: the CUDA kernels K7, K8 and their plain PyTorch
versions (port of cerebra/models/pallas_vit_mlp.py).

    out = x + s·fc2(gelu_erf(fc1(LN(x)·γ + β)))   over the rows of x (M, D)

- K7 `vit_mlp_fwd` (`_fwd_kernel`): the forward; it also leaves LN(x)·γ+β
  and the row statistics for the backward.
- K8 `vit_mlp_bwd` (`_bwd_kernel`): the recompute backward: dx = dout + the
  LN backward, and f32 dγ, dβ, dW1, db1, dW2, db2. On CUDA in bf16 it runs
  as pieces with plain versions of their own (`_dn_ref`, `mlp_dh_ref`,
  `contract_rows_ref`, `mlp_dy_ref`, composed by `_mlp_bwd_pieces`); the
  fused dh kernel and each product can be called alone (`mlp_dh`,
  `mlp_product`).

Parameters keep the caller's dtype and are cast to the compute dtype cdt
before the kernel (the Pallas `_prep`); every product takes cdt operands with
f32 accumulation, while the residual stream (x, out, dx) keeps x's dtype, so
an f32 stream through bf16 blocks stays f32. LN uses eps 1e-6 (flax's). s is
an optional per-row branch scale (stochastic depth), a constant with no
gradient.

Dispatch: a tensor on the CPU takes the plain version (`_mlp_fwd_ref`,
`_mlp_bwd_ref`); a CUDA tensor launches the kernel, built at first use from
`csrc/vit_mlp.cu`, or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from cerebra_torch.kernels import LAUNCHES, check_rc, load_lib, on_cuda, ptr, stream_of
from cerebra_torch.utils.spans import span

LAUNCHES.update(vit_mlp_fwd=0, vit_mlp_bwd=0, vit_mlp_dh=0, vit_mlp_product=0)

LN_EPS = 1e-6  # flax nn.LayerNorm's default, as the Pallas kernels use
_SQRT_2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_DTYPES = (torch.float32, torch.bfloat16)

Params = Sequence[torch.Tensor]


# ------------------------------------------------------ shared with vit_attn
def layernorm_f32(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xn, rstd) of an f32 (..., D) tensor, as `_layernorm_f32`."""
    xc = x32 - x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    return xc * rstd, rstd


def ln_backward(dy, xn, rstd, g, dout_raw, out_dtype):
    """The LN affine and core backward of the Pallas bodies → (dx, dγ, dβ)."""
    dxn = dy * g.float()
    m1 = dxn.mean(-1, keepdim=True)
    m2 = (dxn * xn).mean(-1, keepdim=True)
    dx = (dout_raw + rstd * (dxn - m1 - xn * m2)).to(out_dtype)
    rows = dy.reshape(-1, dy.shape[-1])
    return dx, (rows * xn.reshape(rows.shape)).sum(0), rows.sum(0)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with cdt operands and f32 accumulation (products of two bf16
    values are exact in f32)."""
    return a.float() @ b.float()


def check_cuda(x, s, params, rows: int, saved=()) -> None:
    """What the CUDA kernels take: contiguous tensors, a float32/bfloat16
    stream, parameters in one compute dtype, an f32 scale of `rows` values."""
    if x.dtype not in _DTYPES or params[0].dtype not in _DTYPES:
        raise TypeError(f"stream {x.dtype} / compute {params[0].dtype}: float32 or bfloat16 only")
    for t in (x, s, *params, *saved):
        if t is not None and not t.is_contiguous():
            raise ValueError("the fused ViT kernels take contiguous tensors only")
    for t in params[1:]:
        if t.dtype != params[0].dtype:
            raise TypeError("the parameters must share one compute dtype")
    if s is not None and (s.dtype != torch.float32 or s.numel() != rows):
        raise ValueError(f"the scale must be {rows} float32 values")


# ---------------------------------------------------------- plain versions
def _gelu(h):
    return 0.5 * h * (1.0 + torch.erf(h / _SQRT_2))


def _dgelu(h):
    return 0.5 * (1.0 + torch.erf(h / _SQRT_2)) + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI


def _prep(g, b, w1, b1, w2, b2, cdt) -> Tuple[torch.Tensor, ...]:
    """Parameters cast to the compute dtype, as the Pallas `_prep`."""
    return tuple(t.to(cdt).contiguous() for t in (g, b, w1, b1, w2, b2))


def _ln_y(x, g, b):
    xn, rstd = layernorm_f32(x.float())
    return xn, rstd, (xn * g.float() + b.float()).to(g.dtype)


def _mlp_fwd_ref(x, s, p: Params):
    """Plain K7 → (out, saved); the backward recomputes, so nothing is saved."""
    g, b, w1, b1, w2, b2 = p
    _, _, y = _ln_y(x, g, b)
    gh = _gelu(mm(y, w1) + b1.float()).to(w1.dtype)
    out = mm(gh, w2) + b2.float()
    if s is not None:
        out = out * s[:, None]
    return (x.float() + out).to(x.dtype), ()


def _mlp_bwd_ref(dout, x, s, p: Params, saved=()):
    """Plain K8, the Pallas `_bwd_kernel`'s formulas → (dx, dγ, dβ, dW1, db1,
    dW2, db2), gradients in f32."""
    g, b, w1, b1, w2, _ = p
    cdt = w1.dtype
    xn, rstd, y = _ln_y(x, g, b)
    h = mm(y, w1) + b1.float()
    dout_raw = dout.float()
    d = dout_raw * s[:, None] if s is not None else dout_raw
    dn = d.to(cdt)
    gh = _gelu(h).to(cdt)
    dw2 = mm(gh.t(), dn)
    db2 = d.sum(0)
    dh = mm(dn, w2.t()) * _dgelu(h)
    dhn = dh.to(cdt)
    dw1 = mm(y.t(), dhn)
    db1 = dh.sum(0)
    dy = mm(dhn, w1.t())
    dx, dg, db = ln_backward(dy, xn, rstd, g, dout_raw, x.dtype)
    return dx, dg, db, dw1, db1, dw2, db2


# ----------------------------------------------- K8's pieces, plain versions
# The CUDA backward (bf16) runs K8 as these launches, in this order; their
# plain versions compose `_mlp_bwd_pieces`, which equals `_mlp_bwd_ref` bit
# for bit with one row tile and one row chunk, and differs only in the order
# of the sums over rows otherwise.
DH_ROWS = 64  # rows of a tile of the fused dh kernel, and of a db1 partial
K_STEP = 64  # a row chunk of a contraction is whole steps of 64 rows


def _dn_ref(dout, s, cdt):
    """dn = dout·s rounded to cdt, and db2 = Σ_rows dout·s in f32."""
    d = dout.float()
    if s is not None:
        d = d * s[:, None]
    return d.to(cdt), d.sum(0)


def mlp_dh_ref(y, dn, w1, b1, w2, rows: int = DH_ROWS):
    """The fused dh piece: h = y·W1 + b1 and dh = (dn·W2ᵀ)·gelu′(h) in f32 →
    (gh = gelu(h), dhn = dh, both rounded to W1's dtype, and db1's partials
    (ceil(M / rows), F): dh summed over each tile of `rows` rows)."""
    h = mm(y, w1) + b1.float()
    dh = mm(dn, w2.t()) * _dgelu(h)
    parts = torch.stack([dh[r:r + rows].sum(0) for r in range(0, max(1, dh.shape[0]), rows)])
    return _gelu(h).to(w1.dtype), dh.to(w1.dtype), parts


def row_chunks(M: int, splits: int):
    """The row chunks [r0, r1) of a contraction split `splits` ways, as the
    kernel cuts them: whole k steps, only the last ragged, empty ones last."""
    c = -(-M // splits)
    c = -(-c // K_STEP) * K_STEP
    return [(min(M, z * c), min(M, (z + 1) * c)) for z in range(splits)]


def contract_rows_ref(a, b, splits: int = 1):
    """The partials (splits, K1, K2) of aᵀ·b over the row chunks of a (M, K1)
    and b (M, K2), f32 sums of cdt products; summed in order they are the
    contraction."""
    return torch.stack([mm(a[r0:r1].t(), b[r0:r1]) for r0, r1 in row_chunks(a.shape[0], splits)])


def sum_in_order(parts):
    """Σ_z parts[z], added in order of z (the kernels' sums of partials)."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def mlp_dy_ref(dhn, w1):
    """dy = dhn·W1ᵀ in f32."""
    return mm(dhn, w1.t())


def _mlp_bwd_pieces(dout, x, s, p: Params, rows: int = DH_ROWS, splits: int = 1):
    """K8 composed from its pieces' plain versions, db1 over tiles of `rows`
    rows and dW over `splits` row chunks → `_mlp_bwd_ref`'s gradients."""
    g, b, w1, b1, w2, _ = p
    xn, rstd, y = _ln_y(x, g, b)
    dn, db2 = _dn_ref(dout, s, w1.dtype)
    gh, dhn, db1_parts = mlp_dh_ref(y, dn, w1, b1, w2, rows)
    dw2 = sum_in_order(contract_rows_ref(gh, dn, splits))
    dw1 = sum_in_order(contract_rows_ref(y, dhn, splits))
    dy = mlp_dy_ref(dhn, w1)
    dx, dg, db = ln_backward(dy, xn, rstd, g, dout.float(), x.dtype)
    return dx, dg, db, dw1, sum_in_order(db1_parts), dw2, db2


_EPIS = {"f32": 0, "gelu": 1, "residual": 2, "partial": 3, "bias_round": 4}


def mlp_product_ref(a, b, a_t: bool = False, b_t: bool = False, epi: str = "f32", bias=None,
                    x=None, s=None, splits: int = 1):
    """One product of the ViT half-blocks, C = A·B with A = aᵀ if a_t else a
    and B = bᵀ if b_t else b, and its epilogue: "f32" C; "gelu" gelu(C +
    bias) in bias's dtype; "residual" x + s·(C + bias) in x's dtype;
    "partial" the partials of C over `splits` row chunks of k (splits, M,
    N); "bias_round" C + bias, or C without a bias, rounded to bf16 (K5's
    qkv, K6's do)."""
    A = a.t() if a_t else a
    B = b.t() if b_t else b
    if epi == "partial":
        return torch.stack([mm(A[:, r0:r1], B[r0:r1]) for r0, r1 in row_chunks(A.shape[1], splits)])
    c = mm(A, B)
    if epi == "f32":
        return c
    if epi == "bias_round":
        return (c if bias is None else c + bias.float()).to(torch.bfloat16)
    if epi == "gelu":
        return _gelu(c + bias.float()).to(bias.dtype)
    if epi == "residual":
        v = c + bias.float()
        if s is not None:
            v = v * s[:, None]
        return (x.float() + v).to(x.dtype)
    raise ValueError(f"unknown epilogue {epi!r}")


# ------------------------------------------------------------ CUDA kernels
def _typed(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.cerebra_vit_mlp_fwd.argtypes = [i, i] + [vp] * 13 + [i] * 3 + [vp]
    lib.cerebra_vit_mlp_fwd.restype = i
    lib.cerebra_vit_mlp_bwd.argtypes = [i, i] + [vp] * 21 + [i] * 3 + [vp]
    lib.cerebra_vit_mlp_bwd.restype = i
    lib.cerebra_vit_mlp_scratch.argtypes = [i, i, i]
    lib.cerebra_vit_mlp_scratch.restype = ctypes.c_longlong
    lib.cerebra_vit_mlp_splits.argtypes = [i, i, i]
    lib.cerebra_vit_mlp_splits.restype = i
    lib.cerebra_vit_mlp_dh.argtypes = [vp] * 8 + [i] * 3 + [vp]
    lib.cerebra_vit_mlp_dh.restype = i
    lib.cerebra_vit_mlp_product.argtypes = [i, i, i, vp, i, vp, i, i, i, i, i, vp, vp, vp, vp,
                                            vp]
    lib.cerebra_vit_mlp_product.restype = i


def _lib():
    return load_lib("vit_mlp", _typed)


def _flags(x, cdt):
    return int(x.dtype == torch.bfloat16), int(cdt == torch.bfloat16)


def _mlp_fwd_cuda(x, s, p: Params):
    g, b, w1, b1, w2, b2 = p
    M, D = x.shape
    F = w1.shape[1]
    check_cuda(x, s, p, M)
    cdt = w1.dtype
    if cdt == torch.bfloat16:
        _check_tma(w1, w2)
    y = torch.empty(M, D, dtype=cdt, device=x.device)
    mu, rstd = torch.empty(2, M, dtype=torch.float32, device=x.device)
    gh = torch.empty(M, F, dtype=cdt, device=x.device)
    out = torch.empty_like(x)
    lib = _lib()
    rc = lib.cerebra_vit_mlp_fwd(
        *_flags(x, cdt), ptr(x), ptr(s), *[ptr(t) for t in p], ptr(y), ptr(mu), ptr(rstd),
        ptr(gh), ptr(out), M, D, F, stream_of(x),
    )
    check_rc(lib, rc, "vit_mlp_fwd")
    LAUNCHES["vit_mlp_fwd"] += 1
    return out, (y, mu, rstd)


def _mlp_bwd_cuda(dout, x, s, p: Params, saved):
    g, b, w1, b1, w2, _ = p
    if len(saved) != 3:
        raise ValueError("the CUDA backward needs the CUDA forward's residuals (y, mu, rstd)")
    y, mu, rstd = saved
    M, D = x.shape
    F = w1.shape[1]
    check_cuda(x, s, p, M, (dout, *saved))
    if dout.shape != x.shape or dout.dtype != x.dtype:
        raise ValueError("dout must match x in shape and dtype")
    cdt, dev, f32 = w1.dtype, x.device, torch.float32
    if cdt == torch.bfloat16:
        _check_tma(y, w1, w2)
    lib = _lib()
    # four allocations: dn, gh, dhn in cdt; dy and the partials (f32
    # scratch); the f32 gradients (one buffer, views); dx. No (M, F) f32
    # tensor: h and dh stay in the kernels' registers (bf16), or in dhn's
    # buffer (f32 compute).
    dn, gh, dhn = torch.empty(M * (D + 2 * F), dtype=cdt, device=dev).split(
        [M * D, M * F, M * F])
    scratch = torch.empty(lib.cerebra_vit_mlp_scratch(M, D, F), dtype=f32, device=dev)
    dg, db, dw1, db1, dw2, db2 = torch.empty(3 * D + 2 * D * F + F, dtype=f32, device=dev).split(
        [D, D, D * F, F, D * F, D])
    dw1, dw2 = dw1.view(D, F), dw2.view(F, D)
    dx = torch.empty_like(x)
    rc = lib.cerebra_vit_mlp_bwd(
        *_flags(x, cdt), ptr(x), ptr(dout), ptr(s), ptr(g), ptr(w1), ptr(b1), ptr(w2), ptr(y),
        ptr(mu), ptr(rstd), ptr(dn), ptr(gh), ptr(dhn), ptr(scratch), ptr(dx),
        ptr(dg), ptr(db), ptr(dw1), ptr(db1), ptr(dw2), ptr(db2), M, D, F, stream_of(x),
    )
    check_rc(lib, rc, "vit_mlp_bwd")
    LAUNCHES["vit_mlp_bwd"] += 1
    return dx, dg, db, dw1, db1, dw2, db2


def _check_tma(*tensors) -> None:
    """The TMA reads the products' operands: 16-byte aligned bases and rows
    (a multiple of 8 bf16 values)."""
    for t in tensors:
        if t.data_ptr() % 16 or t.shape[-1] % 8:
            raise ValueError("the ViT half-blocks' products take operands whose base and rows "
                             f"are 16-byte aligned; got shape {tuple(t.shape)}")


def _check_bf16(*tensors) -> None:
    for t in tensors:
        if t is not None and (t.dtype != torch.bfloat16 or not t.is_contiguous()):
            raise TypeError("the MLP's product kernels take contiguous bfloat16 operands")


def contraction_splits(M: int, D: int, F: int) -> int:
    """Row chunks of K8's dW contractions on this card (CUDA only)."""
    return _lib().cerebra_vit_mlp_splits(M, D, F)


def _dh_cuda(y, dn, w1, b1, w2):
    _check_bf16(y, dn, w1, b1, w2)
    _check_tma(y, dn, w1, w2)
    M, D = y.shape
    F = w1.shape[1]
    if dn.shape != (M, D) or w1.shape != (D, F) or b1.shape != (F,) or w2.shape != (F, D):
        raise ValueError("mlp_dh takes y, dn (M, D), w1 (D, F), b1 (F), w2 (F, D)")
    gh = torch.empty(M, F, dtype=y.dtype, device=y.device)
    dhn = torch.empty_like(gh)
    parts = torch.empty(-(-M // DH_ROWS), F, dtype=torch.float32, device=y.device)
    lib = _lib()
    rc = lib.cerebra_vit_mlp_dh(ptr(y), ptr(dn), ptr(w1), ptr(b1), ptr(w2), ptr(gh), ptr(dhn),
                                ptr(parts), M, D, F, stream_of(y))
    check_rc(lib, rc, "vit_mlp_dh")
    LAUNCHES["vit_mlp_dh"] += 1
    return gh, dhn, parts


def _product_cuda(a, b, a_t, b_t, epi, bias, x, s, splits):
    _check_bf16(a, b, bias)
    _check_tma(a, b)
    if a_t and b_t:
        raise ValueError("the MLP's products take a_t or b_t, not both")
    M, K = (a.shape[1], a.shape[0]) if a_t else a.shape
    Kb, N = (b.shape[1], b.shape[0]) if b_t else b.shape
    if Kb != K:
        raise ValueError(f"inner dims {K} and {Kb} differ")
    if epi in ("gelu", "residual") and bias is None:
        raise ValueError(f"the {epi} epilogue takes a bias of {N} values")
    if bias is not None and bias.shape != (N,):
        raise ValueError(f"the bias must hold {N} values")
    if epi == "residual" and (x is None or x.dtype != torch.float32 or x.shape != (M, N)
                              or not x.is_contiguous()):
        raise ValueError("the residual epilogue takes a contiguous f32 x of the output's shape")
    if s is not None and (s.dtype != torch.float32 or s.shape != (M,)):
        raise ValueError(f"the scale must be {M} float32 values")
    if splits < 1:
        raise ValueError("splits is at least 1")
    dev = a.device
    if epi in ("gelu", "bias_round"):
        out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    elif epi == "partial":
        out = torch.empty(splits, M, N, dtype=torch.float32, device=dev)
    else:
        out = torch.empty(M, N, dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.cerebra_vit_mlp_product(int(a_t), int(b_t), _EPIS[epi], ptr(a), a.shape[1], ptr(b),
                                     b.shape[1], M, N, K, splits, ptr(bias), ptr(x), ptr(s),
                                     ptr(out), stream_of(a))
    check_rc(lib, rc, "vit_mlp_product")
    LAUNCHES["vit_mlp_product"] += 1
    return out


# ---------------------------------------------------------------- wrappers
def mlp_fwd(x, s, p: Params):
    """K7 on CUDA, its plain version on the CPU → (out, saved)."""
    if on_cuda(x, s, *p):
        return _mlp_fwd_cuda(x, s, p)
    return _mlp_fwd_ref(x, s, p)


def mlp_bwd(dout, x, s, p: Params, saved):
    """K8 on CUDA, its plain version on the CPU → (dx, dγ, dβ, dW1, db1, dW2,
    db2)."""
    if on_cuda(dout, x, s, *p):
        return _mlp_bwd_cuda(dout, x, s, p, saved)
    return _mlp_bwd_ref(dout, x, s, p, saved)


def mlp_dh(y, dn, w1, b1, w2):
    """K8's fused dh kernel alone (bf16 on CUDA, its plain version on the
    CPU) → (gh, dhn, db1's partials per 64-row tile); K8 runs the same
    kernel."""
    if on_cuda(y, dn, w1, b1, w2):
        return _dh_cuda(y, dn, w1, b1, w2)
    return mlp_dh_ref(y, dn, w1, b1, w2)


def mlp_product(a, b, a_t: bool = False, b_t: bool = False, epi: str = "f32", bias=None,
                x=None, s=None, splits: int = 1):
    """One product of K7/K8, or with "bias_round" of K5/K6, alone on the
    TMA + wgmma pipeline (`mlp_product_ref`'s function; on CUDA bf16
    operands whose base and rows are 16-byte aligned, as the half-blocks'
    products take them)."""
    if epi not in _EPIS:
        raise ValueError(f"unknown epilogue {epi!r}")
    if on_cuda(a, b, bias, x, s):
        return _product_cuda(a, b, a_t, b_t, epi, bias, x, s, splits)
    return mlp_product_ref(a, b, a_t, b_t, epi, bias, x, s, splits)


class _FusedMLP(torch.autograd.Function):
    """`impl` is (forward, backward): the dispatching wrappers, or the plain
    versions for timing them on the card."""

    @staticmethod
    def forward(ctx, impl, x, s, cdt, *params):
        p = _prep(*params, cdt)
        out, saved = impl[0](x, s, p)
        ctx.impl = impl
        ctx.dtypes = [t.dtype for t in params]
        ctx.save_for_backward(x, s, *p, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        with span("cerebra_torch.vit.mlp.bwd"):
            x, s, *rest = ctx.saved_tensors
            grads = ctx.impl[1](dout.to(x.dtype).contiguous(), x, s, rest[:6], rest[6:])
            dx, dparams = grads[0], grads[1:]
            return (None, dx, None, None, *[d.to(t) for d, t in zip(dparams, ctx.dtypes)])


def _residual(impl, x, g, b, w1, b1, w2, b2, compute_dtype, scale):
    """The half-block, its weights' casts (`_prep`) included, inside the
    span `cerebra_torch.vit.mlp`, with or without autograd."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, D), got shape {tuple(x.shape)}")
    with span("cerebra_torch.vit.mlp"):
        cdt = compute_dtype or x.dtype
        s = None
        if scale is not None:
            s = scale.detach().reshape(x.shape[0]).to(torch.float32).contiguous()
        params = (g, b, w1, b1, w2, b2)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
            return _FusedMLP.apply(impl, x, s, cdt, *params)
        return impl[0](x, s, _prep(*params, cdt))[0]


def fused_mlp_residual(x, g, b, w1, b1, w2, b2, tile_m: int = 256, compute_dtype=None,
                       scale=None):
    """x + fc2(gelu_exact(fc1(layernorm(x)·g + b))) over the rows of x (M, D),
    with the JAX function's arguments: w1 (D, F), w2 (F, D); matmuls in
    `compute_dtype` (default x.dtype); `scale` (M,) multiplies the branch and
    gets no gradient. `tile_m` is accepted and does not change the result:
    the CUDA kernels choose their own tiles."""
    del tile_m
    return _residual((mlp_fwd, mlp_bwd), x, g, b, w1, b1, w2, b2, compute_dtype, scale)


def fused_mlp_residual_ref(x, g, b, w1, b1, w2, b2, tile_m: int = 256, compute_dtype=None,
                           scale=None):
    """`fused_mlp_residual` through the plain versions on any device (for
    timing the kernels against them on the card)."""
    del tile_m
    return _residual((_mlp_fwd_ref, _mlp_bwd_ref), x, g, b, w1, b1, w2, b2, compute_dtype,
                     scale)
