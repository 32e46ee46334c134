"""Fused ViT MLP half-block: the CUDA kernels K7, K8 and their plain PyTorch
versions (port of cerebra/models/pallas_vit_mlp.py).

    out = x + s·fc2(gelu_erf(fc1(LN(x)·γ + β)))   over the rows of x (M, D)

- K7 `vit_mlp_fwd` (`_fwd_kernel`): the forward; it also leaves LN(x)·γ+β
  and the row statistics for the backward.
- K8 `vit_mlp_bwd` (`_bwd_kernel`): the recompute backward: dx = dout + the
  LN backward, and f32 dγ, dβ, dW1, db1, dW2, db2.

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

LAUNCHES.update(vit_mlp_fwd=0, vit_mlp_bwd=0)

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


# ------------------------------------------------------------ CUDA kernels
def _typed(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.cerebra_vit_mlp_fwd.argtypes = [i, i] + [vp] * 13 + [i] * 3 + [vp]
    lib.cerebra_vit_mlp_fwd.restype = i
    lib.cerebra_vit_mlp_bwd.argtypes = [i, i] + [vp] * 24 + [i] * 3 + [vp]
    lib.cerebra_vit_mlp_bwd.restype = i
    lib.cerebra_vit_mlp_scratch.argtypes = [i, i]
    lib.cerebra_vit_mlp_scratch.restype = ctypes.c_longlong


def _flags(x, cdt):
    return int(x.dtype == torch.bfloat16), int(cdt == torch.bfloat16)


def _mlp_fwd_cuda(x, s, p: Params):
    g, b, w1, b1, w2, b2 = p
    M, D = x.shape
    F = w1.shape[1]
    check_cuda(x, s, p, M)
    cdt = w1.dtype
    y = torch.empty(M, D, dtype=cdt, device=x.device)
    mu = torch.empty(M, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    gh = torch.empty(M, F, dtype=cdt, device=x.device)
    out = torch.empty_like(x)
    lib = load_lib("vit_mlp", _typed)
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
    h = torch.empty(M, F, dtype=f32, device=dev)
    gh = torch.empty(M, F, dtype=cdt, device=dev)
    dn = torch.empty(M, D, dtype=cdt, device=dev)
    dh = torch.empty(M, F, dtype=f32, device=dev)
    dhn = torch.empty(M, F, dtype=cdt, device=dev)
    dy = torch.empty(M, D, dtype=f32, device=dev)
    dx = torch.empty_like(x)
    dg, db, db2 = (torch.empty(D, dtype=f32, device=dev) for _ in range(3))
    dw1 = torch.empty(D, F, dtype=f32, device=dev)
    db1 = torch.empty(F, dtype=f32, device=dev)
    dw2 = torch.empty(F, D, dtype=f32, device=dev)
    lib = load_lib("vit_mlp", _typed)
    scratch = torch.empty(lib.cerebra_vit_mlp_scratch(D, F), dtype=f32, device=dev)
    rc = lib.cerebra_vit_mlp_bwd(
        *_flags(x, cdt), ptr(x), ptr(dout), ptr(s), ptr(g), ptr(w1), ptr(b1), ptr(w2), ptr(y),
        ptr(mu), ptr(rstd), ptr(h), ptr(gh), ptr(dn), ptr(dh), ptr(dhn), ptr(dy), ptr(scratch),
        ptr(dx),
        ptr(dg), ptr(db), ptr(dw1), ptr(db1), ptr(dw2), ptr(db2), M, D, F, stream_of(x),
    )
    check_rc(lib, rc, "vit_mlp_bwd")
    LAUNCHES["vit_mlp_bwd"] += 1
    return dx, dg, db, dw1, db1, dw2, db2


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
        x, s, *rest = ctx.saved_tensors
        grads = ctx.impl[1](dout.to(x.dtype).contiguous(), x, s, rest[:6], rest[6:])
        dx, dparams = grads[0], grads[1:]
        return (None, dx, None, None, *[d.to(t) for d, t in zip(dparams, ctx.dtypes)])


def _residual(impl, x, g, b, w1, b1, w2, b2, compute_dtype, scale):
    if x.dim() != 2:
        raise ValueError(f"x must be (M, D), got shape {tuple(x.shape)}")
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
