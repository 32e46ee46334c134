"""Fused ViT attention half-block: the CUDA kernels K5, K6 and their plain
PyTorch versions (port of cerebra/models/pallas_vit_attn.py).

    out = x + s·proj(MHA(LN(x)·γ + β))   per sequence of x (B, N, D)

- K5 `vit_attn_fwd` (`_fwd_kernel`): the forward. It also leaves, for the
  backward, LN(x)·γ+β, q/k/v, the attention output and each query row's
  softmax max and sum (the TPU forward saves nothing; an 80 GB card can keep
  them).
- K6 `vit_attn_bwd` (`_bwd_kernel`): dx = dout + the LN backward, and f32
  dγ, dβ, dWqkv, dbqkv, dWp, dbp.
- K15 `flash_mha`: the same cores as plain multi-head attention over
  (B, H, N, dh) q, k, v, the port of `_flash_mha` (the Pallas TPU flash
  attention) that `Attention(use_flash=True)` takes.
- Their attention cores alone, the launches between the products:
  `attn_core_fwd` (o and each query row's softmax max and sum) and
  `attn_core_bwd` (dq, then dk and dv), with plain pieces
  `attn_core_fwd_ref` / `attn_core_bwd_ref`; `attn_scores_cuda` gives the
  bf16 cores' scores in the forward's and in dk/dv's orientation.

The q scale dh^-0.5 is folded into Wq and bq before the kernel, and dWq, dbq
are rescaled after it (`_split_params`, `_bwd`). The qkv feature order is
i·D + h·dh + c. Parameters are cast to the compute dtype cdt; products take
cdt operands with f32 accumulation; softmax is f32; the residual stream
keeps x's dtype. s is an optional per-sequence branch scale (stochastic
depth), a constant with no gradient.

Dispatch: a tensor on the CPU takes the plain version (`_attn_fwd_ref`,
`_attn_bwd_ref`); a CUDA tensor launches the kernel, built at first use from
`csrc/vit_attn.cu`, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from cerebra_torch.kernels import LAUNCHES, check_rc, load_lib, on_cuda, ptr, stream_of
from cerebra_torch.models.vit_mlp import check_cuda, layernorm_f32, ln_backward, mm

LAUNCHES.update(vit_attn_fwd=0, vit_attn_bwd=0, vit_attn_core_fwd=0, vit_attn_core_bwd=0)

MAX_HEAD_DIM = 64  # the CUDA kernels' tile width
Params = Sequence[torch.Tensor]


def _prep(g, b, wqkv, bqkv, wproj, bproj, num_heads, cdt) -> Tuple[torch.Tensor, ...]:
    """The attention scale folded into the q columns (in f32, before the
    cast) and every parameter cast to the compute dtype, in the caller's
    (D, 3D) layout (the Pallas `_split_params` without the head split)."""
    D = wqkv.shape[0]
    scale = (D // num_heads) ** -0.5
    wqkv = torch.cat([wqkv[:, :D] * scale, wqkv[:, D:]], 1)
    bqkv = torch.cat([bqkv[:D] * scale, bqkv[D:]])
    return tuple(t.to(cdt).contiguous() for t in (g, b, wqkv, bqkv, wproj, bproj))


# ---------------------------------------------------------- plain versions
def _heads(t, B, N, H):
    """(B, N, D) → (B, H, N, dh)"""
    return t.reshape(B, N, H, -1).transpose(1, 2)


def _forward_parts(x, p: Params, H: int):
    """LN, qkv, softmax and the attention output of the Pallas bodies."""
    g, b, wqkv, bqkv, _, _ = p
    B, N, D = x.shape
    cdt = wqkv.dtype
    xn, rstd = layernorm_f32(x.float())
    y = (xn * g.float() + b.float()).to(cdt)
    qkv = (mm(y, wqkv) + bqkv.float()).to(cdt)
    q, k, v = (_heads(qkv[..., i * D:(i + 1) * D], B, N, H) for i in range(3))
    p_att = torch.softmax(mm(q, k.transpose(-1, -2)), dim=-1)
    o = mm(p_att.to(cdt), v).to(cdt)
    return xn, rstd, y, q, k, v, p_att, o.transpose(1, 2).reshape(B, N, D)


def _attn_fwd_ref(x, s, p: Params, num_heads: int):
    """Plain K5 → (out, saved); the backward recomputes, so nothing is saved."""
    *_, o = _forward_parts(x, p, num_heads)
    out = mm(o, p[4]) + p[5].float()
    if s is not None:
        out = out * s[:, None, None]
    return (x.float() + out).to(x.dtype), ()


def _attn_bwd_ref(dout, x, s, p: Params, num_heads: int, saved=()):
    """Plain K6, the Pallas `_bwd_kernel`'s formulas → (dx, dγ, dβ, dWqkv,
    dbqkv, dWp, dbp), f32, with dWq and dbq in the scale-folded space."""
    g, _, wqkv, _, wp, _ = p
    B, N, D = x.shape
    cdt = wqkv.dtype
    xn, rstd, y, q, k, v, p_att, o = _forward_parts(x, p, num_heads)
    dout_raw = dout.float()
    d = dout_raw * s[:, None, None] if s is not None else dout_raw
    dn = d.to(cdt)
    dbp = d.reshape(-1, D).sum(0)
    dwp = mm(o.reshape(-1, D).t(), dn.reshape(-1, D))
    do = _heads(mm(dn, wp.t()).to(cdt), B, N, num_heads)
    dp = mm(do, v.transpose(-1, -2))
    dv = mm(p_att.to(cdt).transpose(-1, -2), do)
    ds = (p_att * (dp - (dp * p_att).sum(-1, keepdim=True))).to(cdt)
    dq = mm(ds, k)
    dk = mm(ds.transpose(-1, -2), q)
    dqkv = torch.cat([t.transpose(1, 2).reshape(B * N, D) for t in (dq, dk, dv)], 1)
    dqkvn = dqkv.to(cdt)
    dwqkv = mm(y.reshape(-1, D).t(), dqkvn)
    dbqkv = dqkv.sum(0)
    dy = mm(dqkvn, wqkv.t()).reshape(B, N, D)
    dx, dg, db = ln_backward(dy, xn, rstd, g, dout_raw, x.dtype)
    return dx, dg, db, dwqkv, dbqkv, dwp, dbp


def _qkv_heads(qkv, B, N, H):
    """(B·N, 3D) → q, k, v each (B, H, N, dh)"""
    D = qkv.shape[1] // 3
    return (_heads(qkv[:, i * D:(i + 1) * D].reshape(B, N, D), B, N, H) for i in range(3))


def _rows(t, B, N):
    """(B, H, N, dh) → (B·N, D)"""
    return t.transpose(1, 2).reshape(B * N, -1)


def attn_core_fwd_ref(qkv, B: int, N: int, H: int):
    """Plain attention core of K5, whole-row softmax as the Pallas body:
    qkv (B·N, 3D) in cdt → (o (B·N, D) in cdt, stats (B, H, N, 2) f32 = each
    query row's max m and sum l of exp(s − m))."""
    q, k, v = _qkv_heads(qkv, B, N, H)
    s = mm(q, k.transpose(-1, -2))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    o = mm((e / l).to(qkv.dtype), v).to(qkv.dtype)
    return _rows(o, B, N), torch.cat([m, l], -1)


def attn_core_bwd_ref(qkv, dob, stats, B: int, N: int, H: int):
    """Plain attention core of K6: p = exp(s − m) / l from the forward's
    stats, delta = Σ_j p·dp over f32 p (the Pallas body's sum, not do·o),
    dS = p·(dp − delta) rounded to cdt → (dqkv32 (B·N, 3D) f32 holding dq,
    dk, dv; dqkvn, the same rounded to cdt; delta (B, H, N) f32)."""
    cdt = qkv.dtype
    q, k, v = _qkv_heads(qkv, B, N, H)
    do = _heads(dob.reshape(B, N, -1), B, N, H)
    p = torch.exp(mm(q, k.transpose(-1, -2)) - stats[..., :1]) / stats[..., 1:]
    dp = mm(do, v.transpose(-1, -2))
    delta = (p * dp).sum(-1)
    ds = (p * (dp - delta[..., None])).to(cdt)
    dq, dk, dv = mm(ds, k), mm(ds.transpose(-1, -2), q), mm(p.to(cdt).transpose(-1, -2), do)
    dqkv32 = torch.cat([_rows(t, B, N) for t in (dq, dk, dv)], 1)
    return dqkv32, dqkv32.to(cdt), delta


# ------------------------------------------------------------ CUDA kernels
def _typed(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.cerebra_vit_attn_fwd.argtypes = [i, i] + [vp] * 15 + [i] * 4 + [vp]
    lib.cerebra_vit_attn_fwd.restype = i
    lib.cerebra_vit_attn_bwd.argtypes = [i, i] + [vp] * 26 + [i] * 4 + [vp]
    lib.cerebra_vit_attn_bwd.restype = i
    lib.cerebra_vit_attn_scratch.argtypes = [i]
    lib.cerebra_vit_attn_scratch.restype = ctypes.c_longlong
    lib.cerebra_vit_attn_core_fwd.argtypes = [i] + [vp] * 3 + [i] * 4 + [vp]
    lib.cerebra_vit_attn_core_fwd.restype = i
    lib.cerebra_vit_attn_core_bwd.argtypes = [i] + [vp] * 6 + [i] * 4 + [vp]
    lib.cerebra_vit_attn_core_bwd.restype = i
    lib.cerebra_vit_attn_scores.argtypes = [vp] * 3 + [i] * 4 + [vp]
    lib.cerebra_vit_attn_scores.restype = i


def _dims(x, p: Params, num_heads: int):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got shape {tuple(x.shape)}")
    B, N, D = x.shape
    if D % num_heads or D // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"D={D} with {num_heads} heads: the CUDA kernels take a head "
                         f"dim dividing D and at most {MAX_HEAD_DIM}")
    if tuple(p[2].shape) != (D, 3 * D) or tuple(p[4].shape) != (D, D):
        raise ValueError("wqkv must be (D, 3D) and wproj (D, D)")
    return B, N, D


def _flags(x, cdt):
    return int(x.dtype == torch.bfloat16), int(cdt == torch.bfloat16)


def _attn_fwd_cuda(x, s, p: Params, num_heads: int):
    B, N, D = _dims(x, p, num_heads)
    check_cuda(x, s, p, B)
    M, cdt, dev, f32 = B * N, p[2].dtype, x.device, torch.float32
    y = torch.empty(M, D, dtype=cdt, device=dev)
    mu = torch.empty(M, dtype=f32, device=dev)
    rstd = torch.empty_like(mu)
    qkv = torch.empty(M, 3 * D, dtype=cdt, device=dev)
    o = torch.empty(M, D, dtype=cdt, device=dev)
    stats = torch.empty(B, num_heads, N, 2, dtype=f32, device=dev)
    out = torch.empty_like(x)
    lib = load_lib("vit_attn", _typed)
    rc = lib.cerebra_vit_attn_fwd(
        *_flags(x, cdt), ptr(x), ptr(s), *[ptr(t) for t in p], ptr(y), ptr(mu), ptr(rstd),
        ptr(qkv), ptr(o), ptr(stats), ptr(out), B, N, D, num_heads, stream_of(x),
    )
    check_rc(lib, rc, "vit_attn_fwd")
    LAUNCHES["vit_attn_fwd"] += 1
    return out, (y, mu, rstd, qkv, o, stats)


def _attn_bwd_cuda(dout, x, s, p: Params, num_heads: int, saved):
    B, N, D = _dims(x, p, num_heads)
    if len(saved) != 6:
        raise ValueError("the CUDA backward needs the CUDA forward's residuals")
    check_cuda(x, s, p, B, (dout, *saved))
    if dout.shape != x.shape or dout.dtype != x.dtype:
        raise ValueError("dout must match x in shape and dtype")
    y, mu, rstd, qkv, o, stats = saved
    g, _, wqkv, _, wp, _ = p
    M, cdt, dev, f32 = B * N, wqkv.dtype, x.device, torch.float32
    dn = torch.empty(M, D, dtype=cdt, device=dev)
    dob = torch.empty(M, D, dtype=cdt, device=dev)
    delta = torch.empty(B, num_heads, N, dtype=f32, device=dev)
    dqkv32 = torch.empty(M, 3 * D, dtype=f32, device=dev)
    dqkvn = torch.empty(M, 3 * D, dtype=cdt, device=dev)
    dy = torch.empty(M, D, dtype=f32, device=dev)
    dx = torch.empty_like(x)
    dg, db, dbp = (torch.empty(D, dtype=f32, device=dev) for _ in range(3))
    dwqkv = torch.empty(D, 3 * D, dtype=f32, device=dev)
    dbqkv = torch.empty(3 * D, dtype=f32, device=dev)
    dwp = torch.empty(D, D, dtype=f32, device=dev)
    lib = load_lib("vit_attn", _typed)
    scratch = torch.empty(lib.cerebra_vit_attn_scratch(D), dtype=f32, device=dev)
    rc = lib.cerebra_vit_attn_bwd(
        *_flags(x, cdt), ptr(x), ptr(dout), ptr(s), ptr(g), ptr(wqkv), ptr(wp), ptr(y),
        ptr(mu), ptr(rstd), ptr(qkv), ptr(o), ptr(stats), ptr(dn), ptr(dob), ptr(delta),
        ptr(dqkv32), ptr(dqkvn), ptr(dy), ptr(scratch), ptr(dx), ptr(dg), ptr(db), ptr(dwqkv),
        ptr(dbqkv),
        ptr(dwp), ptr(dbp), B, N, D, num_heads, stream_of(x),
    )
    check_rc(lib, rc, "vit_attn_bwd")
    LAUNCHES["vit_attn_bwd"] += 1
    return dx, dg, db, dwqkv, dbqkv, dwp, dbp


def _core_dims(qkv, B, N, H, others=()):
    if qkv.dim() != 2 or qkv.shape[0] != B * N or qkv.shape[1] % 3:
        raise ValueError(f"qkv must be (B·N, 3D) = ({B * N}, 3D), got {tuple(qkv.shape)}")
    D = qkv.shape[1] // 3
    if D % H or D // H > MAX_HEAD_DIM:
        raise ValueError(f"D={D} with {H} heads: the CUDA kernels take a head dim dividing D "
                         f"and at most {MAX_HEAD_DIM}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype {qkv.dtype}: float32 or bfloat16 only")
    for t in (qkv, *others):
        if not t.is_contiguous():
            raise ValueError("the attention cores take contiguous tensors only")
    return D


def _core_fwd_cuda(qkv, B, N, H):
    D = _core_dims(qkv, B, N, H)
    o = torch.empty(B * N, D, dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty(B, H, N, 2, dtype=torch.float32, device=qkv.device)
    lib = load_lib("vit_attn", _typed)
    rc = lib.cerebra_vit_attn_core_fwd(int(qkv.dtype == torch.bfloat16), ptr(qkv), ptr(o),
                                       ptr(stats), B, N, D, H, stream_of(qkv))
    check_rc(lib, rc, "vit_attn_core_fwd")
    LAUNCHES["vit_attn_core_fwd"] += 1
    return o, stats


def _core_bwd_cuda(qkv, dob, stats, B, N, H):
    D = _core_dims(qkv, B, N, H, (dob, stats))
    if dob.shape != (B * N, D) or dob.dtype != qkv.dtype:
        raise ValueError("dob must be (B·N, D) in qkv's dtype")
    if stats.shape != (B, H, N, 2) or stats.dtype != torch.float32:
        raise ValueError("stats must be (B, H, N, 2) float32")
    dev, f32 = qkv.device, torch.float32
    delta = torch.empty(B, H, N, dtype=f32, device=dev)
    dqkv32 = torch.empty(B * N, 3 * D, dtype=f32, device=dev)
    dqkvn = torch.empty(B * N, 3 * D, dtype=qkv.dtype, device=dev)
    lib = load_lib("vit_attn", _typed)
    rc = lib.cerebra_vit_attn_core_bwd(int(qkv.dtype == torch.bfloat16), ptr(qkv), ptr(dob),
                                       ptr(stats), ptr(delta), ptr(dqkv32), ptr(dqkvn), B, N, D,
                                       H, stream_of(qkv))
    check_rc(lib, rc, "vit_attn_core_bwd")
    LAUNCHES["vit_attn_core_bwd"] += 1
    return dqkv32, dqkvn, delta


# ---------------------------------------------------------------- wrappers
def attn_fwd(x, s, p: Params, num_heads: int):
    """K5 on CUDA, its plain version on the CPU → (out, saved)."""
    if on_cuda(x, s, *p):
        return _attn_fwd_cuda(x, s, p, num_heads)
    return _attn_fwd_ref(x, s, p, num_heads)


def attn_bwd(dout, x, s, p: Params, num_heads: int, saved):
    """K6 on CUDA, its plain version on the CPU → (dx, dγ, dβ, dWqkv, dbqkv,
    dWp, dbp) with dWq, dbq in the scale-folded space."""
    if on_cuda(dout, x, s, *p):
        return _attn_bwd_cuda(dout, x, s, p, num_heads, saved)
    return _attn_bwd_ref(dout, x, s, p, num_heads, saved)


def attn_scores_cuda(qkv, B: int, N: int, H: int):
    """The bf16 cores' scores of every (sequence, head) on the card, formed
    as the forward and dq form them (S, q rows against k rows) and as dk/dv
    forms them (St, k rows against q rows), both (B, H, N, N) f32 with rows
    the first operand's; St must be S transposed bit for bit."""
    D = _core_dims(qkv, B, N, H)
    if qkv.dtype != torch.bfloat16 or not on_cuda(qkv):
        raise ValueError("the scores come from the bf16 CUDA cores: a bf16 CUDA qkv only")
    S, St = (torch.empty(B, H, N, N, dtype=torch.float32, device=qkv.device) for _ in range(2))
    lib = load_lib("vit_attn", _typed)
    check_rc(lib, lib.cerebra_vit_attn_scores(ptr(qkv), ptr(S), ptr(St), B, N, D, H,
                                              stream_of(qkv)), "vit_attn_scores")
    return S, St


def attn_core_fwd(qkv, B: int, N: int, H: int):
    """K5's attention core alone (the kernel on CUDA, its plain version on
    the CPU) → (o, stats); K5 runs the same kernel between its products."""
    if on_cuda(qkv):
        return _core_fwd_cuda(qkv, B, N, H)
    return attn_core_fwd_ref(qkv, B, N, H)


def attn_core_bwd(qkv, dob, stats, B: int, N: int, H: int):
    """K6's attention cores alone (dq, then dk/dv) → (dqkv32, dqkvn, delta)."""
    if on_cuda(qkv, dob, stats):
        return _core_bwd_cuda(qkv, dob, stats, B, N, H)
    return attn_core_bwd_ref(qkv, dob, stats, B, N, H)


class _FlashMHA(torch.autograd.Function):
    """K15: softmax(q·kᵀ·scale)·v through K5/K6's attention cores."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        B, H, N, _ = q.shape
        # the scale folded into q in q's dtype, as `(q * scale) @ kᵀ` rounds it
        qkv = torch.cat([_rows(t, B, N) for t in (q * scale, k, v)], 1)
        o, stats = attn_core_fwd(qkv, B, N, H)
        ctx.save_for_backward(qkv, stats)
        ctx.scale = scale
        return _heads(o.reshape(B, N, -1), B, N, H)

    @staticmethod
    def backward(ctx, do):
        qkv, stats = ctx.saved_tensors
        B, H, N, _ = do.shape
        dqkv32, _, _ = attn_core_bwd(qkv, _rows(do, B, N).to(qkv.dtype), stats, B, N, H)
        dq, dk, dv = _qkv_heads(dqkv32, B, N, H)
        # chain rule through q·scale
        return (dq * ctx.scale).to(qkv.dtype), dk.to(qkv.dtype), dv.to(qkv.dtype), None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over (B, H, N, dh) q, k, v of one dtype (f32 or
    bf16) → (B, H, N, dh), the function of the JAX package's `_flash_mha`
    (cerebra/models/vit.py:75). On CUDA the forward is K5's attention core
    (`vit_attn_core_fwd`) and the backward K6's (`vit_attn_core_bwd`, from
    the forward's row statistics); a head dim above MAX_HEAD_DIM raises. On
    the CPU both are their plain versions."""
    return _FlashMHA.apply(q, k, v, scale)


class _FusedAttn(torch.autograd.Function):
    """`impl` is (forward, backward): the dispatching wrappers, or the plain
    versions for timing them on the card."""

    @staticmethod
    def forward(ctx, impl, num_heads, x, s, cdt, *params):
        p = _prep(*params, num_heads, cdt)
        out, saved = impl[0](x, s, p, num_heads)
        ctx.impl, ctx.num_heads = impl, num_heads
        ctx.dtypes = [t.dtype for t in params]
        ctx.save_for_backward(x, s, *p, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, s, *rest = ctx.saved_tensors
        H = ctx.num_heads
        dx, dg, db, dwqkv, dbqkv, dwp, dbp = ctx.impl[1](
            dout.to(x.dtype).contiguous(), x, s, rest[:6], H, rest[6:])
        # the q slices were scale-folded: chain rule through wq·scale
        D = x.shape[-1]
        scale = (D // H) ** -0.5
        dwqkv[:, :D] *= scale
        dbqkv[:D] *= scale
        dparams = (dg, db, dwqkv, dbqkv, dwp, dbp)
        return (None, None, dx, None, None, *[d.to(t) for d, t in zip(dparams, ctx.dtypes)])


def _residual(impl, x, g, b, wqkv, bqkv, wproj, bproj, num_heads, compute_dtype, scale):
    cdt = compute_dtype or x.dtype
    s = None
    if scale is not None:
        s = scale.detach().reshape(x.shape[0]).to(torch.float32).contiguous()
    params = (g, b, wqkv, bqkv, wproj, bproj)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return _FusedAttn.apply(impl, num_heads, x, s, cdt, *params)
    return impl[0](x, s, _prep(*params, num_heads, cdt), num_heads)[0]


def fused_attn_residual(x, g, b, wqkv, bqkv, wproj, bproj, num_heads: int, pad: int = 16,
                        compute_dtype=None, scale=None):
    """x + proj(MHA(layernorm(x)·g + b)) over (B, N, D) sequences, with the JAX
    function's arguments: wqkv (D, 3D), wproj (D, D); matmuls in
    `compute_dtype` (default x.dtype); `scale` (B,) multiplies the branch
    and gets no gradient. `pad` is accepted and does not change the result:
    the CUDA kernels mask keys at or beyond N and need no padding."""
    del pad
    return _residual((attn_fwd, attn_bwd), x, g, b, wqkv, bqkv, wproj, bproj, num_heads,
                     compute_dtype, scale)


def fused_attn_residual_ref(x, g, b, wqkv, bqkv, wproj, bproj, num_heads: int, pad: int = 16,
                            compute_dtype=None, scale=None):
    """`fused_attn_residual` through the plain versions on any device (for
    timing the kernels against them on the card)."""
    del pad
    return _residual((_attn_fwd_ref, _attn_bwd_ref), x, g, b, wqkv, bqkv, wproj, bproj,
                     num_heads, compute_dtype, scale)
