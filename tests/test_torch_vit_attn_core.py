"""The attention cores of K5 and K6 as the CUDA half-blocks compose them: LN,
the qkv product, the forward core (o and each query row's softmax max and
sum), the proj product; and for the backward the proj's gradients, do, the
backward core (dq, dk, dv from the forward's max and sum, with delta summed
over f32 p), the qkv weights' gradients and the LN backward. Run through the
cores' plain versions, as a CPU tensor takes them, and held against the
port's plain half-blocks (`_attn_fwd_ref`, `_attn_bwd_ref`) and against the
JAX package's Pallas kernels in interpret mode, f32 and bf16, at N on both
sides of the CUDA kernels' 64-row tiles and head dims 8 and 64.

Tolerances as tests/test_torch_vit_kernels.py, for its reasons: f32 values
2e-5 abs and each gradient 2e-5 of its largest entry (the same formulas,
sums in another order); bf16 every output relative Frobenius 1e-2 (a sum
that lands on the other side of a bf16 rounding moves that element by one
ulp and the products carry it on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_vit_attn import fused_attn_residual as jax_attn
from cerebra_torch.kernels import LAUNCHES
from cerebra_torch.models import vit_attn as va
from cerebra_torch.models.vit_mlp import layernorm_f32, ln_backward, mm

torch.set_num_threads(1)

DTYPES = {"f32": (None, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
HEADS = {8: (32, 4), 64: (64, 1)}  # head dim → (D, H)
KEEP = 0.9


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


def compose_fwd(x, s, p, H):
    """K5 as the CUDA half-block runs it, with the forward core's plain
    version → (out, the saved residuals)."""
    g, b, wqkv, bqkv, wp, bp = p
    B, N, D = x.shape
    cdt = wqkv.dtype
    xn, rstd = layernorm_f32(x.float())
    y = (xn * g.float() + b.float()).to(cdt).reshape(B * N, D)
    qkv = (mm(y, wqkv) + bqkv.float()).to(cdt)
    o, stats = va.attn_core_fwd(qkv, B, N, H)
    out = mm(o, wp) + bp.float()
    if s is not None:
        out = out * s.repeat_interleave(N)[:, None]
    out = (x.float().reshape(B * N, D) + out).to(x.dtype).reshape(B, N, D)
    return out, (xn, rstd, y, qkv, o, stats)


def compose_bwd(dout, x, s, p, H, saved):
    """K6 as the CUDA half-block runs it, with the backward core's plain
    version → (dx, dγ, dβ, dWqkv, dbqkv, dWp, dbp), dWq and dbq scale-folded."""
    g, _, wqkv, _, wp, _ = p
    xn, rstd, y, qkv, o, stats = saved
    B, N, D = x.shape
    cdt = wqkv.dtype
    dout_raw = dout.float()
    d = dout_raw.reshape(B * N, D)
    if s is not None:
        d = d * s.repeat_interleave(N)[:, None]
    dn = d.to(cdt)
    dbp, dwp = d.sum(0), mm(o.t(), dn)
    dob = mm(dn, wp.t()).to(cdt)
    dqkv32, dqkvn, _ = va.attn_core_bwd(qkv, dob, o, stats, B, N, H)
    dwqkv, dbqkv = mm(y.t(), dqkvn), dqkv32.sum(0)
    dy = mm(dqkvn, wqkv.t()).reshape(B, N, D)
    dx, dg, db = ln_backward(dy, xn, rstd, g, dout_raw, x.dtype)
    return dx, dg, db, dwqkv, dbqkv, dwp, dbp


def _inputs(N, dh, seed):
    rng = np.random.default_rng(seed)
    D, H = HEADS[dh]
    B = 2
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    shapes = [(D,), (D,), (D, 3 * D), (3 * D,), (D, D), (D,)]
    params = [(rng.normal(size=sh) * sc + (1.0 if i == 0 else 0.0)).astype(np.float32)
              for i, (sh, sc) in enumerate(zip(shapes, [0.1, 0.1, 0.1, 0.05, 0.1, 0.05]))]
    ct = rng.normal(size=(B, N, D)).astype(np.float32)
    s = np.full(B, 1.0 / KEEP, np.float32)
    s[0] = 0.0  # one sample dropped
    return x, params, ct, s, H


@pytest.mark.parametrize("dh", sorted(HEADS))
@pytest.mark.parametrize("N", [17, 64, 65, 129])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cores_compose_the_half_blocks(dtype, N, dh):
    """LN + products + the plain cores equal the plain half-blocks."""
    x, params, ct, s, H = _inputs(N, dh, N + dh)
    cdt = DTYPES[dtype][1]
    xt, st, dt = torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(ct)
    p = va._prep(*[torch.from_numpy(a) for a in params], H, cdt)
    out, saved = compose_fwd(xt, st, p, H)
    bf16 = dtype == "bf16"
    _compare(out, va._attn_fwd_ref(xt, st, p, H)[0], bf16, "out")
    names = ["dx", "dg", "db", "dwqkv", "dbqkv", "dwproj", "dbproj"]
    for name, a, b in zip(names, compose_bwd(dt, xt, st, p, H, saved),
                          va._attn_bwd_ref(dt, xt, st, p, H)):
        _compare(a, b, bf16, name)


@pytest.mark.parametrize("dh", sorted(HEADS))
@pytest.mark.parametrize("N", [17, 64, 65, 129])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cores_match_jax(dtype, N, dh):
    """The composition through the plain cores against the Pallas kernels
    (interpret mode): the value and every gradient of the parameters as the
    caller passes them (the q scale unfolded)."""
    x, params, ct, s, H = _inputs(N, dh, N + dh)
    cdt_j, cdt = DTYPES[dtype]

    def f(x_, *p_):
        return jax_attn(x_, *p_, H, 16, compute_dtype=cdt_j, scale=jnp.asarray(s))

    out_j, vjp = jax.vjp(f, jnp.asarray(x), *[jnp.asarray(a) for a in params])
    grads_j = vjp(jnp.asarray(ct))

    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    p = va._prep(*[torch.from_numpy(a) for a in params], H, cdt)
    out, saved = compose_fwd(xt, st, p, H)
    dx, dg, db, dwqkv, dbqkv, dwp, dbp = compose_bwd(torch.from_numpy(ct), xt, st, p, H, saved)
    D = x.shape[-1]
    scale = (D // H) ** -0.5
    dwqkv[:, :D] *= scale
    dbqkv[:D] *= scale
    bf16 = dtype == "bf16"
    _compare(out, out_j, bf16, "out")
    names = ["dx", "dg", "db", "dwqkv", "dbqkv", "dwproj", "dbproj"]
    for name, a, b in zip(names, (dx, dg, db, dwqkv, dbqkv, dwp, dbp), grads_j):
        _compare(a, b, bf16, name)


def test_core_wrappers_take_the_plain_versions_on_the_cpu():
    """On the CPU the core wrappers are their plain versions and launch
    nothing; the backward's delta is Σ_j p·dp per query row."""
    x, params, ct, s, H = _inputs(37, 8, 0)
    B, N, D = x.shape
    p = va._prep(*[torch.from_numpy(a) for a in params], H, torch.float32)
    _, (_, _, _, qkv, o, stats) = compose_fwd(torch.from_numpy(x), None, p, H)
    before = dict(LAUNCHES)
    o2, stats2 = va.attn_core_fwd(qkv, B, N, H)
    assert torch.equal(o2, o) and torch.equal(stats2, stats)
    assert stats.shape == (B, H, N, 2)
    dob = torch.from_numpy(ct).reshape(B * N, D)
    dqkv32, dqkvn, delta = va.attn_core_bwd(qkv, dob, o, stats, B, N, H)
    want = va.attn_core_bwd_ref(qkv, dob, stats, B, N, H)
    for a, b in zip((dqkv32, dqkvn, delta), want):
        assert torch.equal(a, b)
    assert dqkv32.shape == (B * N, 3 * D) and delta.shape == (B, H, N)
    q, k, v = va._qkv_heads(qkv, B, N, H)
    prob = torch.softmax(q @ k.transpose(-1, -2), -1)
    dp = va._heads(dob.reshape(B, N, D), B, N, H) @ v.transpose(-1, -2)
    torch.testing.assert_close(delta, (prob * dp).sum(-1), rtol=1e-5, atol=1e-6)
    assert dict(LAUNCHES) == before
