"""The port's fused ViT half-blocks (K5–K8 through their plain versions, as a
CPU tensor takes them) against the JAX package's Pallas kernels in interpret
mode: values and every gradient, in f32 and with an f32 stream through bf16
matmuls, with and without the drop-path scale (one sample dropped), at a
ragged N or M, and with a head dim whose scale dh^-0.5 is not a power of two
(the folded-scale dWq).

Tolerances. f32: both sides run the same f32 formulas and differ in the
order of sums and, for GELU, by the TPU kernel's rational erf (error 1.5e-7),
so values agree to 2e-5 abs and each gradient to 2e-5 of its largest entry.
bf16 compute: the same rounding points on both sides, but a sum that lands on
the other side of a bf16 rounding moves that element by one bf16 ulp (2^-8
relative) and the products carry it on; every output is held to a relative
Frobenius error of 1e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.pallas_vit_attn import fused_attn_residual as jax_attn
from cerebra.models.pallas_vit_mlp import fused_mlp_residual as jax_mlp
from cerebra_torch.kernels import LAUNCHES
from cerebra_torch.models import vit_attn, vit_mlp

torch.set_num_threads(1)

KEEP = 0.9
DTYPES = {"f32": (None, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _params(rng, shapes, scales):
    return [(rng.normal(size=s) * sc + (1.0 if i == 0 else 0.0)).astype(np.float32)
            for i, (s, sc) in enumerate(zip(shapes, scales))]


def _scale(rng, B, scaled):
    if not scaled:
        return None
    s = np.full(B, 1.0 / KEEP, np.float32)
    s[0] = 0.0  # one sample dropped
    return s


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


def _run_both(jax_fn, torch_fn, x, params, ct, s, cdt_j, cdt_t, extra_j, extra_t):
    """Value and gradients (x and every parameter) under the cotangent ct."""
    def f(x_, *p):
        scale = None if s is None else jnp.asarray(s)
        return jax_fn(x_, *p, *extra_j, compute_dtype=cdt_j, scale=scale)

    out_j, vjp = jax.vjp(f, jnp.asarray(x), *[jnp.asarray(p) for p in params])
    grads_j = vjp(jnp.asarray(ct))

    xt = torch.from_numpy(x).requires_grad_(True)
    pt = [torch.from_numpy(p).requires_grad_(True) for p in params]
    scale = None if s is None else torch.from_numpy(s)
    out_t = torch_fn(xt, *pt, *extra_t, compute_dtype=cdt_t, scale=scale)
    out_t.backward(torch.from_numpy(ct))
    grads_t = [xt.grad] + [p.grad for p in pt]
    return out_j, grads_j, out_t.detach(), grads_t


@pytest.mark.parametrize("scaled", [False, True], ids=["no_s", "s"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("N", [16, 13])
def test_fused_attn_matches_jax(N, dtype, scaled):
    rng = np.random.default_rng(N)
    B, D, H = 2, 32, 4  # dh = 8: the folded scale 8^-0.5 is not a power of two
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    params = _params(rng, [(D,), (D,), (D, 3 * D), (3 * D,), (D, D), (D,)],
                     [0.1, 0.1, 0.1, 0.05, 0.1, 0.05])
    ct = rng.normal(size=(B, N, D)).astype(np.float32)
    s = _scale(rng, B, scaled)
    cdt_j, cdt_t = DTYPES[dtype]
    out_j, g_j, out_t, g_t = _run_both(jax_attn, vit_attn.fused_attn_residual, x, params, ct,
                                       s, cdt_j, cdt_t, (H, 16), (H,))
    bf16 = dtype == "bf16"
    _compare(out_t, out_j, bf16, "out")
    names = ["dx", "dg", "db", "dwqkv", "dbqkv", "dwproj", "dbproj"]
    for name, a, b in zip(names, g_t, g_j):
        _compare(a, b, bf16, name)
    assert out_t.dtype == torch.float32  # the stream keeps x's dtype


@pytest.mark.parametrize("scaled", [False, True], ids=["no_s", "s"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M", [32, 37])
def test_fused_mlp_matches_jax(M, dtype, scaled):
    rng = np.random.default_rng(M)
    D, F = 32, 128
    x = rng.normal(size=(M, D)).astype(np.float32)
    params = _params(rng, [(D,), (D,), (D, F), (F,), (F, D), (D,)],
                     [0.1, 0.1, 0.1, 0.05, 0.1, 0.05])
    ct = rng.normal(size=(M, D)).astype(np.float32)
    s = _scale(rng, M, scaled)
    cdt_j, cdt_t = DTYPES[dtype]
    out_j, g_j, out_t, g_t = _run_both(jax_mlp, vit_mlp.fused_mlp_residual, x, params, ct, s,
                                       cdt_j, cdt_t, (16,), (16,))
    bf16 = dtype == "bf16"
    _compare(out_t, out_j, bf16, "out")
    for name, a, b in zip(["dx", "dg", "db", "dw1", "db1", "dw2", "db2"], g_t, g_j):
        _compare(a, b, bf16, name)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    rng = np.random.default_rng(0)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    x = torch.from_numpy(rng.normal(size=(1, 5, 16)).astype(np.float32)).requires_grad_(True)
    p = [torch.ones(16), torch.zeros(16), torch.eye(16).repeat(1, 3) * 0.1, torch.zeros(48),
         torch.eye(16), torch.zeros(16)]
    vit_attn.fused_attn_residual(x, *p, 2).sum().backward()
    m = [torch.ones(16), torch.zeros(16), torch.ones(16, 32) * 0.1, torch.zeros(32),
         torch.ones(32, 16) * 0.1, torch.zeros(16)]
    vit_mlp.fused_mlp_residual(x.reshape(5, 16), *m).sum().backward()
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES


def test_plain_versions_on_saved_residuals_match_recompute():
    """The plain backward ignores the forward's residuals (it recomputes, as
    the Pallas body does), and the autograd path hands it none."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 7, 16)).astype(np.float32))
    p = vit_attn._prep(torch.ones(16), torch.zeros(16),
                       torch.from_numpy(rng.normal(size=(16, 48)).astype(np.float32)) * 0.2,
                       torch.zeros(48), torch.eye(16), torch.zeros(16), 2, torch.float32)
    out, saved = vit_attn.attn_fwd(x, None, p, 2)
    assert saved == ()
    dout = torch.ones_like(out)
    a = vit_attn.attn_bwd(dout, x, None, p, 2, saved)
    b = vit_attn._attn_bwd_ref(dout, x, None, p, 2)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
