"""The port's DINO ViT against the JAX package on the CPU, with the JAX
weights loaded through `params_from_jax`: `Block` on its fused (the kernels'
plain versions, against Pallas in interpret mode) and unfused branches, with
and without LayerScale; `VisionTransformer` at its training grid and at an
off-grid size (pos-embed interpolation), with its other outputs; `DINOHead`;
and the pos-embed resize against `jax.image.resize`.

Tolerance: everything is f32 and both sides run the same formulas, summed in
another order, so values agree to 2e-5 and gradients to 2e-5 of their
largest entry (the fused MLP's rational erf on the TPU side differs from
erf by at most 1.5e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models.heads import DINOHead as JaxHead
from cerebra.models.vit import Block as JaxBlock
from cerebra.models.vit import VisionTransformer as JaxViT
from cerebra.models.vit import _interpolate_pos_embed as jax_interp
from cerebra_torch.models import heads, vit

torch.set_num_threads(1)
TOL = 2e-5


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


def _randomize(params, rng, names):
    """LayerScale gammas start at 1e-5; give them O(1) values so the branch
    they scale is tested."""
    params = jax.tree.map(np.asarray, params)
    for n in names:
        params[n] = rng.normal(size=params[n].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("layer_scale", [False, True], ids=["plain", "ls"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_block_matches_jax(fused, layer_scale):
    rng = np.random.default_rng(0)
    D, H, N = 48, 2, 13
    jb = JaxBlock(D, H, layer_scale=layer_scale, use_fused_attn=fused, use_fused_mlp=fused)
    x = rng.normal(size=(2, N, D)).astype(np.float32)
    params = jb.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = _randomize(params, rng, ["ls1_gamma", "ls2_gamma"] if layer_scale else [])
    ct = rng.normal(size=x.shape).astype(np.float32)

    out_j, vjp = jax.vjp(lambda p, x_: jb.apply({"params": p}, x_), params, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(ct))

    tb = vit.Block(D, H, layer_scale=layer_scale, use_fused_attn=fused, use_fused_mlp=fused)
    tb.load_state_dict(vit.block_params_from_jax(params, layer_scale), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = tb(xt)
    out_t.backward(torch.from_numpy(ct))
    _close(out_t, out_j, "out")
    _close(xt.grad, gx_j, "dx")
    want = vit.block_params_from_jax(jax.tree.map(np.asarray, gp_j), layer_scale)
    for name, p in tb.named_parameters():
        _close(p.grad, want[name], name)


def _jax_vit(**kw):
    return JaxViT(img_size=32, patch_size=8, embed_dim=48, depth=2, num_heads=2, **kw)


def _torch_vit(params):
    tv = vit.VisionTransformer(img_size=32, patch_size=8, embed_dim=48, depth=2, num_heads=2)
    tv.load_state_dict(vit.params_from_jax(params, depth=2), strict=True)
    return tv.eval()


@pytest.mark.parametrize("size", [32, 24], ids=["global", "off_grid"])
def test_vision_transformer_matches_jax(size):
    rng = np.random.default_rng(1)
    jv = _jax_vit()
    params = jv.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))["params"]
    img = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    tv = _torch_vit(params)
    xt = torch.from_numpy(img).requires_grad_(True)

    out_j, vjp = jax.vjp(lambda p, x_: jv.apply({"params": p}, x_), params, jnp.asarray(img))
    ct = rng.normal(size=out_j.shape).astype(np.float32)
    gp_j, gx_j = vjp(jnp.asarray(ct))
    out_t = tv(xt)
    out_t.backward(torch.from_numpy(ct))
    _close(out_t, out_j, "cls")
    _close(xt.grad, gx_j, "dimg")
    want = vit.params_from_jax(jax.tree.map(np.asarray, gp_j), depth=2)
    for name, p in tv.named_parameters():
        _close(p.grad, want[name], name)

    with torch.no_grad():
        x = torch.from_numpy(img)
        _close(tv(x, return_all_tokens=True), jv.apply({"params": params}, img,
                                                       return_all_tokens=True), "tokens")
        for a, b in zip(tv(x, n_intermediate=2),
                        jv.apply({"params": params}, img, n_intermediate=2)):
            _close(a, b, "intermediate")
        _close(tv(x, return_attention_of_last_block=True),
               jv.apply({"params": params}, img, return_attention_of_last_block=True), "attn")


def test_dino_head_matches_jax():
    rng = np.random.default_rng(2)
    jh = JaxHead(in_dim=48, out_dim=32, hidden_dim=64, bottleneck_dim=16)
    x = rng.normal(size=(5, 48)).astype(np.float32)
    params = jh.init(jax.random.key(2), jnp.asarray(x))["params"]
    th = heads.DINOHead(48, 32, hidden_dim=64, bottleneck_dim=16)
    th.load_state_dict(heads.params_from_jax(params), strict=True)
    assert not th.last_layer.weight_g.requires_grad  # norm_last_layer: the gain is fixed
    out_j, vjp = jax.vjp(lambda p: jh.apply({"params": p}, jnp.asarray(x)), params)
    ct = rng.normal(size=out_j.shape).astype(np.float32)
    (gp_j,) = vjp(jnp.asarray(ct))
    out_t = th(torch.from_numpy(x))
    out_t.backward(torch.from_numpy(ct))
    _close(out_t, out_j, "head")
    want = heads.params_from_jax(jax.tree.map(np.asarray, gp_j))
    for name, p in th.named_parameters():
        if p.requires_grad:
            _close(p.grad, want[name], name)


def test_dino_head_with_batchnorm_raises_like_the_jax_recipe():
    """The JAX recipe applies a BN head without its batch_stats and flax
    raises; the port has no reference to match and refuses it."""
    with pytest.raises(NotImplementedError):
        heads.DINOHead(8, 16, use_bn=True)


@pytest.mark.parametrize("grid", [(12, 12), (36, 36), (12, 20)], ids=str)
def test_pos_embed_resize_matches_jax_image_resize(grid):
    """jax.image.resize's bicubic antialiases when it shrinks; the port's
    F.interpolate(..., antialias=True) agrees with it."""
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(1, 1 + 28 * 28, 8)).astype(np.float32)
    want = jax_interp(jnp.asarray(pos), *grid)
    got = vit._interpolate_pos_embed(torch.from_numpy(pos), *grid)
    _close(got, want, "pos")
