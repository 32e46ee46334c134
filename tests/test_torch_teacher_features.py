"""The teacher-feature slice of the port against the JAX package on the CPU:
the Gaussian-noise generator, the image sources (synthetic, a PNG folder,
the stratified split), `extract_features`, the DINOv2 ViT-S/14 (LayerScale,
patch 14) through both packages' importers of one random hub-layout state
dict and through a JAX-initialised tree, and the two CLIs, `extract_features`
(--teacher dinov2_jax and dino_ckpt) and `noise_probe`, against the JAX CLIs.

LayerScale gammas are drawn from U(0.5, 1.5): at their 1e-5 init a wrong
branch would move the output by about 1e-5 and pass.

Tolerances: the noise generator, the sources and `extract_features` with
one model function exactly (the same numpy code); the DINOv2 ViT f32 1e-5
of the largest value (the same formulas, summed in another order); the CLI
features 1e-4 (twelve f32 blocks of ViT-S/14 after a 256-px bilinear resize
in each package); the noise-probe JSON 1e-5."""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.cli import extract_features as jax_ef_cli
from cerebra.cli import noise_probe as jax_np_cli
from cerebra.data import gauss_noise as jgn
from cerebra.data import sources as jsrc
from cerebra.models import vit as jvit
from cerebra_torch.cli import extract_features, noise_probe
from cerebra_torch.data import gauss_noise as tgn
from cerebra_torch.data import sources as tsrc
from cerebra_torch.models import dino_model as tdm
from cerebra_torch.models import vit as tvit
from cerebra_torch.models.multicrop import MultiCropWrapper
from cerebra_torch.train.checkpoints import export_dino_pth

torch.set_num_threads(1)


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def dinov2_state_dict(rng, embed=32, depth=2, patch=14, grid=4, prefix=""):
    """Random weights in the torch.hub dinov2_vits14 layout: LayerScale
    gammas U(0.5, 1.5), an unused mask_token, matrices of std 0.5/√fan_in."""
    def t(*shape):
        return rng.normal(scale=0.5 / np.sqrt(shape[-1]), size=shape).astype(np.float32)

    def near_one(n):
        return (1.0 + rng.normal(scale=0.05, size=n)).astype(np.float32)

    def gamma(n):
        return rng.uniform(0.5, 1.5, size=n).astype(np.float32)

    sd = {"cls_token": t(1, 1, embed), "pos_embed": t(1, grid * grid + 1, embed),
          "mask_token": t(1, embed), "patch_embed.proj.weight": t(embed, 3, patch, patch),
          "patch_embed.proj.bias": t(embed), "norm.weight": near_one(embed), "norm.bias": t(embed)}
    F = 4 * embed
    for i in range(depth):
        b = f"blocks.{i}."
        sd.update({
            b + "norm1.weight": near_one(embed), b + "norm1.bias": t(embed),
            b + "attn.qkv.weight": t(3 * embed, embed), b + "attn.qkv.bias": t(3 * embed),
            b + "attn.proj.weight": t(embed, embed), b + "attn.proj.bias": t(embed),
            b + "ls1.gamma": gamma(embed),
            b + "norm2.weight": near_one(embed), b + "norm2.bias": t(embed),
            b + "mlp.fc1.weight": t(F, embed), b + "mlp.fc1.bias": t(F),
            b + "mlp.fc2.weight": t(embed, F), b + "mlp.fc2.bias": t(embed),
            b + "ls2.gamma": gamma(embed),
        })
    return {prefix + k: v for k, v in sd.items()}


# ------------------------------------------------------------------ sources


def test_gauss_noise_generator_matches_jax_exactly():
    imgs = np.random.default_rng(0).random((6, 8, 8, 3)).astype(np.float32)
    gj, gt = jgn.GaussNoiseGenerator(rank=4).fit(imgs), tgn.GaussNoiseGenerator(rank=4).fit(imgs)
    np.testing.assert_array_equal(gt.mean, gj.mean)
    np.testing.assert_array_equal(gt.basis, gj.basis)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        np.testing.assert_array_equal(gt.sample(rt, (8, 8, 3)), gj.sample(rj, (8, 8, 3)))


def test_synthetic_image_source_bit_equal():
    j = jsrc.synthetic_image_source(n_classes=3, per_class=2, image_size=12, seed=4)
    t = tsrc.synthetic_image_source(n_classes=3, per_class=2, image_size=12, seed=4)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert tuple(t.catalog.wnids) == tuple(j.catalog.wnids) and t.paths is None and t.n == 6


@pytest.fixture(scope="module")
def png_folder(tmp_path_factory):
    """Two class folders of small PNGs (and a file the scan skips)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(1)
    for c, n in (("beta", 3), ("alpha", 4)):
        os.makedirs(root / c)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (20 + i, 24, 3), dtype=np.uint8)).save(
                root / c / f"im{i}.png")
        (root / c / "notes.txt").write_text("skip")
    return str(root)


def test_image_folder_source_matches_jax(png_folder):
    j, t = jsrc.image_folder_source(png_folder), tsrc.image_folder_source(png_folder)
    assert t.paths == j.paths and t.n == 7
    np.testing.assert_array_equal(t.labels, j.labels)
    assert dataclasses.astuple(t.catalog) == dataclasses.astuple(j.catalog)
    np.testing.assert_array_equal(t.load_image(5), j.load_image(5))
    for tj, tt in zip(j.stratified_split(0.3, seed=43), t.stratified_split(0.3, seed=43)):
        np.testing.assert_array_equal(tt, tj)
    for tj, tt in zip(j._proportional_split(0.3, 7), t._proportional_split(0.3, 7)):
        np.testing.assert_array_equal(tt, tj)
    assert tsrc.imagenet_source(png_folder, n_classes=1).n == 4  # alpha only


def test_torchvision_source_imports_lazily():
    """torchvision is imported only when the source is asked for."""
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            tsrc.torchvision_source("cifar10", "/nonexistent")
    else:
        with pytest.raises(FileNotFoundError):
            tsrc.torchvision_source("cifar10", "/nonexistent")


@pytest.mark.parametrize("preprocess", [True, False], ids=["preprocess", "pil_resize"])
def test_extract_features_matches_jax(png_folder, preprocess):
    """One model function (numpy, so both packages run the same arithmetic)
    over the PNG folder, in batches of 3."""
    W = np.random.default_rng(2).normal(size=(3, 5)).astype(np.float32)

    def model_np(batch):
        return np.asarray(batch, dtype=np.float32).mean(axis=(1, 2)) @ W

    pre = (lambda img: img[:16, :16].astype(np.float32) / 255.0) if preprocess else None
    src_j, src_t = jsrc.image_folder_source(png_folder), tsrc.image_folder_source(png_folder)
    want = jsrc.extract_features(src_j, model_np, preprocess=pre, batch_size=3, image_size=12)
    got = tsrc.extract_features(src_t, lambda b: torch.from_numpy(model_np(b.numpy())),
                                preprocess=pre, batch_size=3, image_size=12)
    assert got.shape == (7, 5)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- DINOv2


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_plain"])
@pytest.mark.parametrize("size", [56, 42], ids=["on_grid", "interpolated"])
def test_dinov2_vit_matches_jax_through_both_importers(fused, size):
    """A random hub-layout dict with `teacher.backbone.`-style prefixes into
    both importers; the pos grid of 4 at 56 px, or interpolated to 3 at 42
    px. `fused` takes the kernels' plain versions (K5, K7 with the gammas
    folded into proj and fc2)."""
    rng = np.random.default_rng(3)
    sd = dinov2_state_dict(rng, embed=32, depth=2, prefix="module.backbone.")
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    jm = jvit.VisionTransformer(img_size=56, patch_size=14, embed_dim=32, depth=2, num_heads=2,
                                layer_scale=True)
    want = jm.apply(jvit.import_dinov2_vit_torch(sd, depth=2), jnp.asarray(x))
    tm = tvit.VisionTransformer(img_size=56, patch_size=14, embed_dim=32, depth=2, num_heads=2,
                                layer_scale=True, use_fused_attn=fused, use_fused_mlp=fused)
    tm.load_state_dict(tvit.import_dinov2_vit_torch(sd, depth=2))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))
    _close(got, want, 1e-5)


def test_dinov2_vit_matches_jax_from_a_jax_tree():
    """A JAX-initialised ViT-S/14-shaped tree (depth 2) with drawn gammas,
    carried by params_from_jax."""
    rng = np.random.default_rng(4)
    dims = dict(img_size=28, patch_size=14, embed_dim=384, depth=2, num_heads=6,
                layer_scale=True)  # vit_small_dinov2's, at depth 2
    jm = jvit.VisionTransformer(**dims)
    x = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    for i in range(2):
        for g in ("ls1_gamma", "ls2_gamma"):
            params[f"block_{i}"][g] = rng.uniform(0.5, 1.5, 384).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = tvit.VisionTransformer(**dims)
    full = tvit.vit_small_dinov2()
    assert (full.patch_embed.proj.kernel_size, full.embed_dim, full.num_heads, full.depth,
            full.pos_embed.shape[1], full.blocks[0].layer_scale) == ((14, 14), 384, 6, 12, 1370,
                                                                     True)
    tm.load_state_dict(tvit.params_from_jax(params, depth=2, layer_scale=True))
    with torch.inference_mode():
        _close(tm.eval()(torch.from_numpy(x)), want, 1e-5)


def test_importers_check_the_layer_scale_keys():
    rng = np.random.default_rng(5)
    v2 = dinov2_state_dict(rng, depth=1)
    sd = tvit.import_dinov2_vit_torch(v2, depth=1)
    assert "mask_token" not in sd and "blocks.0.ls2.gamma" in sd
    with pytest.raises(ValueError):
        tvit.import_dino_vit_torch(v2, depth=1)
    v1 = {k: v for k, v in v2.items() if ".ls" not in k}
    assert "blocks.0.ls1.gamma" not in tvit.import_dino_vit_torch(v1, depth=1)
    with pytest.raises(KeyError):
        tvit.import_dinov2_vit_torch(v1, depth=1)


# --------------------------------------------------------------------- CLIs


def _cli_pair(jax_main, torch_main, tmp_path, args, name):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir(exist_ok=True)
    tdir.mkdir(exist_ok=True)
    jax_main(args + ["--out", str(jdir / name)])
    torch_main(args + ["--out", str(tdir / name), "--device", "cpu"])
    return np.load(jdir / name), np.load(tdir / name)


def test_extract_features_cli_dinov2_matches_jax(tmp_path):
    """--teacher dinov2_jax from an .npz at ViT-S/14's dims (37 × 37 pos
    grid, 12 blocks), 2 × 2 synthetic images at 28 px."""
    sd = dinov2_state_dict(np.random.default_rng(6), embed=384, depth=12, grid=37)
    weights = str(tmp_path / "dinov2.npz")
    np.savez(weights, **sd)
    args = ["--synthetic", "--synthetic_classes", "2", "--synthetic_per_class", "2",
            "--image_size", "28", "--teacher", "dinov2_jax", "--teacher_weights", weights]
    j, t = _cli_pair(jax_ef_cli.main, extract_features.main, tmp_path, args, "f.npz")
    assert t["features"].shape == (4, 384)
    np.testing.assert_array_equal(t["labels"], j["labels"])
    _close(t["features"], j["features"], 1e-4)


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A seeded vit_tiny/16 at 64 px as a reference-layout DINO checkpoint."""
    args = tdm.DinoArgs(arch="vit_tiny", patch_size=16, image_size=64, use_head=False)
    model = tdm.DinoModel(args, seed=2)
    wrapped = MultiCropWrapper(model.backbone, torch.nn.Identity())
    path = str(tmp_path_factory.mktemp("ckpt") / "checkpoint.pth")
    export_dino_pth(path, wrapped, wrapped, torch.zeros(1, 8), epoch=0)
    return path


def test_extract_features_cli_dino_ckpt_matches_jax(tmp_path, tiny_checkpoint):
    args = ["--synthetic", "--synthetic_classes", "2", "--synthetic_per_class", "2",
            "--image_size", "64", "--teacher", "dino_ckpt", "--teacher_weights",
            tiny_checkpoint, "--arch", "vit_tiny", "--patch_size", "16"]
    j, t = _cli_pair(jax_ef_cli.main, extract_features.main, tmp_path, args, "f.npz")
    assert t["features"].shape == (4, 192)
    np.testing.assert_array_equal(t["labels"], j["labels"])
    _close(t["features"], j["features"], 1e-4)


@pytest.mark.parametrize("prior", ["synthetic", "folder"])
def test_noise_probe_cli_matches_jax(tmp_path, tiny_checkpoint, png_folder, prior):
    """noise_probe at its defaults (vit_tiny/16 at 64 px, 16 noise images)
    on the checkpoint's weights: the JSON of both packages."""
    root = png_folder if prior == "folder" else str(tmp_path / "none")
    out = {}
    for name, main, extra in (("jax", jax_np_cli.main, []),
                              ("torch", noise_probe.main, ["--device", "cpu"])):
        log_dir = tmp_path / name
        main(["--custom_model_weights", tiny_checkpoint, "--images_root", root,
              "--log_dir", str(log_dir), "--seed", "3"] + extra)
        out[name] = json.loads((log_dir / "noise_probe.json").read_text())
    assert out["torch"].keys() == out["jax"].keys()
    assert out["torch"]["feature_dim"] == out["jax"]["feature_dim"] == 192
    for k in ("mean_cos_real_vs_noise", "mean_cos_real_vs_real"):
        assert abs(out["torch"][k] - out["jax"][k]) <= 1e-5, k


def test_extract_features_cli_transformers_teacher_is_local_and_lazy(tmp_path, monkeypatch):
    """--teacher transformers through a stand-in `transformers` module: the
    processor and model come from the local directory only
    (local_files_only), the features are the last hidden state's CLS token
    of the PIL-resized [0, 1] images; without the package the CLI raises."""
    seen = []

    class Processor:
        def __call__(self, images, return_tensors):
            assert return_tensors == "pt"
            return {"pixel_values": torch.from_numpy(np.stack(images)).permute(0, 3, 1, 2)}

    class Model(torch.nn.Module):
        def forward(self, pixel_values):
            pooled = pixel_values.mean(dim=(2, 3))  # (B, 3)
            return types.SimpleNamespace(last_hidden_state=torch.stack([pooled, -pooled], 1))

    def loader(obj):
        def from_pretrained(path, **kw):
            seen.append((path, kw))
            return obj
        return types.SimpleNamespace(from_pretrained=from_pretrained)

    fake = types.ModuleType("transformers")
    fake.AutoImageProcessor, fake.AutoModel = loader(Processor()), loader(Model())
    monkeypatch.setitem(sys.modules, "transformers", fake)
    out = str(tmp_path / "f.npz")
    args = ["--synthetic", "--synthetic_classes", "2", "--synthetic_per_class", "2",
            "--image_size", "12", "--teacher", "transformers", "--teacher_weights",
            str(tmp_path / "hf"), "--device", "cpu", "--out", out]
    extract_features.main(args)
    assert seen == [(str(tmp_path / "hf"), {"local_files_only": True})] * 2
    src = tsrc.synthetic_image_source(2, 2, 12, seed=43)
    want = tsrc.extract_features(src, lambda b: b.mean(dim=(1, 2)), image_size=12)
    np.testing.assert_allclose(np.load(out)["features"], want, rtol=1e-6)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        extract_features.main(args)


def test_clis_refuse_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        extract_features.main(["--synthetic", "--out", str(tmp_path / "f.npz")])
    with pytest.raises(RuntimeError):
        noise_probe.main(["--log_dir", str(tmp_path)])
