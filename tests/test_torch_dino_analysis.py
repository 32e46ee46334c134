"""The EEG-side DINO analysis of the port against the JAX package on the CPU:
`DinoModel` on carried weights (a seeded port model's checkpoint read by
JAX; features of tiled EEG images with JAX's window starts), `from_torch_checkpoint` on reference-layout files read by
both packages, `dino_image_transform`, the `eeg_retrieval_dino` CLI in the
eeg, eeg2eeg and img modes (stimulus JPEGs), `visualize_attention`'s maps
and masks, `brain_map`,
the PNG writer, and K15 (`Attention(use_flash=True)`, the flash attention
over the qkv rows) against the JAX Attention's softmax path.

Tolerances: features, maps and K15's values f32 1e-5, K15's gradients 2e-5
(f32 sums in another order); the image transform and multi-scale resizes
1e-4; recall and precision exactly (the same top-k neighbours); the masks
and cluster-map shapes exactly; the PCA-reduced brain-map matrix 1e-5 (its
power features are f32 means summed in another order); the port's KMeans
inertia at most 1 % above scikit-learn's on the same matrix."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.cli import eeg_retrieval_dino as jax_erd_cli
from cerebra.data import make_synthetic_corpus as jax_synthetic
from cerebra.eval.metrics import PCA as JaxPCA
from cerebra.models import dino_model as jdm
from cerebra.models.vit import Attention as JaxAttention
from cerebra_torch.cli import brain_map, eeg_retrieval_dino, visualize_attention
from cerebra_torch.eval.metrics import kmeans
from cerebra_torch.models import dino_model as tdm
from cerebra_torch.models import vit
from cerebra_torch.models.multicrop import MultiCropWrapper
from cerebra_torch.train.checkpoints import export_dino_pth
from cerebra_torch.utils.plotting import colormap, write_png

torch.set_num_threads(1)

ARGS = dict(arch="vit_tiny", patch_size=16, image_size=32, out_dim=64)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded port model as a reference-layout DINO checkpoint
    (export_dino_pth: the teacher under `backbone.` / `head.`, the student
    with DDP's `module.` too)."""
    tmodel = tdm.DinoModel(tdm.DinoArgs(**ARGS), seed=1)
    wrapped = MultiCropWrapper(tmodel.backbone, tmodel.head)
    path = str(tmp_path_factory.mktemp("ckpt") / "checkpoint.pth")
    export_dino_pth(path, wrapped, wrapped, torch.zeros(1, ARGS["out_dim"]), epoch=0)
    return path


@pytest.fixture(scope="module")
def models(checkpoint):
    """The JAX DinoModel on the checkpoint's weights and the port's model
    that wrote them."""
    return (jdm.DinoModel.from_torch_checkpoint(checkpoint, jdm.DinoArgs(**ARGS)),
            tdm.DinoModel(tdm.DinoArgs(**ARGS), seed=1))


def _eeg(B=3, T=20, C=8, seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, C)).astype(np.float32)


def test_features_from_eeg_match_jax(models):
    jmodel, tmodel = models
    eeg = _eeg()
    key = jax.random.key(5)
    # JAX's starts from its per-trial keys: width 20·(32//20 + 1) = 40
    starts = [int(jax.random.randint(k, (), 0, 40 - 32)) for k in jax.random.split(key, 3)]
    assert len(set(starts)) > 1
    want = np.asarray(jmodel.features_from_eeg(key, jnp.asarray(eeg)))
    got = tmodel.features_from_eeg(torch.from_numpy(eeg), starts=torch.tensor(starts))
    assert got.shape == want.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    drawn = tmodel.features_from_eeg(torch.from_numpy(eeg), generator=torch.Generator())
    assert drawn.shape == (3, 64) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("key", ["teacher", "student"])
def test_from_torch_checkpoint_matches_jax(models, checkpoint, key):
    jmodel, tmodel = models
    if key == "teacher":
        jm = jmodel
    else:
        jm = jdm.DinoModel.from_torch_checkpoint(checkpoint, jdm.DinoArgs(**ARGS),
                                                 checkpoint_key=key)
    tm = tdm.DinoModel.from_torch_checkpoint(checkpoint, tdm.DinoArgs(**ARGS), checkpoint_key=key)
    imgs = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(imgs)))
    got = tm(torch.from_numpy(imgs))
    assert torch.equal(got, tmodel(torch.from_numpy(imgs)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_from_torch_checkpoint_without_a_head(models, tmp_path):
    _, tmodel = models
    sd = {f"backbone.{k}": v for k, v in tmodel.backbone.state_dict().items()}
    sd["mask_token"] = torch.zeros(1, 192)  # not the ViT's: ignored by both
    path = str(tmp_path / "backbone.pth")
    torch.save({"teacher": sd}, path)
    jm = jdm.DinoModel.from_torch_checkpoint(path, jdm.DinoArgs(**ARGS))
    tm = tdm.DinoModel.from_torch_checkpoint(path, tdm.DinoArgs(**ARGS))
    assert tm.head is None
    imgs = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    got = tm(torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, 192)
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(imgs))), atol=1e-5)


@pytest.mark.parametrize("shape,size", [((40, 30, 3), 32), ((300, 200, 3), 224),
                                        ((260, 270, 3), 256)])
def test_dino_image_transform_matches_jax(shape, size):
    img = np.random.default_rng(3).integers(0, 256, size=shape).astype(np.uint8)
    want = jdm.dino_image_transform(img, size)
    got = tdm.dino_image_transform(img, size)
    assert got.shape == want.shape == (size, size, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


# The image window starts at 0 in both packages: T = 33 and 32 px give a
# tiled width of 33, one start.
ERD_FLAGS = ["--synthetic", "--synthetic_classes", "3", "--synthetic_per_class", "5",
             "--synthetic_channels", "8", "--synthetic_samples", "40", "--time_low", "0",
             "--time_high", "33", "--arch", "vit_tiny", "--patch_size", "16", "--image_size",
             "32", "--out_dim", "64", "--topK", "3"]


@pytest.mark.parametrize("mode", ["eeg", "eeg2eeg"])
def test_eeg_retrieval_dino_cli_matches_jax(checkpoint, tmp_path, mode):
    flags = ERD_FLAGS + ["--gallery_tranformation_type", mode, "--query_tranformation_type",
                         mode, "--custom_model_weights", checkpoint]
    want = jax_erd_cli.main(flags + ["--log_dir", str(tmp_path / "jax")])
    got = eeg_retrieval_dino.main(flags + ["--log_dir", str(tmp_path / "torch"), "--device",
                                           "cpu"])
    assert got == want
    for name in ("commandline_args.txt", "synthetic_Scores.pth", "synthetic_Scores.txt",
                 "synthetic_.csv"):
        assert os.path.exists(tmp_path / "torch" / name)
    with open(tmp_path / "jax" / "synthetic_.csv") as a, open(tmp_path / "torch" /
                                                                "synthetic_.csv") as b:
        assert a.read() == b.read()


def test_eeg_retrieval_dino_image_modes_fall_back_to_eeg_images(checkpoint, tmp_path, capsys):
    """img2eeg without a readable --images_root takes EEG-image input, as the
    JAX CLI does: the same scores as eeg2eeg (the same model and starts)."""
    flags = ERD_FLAGS + ["--custom_model_weights", checkpoint, "--device", "cpu"]
    got = eeg_retrieval_dino.main(flags + [
        "--gallery_tranformation_type", "img2eeg", "--query_tranformation_type", "img2eeg",
        "--images_root", str(tmp_path / "missing"), "--log_dir", str(tmp_path / "img")])
    assert "falling back to EEG-image input" in capsys.readouterr().out
    assert got == eeg_retrieval_dino.main(flags + ["--log_dir", str(tmp_path / "eeg")])


def _stimulus_jpegs(root, flags):
    """A JPEG per trial of the synthetic corpus the flags make, where
    image_path puts it ({root}/{wnid}/{name}.JPEG)."""
    from PIL import Image

    n_classes, per_class = int(flags[flags.index("--synthetic_classes") + 1]), int(
        flags[flags.index("--synthetic_per_class") + 1])
    rng = np.random.default_rng(8)
    for i in range(n_classes * per_class):
        wnid = f"n{10000000 + i // per_class:08d}"
        os.makedirs(root / wnid, exist_ok=True)
        img = rng.integers(0, 256, size=(40, 48, 3)).astype(np.uint8)
        Image.fromarray(img).save(root / wnid / f"{wnid}_{i:05d}.JPEG")


def test_eeg_retrieval_dino_image_mode_matches_jax(checkpoint, tmp_path):
    """img mode on stimulus JPEGs (PIL reads them; dino_image_transform)."""
    _stimulus_jpegs(tmp_path / "images", ERD_FLAGS)
    flags = ERD_FLAGS + ["--gallery_tranformation_type", "img", "--query_tranformation_type",
                         "img", "--dino_base_model_weights", checkpoint, "--images_root",
                         str(tmp_path / "images")]
    want = jax_erd_cli.main(flags + ["--log_dir", str(tmp_path / "jax")])
    got = eeg_retrieval_dino.main(flags + ["--log_dir", str(tmp_path / "torch"), "--device",
                                           "cpu"])
    assert got == want
    # visualize_attention on one of those images: a map a head
    image = next((tmp_path / "images").glob("*/*.JPEG"))
    paths = visualize_attention.main(["--image_path", str(image), "--image_size", "32",
                                      "--pretrained_weights", checkpoint, "--device", "cpu",
                                      "--log_dir", str(tmp_path / "va")])
    assert [os.path.basename(p) for p in paths] == [f"attn-head{h}.png" for h in range(3)]


def test_visualize_attention_matches_jax(models, checkpoint, tmp_path):
    jmodel, tmodel = models
    img = np.random.default_rng(4).normal(size=(32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jmodel.backbone.apply(
        {"params": p}, x, return_attention_of_last_block=True))(
        jmodel.params["backbone"], jnp.asarray(img)[None]))[0, :, 0, 1:]
    attn, masks = visualize_attention.attention_maps(tmodel, torch.from_numpy(img), 0.6)
    np.testing.assert_allclose(attn, want, atol=1e-5)
    # the JAX CLI's mass masks (dino/visualize_attention.py:186-196)
    order = np.argsort(want, axis=1)
    val = np.take_along_axis(want, order, axis=1)
    cum = np.cumsum(val / val.sum(axis=1, keepdims=True), axis=1)
    want_masks = np.zeros_like(want, dtype=bool)
    np.put_along_axis(want_masks, order, cum > 0.4, axis=1)
    np.testing.assert_array_equal(masks, want_masks)
    assert visualize_attention.attention_maps(tmodel, torch.from_numpy(img))[1] is None
    # the CLI writes the JAX CLI's files: a map and a mask a head, interleaved
    flags = ERD_FLAGS[:13] + ["--arch", "vit_tiny", "--patch_size", "16", "--image_size", "32",
                              "--threshold", "0.6", "--pretrained_weights", checkpoint]
    paths = visualize_attention.main(flags + ["--log_dir", str(tmp_path), "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == [
        name for h in range(3) for name in (f"attn-head{h}.png", f"mask_th0.6_head{h}.png")]


def test_upsample_is_jax_nearest():
    a = np.random.default_rng(5).normal(size=(7, 7)).astype(np.float32)
    for size in (32, 50, 224):
        want = np.asarray(jax.image.resize(jnp.asarray(a), (size, size), "nearest"))
        np.testing.assert_array_equal(visualize_attention._upsample(a, size), want)


def test_brain_map_matches_jax(tmp_path):
    from sklearn.cluster import KMeans

    flags = ["--synthetic", "--synthetic_classes", "4", "--synthetic_per_class", "3",
             "--synthetic_channels", "12", "--n_time_bins", "10", "--pca_dim", "3"]
    # the JAX CLI's features and PCA (cerebra/cli/brain_map.py:33-47)
    corpus = jax_synthetic(seed=43, n_per_class=3, n_classes=4, n_channels=12, n_samples=512,
                           feature_dim=384, class_signal_scale=1.5).window(20, 480)
    N, T, C = corpus.eeg.shape
    bins = np.array_split(np.arange(T), 10)
    present = np.unique(corpus.labels)
    feats = np.zeros((C, 10, len(present)), dtype=np.float32)
    for ci, cls in enumerate(present):
        power = (corpus.eeg[corpus.labels == cls] ** 2).mean(axis=0)
        for bi, idx in enumerate(bins):
            feats[:, bi, ci] = power[idx].mean(axis=0)
    flat = feats.reshape(C * 10, -1)
    want = JaxPCA(dim=3, whit=0.5).fit(flat).apply(flat)
    got_flat = brain_map.power_features(torch.from_numpy(corpus.eeg), corpus.labels, 10)
    np.testing.assert_allclose(got_flat, flat, rtol=1e-5)
    from cerebra_torch.eval.metrics import PCA

    got = PCA(dim=3, whit=0.5).fit(got_flat).apply(got_flat)
    np.testing.assert_allclose(got, want, atol=1e-5)
    _, _, inertia = kmeans(want, 5, generator=torch.Generator().manual_seed(43))
    assert inertia <= 1.01 * KMeans(n_clusters=5, n_init=5, random_state=43).fit(want).inertia_
    grid = brain_map.main(flags + ["--log_dir", str(tmp_path), "--device", "cpu"])
    assert grid.shape == (12, 10) and set(np.unique(grid)) <= set(range(5))
    assert os.path.exists(tmp_path / "brain_map.json") and os.path.exists(tmp_path /
                                                                           "brain_map.png")


def test_png_writer_round_trips(tmp_path):
    from PIL import Image

    values = np.random.default_rng(6).normal(size=(9, 13))
    for name in ("inferno", "gray"):
        rgb = colormap(values, name)
        np.testing.assert_array_equal(np.asarray(Image.open(write_png(str(tmp_path / "a.png"),
                                                                      rgb))), rgb)
    labels = colormap(np.arange(12).reshape(3, 4), "tab10")
    np.testing.assert_array_equal(labels[0, 0], [0x1F, 0x77, 0xB4])
    np.testing.assert_array_equal(labels[2, 2], labels[0, 0])  # label 10 wraps to 0
    np.testing.assert_array_equal(colormap(np.zeros((2, 2)), "gray"), np.zeros((2, 2, 3)))
    with pytest.raises(ValueError, match="colormap"):
        colormap(values, "viridis")


def _jax_attention(dim, heads, N, seed):
    jattn = JaxAttention(dim=dim, num_heads=heads)
    x = np.random.default_rng(seed).normal(size=(2, N, dim)).astype(np.float32)
    params = jax.jit(jattn.init)(jax.random.key(seed), jnp.asarray(x))["params"]
    return jattn, params, x


@pytest.mark.parametrize("dim,heads,N", [(32, 2, 17), (48, 3, 40), (32, 2, 150)])
def test_flash_attention_matches_jax_softmax_path(dim, heads, N):
    """K15 on the CPU (its plain pieces: the one-pass softmax over key tiles
    of 64 and the backward with di = Σ o·do, over the qkv rows): the JAX
    Attention's unfused path is the function `_flash_mha` computes; N = 150
    is ragged against the 64-key tile."""
    jattn, params, x = _jax_attention(dim, heads, N, seed=N)
    cot = np.random.default_rng(1).normal(size=(2, N, dim)).astype(np.float32)

    def jloss(p, xx):
        out, _ = jattn.apply({"params": p}, xx, need_weights=False)
        return jnp.sum(out * cot), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    tattn = vit.Attention(dim, heads, use_flash=True, flash_min_seq=0)
    sd = {"qkv.weight": params["qkv"]["kernel"].T, "qkv.bias": params["qkv"]["bias"],
          "proj.weight": params["proj"]["kernel"].T, "proj.bias": params["proj"]["bias"]}
    tattn.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out, attn = tattn(xt, need_weights=False)
    assert attn is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=2e-5)
    np.testing.assert_allclose(tattn.qkv.weight.grad.numpy(), np.asarray(jgp["qkv"]["kernel"]).T,
                               atol=2e-5)
    np.testing.assert_allclose(tattn.proj.weight.grad.numpy(),
                               np.asarray(jgp["proj"]["kernel"]).T, atol=2e-5)
    # below flash_min_seq, or with the map asked for, the softmax path
    tattn.flash_min_seq = N + 1
    np.testing.assert_allclose(tattn(xt, need_weights=False)[0].detach().numpy(),
                               np.asarray(jout), atol=1e-5)


def test_flash_mha_in_bf16_on_the_cpu():
    from cerebra_torch.models.vit_attn import flash_mha

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 20, 8, generator=gen).to(torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    out = flash_mha(q, k, v, 8 ** -0.5)
    want = torch.softmax(((q * 8 ** -0.5) @ k.transpose(-1, -2)).float(), -1) @ v.float()
    assert out.dtype == torch.bfloat16
    rel = ((out.float() - want).norm() / want.norm()).item()
    assert rel <= 1.5e-2, rel
    out.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 and torch.isfinite(t.grad).all() for t in (q, k, v))
