"""The DINO ViT cell's counts against the hand counts of its shapes, and
the plain ViT's pieces (`reference/vit.py`) against the port's on the CPU
in f32: the EEG images, the resized position grid, the CLS feature."""

import pytest
import torch

from perfbench.counts import vit
from perfbench.run import HERE, load_json
from perfbench.reference import vit as plain

T = 1e12


def test_counts_of_the_b128_step():
    """Student forward and backward over 256 global (785 tokens) and 512
    local (145) sequences, the teacher's forward over the globals: 26.76
    TFLOP in the attention half-blocks, 29.06 in the MLP ones, 0.11 in the
    patch convolution and 0.11 in DINOHead."""
    cfg = load_json(HERE, "configs", "dino_vits8.json")
    c = vit.dino_vit(cfg, 128)
    assert (vit.tokens(cfg, 224), vit.tokens(cfg, 96)) == (785, 145)
    attn, mlp = c["layers"]["vit_attn"]["flops"], c["layers"]["vit_mlp"]["flops"]
    assert attn / T == pytest.approx(26.76, abs=0.01)
    assert mlp / T == pytest.approx(29.06, abs=0.01)
    assert (c["step_flops"] - attn - mlp) / T == pytest.approx(0.22, abs=0.01)
    assert c["dtype"] == "bfloat16"
    # bound by the operations: 27.1 and 29.4 ms at 989 TFLOP/s, the bytes 8.3 ms each
    for layer in c["layers"].values():
        assert layer["bytes"] / 3.35e12 < layer["flops"] / 989e12 / 3


def test_eeg_images_and_positions_match_the_port():
    from cerebra_torch.models.vit import _interpolate_pos_embed
    from cerebra_torch.signal.windows import tile_eeg_views, window_starts

    gen = torch.Generator().manual_seed(3)
    eeg = torch.randn(3, 40, 8, generator=gen)
    for size in (32, 16):
        starts = window_starts((2, 3), 8, 40, size, gen)
        want = tile_eeg_views(eeg, starts, size).reshape(6, size, size, 3).permute(0, 3, 1, 2)
        assert torch.equal(plain.eeg_images(eeg, starts, size), want)
    pos = torch.randn(1, 17, 6, generator=gen)
    for g in (4, 2, 3):
        torch.testing.assert_close(plain.position_grid(pos, g, g), _interpolate_pos_embed(pos, g, g))


def test_vit_cls_matches_the_port():
    """The CLS feature of the port's unfused ViT with drop path off, and with
    one block's masks fed to both."""
    from cerebra_torch.models.vit import VisionTransformer

    gen = torch.Generator().manual_seed(4)
    model = VisionTransformer(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2,
                              generator=gen).eval()
    p = {f"backbone.{k}": v.detach() for k, v in model.named_parameters()}
    cfg = {"patch_size": 8, "depth": 2, "num_heads": 2, "drop_path_rate": 0.0}
    for size in (32, 16):
        x = torch.randn(5, size, size, 3, generator=gen)
        torch.testing.assert_close(plain.vit_cls(x.permute(0, 3, 1, 2), p, "backbone.", cfg),
                                   model(x), atol=1e-5, rtol=1e-5)
