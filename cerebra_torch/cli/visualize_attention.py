"""visualize_attention: per-head self-attention maps of a DINO ViT (port of
cerebra/cli/visualize_attention.py; reference dino/visualize_attention.py):
the last block's CLS-token attention over the patch grid, upsampled by
nearest neighbour, one `attn-head{h}.png` a head, and with `--threshold`
the `mask_th{t}_head{h}.png` masks of each head's top attention mass. The
PNGs come from utils/plotting.py (inferno and gray colormaps), not
matplotlib.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from cerebra_torch.cli.common import load_corpus, reference_argparser, resolve_device
from cerebra_torch.models.dino_model import DinoArgs, DinoModel
from cerebra_torch.signal.windows import tile_eeg_to_image
from cerebra_torch.utils.plotting import colormap, write_png


def attention_maps(model: DinoModel, img: torch.Tensor, threshold: float = 0.0
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One preprocessed (H, W, 3) image → (CLS → patch attention of the last
    block per head (heads, N − 1), and with a threshold the masks that keep
    each head's top `threshold` fraction of attention mass (heads, N − 1)
    bool, else None)."""
    with torch.inference_mode():
        attn = model.backbone(img[None].to(model.device, torch.float32),
                              return_attention_of_last_block=True)  # (1, heads, N, N)
    attn = attn[0, :, 0, 1:].float().cpu().numpy()
    if not threshold:
        return attn, None
    # sort ascending, cumulative-normalise, keep where the mass above lies
    # within the threshold, un-sort (dino/visualize_attention.py:186-196)
    order = np.argsort(attn, axis=1)
    val = np.take_along_axis(attn, order, axis=1)
    cum = np.cumsum(val / val.sum(axis=1, keepdims=True), axis=1)
    th_attn = np.zeros_like(attn, dtype=bool)
    np.put_along_axis(th_attn, order, cum > (1 - threshold), axis=1)
    return attn, th_attn


def _upsample(a: np.ndarray, size: int) -> np.ndarray:
    """(g, g) → (size, size), nearest neighbour as `jax.image.resize`'s
    "nearest" (source index floor((i + 0.5)·g / size) in f32)."""
    idx = np.floor((np.arange(size, dtype=np.float32) + 0.5) * a.shape[0] / size).astype(np.int64)
    return a[idx][:, idx]


def main(argv=None):
    parser = reference_argparser("DINO self-attention visualization")
    parser.add_argument("--arch", type=str, default="vit_tiny")
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--image_path", type=str, default="",
                        help="image to visualize; default: first corpus EEG as image")
    parser.add_argument("--threshold", type=float, default=0.0,
                        help="keep top mass fraction (0 = raw maps)")
    parser.add_argument("--pretrained_weights", type=str, default="",
                        help="reference flag name (dino/visualize_attention.py:103); alias of "
                             "--custom_model_weights")
    FLAGS, _ = parser.parse_known_args(argv)
    if FLAGS.pretrained_weights and not FLAGS.custom_model_weights:
        FLAGS.custom_model_weights = FLAGS.pretrained_weights
    device = resolve_device(FLAGS)
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    args = DinoArgs(arch=FLAGS.arch, patch_size=FLAGS.patch_size,
                    image_size=FLAGS.image_size, use_head=False)
    if FLAGS.custom_model_weights and os.path.exists(FLAGS.custom_model_weights):
        model = DinoModel.from_torch_checkpoint(FLAGS.custom_model_weights, args, device=device)
    else:
        model = DinoModel(args, seed=FLAGS.seed, device=device)
        print("WARNING: random-init ViT (no --custom_model_weights)")

    if FLAGS.image_path:
        from PIL import Image  # only an image file needs it

        img = torch.from_numpy(model.dinov1_transform(
            np.asarray(Image.open(FLAGS.image_path).convert("RGB"))))
    else:
        eeg = torch.from_numpy(np.ascontiguousarray(load_corpus(FLAGS).eeg[0]))
        img = tile_eeg_to_image(eeg.t(), FLAGS.image_size,
                                generator=torch.Generator().manual_seed(0)).permute(1, 2, 0)

    attn, th_attn = attention_maps(model, img, FLAGS.threshold)
    grid = FLAGS.image_size // FLAGS.patch_size
    paths = []
    for h in range(attn.shape[0]):
        a = _upsample(attn[h].reshape(grid, grid), FLAGS.image_size)
        paths.append(write_png(os.path.join(FLAGS.log_dir, f"attn-head{h}.png"),
                               colormap(a, "inferno")))
        if th_attn is not None:
            m = _upsample(th_attn[h].reshape(grid, grid).astype(np.float32), FLAGS.image_size)
            # reference naming (dino/visualize_attention.py:213)
            paths.append(write_png(os.path.join(FLAGS.log_dir,
                                                f"mask_th{FLAGS.threshold}_head{h}.png"),
                                   colormap(m, "gray")))
    print(f"wrote {len(paths)} attention maps to {FLAGS.log_dir}")
    return paths


if __name__ == "__main__":
    main()
