"""extract_features: build a teacher-feature cache for a corpus (port of
cerebra/cli/extract_features.py). Runs a teacher once over the stimulus
images and writes `features.npz` (`features`, `labels`), which every trainer
reads with --features_cache (the reference downloads DINOv2 through
torch.hub on each run and mutates its dataset in place,
LstmDistillFromDinoV2Train.py:144-146, 287).

Teachers, all from local files (nothing is downloaded):
  --teacher dino_ckpt    the port's DINO ViT from a local DINO .pth checkpoint
  --teacher dinov2_jax   the port's DINOv2 ViT-S/14 (LayerScale, patch 14)
                         from a local state dict in the dinov2_vits14 layout
                         (.pth, .npz or .npy); the name is the JAX CLI's
  --teacher transformers a local Hugging Face DINOv2 directory (needs the
                         `transformers` package)
  --teacher random_vit   a seeded random ViT (smoke tests, ablation control)

The ViT teachers run on `--device` under torch.inference_mode(); on CUDA
every block takes the fused attention and MLP forwards (K5, K7).
"""

from __future__ import annotations

import numpy as np
import torch

from cerebra_torch.cli.common import reference_argparser, resolve_device
from cerebra_torch.data.sources import (
    extract_features,
    image_folder_source,
    synthetic_image_source,
)
from cerebra_torch.models.dino_model import DinoArgs, DinoModel, dino_image_transform
from cerebra_torch.models.vit import import_dinov2_vit_torch, vit_small_dinov2


def _load_state_dict(path: str) -> dict:
    """A dinov2_vits14-layout state dict from .npz/.npy or a torch file (its
    `teacher` or `model` entry when present)."""
    if path.endswith((".npz", ".npy")):
        return dict(np.load(path))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.get("teacher", obj.get("model", obj)) if isinstance(obj, dict) else obj


def _transformers_teacher(path: str, device: torch.device):
    """A model function over a local Hugging Face DINOv2 directory: its CLS
    token of the last hidden state."""
    from transformers import AutoImageProcessor, AutoModel

    processor = AutoImageProcessor.from_pretrained(path, local_files_only=True)
    model = AutoModel.from_pretrained(path, local_files_only=True).to(device).eval()

    @torch.inference_mode()
    def model_fn(batch: torch.Tensor) -> torch.Tensor:
        inputs = processor(images=list(batch.numpy()), return_tensors="pt")
        out = model(**{k: v.to(device) for k, v in inputs.items()})
        return out.last_hidden_state[:, 0]

    return model_fn


def main(argv=None):
    parser = reference_argparser("Teacher feature-cache extraction")
    parser.add_argument("--teacher", type=str, default="random_vit",
                        choices=["dino_ckpt", "dinov2_jax", "transformers", "random_vit"])
    parser.add_argument("--teacher_weights", type=str, default="")
    parser.add_argument("--arch", type=str, default="vit_small")
    parser.add_argument("--patch_size", type=int, default=8)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--out", type=str, default="features.npz")
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    device = resolve_device(FLAGS)

    if FLAGS.synthetic:
        source = synthetic_image_source(
            n_classes=FLAGS.synthetic_classes, per_class=FLAGS.synthetic_per_class,
            image_size=FLAGS.image_size, seed=FLAGS.seed,
        )
    else:
        source = image_folder_source(FLAGS.images_root)
    print(f"{source.n} images over {source.catalog.n_classes} classes")

    if FLAGS.teacher == "transformers":
        feats = extract_features(source, _transformers_teacher(FLAGS.teacher_weights, device),
                                 image_size=FLAGS.image_size)
    elif FLAGS.teacher == "dinov2_jax":
        model = vit_small_dinov2()
        model.load_state_dict(import_dinov2_vit_torch(_load_state_dict(FLAGS.teacher_weights)))
        model = model.to(device).eval()

        @torch.inference_mode()
        def model_fn(batch: torch.Tensor) -> torch.Tensor:
            return model(batch.to(device))

        feats = extract_features(
            source, model_fn,
            preprocess=lambda img: dino_image_transform(img, FLAGS.image_size),
            image_size=FLAGS.image_size,
        )
    else:
        args = DinoArgs(arch=FLAGS.arch, patch_size=FLAGS.patch_size,
                        image_size=FLAGS.image_size, use_head=False)
        if FLAGS.teacher == "dino_ckpt":
            dino = DinoModel.from_torch_checkpoint(FLAGS.teacher_weights, args, device=device)
        else:
            dino = DinoModel(args, seed=FLAGS.seed, device=device)
        feats = extract_features(source, dino, preprocess=dino.dinov1_transform,
                                 image_size=FLAGS.image_size)

    np.savez(FLAGS.out, features=feats.astype(np.float32), labels=source.labels)
    print(f"wrote {FLAGS.out}: features {feats.shape}")
    return feats


if __name__ == "__main__":
    main()
