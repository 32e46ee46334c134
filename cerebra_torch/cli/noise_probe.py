"""noise_probe: probe a DINO model with Gaussian-noise images fitted to an
image prior (port of cerebra/cli/noise_probe.py; the experiment of the
reference's optimizeSearch.ipynb notebook: how do the features of noise
images compare with those of real images?).

Writes `noise_probe.json` with the mean cosine similarity between real and
matched noise features, and among the real features: the null-hypothesis
control for image-feature retrieval. Every draw comes from the numpy
generator seeded by `--seed`, in the JAX CLI's order, and the model runs on
`--device` (K5 and K7 in every block on CUDA).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cerebra_torch.cli.common import reference_argparser, resolve_device
from cerebra_torch.data.gauss_noise import GaussNoiseGenerator
from cerebra_torch.data.sources import image_folder_source
from cerebra_torch.models.dino_model import DinoArgs, DinoModel
from cerebra_torch.signal.image_aug import IMAGENET_MEAN, IMAGENET_STD


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def main(argv=None):
    parser = reference_argparser("Gaussian-noise image probe of a DINO model")
    parser.add_argument("--arch", type=str, default="vit_tiny")
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--n_noise", type=int, default=16)
    parser.add_argument("--pretrained_weights", type=str, default="",
                        help="reference flag name; alias of --custom_model_weights")
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
        print("WARNING: random-init DINO model (no --custom_model_weights)")

    rng = np.random.default_rng(FLAGS.seed)
    S = FLAGS.image_size
    from_folder = os.path.isdir(FLAGS.images_root)
    if from_folder:
        src = image_folder_source(FLAGS.images_root)
        real = np.stack([
            np.asarray(model.dinov1_transform(src.load_image(i)))
            for i in rng.choice(src.n, size=min(FLAGS.n_noise, src.n), replace=False)
        ])
    else:
        print("no images_root; using synthetic real images")
        real = rng.normal(0.45, 0.2, size=(FLAGS.n_noise, S, S, 3)).astype(np.float32)

    gen = GaussNoiseGenerator(rank=min(32, len(real))).fit(real)
    # the noise takes the real images' preprocessing: ImageNet-normalised
    # for folder images, none for the synthetic [0, 1]-range draws
    noise = np.stack([gen.sample(rng, shape=(S, S, 3)).astype(np.float32) / 255.0
                      for _ in range(FLAGS.n_noise)])
    if from_folder:
        noise = (noise - IMAGENET_MEAN) / IMAGENET_STD

    f_real = model(torch.from_numpy(real.astype(np.float32))).cpu().numpy()
    f_noise = model(torch.from_numpy(noise.astype(np.float32))).cpu().numpy()
    out = {
        "mean_cos_real_vs_noise": float((_unit(f_real) @ _unit(f_noise).T).mean()),
        "mean_cos_real_vs_real": float((_unit(f_real) @ _unit(f_real).T).mean()),
        "feature_dim": int(f_real.shape[-1]),
    }
    print(json.dumps(out))
    with open(os.path.join(FLAGS.log_dir, "noise_probe.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
