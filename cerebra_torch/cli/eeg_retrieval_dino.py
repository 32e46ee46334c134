"""EEGRetreivalDino: retrieval with a DINO model under the four gallery/query
transformation modes (port of cerebra/cli/eeg_retrieval_dino.py; reference
EEGRetreivalDino.py:130-277):

  eeg     — raw EEG windows, flattened;
  eeg2eeg — EEG → tiled EEG image → (EEG-finetuned) DINO features, reshaped
            to (128, ·) and windowed [min_time, max_time) like
            transformEEGDataDino keep_features_flat=False
            (utils/PerilsEEGDataset.py:443-447);
  img     — stimulus image → base DINO features (needs images; without a
            readable --images_root it takes EEG-image input, with a warning);
  img2eeg — stimulus image → EEG-finetuned DINO features (likewise).

The models run on `--device` (K5 and K7 in every block on CUDA), the
retrieval too (eval/scores.py). The window starts of the EEG images come
from a generator seeded by `--seed`, gallery first.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cerebra_torch.cli.common import (
    load_corpus,
    reference_argparser,
    resolve_device,
    split_train_val,
)
from cerebra_torch.eval.scores import evaluate, save_score_artifacts
from cerebra_torch.models.dino_model import DinoArgs, DinoModel

_MODES = ["img", "img2eeg", "eeg", "eeg2eeg"]
_IMAGE_BATCH = 64


def _dino_features(model: DinoModel, eeg: np.ndarray, generator: torch.Generator,
                   min_time: int, max_time: int) -> torch.Tensor:
    feats = model.features_from_eeg(torch.from_numpy(np.ascontiguousarray(eeg)),
                                    generator=generator)
    # keep_features_flat=False: only where the reshaped width covers the
    # window (the reference's out_dim 65536 → (128, 512))
    if feats.shape[-1] % 128 == 0 and feats.shape[-1] // 128 > max_time:
        feats = feats.reshape(feats.shape[0], 128, -1)[:, :, min_time:max_time]
    return feats.reshape(feats.shape[0], -1)


def main(argv=None):
    parser = reference_argparser("DINO retrieval over transformation modes")
    parser.add_argument("--gallery_tranformation_type", type=str, default="eeg2eeg",
                        choices=_MODES)
    parser.add_argument("--query_tranformation_type", type=str, default="eeg2eeg",
                        choices=_MODES)
    parser.add_argument("--dino_base_model_weights", type=str, default="")
    parser.add_argument("--arch", type=str, default="vit_tiny")
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--out_dim", type=int, default=65536)
    parser.add_argument("--min_time", type=int, default=20)
    parser.add_argument("--max_time", type=int, default=490)
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    device = resolve_device(FLAGS)
    os.makedirs(FLAGS.log_dir, exist_ok=True)
    with open(os.path.join(FLAGS.log_dir, "commandline_args.txt"), "w") as f:
        f.write(str(vars(FLAGS)))  # EEGRetreivalDino.py:128-129

    corpus = load_corpus(FLAGS)
    # Spampinato protocol (EEGRetreivalDino.py:163-176): separate datasets,
    # the gallery from (search_gallery, gallery_subject), the query from
    # (query_gallery, query_subject). Without a split file, the Perils
    # protocol's seed-43 80/20 split of one corpus.
    query_corpus = None
    if not FLAGS.synthetic and FLAGS.eeg_dataset_split:
        query_corpus = load_corpus(FLAGS, subset=FLAGS.query_gallery, subject=FLAGS.query_subject)
    args = DinoArgs(arch=FLAGS.arch, patch_size=FLAGS.patch_size, image_size=FLAGS.image_size,
                    out_dim=FLAGS.out_dim)

    def build_model(mode):
        weights = FLAGS.dino_base_model_weights if mode == "img" else FLAGS.custom_model_weights
        if weights and os.path.exists(weights):
            return DinoModel.from_torch_checkpoint(weights, args, device=device)
        print(f"WARNING: no weights for mode {mode}; random-init DINO model")
        return DinoModel(args, seed=FLAGS.seed, device=device)

    def image_features(model, sub_corpus, indices):
        """Stimulus image → DINO features (the reference's img/img2eeg modes
        run the model on the trial's JPEG, EEGRetreivalDino.py:130-277)."""
        from PIL import Image  # only this mode reads JPEGs

        from cerebra_torch.data.corpus import image_path

        feats = []
        for b0 in range(0, len(indices), _IMAGE_BATCH):
            batch = [model.dinov1_transform(np.asarray(Image.open(
                image_path(sub_corpus, int(i), FLAGS.images_root)).convert("RGB")))
                for i in indices[b0:b0 + _IMAGE_BATCH]]
            feats.append(model(torch.from_numpy(np.stack(batch))))
        out = torch.cat(feats)
        return out.reshape(len(out), -1)

    generator = torch.Generator().manual_seed(FLAGS.seed)

    def transform(mode, sub_corpus, indices):
        eeg = sub_corpus.eeg[indices]
        if mode == "eeg":
            return torch.from_numpy(eeg.reshape(len(eeg), -1)).to(device)
        model = build_model(mode)
        if mode in ("img", "img2eeg"):
            if FLAGS.images_root and os.path.isdir(FLAGS.images_root):
                return image_features(model, sub_corpus, indices)
            print(f"WARNING: mode {mode} without a readable --images_root; "
                  "falling back to EEG-image input")
        return _dino_features(model, eeg, generator, FLAGS.min_time, FLAGS.max_time)

    if query_corpus is not None:
        g_corpus, gallery_idx, g_labels = corpus, np.arange(corpus.n), corpus.labels
        q_corpus, query_idx, q_labels = query_corpus, np.arange(query_corpus.n), query_corpus.labels
    else:
        gallery_idx, query_idx = split_train_val(FLAGS, corpus)
        g_corpus = q_corpus = corpus
        g_labels = corpus.labels[gallery_idx]
        q_labels = corpus.labels[query_idx]
    gallery = transform(FLAGS.gallery_tranformation_type, g_corpus, gallery_idx)
    query = transform(FLAGS.query_tranformation_type, q_corpus, query_idx)

    recall, precision, scores = evaluate(
        gallery, query, list(g_labels), list(q_labels),
        corpus.catalog, top_k=FLAGS.topK, metadata={"flags": vars(FLAGS)},
    )
    print(f"Overall Recall :{recall} Overall Precision: {precision}")
    ds_name = "synthetic" if FLAGS.synthetic else os.path.basename(FLAGS.eeg_dataset).split(".")[0]
    save_score_artifacts(FLAGS.log_dir, ds_name, scores, recall, precision)
    return recall, precision


if __name__ == "__main__":
    main()
