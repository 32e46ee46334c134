"""LstmDistillFromDinoV2Eval — load a trained LSTM (or a DINO-LSTM
checkpoint's teacher), turn the corpus into LSTM features, run retrieval
and write the Scores artifacts (port of
cerebra/cli/lstm_distill_from_dinov2_eval.py; SURVEY.md §3.3).

Both checkpoint layouts load: a flat `Model` state dict
(`lstm_dinov2_best_loss.pth`) and a DINO checkpoint's `teacher` with
`backbone.` stripped (LstmDistillFromDinoV2Eval.py:309-313). The model's
shape comes from the weights (`model_from_state_dict`); a DINO backbone has
no fc, so the features are the raw h[T−1] (K3 on the card). The model runs
in f32, as the JAX CLI's does.

    python -m cerebra_torch.cli.lstm_distill_from_dinov2_eval --synthetic \
        --custom_model_weights W.pth [--device cuda|cpu] ...
"""

from __future__ import annotations

import os
import time

import torch

from cerebra_torch.cli.common import (
    init_distributed,
    load_corpus,
    reference_argparser,
    resolve_device,
    split_train_val,
)
from cerebra_torch.eval.scores import evaluate, save_score_artifacts
from cerebra_torch.models.lstm import Model, model_from_state_dict
from cerebra_torch.utils.config import is_main_process


def load_model(FLAGS, n_channels: int, feature_dim: int, device: torch.device) -> Model:
    """`Model` from `--custom_model_weights` (either layout), or, without
    weights, a random-init Model(C, C, 2, feature_dim) from `--seed` with a
    warning (load_model_params, cerebra/cli/lstm_distill_from_dinov2_eval.py:
    33-74)."""
    path = FLAGS.custom_model_weights
    if path and os.path.exists(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "teacher" in ckpt:
            # DINO checkpoint: the teacher's backbone only, no top
            # (LstmDistillFromDinoV2Eval.py:308-316)
            ckpt = {k: v for k, v in ckpt["teacher"].items() if k.startswith("backbone.")}
        return model_from_state_dict(ckpt, n_channels, device=device)
    print("WARNING: no --custom_model_weights; evaluating a random-init model")
    return Model(n_channels, n_channels, 2, feature_dim, device=device,
                 generator=torch.Generator().manual_seed(FLAGS.seed))


def features(model: Model, eeg, device: torch.device) -> torch.Tensor:
    """The model's features of a whole split in one no-grad forward: fc's
    output, or h[T−1] for a backbone without fc."""
    with torch.no_grad():
        out = model(torch.as_tensor(eeg).to(device))
    return out[0] if isinstance(out, tuple) else out


def score(FLAGS, corpus, gallery_idx, query_idx, gallery, query):
    """Retrieval scores and, on rank 0, the three artifacts in --log_dir."""
    recall, precision, scores = evaluate(
        gallery, query, list(corpus.labels[gallery_idx]), list(corpus.labels[query_idx]),
        corpus.catalog, top_k=FLAGS.topK, metadata={"flags": vars(FLAGS)},
    )
    ds_name = "synthetic" if FLAGS.synthetic else os.path.basename(FLAGS.eeg_dataset).split(".")[0]
    if is_main_process():
        print("artifacts:", save_score_artifacts(FLAGS.log_dir, ds_name, scores, recall,
                                                 precision))
    return recall, precision


def main(argv=None):
    parser = reference_argparser("LSTM→DINOv2 retrieval evaluation (PyTorch/CUDA)")
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    # in a launched world every rank scores the whole corpus; rank 0 writes
    device = init_distributed(resolve_device(FLAGS))
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    corpus = load_corpus(FLAGS)
    model = load_model(FLAGS, corpus.n_channels, FLAGS.feature_dim, device)
    t0 = time.perf_counter()
    train_idx, val_idx = split_train_val(FLAGS, corpus)
    gallery = features(model, corpus.eeg[train_idx], device)
    query = features(model, corpus.eeg[val_idx], device)
    recall, precision = score(FLAGS, corpus, train_idx, val_idx, gallery, query)
    print(f"Overall Recall :{recall} Overall Precision: {precision} "
          f"(in {time.perf_counter() - t0:.2f}s)")
    return recall, precision


if __name__ == "__main__":
    main()
