"""LSTMDistillRetreival — load a distilled LSTM checkpoint, replace the
corpus EEG with LSTM features and run retrieval (port of
cerebra/cli/lstm_distill_retrieval.py).

The reference takes `.dataset` of both random_split halves, so gallery and
query are the same full set, a train/test leak that scores self-retrieval
(SURVEY.md §7.7). The default is the disjoint 80/20 split;
`--compat_reference_leak` reproduces the reference.

    python -m cerebra_torch.cli.lstm_distill_retrieval --synthetic \
        --custom_model_weights W.pth [--compat_reference_leak] [--device cuda|cpu] ...
"""

from __future__ import annotations

import os

import numpy as np

from cerebra_torch.cli.common import (
    load_corpus,
    reference_argparser,
    resolve_device,
    split_train_val,
)
from cerebra_torch.cli.lstm_distill_from_dinov2_eval import features, load_model, score


def main(argv=None):
    parser = reference_argparser("Inline-LSTM retrieval evaluation (PyTorch/CUDA)")
    parser.add_argument("--compat_reference_leak", action="store_true",
                        help="gallery == query == full set (reference bug §7.7)")
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    device = resolve_device(FLAGS)
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    corpus = load_corpus(FLAGS)
    model = load_model(FLAGS, corpus.n_channels, FLAGS.feature_dim, device)
    if FLAGS.compat_reference_leak:
        gallery_idx = query_idx = np.arange(corpus.n)
    else:
        gallery_idx, query_idx = split_train_val(FLAGS, corpus)
    gallery = features(model, corpus.eeg[gallery_idx], device)
    query = features(model, corpus.eeg[query_idx], device)
    recall, precision = score(FLAGS, corpus, gallery_idx, query_idx, gallery, query)
    print(f"Overall Recall :{recall} Overall Precision: {precision}")
    return recall, precision


if __name__ == "__main__":
    main()
