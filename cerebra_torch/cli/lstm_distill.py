"""LSTMDistill — the inline-LSTM cosine-distillation recipe (port of
cerebra/cli/lstm_distill.py; reference LSTMDistill.py): a 4-layer LSTM
student of the corpus's width, cosine loss against cached teacher
features, Adam at lr 1e-4, validation every epoch, the best-loss weights
written as `lstm_best_loss.pth` (the reference `.pth` layout).

    python -m cerebra_torch.cli.lstm_distill --synthetic [--device cuda|cpu] ...
"""

from __future__ import annotations

from cerebra_torch.cli.common import reference_argparser, run_feature_distill


def main(argv=None):
    parser = reference_argparser("Inline-LSTM cosine distillation (PyTorch/CUDA)")
    parser.set_defaults(learning_rate=1e-4)
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    # Adam (LSTMDistill.py:322), the inline 4-layer LSTMModel (:112-147),
    # validation every epoch (:340-378)
    return run_feature_distill(FLAGS, dict(optimizer="adam", loss="cosine",
                                           validation_frequency=1), "lstm_best_loss.pth",
                               "cerebra_torch.cli.lstm_distill", argv)


if __name__ == "__main__":
    main()
