"""LstmDistillFromDinoV2TrainSpampinato — the Spampinato-loader KD variant
(port of cerebra/cli/lstm_distill_from_dinov2_train_spampinato.py): 128-ch
EEG, Model(128, 128, 4), Hinton KD over the regressed features with α and
T from `--hyperprams` (defaults 0.5 and 2.0), AdamW at lr 1e-4, 200 epochs,
the best-loss weights written as `lstm_dinov2_best_loss.pth`.

    python -m cerebra_torch.cli.lstm_distill_from_dinov2_train_spampinato --synthetic \
        --synthetic_channels 128 --synthetic_samples 500 [--device cuda|cpu] ...
"""

from __future__ import annotations

from cerebra_torch.cli.common import parsed_hyperparams, reference_argparser, run_feature_distill


def main(argv=None):
    parser = reference_argparser("Spampinato LSTM→DINOv2 KD distillation (PyTorch/CUDA)")
    parser.set_defaults(learning_rate=1e-4, num_epochs=200)
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    hp = parsed_hyperparams(FLAGS)
    return run_feature_distill(
        FLAGS, dict(optimizer="adamw", loss="hinton_kd", alpha=float(hp.get("alpha", 0.5)),
                    kd_temperature=float(hp.get("temperature", 2.0))),
        "lstm_dinov2_best_loss.pth", "cerebra_torch.cli.lstm_distill_from_dinov2_train_spampinato",
        argv)


if __name__ == "__main__":
    main()
