"""GetTsneForRawEEG — per-subject raw-EEG 3-component t-SNE 3-D scatter PNGs
(reference GetTsneForRawEEG.py:39-113; port of
cerebra/cli/get_tsne_for_raw_eeg.py).

The embedding is the port's exact t-SNE on `--device` (`eval/tsne.py`,
scikit-learn's TSNE with the JAX CLI's parameters, the exact gradient in
place of Barnes–Hut); the figure is a PNG from `utils/plotting.py`: the
points at azim 50 / elev 40 in tab20c's colours, without axes, title or
legend, under the JAX CLI's file names."""

from __future__ import annotations

import os

import numpy as np
import torch

from cerebra_torch.cli.common import load_corpus, reference_argparser, resolve_device
from cerebra_torch.eval.tsne import tsne
from cerebra_torch.utils.plotting import scatter3d_image, tab20c_colours, write_png


def main(argv=None):
    parser = reference_argparser("Raw-EEG t-SNE visualization")
    parser.add_argument("--subjects", type=str, default="1,2,3,4,5,6")
    parser.add_argument("--perplexity", type=float, default=40.0)
    FLAGS, _ = parser.parse_known_args(argv)
    device = resolve_device(FLAGS)
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    corpus = load_corpus(FLAGS)
    colours = tab20c_colours(corpus.catalog.n_classes)
    outputs = []
    for subject in (int(s) for s in FLAGS.subjects.split(",")):
        mask = (corpus.subjects == subject) if not FLAGS.synthetic else np.ones(corpus.n, bool)
        if not mask.any():
            continue
        feats = corpus.eeg[mask].reshape(mask.sum(), -1)
        labels = corpus.labels[mask]
        if len(feats) < 3:  # the perplexity must stay below the sample count
            print(f"subject {subject}: only {len(feats)} trials, skipping t-SNE")
            continue
        perplexity = min(FLAGS.perplexity, len(feats) - 1)
        xt, kl, n_iter = tsne(torch.as_tensor(feats, device=device), n_components=3,
                              perplexity=perplexity, learning_rate=0.1, max_iter=1000)
        print(f"subject {subject}: {len(feats)} trials, KL divergence {kl:.6f} after "
              f"{n_iter} iterations")
        img = scatter3d_image(xt.cpu().numpy(), colours[np.minimum(labels, len(colours) - 1)])
        out = os.path.join(FLAGS.log_dir, f"SUB_{subject}_RAW_EEG_features_distribution.png")
        outputs.append(write_png(out, img))
        if FLAGS.synthetic:
            break
    print("wrote:", outputs)
    return outputs


if __name__ == "__main__":
    main()
