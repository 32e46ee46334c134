"""TestRetrieval_Perils_SaveChannelWiseOutputs: one EEG trace PNG per channel
(port of cerebra/cli/save_channelwise_outputs.py; reference
TestRetrieval_Perils_SaveChannelWiseOutputs.py:62-70). The traces are drawn
by utils/plotting.py, not matplotlib; names and count are the JAX CLI's."""

from __future__ import annotations

import os

from cerebra_torch.cli.common import load_corpus, reference_argparser, resolve_device
from cerebra_torch.utils.plotting import trace_image, write_png


def main(argv=None):
    parser = reference_argparser("Per-channel EEG trace dumps")
    parser.add_argument("--sample_index", type=int, default=0)
    parser.add_argument("--max_plots", type=int, default=0, help="0 = all channels")
    FLAGS, _ = parser.parse_known_args(argv)
    resolve_device(FLAGS)  # the traces are drawn on the host; the flag is still checked
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    corpus = load_corpus(FLAGS)
    eeg = corpus.eeg[FLAGS.sample_index]  # (T, C)
    n = corpus.n_channels if not FLAGS.max_plots else min(FLAGS.max_plots, corpus.n_channels)
    paths = [write_png(os.path.join(FLAGS.log_dir, f"ch_{ch}_the_perils.png"),
                       trace_image([eeg[:, ch]]))
             for ch in range(n)]
    print(f"wrote {len(paths)} channel plots to {FLAGS.log_dir}")
    return paths


if __name__ == "__main__":
    main()
