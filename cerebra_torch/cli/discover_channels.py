"""Greedy channel discovery and the per-channel best-window sweep (port of
cerebra/cli/discover_channels.py; reference TestRetrieval_Perils_
DiscoverChannels.py / TestRetrieval_DiscoverChannels.py).

The split is the seed-123 80/20 random_split of the reference
(TestRetrieval_Perils_DiscoverChannels.py:62-63), over channel-wise
normalised EEG like its apply_channel_wise_norm loader. The corpus goes to
`--device` once; the sweeps run there (eval/channel_discovery.py).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from cerebra_torch.cli.common import load_corpus, reference_argparser, resolve_device
from cerebra_torch.data import random_split_indices
from cerebra_torch.data.channelmap import read_channel_list, read_channel_map
from cerebra_torch.eval.channel_discovery import best_window_sweep, greedy_channel_discovery
from cerebra_torch.signal.norm import channel_wise_norm


def main(argv=None):
    parser = reference_argparser("Greedy channel discovery")
    parser.add_argument("--max_channels", type=int, default=0, help="0 = all")
    parser.add_argument("--channel_map", type=str, default="", help="optional channelmap file")
    parser.add_argument("--best_window_sweep", action="store_true",
                        help="per-channel best-time-window sweep instead of the "
                             "greedy set search (TestRetrieval_DiscoverChannels "
                             "'best ts' mode)")
    parser.add_argument("--window_width", type=int, default=1)
    parser.add_argument("--channel_chunk", type=int, default=0,
                        help="evaluate candidate recalls in channel chunks, computing "
                             "each chunk's distances on the fly, so the per-channel "
                             "distance tensor D (11.8 GB at the Spampinato scale) is "
                             "never held. 0 = D resident")
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    device = resolve_device(FLAGS)
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    corpus = load_corpus(FLAGS)
    eeg = channel_wise_norm(torch.from_numpy(np.ascontiguousarray(corpus.eeg)).to(device))
    train_idx, test_idx = random_split_indices(corpus.n, [0.8, 0.2], seed=123)
    gallery, query = eeg[torch.from_numpy(train_idx).to(device)], eeg[
        torch.from_numpy(test_idx).to(device)]
    del eeg

    if FLAGS.best_window_sweep:
        t0 = time.perf_counter()
        res = best_window_sweep(
            gallery, query, corpus.labels[train_idx], corpus.labels[test_idx],
            width=FLAGS.window_width, top_k=FLAGS.topK, n_classes=corpus.catalog.n_classes,
        )
        dt = time.perf_counter() - t0
        names = _channel_names(FLAGS, corpus.n_channels)
        order = np.argsort(res.best_recall)[::-1]
        print(f"best-window sweep ({corpus.n_channels} ch × width {FLAGS.window_width}) "
              f"in {dt:.2f}s")
        # the reference's logged-number format, one line per channel
        # (TestRetrieval_DiscoverChannels.py:141-154):
        #   MasterFixedChannels = [33] # AF3 #best ts 167_168  with Scores: {...}
        log_lines = []
        for ch in order:
            name = names[ch] if names else f"ch{ch}"
            s, e = int(res.best_start[ch]), int(res.best_start[ch]) + FLAGS.window_width
            log_lines.append(
                f"MasterFixedChannels = [{ch}] # {name} #best ts {s}_{e}  with Scores: "
                f"{{'Recall': {float(res.best_recall[ch])}, "
                f"'Precision': {float(res.best_precision[ch])}}}"
            )
        for line in log_lines[:10]:
            print("  " + line)
        with open(os.path.join(FLAGS.log_dir, "best_window_log.txt"), "w") as f:
            f.write("\n".join(log_lines) + "\n")
        with open(os.path.join(FLAGS.log_dir, "best_window_sweep.json"), "w") as f:
            json.dump({"best_start": res.best_start.tolist(),
                       "best_recall": res.best_recall.tolist(),
                       "best_precision": res.best_precision.tolist(),
                       "channel_names": names,
                       "elapsed_s": dt}, f, indent=2)
        return res

    t0 = time.perf_counter()
    result = greedy_channel_discovery(
        gallery, query, corpus.labels[train_idx], corpus.labels[test_idx],
        top_k=FLAGS.topK, n_classes=corpus.catalog.n_classes,
        max_channels=FLAGS.max_channels or None, channel_chunk=FLAGS.channel_chunk or None,
    )
    dt = time.perf_counter() - t0
    names = _channel_names(FLAGS, corpus.n_channels)
    print(f"greedy sweep over {corpus.n_channels} channels in {dt:.2f}s")
    for ch, rec in zip(result.selected, result.recalls):
        label = names[ch] if names else f"ch{ch}"
        print(f"  +{label} (idx {ch}) → recall {rec:.2f}")
    out = {
        "selected_channels": result.selected,
        "recalls": result.recalls,
        "channel_names": [names[c] for c in result.selected] if names else None,
        "elapsed_s": dt,
    }
    with open(os.path.join(FLAGS.log_dir, "channel_discovery.json"), "w") as f:
        json.dump(out, f, indent=2)
    return result


def _channel_names(FLAGS, n_channels):
    if not FLAGS.channel_map:
        return None
    if FLAGS.channel_map.endswith("perils_channel_map.txt"):
        return read_channel_list(FLAGS.channel_map)
    cm = read_channel_map(FLAGS.channel_map)
    return [cm.get(i + 1, str(i + 1)) for i in range(n_channels)]  # the map is 1-based


if __name__ == "__main__":
    main()
