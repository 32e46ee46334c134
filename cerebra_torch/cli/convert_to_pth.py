"""ConvertToPth — BDF → .pth ingest CLI (port of cerebra/cli/convert_to_pth.py:
the reference ConvertToPth.py FLAGS class :18-44 as real flags, plus
`--device`, where the filters run; default cuda)."""

from __future__ import annotations

import argparse
import os

from cerebra_torch.cli.common import resolve_device
from cerebra_torch.data.ingest import (
    IMAGE_BLOCK_SEQUENCE,
    IMAGE_CLASS_MAPPINGS,
    IMAGE_RAPID_SEQUENCE,
    convert_bdf_to_pth,
)
from cerebra_torch.utils.config import bool_flag


def main(argv=None, stage_seconds=None):
    p = argparse.ArgumentParser("BDF → .pth converter (PyTorch build, MNE-free)")
    p.add_argument("--subject", type=int, default=2)
    p.add_argument("--eeg_design", type=str, default="rapid_event",
                   choices=["block", "rapid_event"])
    p.add_argument("--data_path", type=str, default="./data")
    p.add_argument("--bdf_file", type=str, default="",
                   help="explicit .bdf path (default: {data_path}/spampinato-{subject}-2.bdf)")
    p.add_argument("--out_dir", type=str, default="./output")
    p.add_argument("--apply_high_low_pass_filter", type=bool_flag, default=True)
    p.add_argument("--low_pass_cut_freq", type=float, default=14.0)
    p.add_argument("--high_pass_cut_freq", type=float, default=71.0)
    p.add_argument("--apply_notch_filter", type=bool_flag, default=False)
    p.add_argument("--notch_filter_freq", type=float, default=60.0)
    p.add_argument("--number_of_image_samples", type=int, default=2000)
    p.add_argument("--image_class_mappings_file", type=str, default=IMAGE_CLASS_MAPPINGS)
    p.add_argument("--sequence_file", type=str, default="",
                   help="override the stimulus sequence file (default: by --eeg_design)")
    p.add_argument("--reference_channels", type=str, default="96,97",
                   help="0-based re-reference electrode indices (ConvertToPth.py:22)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the filters run on: cuda (default) or cpu")
    FLAGS, _ = p.parse_known_args(argv)
    print(FLAGS)

    device = resolve_device(FLAGS)
    sequence = FLAGS.sequence_file or (
        IMAGE_RAPID_SEQUENCE if FLAGS.eeg_design == "rapid_event" else IMAGE_BLOCK_SEQUENCE
    )
    data_type = "IMAGE_RAPID" if FLAGS.eeg_design == "rapid_event" else "IMAGE_BLOCK"
    bdf_path = FLAGS.bdf_file or os.path.join(FLAGS.data_path, f"spampinato-{FLAGS.subject}-2.bdf")
    name = f"spampinato-{FLAGS.subject}-{data_type}"
    name += (
        f"_{int(FLAGS.low_pass_cut_freq)}Hz_{int(FLAGS.high_pass_cut_freq)}Hz"
        if FLAGS.apply_high_low_pass_filter
        else "_RAW_with_mean_std"
    )
    out_path = os.path.join(FLAGS.out_dir, f"{name}.pth")
    raw = convert_bdf_to_pth(
        bdf_path,
        out_path,
        subject=FLAGS.subject,
        sequence_file=sequence,
        mappings_file=FLAGS.image_class_mappings_file,
        reference_channels=tuple(int(c) for c in FLAGS.reference_channels.split(",")),
        apply_bandpass=FLAGS.apply_high_low_pass_filter,
        band=(FLAGS.low_pass_cut_freq, FLAGS.high_pass_cut_freq),
        apply_notch=FLAGS.apply_notch_filter,
        notch_freq=FLAGS.notch_filter_freq,
        expected_samples=FLAGS.number_of_image_samples,
        device=device,
        stage_seconds=stage_seconds,
    )
    print(f"wrote {out_path}: {raw.n} epochs × {raw.n_channels}ch × {raw.n_samples} samples")
    return raw


if __name__ == "__main__":
    main()
