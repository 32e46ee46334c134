"""The ViT's attention half-blocks' least time on the chip (`counts.bound_s`
of the operations and bytes of the student's forward and backward over
both view groups and the teacher's forward, `counts/vit.py`) as a share
of the device time of their program spans."""

from perfbench import counts


def read(record):
    return counts.layer_roofline(record, "vit_attn")
