"""The operation and byte counts against the hand counts of the cells'
shapes, and the peaks with their source."""

import pytest

from perfbench import counts
from perfbench.run import HERE, load_cell, load_json

G = 1e9


def test_peaks():
    assert counts.PEAKS["flops_per_s"] == {"bfloat16": 989e12, "float32": 67e12}
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in counts.PEAKS["source"]


def test_headline_step():
    _, cfg = load_cell("lstm_distill_dinov2.b1024")
    c = counts.feature_distill(cfg, 1024)
    stack = c["layers"]["lstm_stack"]
    # the stack over (460, 1024) at C = H = 96, L = 2: forward 138.9, backward 243.1
    assert counts.stack_flops(460, 1024, 96, 96, 2) / G == pytest.approx(138.9, abs=0.05)
    assert stack["flops"] / G == pytest.approx(382.0, abs=0.1)
    assert counts.filter_flops(1024 * 96, 512) / G == pytest.approx(51.54, abs=0.01)
    # fc 96 -> 384 and the 40-way head, forward and backward: 0.32 GFLOP
    assert (c["step_flops"] - stack["flops"]) / G == pytest.approx(51.54 + 0.32, abs=0.01)
    # bound by the operations: 0.386 ms, the bytes (x, h0 twice, weights, grads) far less
    assert counts.bound_s(stack["flops"], stack["bytes"], "bfloat16") == pytest.approx(
        stack["flops"] / 989e12)
    assert stack["bytes"] / 3.35e12 < 0.3e-3


def test_dino_step():
    cfg = load_json(HERE, "configs", "dino_lstm.json")
    c = counts.dino(cfg, 8)
    fwd_g = counts.stack_flops(300, 16, 96, 128, 4)
    fwd_l = counts.stack_flops(200, 32, 96, 128, 4)
    assert (fwd_g + fwd_l) / G == pytest.approx(11.38, abs=0.01)  # the student's forward
    assert fwd_g / G == pytest.approx(4.88, abs=0.01)  # the teacher's
    assert c["layers"]["lstm_stack"]["flops"] / G == pytest.approx(11.38 + 21.65 + 4.88, abs=0.02)
    assert (c["step_flops"] - c["layers"]["lstm_stack"]["flops"]) / G == pytest.approx(
        1.625, abs=0.005)
    assert c["step_flops"] / G == pytest.approx(39.5, abs=0.1)


def test_layer_roofline():
    """A layer's bound over its device time a step, in %; None without time
    or without counts for the layer."""
    c = {"layers": {"a": {"flops": 989e9, "bytes": 1.0}}, "dtype": "bfloat16"}
    r = {"counts": c, "trace": {"steps": 4, "layer_s": {"a": 0.016, "b": 0.016, "z": 0.0}}}
    assert counts.layer_roofline(r, "a") == pytest.approx(25.0)  # 1 ms of 4 ms a step
    assert counts.layer_roofline(r, "b") is None and counts.layer_roofline(r, "z") is None
    c["layers"]["z"] = c["layers"]["a"]
    assert counts.layer_roofline(r, "z") is None
    assert counts.layer_roofline({"counts": c}, "a") is None


def test_dense_flops():
    assert counts.dense_flops(2, [3, 5], bwd=False) == 60
    assert counts.dense_flops(2, [3, 5], bwd=True) == 180
    assert counts.dense_flops(2, [3, 5], bwd=True, first_dx=False) == 120
