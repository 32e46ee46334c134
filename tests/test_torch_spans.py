"""The port's spans (`cerebra_torch/utils/spans.py`): a shared no-op with
nothing on; under `recording()` one CPU `feature_distill_step` records the
step's phases and the LSTM stack's ranges, each inside its parent; the
layer-by-layer backward records a scan and products a layer inside
`lstm.bwd`; one small DINO ViT step records its phases and each ViT
half-block's forward and backward; under `torch.profiler` the same names
are `user_annotation` events of the Chrome export."""

import json

import pytest
import torch

from cerebra_torch.models.lstm import Model
from cerebra_torch.models.lstm_stack import (
    _bwd_layerwise_ref,
    _fwd_infer_last_ref,
    _fwd_train_ref,
    _stack,
)
from cerebra_torch.train.optim import make_optimizer
from cerebra_torch.train.steps import feature_distill_step
from cerebra_torch.utils import spans

P = "cerebra_torch."


def small_step():
    """A Model(6, 8, 2) with fc and head, RMSprop, and one step's arguments."""
    gen = torch.Generator().manual_seed(0)
    model = Model(6, 8, 2, 12, n_classes=3, generator=gen)
    opt = make_optimizer("rmsprop", model.parameters(), 1e-3)
    eeg = torch.randn(4, 10, 6, generator=gen)
    feats, labels = torch.randn(4, 12, generator=gen), torch.tensor([0, 1, 2, 0])

    def loss_fn(f, logits, t, y, epoch):
        return ((f - t) ** 2).mean() + torch.nn.functional.cross_entropy(logits, y)

    return lambda: feature_distill_step(model, opt, loss_fn, eeg, feats, labels, 0)


def test_off_is_one_shared_no_op():
    assert spans.span("a") is spans.span("b") is spans.OFF
    with spans.span("a") as s:
        assert s is spans.OFF
    step = small_step()
    step()
    with spans.recording() as rec:
        pass
    assert rec == [] and spans._records is None


def test_recorded_step_has_the_tree():
    step = small_step()
    with spans.recording() as rec:
        step()
    assert spans.span("after") is spans.OFF
    names = [r[0][len(P):] for r in rec]
    assert names.count("step") == 1 and names.count("step.optimizer") == 2
    for name in ("step.forward", "step.loss", "step.backward", "lstm.prepare", "lstm.fwd",
                 "lstm.bwd"):
        assert names.count(name) == 1, name
    by_name = {r[0]: r for r in rec}
    parent = {"step.forward": "step", "step.loss": "step", "step.backward": "step",
              "step.optimizer": "step", "lstm.prepare": "step.forward",
              "lstm.fwd": "step.forward", "lstm.bwd": "step.backward"}
    for name, up, tid, t0, t1 in rec:
        assert t0 <= t1 and tid
        short = name[len(P):]
        if short == "step":
            assert up is None
            continue
        assert up == P + parent[short], name
        assert by_name[up][3] <= t0 and t1 <= by_name[up][4], name
    order = [n for n in names if n in ("step.optimizer", "step.forward", "step.loss",
                                       "step.backward")]
    assert order == ["step.optimizer", "step.forward", "step.loss", "step.backward",
                     "step.optimizer"]


def test_layerwise_backward_spans_each_layer():
    gen = torch.Generator().manual_seed(1)
    T, B, C, H, L = 7, 3, 5, 4, 2
    x = torch.randn(T, B, C, generator=gen)
    layers = [tuple((torch.randn(*s, generator=gen) * 0.3).requires_grad_(True)
                    for s in ((C if l == 0 else H, 4 * H), (H, 4 * H), (4 * H,)))
              for l in range(L)]
    with spans.recording() as rec:
        out = _stack((_fwd_train_ref, _bwd_layerwise_ref), _fwd_infer_last_ref, True, x, layers)
        out.sum().backward()
    bwd = [r for r in rec if r[0] == P + "lstm.bwd"]
    assert len(bwd) == 1
    for piece in ("lstm.bwd.scan", "lstm.bwd.products"):
        got = [r for r in rec if r[0] == P + piece]
        assert len(got) == L, piece
        for _, parent, _, t0, t1 in got:
            assert parent == P + "lstm.bwd" and bwd[0][3] <= t0 <= t1 <= bwd[0][4]
    assert all(w.grad is not None for layer in layers for w in layer)


def test_profiler_sees_the_same_names(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    step = small_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    assert spans.span("after") is spans.OFF
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(P):
            got[e["name"]] = got.get(e["name"], 0) + 1
    assert got == {P + "step": 1, P + "step.optimizer": 2, P + "step.forward": 1,
                   P + "step.loss": 1, P + "step.backward": 1, P + "lstm.prepare": 1,
                   P + "lstm.fwd": 1, P + "lstm.bwd": 1}


@pytest.mark.parametrize("fused", [True, False])
def test_dino_vit_step_spans(monkeypatch, fused):
    """One DINO ViT step of the recipe (D 32, depth 2): each half-block's
    forward once a block for each student group and for the teacher's
    globals, each fused half's backward once a block for each student group
    (the unfused halves' backward is autograd's own, with no span); the
    step's phases once each, `.optimizer` twice (zero_grad, then the
    cancel, clip and update), each inside the step; the half-blocks inside
    `.teacher`, `.forward` and `.backward`."""
    from tests._dino_vit_small import small_run

    run = small_run(monkeypatch, fused)
    depth = run.cfg["depth"]
    with spans.recording() as rec:
        run.step()
    names = [r[0][len(P):] for r in rec]
    want = {"step": 1, "step.views": 1, "step.teacher": 1, "step.forward": 1, "step.loss": 1,
            "step.backward": 1, "step.optimizer": 2, "step.ema": 1,
            "vit.attn": 3 * depth, "vit.mlp": 3 * depth}
    if fused:
        want.update({"vit.attn.bwd": 2 * depth, "vit.mlp.bwd": 2 * depth})
    assert {n: names.count(n) for n in set(names)} == want
    parents = {}
    for name, up, *_ in rec:
        parents.setdefault(name[len(P):], set()).add(up and up[len(P):])
    assert parents["step"] == {None}
    assert all(parents[n] == {"step"} for n in want if n.startswith("step."))
    assert parents["vit.attn"] == parents["vit.mlp"] == {"step.teacher", "step.forward"}
    if fused:  # autograd runs the backward on the calling thread on the CPU
        assert parents["vit.attn.bwd"] == parents["vit.mlp.bwd"] == {"step.backward"}
