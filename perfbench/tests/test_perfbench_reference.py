"""Each plain reference against the port's CPU path (the kernels' plain
versions) at a tiny size, in float32; the LSTM also against torch.nn.LSTM."""

import numpy as np
import pytest
import torch

from perfbench import compare, feed
from perfbench.drivers.dino import head_specs
from perfbench.reference import dino, filter as plain_filter, losses, nets, optim
from perfbench.run import measure
from perfbench.tests.conftest import small


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_lstm_against_torch_and_the_port():
    from cerebra_torch.models.lstm import Model

    C, H, L = 6, 8, 3
    p = feed.draw_params(feed.lstm_specs("lstm.", C, H, L), gen(), "cpu")
    x = torch.randn(5, 11, C, generator=gen(1))
    lstm = torch.nn.LSTM(C, H, L, batch_first=True)
    lstm.load_state_dict({k[5:]: v for k, v in p.items()})
    want = lstm(x)[0][:, -1]
    got = nets.lstm_last(x, p, "lstm.", L)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    port = Model(C, H, L, None)
    feed.load_params(port, p)
    torch.testing.assert_close(got, port(x), atol=1e-6, rtol=1e-5)


def test_filter_matrix_against_the_port():
    from cerebra_torch.signal.filters import design_bandpass, zero_phase_matrix

    _, cfg = small("lstm_distill_dinov2.b1024")
    want = zero_phase_matrix(design_bandpass(*cfg["band"], fs=cfg["fs"], order=cfg["filter_order"]),
                             cfg["raw_samples"], num_taps=cfg["num_taps"], dtype=torch.float32)
    torch.testing.assert_close(plain_filter.fir_matrix(cfg, "cpu"), want)


def test_feature_distribution_loss_against_the_port():
    from cerebra_torch.losses import feature_distribution_loss_v1

    f, t, logits = (torch.randn(6, n, generator=gen(i)) for i, n in enumerate((16, 16, 5)))
    labels = torch.randint(0, 5, (6,), generator=gen(3))
    torch.testing.assert_close(losses.feature_distribution_v1(f, t, labels, logits, 1.5, 0.5, 0.5),
                               feature_distribution_loss_v1(f, t, labels, logits, 1.5, 0.5, 0.5))


def test_dino_loss_and_head_against_the_port():
    from cerebra_torch.losses import dino_multicrop_loss
    from cerebra_torch.models.heads import DINOHead

    s, t = torch.randn(6, 3, 32, generator=gen(1)), torch.randn(2, 3, 32, generator=gen(2))
    c = torch.randn(1, 32, generator=gen(3))
    got, want = dino.dino_multicrop(s, t, c, 0.04, 0.1, 0.9), dino_multicrop_loss(s, t, c, 0.04)
    torch.testing.assert_close(got, want)
    _, cfg = small("dino_lstm.b8")
    p = feed.draw_params(head_specs("", cfg), gen(), "cpu")
    head = DINOHead(cfg["embed_dim"], cfg["out_dim"])
    feed.load_params(head, p)
    x = torch.randn(7, cfg["embed_dim"], generator=gen(4))
    torch.testing.assert_close(nets.dino_head(x, p, "", cfg["head_nlayers"]), head(x))


def test_optimizers_and_schedules_against_torch_and_the_port():
    from cerebra_torch.train.schedules import cosine_scheduler

    w = torch.randn(4, 3, generator=gen(1))
    for make, step in ((lambda q: torch.optim.RMSprop([q], lr=1e-2, alpha=0.99, eps=1e-8),
                        lambda p, g, st, t: optim.rmsprop(p, g, st, 1e-2, 0.99, 1e-8)),
                       (lambda q: torch.optim.AdamW([q], lr=1e-2, weight_decay=0.3),
                        lambda p, g, st, t: optim.adamw(p, g, st, t, 1e-2, 0.3, {"w"}))):
        q = torch.nn.Parameter(w.clone())
        opt, p, st = make(q), {"w": w.clone()}, {}
        for t in range(1, 4):
            g = torch.randn(4, 3, generator=gen(t))
            q.grad = g.clone()
            opt.step()
            step(p, {"w": g}, st, t)
        torch.testing.assert_close(p["w"], q.detach())
    np.testing.assert_allclose(optim.cosine(0.1, 1e-3, 5, 7, 2),
                               cosine_scheduler(0.1, 1e-3, 5, 7, warmup_epochs=2), rtol=1e-6)


def test_crops_against_the_port():
    from cerebra_torch.signal.windows import multicrop_views
    from cerebra_torch.train.recipes import step_generator

    _, cfg = small("dino_lstm.b8")
    eeg = torch.arange(40.0)[None, :, None].expand(2, 40, 3)
    for step in (0, 7, 2 ** 33):
        g, l = multicrop_views(eeg, 24, 16, 2, 4, step_generator(2 ** 31 + 9, step))
        gs, ls = dino.crop_starts(2 ** 31 + 9, step, 40, cfg)
        assert [int(v[0, 0, 0]) for v in g] == gs and [int(v[0, 0, 0]) for v in l] == ls


@pytest.mark.parametrize("name", ["lstm_distill_dinov2.b1024", "dino_lstm.b8"])
def test_first_steps_against_the_port(name):
    """The program's first steps on the CPU in f32 and the reference's read
    the same to f32 rounding: every gap under 1e-4."""
    cell, cfg = small(name)
    record = measure(name, 2 ** 31 + 11, 0.05, False, torch.device("cpu"), cell, cfg)
    assert all(c["value"] < 1e-4 for c in record["checks"].values()), record["checks"]
    assert compare.passed(record["checks"]) and record["failed"] == 0
