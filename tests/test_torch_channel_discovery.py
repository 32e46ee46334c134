"""Retrieval analysis of the port against the JAX package on the CPU: the
per-channel distances, the reference's recall and precision (with the top-k
tie rule on duplicated gallery trials), the greedy sweep with D resident and
chunked (a chunk that does not divide C), the best-window sweep, the
normalisations, the channel maps, the metrics, and the discover_channels
and save_channelwise_outputs CLIs (brain_map: test_torch_dino_analysis.py).

Tolerances: distances 1e-4 relative (f32 products summed in another order);
recalls and precisions 1e-4 (the same top-k sets; the per-class rounding and
the class sum in the JAX package's f32 order) and the greedy's selections
and best windows exactly; normalisations 1e-6; PCA 1e-8 (f64); mAP, AP,
accuracy and the channel maps exactly; multi_scale 1e-4."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.cli import discover_channels as jax_dc_cli
from cerebra.cli import save_channelwise_outputs as jax_cw_cli
from cerebra.data import channelmap as jcm
from cerebra.eval import channel_discovery as jcd
from cerebra.eval import metrics as jmetrics
from cerebra.signal import norm as jnorm
from cerebra_torch.cli import discover_channels, save_channelwise_outputs
from cerebra_torch.data import channelmap as tcm
from cerebra_torch.eval import channel_discovery as tcd
from cerebra_torch.eval import metrics as tmetrics
from cerebra_torch.signal import norm as tnorm

torch.set_num_threads(1)


def _split(seed=0, n_classes=5, per_class=6, T=10, C=12, dup=False):
    """A small labelled gallery/query pair (Ng, T, C), (Nq, T, C); with
    `dup` every gallery trial appears twice (equal distances)."""
    rng = np.random.default_rng(seed)
    g_lab = np.repeat(np.arange(n_classes), per_class)
    q_lab = np.repeat(np.arange(n_classes), 2)
    sig = rng.normal(size=(n_classes, T, C))
    g = sig[g_lab] * 0.6 + rng.normal(size=(len(g_lab), T, C))
    q = sig[q_lab] * 0.6 + rng.normal(size=(len(q_lab), T, C))
    if dup:
        g, g_lab = np.concatenate([g, g]), np.concatenate([g_lab, g_lab])
    return g.astype(np.float32), q.astype(np.float32), g_lab, q_lab


def test_per_channel_distances_match_jax():
    g, q, _, _ = _split()
    want = np.asarray(jcd.per_channel_distances(jnp.asarray(g), jnp.asarray(q)))
    got = tcd.per_channel_distances(g, q).numpy()
    assert got.shape == want.shape == (12, 10, 30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_lower_index_is_lax_top_k_set(k):
    """On integer distances (most rows tie at the k-th value) the set is
    jax.lax.top_k(-d, k)'s: equal values go to the lower index."""
    d = np.random.default_rng(k).integers(0, 6, size=(4, 9, 40)).astype(np.float32)
    want = np.sort(np.asarray(jax.lax.top_k(-jnp.asarray(d), k)[1]), -1)
    got = np.sort(tcd.topk_lower_index(torch.from_numpy(d), k).numpy(), -1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["random", "integer", "duplicated_gallery"])
def test_recall_precision_match_jax(case):
    rng = np.random.default_rng(1)
    if case == "duplicated_gallery":
        g, q, g_lab, q_lab = _split(dup=True)
        d = np.array(jcd.per_channel_distances(jnp.asarray(g), jnp.asarray(q)))
    else:
        g_lab, q_lab = rng.integers(0, 6, 50), rng.integers(0, 6, 20)
        d = rng.normal(size=(7, 20, 50)).astype(np.float32)
        if case == "integer":
            d = np.round(d * 2).astype(np.float32)
    for k in (1, 5):
        jr, jp = jcd.recall_precision_for_distances(jnp.asarray(d), jnp.asarray(g_lab),
                                                    jnp.asarray(q_lab), k, 6)
        tr, tp = tcd.recall_precision_for_distances(torch.from_numpy(d), g_lab, q_lab, k, 6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)


@pytest.mark.parametrize("chunk", [None, 5, 12])
def test_greedy_channel_discovery_matches_jax(chunk):
    g, q, g_lab, q_lab = _split(seed=2, T=6, C=12)
    kw = dict(top_k=1, n_classes=5, max_channels=6, channel_chunk=chunk)
    want = jcd.greedy_channel_discovery(g, q, g_lab, q_lab, **kw)
    got = tcd.greedy_channel_discovery(torch.from_numpy(g), torch.from_numpy(q), g_lab, q_lab,
                                       **kw)
    assert len(want.selected) >= 2
    assert got.selected == want.selected
    np.testing.assert_allclose(got.recalls, want.recalls, atol=1e-4)
    assert len(got.per_iteration) == len(want.per_iteration) == len(got.iteration_s)
    for a, b in zip(got.per_iteration, want.per_iteration):
        np.testing.assert_allclose(a, b, atol=1e-4)  # taken channels -inf on both


def test_greedy_resident_and_chunked_agree_bit_for_bit():
    g, q, g_lab, q_lab = _split(seed=4, T=5, C=9, dup=True)
    runs = [tcd.greedy_channel_discovery(g, q, g_lab, q_lab, top_k=3, channel_chunk=c,
                                         stop_on_no_improvement=False)
            for c in (None, 2, 4)]
    for r in runs[1:]:
        assert r.selected == runs[0].selected and r.recalls == runs[0].recalls
        for a, b in zip(r.per_iteration, runs[0].per_iteration):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("width,stride", [(1, 1), (3, 1), (3, 2)])
def test_best_window_sweep_matches_jax(width, stride):
    g, q, g_lab, q_lab = _split(seed=3, T=9, C=4)
    kw = dict(width=width, top_k=3, n_classes=5, stride=stride)
    want = jcd.best_window_sweep(g, q, g_lab, q_lab, **kw)
    got = tcd.best_window_sweep(torch.from_numpy(g), torch.from_numpy(q), g_lab, q_lab, **kw)
    for name in ("recalls", "precisions", "best_recall", "best_precision"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-4)
    np.testing.assert_array_equal(got.best_start, want.best_start)


def test_best_window_sweep_checks_its_arguments():
    g, q, g_lab, q_lab = _split(T=4, C=2)
    with pytest.raises(ValueError, match="window width"):
        tcd.best_window_sweep(g, q, g_lab, q_lab, width=5)
    with pytest.raises(ValueError, match="stride"):
        tcd.best_window_sweep(g, q, g_lab, q_lab, stride=0)


def test_normalisations_match_jax():
    rng = np.random.default_rng(5)
    eeg = rng.normal(1.0, 2.0, size=(3, 20, 7)).astype(np.float32)
    t = torch.from_numpy(eeg)
    for jf, tf in ((jnorm.channel_wise_norm, tnorm.channel_wise_norm),
                   (jnorm.z2_score_norm, tnorm.z2_score_norm)):
        np.testing.assert_allclose(tf(t).numpy(), np.asarray(jf(jnp.asarray(eeg))), atol=1e-6)
    np.testing.assert_allclose(tnorm.global_scalar_norm(t, 0.5, 2.0).numpy(),
                               np.asarray(jnorm.global_scalar_norm(jnp.asarray(eeg), 0.5, 2.0)),
                               atol=1e-6)
    np.testing.assert_allclose(tnorm.channel_wise_norm(t, eps=0.1).numpy(),
                               np.asarray(jnorm.channel_wise_norm(jnp.asarray(eeg), eps=0.1)),
                               atol=1e-6)
    # the random views, with JAX's draws fed in as data
    key = jax.random.key(3)
    draws = np.array(jax.random.randint(key, (4,), 0, 7))
    np.testing.assert_allclose(
        tnorm.random_channel_norm_view(t[0], 4, draws=torch.from_numpy(draws)).numpy(),
        np.asarray(jnorm.random_channel_norm_view(key, jnp.asarray(eeg[0]), 4)), atol=1e-6)
    keys = jax.random.split(key, 3)
    draws = np.stack([np.asarray(jax.random.randint(k, (32,), 0, 7)) for k in keys])
    np.testing.assert_allclose(
        tnorm.three_view_augment(t, draws=torch.from_numpy(draws)).numpy(),
        np.asarray(jnorm.three_view_augment(key, jnp.asarray(eeg))), atol=1e-6)
    gen_views = tnorm.three_view_augment(t, generator=torch.Generator().manual_seed(0))
    assert gen_views.shape == (3, 3, 20, 7) and torch.isfinite(gen_views).all()


def test_channel_maps_match_jax():
    assert tcm.read_channel_map() == jcm.read_channel_map()
    assert tcm.read_channel_list() == jcm.read_channel_list()
    assert len(tcm.read_channel_map()) == 128
    assert tcm.BAD_CHANNELS == jcm.BAD_CHANNELS
    names = tcm.read_channel_list()
    assert tcm.good_channel_indices(names) == jcm.good_channel_indices(names)
    cm = tcm.read_channel_map()
    names128 = [cm[i + 1] for i in range(128)]
    assert tcm.good_channel_indices(names128) == jcm.good_channel_indices(names128)
    assert not tcm.CHANNELMAP_128.startswith(os.path.dirname(jcm.CHANNELMAP_128) + os.sep)


def test_pca_and_map_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(40, 6)) @ rng.normal(size=(6, 6))
    for dim, whit in ((3, 0.5), (6, 1.0)):
        want = jmetrics.PCA(dim=dim, whit=whit).fit(x).apply(x)
        np.testing.assert_allclose(tmetrics.PCA(dim=dim, whit=whit).fit(x).apply(x), want,
                                   rtol=1e-8, atol=1e-8)
    ranks = np.stack([rng.permutation(30) for _ in range(4)], 1)
    gnd = [{"ok": [1, 5, 9], "junk": [2]}, {"ok": [0]}, {"ok": []}, {"ok": [3, 4], "junk": [7, 8]}]
    got, want = tmetrics.compute_map(ranks, gnd, [1, 5, 10]), jmetrics.compute_map(ranks, gnd,
                                                                                     [1, 5, 10])
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert tmetrics.compute_ap(np.array([0, 3, 7]), 4) == jmetrics.compute_ap(np.array([0, 3, 7]), 4)


def test_accuracy_and_multi_scale_match_jax():
    rng = np.random.default_rng(7)
    logits = np.round(rng.normal(size=(12, 6)), 0).astype(np.float32)  # ties among classes
    target = rng.integers(0, 6, 12)
    assert tmetrics.accuracy(torch.from_numpy(logits), torch.from_numpy(target), (1, 3)) == \
        jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(target), (1, 3))
    imgs = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    w = rng.normal(size=(3, 5)).astype(np.float32)

    def j_model(x):  # pooled colour features through a fixed projection
        return jnp.mean(x, axis=(1, 2)) @ w + jnp.mean(x ** 2)

    def t_model(x):
        return x.mean(dim=(1, 2)) @ torch.from_numpy(w) + (x ** 2).mean()

    np.testing.assert_allclose(tmetrics.multi_scale(torch.from_numpy(imgs), t_model).numpy(),
                               np.asarray(jmetrics.multi_scale(jnp.asarray(imgs), j_model)),
                               atol=1e-4)


# Harder than the CLI defaults so the greedy takes several channels: a
# 10-sample window and the top-1 neighbour.
DC_FLAGS = ["--synthetic", "--synthetic_classes", "5", "--synthetic_per_class", "10",
            "--synthetic_channels", "12", "--synthetic_samples", "60", "--time_low", "0",
            "--time_high", "10", "--topK", "1", "--seed", "3"]


@pytest.mark.parametrize("extra", [["--max_channels", "4"],
                                   ["--max_channels", "4", "--channel_chunk", "5"],
                                   ["--best_window_sweep", "--window_width", "3"]],
                         ids=["resident", "chunked", "sweep"])
def test_discover_channels_cli_matches_jax(tmp_path, extra):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    cmap = ["--channel_map", tcm.CHANNELMAP_128]
    jax_dc_cli.main(DC_FLAGS + extra + cmap + ["--log_dir", jd])
    discover_channels.main(DC_FLAGS + extra + cmap + ["--log_dir", td, "--device", "cpu"])
    if "--best_window_sweep" in extra:
        with open(os.path.join(jd, "best_window_sweep.json")) as f:
            want = json.load(f)
        with open(os.path.join(td, "best_window_sweep.json")) as f:
            got = json.load(f)
        assert got["best_start"] == want["best_start"]
        assert got["channel_names"] == want["channel_names"]
        np.testing.assert_allclose(got["best_recall"], want["best_recall"], atol=1e-4)
        np.testing.assert_allclose(got["best_precision"], want["best_precision"], atol=1e-4)
        with open(os.path.join(td, "best_window_log.txt")) as f:
            assert len(f.read().splitlines()) == 12
        return
    with open(os.path.join(jd, "channel_discovery.json")) as f:
        want = json.load(f)
    with open(os.path.join(td, "channel_discovery.json")) as f:
        got = json.load(f)
    assert len(want["selected_channels"]) >= 2
    assert got["selected_channels"] == want["selected_channels"]
    assert got["channel_names"] == want["channel_names"]
    np.testing.assert_allclose(got["recalls"], want["recalls"], atol=1e-4)


def test_save_channelwise_outputs_writes_the_jax_clis_files(tmp_path):
    from PIL import Image

    flags = ["--synthetic", "--synthetic_classes", "2", "--synthetic_per_class", "2",
             "--synthetic_channels", "6", "--max_plots", "4"]
    want = jax_cw_cli.main(flags + ["--log_dir", str(tmp_path / "jax")])
    got = save_channelwise_outputs.main(flags + ["--log_dir", str(tmp_path / "torch"),
                                                 "--device", "cpu"])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    img = np.asarray(Image.open(got[0]))
    assert img.ndim == 3 and img.shape[2] == 3 and (img != 255).any()


@pytest.mark.parametrize("cli", ["discover_channels", "save_channelwise_outputs", "brain_map",
                                 "eeg_retrieval_dino", "visualize_attention"])
def test_new_clis_raise_without_a_card(tmp_path, cli):
    """--device cuda (the default) on a machine without CUDA raises: no
    fall-back to the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = importlib.import_module(f"cerebra_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--synthetic", "--synthetic_classes", "2", "--synthetic_per_class", "2",
              "--synthetic_channels", "4", "--log_dir", str(tmp_path)])


def _tie_split(seed=11, n_classes=40, per_gallery=6, T=4, n_base=6, segments=False):
    """A 40-class gallery/query pair with 55-64 queries a class, in which
    every base channel (or, with `segments`, every even time segment of T
    samples) has a twin whose trials are those of another class: class c's
    k-th trial takes the data of the k-th trial of class π(c), π permuting
    classes of equal query count. A candidate and its twin then have
    per-class recalls that are permutations of each other, equal in exact
    arithmetic and ordered by the bits of the f32 class sum alone."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(55, 65, n_classes)
    q_lab = np.repeat(np.arange(n_classes), counts)
    g_lab = np.repeat(np.arange(n_classes), per_gallery)
    perm = np.arange(n_classes)
    for n in np.unique(counts):
        same = np.nonzero(counts == n)[0]
        perm[same] = rng.permutation(same)

    def remap(labels):  # trial i of class c → the same-rank trial of class perm[c]
        first = np.concatenate([[0], np.cumsum(np.bincount(labels, minlength=n_classes))])
        rank = np.arange(len(labels)) - first[labels]
        return first[perm[labels]] + rank

    sq, sg = remap(q_lab), remap(g_lab)
    sig = rng.normal(size=(n_classes, T, n_base)) * np.linspace(0.5, 0.15, n_base)
    g = sig[g_lab] + rng.normal(size=(len(g_lab), T, n_base))
    q = sig[q_lab] + rng.normal(size=(len(q_lab), T, n_base))
    if segments:  # (N, 2T, C): each channel's T samples, then their twin
        g, q = np.concatenate([g, g[sg]], 1), np.concatenate([q, q[sq]], 1)
    else:  # (N, T, 2C): channel b, then its twin
        g, q = np.concatenate([g, g[sg]], 2), np.concatenate([q, q[sq]], 2)
    return g.astype(np.float32), q.astype(np.float32), g_lab, q_lab


def test_recall_at_40_classes_bit_equal_to_jax():
    """At 40 classes XLA:CPU sums the classes as (x0 + … + x19) + (x20 + …
    + x39); the port's recall and precision carry those bits, on the
    greedy's compiled `_chunk_recall` and on the jitted function alone."""
    rng = np.random.default_rng(12)
    q_lab = np.repeat(np.arange(40), rng.integers(55, 65, 40))
    g_lab = rng.integers(0, 40, 200)
    d = rng.random((8, len(q_lab), 200)).astype(np.float32)
    want = jcd._chunk_recall(jnp.asarray(d), jnp.zeros(d.shape[1:]), jnp.asarray(g_lab),
                             jnp.asarray(q_lab), 5, 40)
    jr, jp = jcd.recall_precision_for_distances(jnp.asarray(d), jnp.asarray(g_lab),
                                                jnp.asarray(q_lab), 5, 40)
    tr, tp = tcd.recall_precision_for_distances(torch.from_numpy(d), g_lab, q_lab, 5, 40)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("n", [2, 5, 22, 33, 40, 64, 97])
def test_xla_cpu_sum_order_matches_jnp_sum(n):
    """The class sum alone against a jitted `jnp.sum` of the masked per-class
    values, bit for bit (up to 22 elements and above 32; between them LLVM
    vectorises the loop by the element count and the host)."""
    rng = np.random.default_rng(n)
    x = (np.round(rng.random((16, n)) * 1e4) * 0.01).astype(np.float32)
    present = rng.random(n) > 0.1
    want = jax.jit(lambda v, p: jnp.sum(jnp.where(p, v, 0.0), axis=-1) / jnp.sum(p))(
        jnp.asarray(x), jnp.asarray(present))
    got = tcd._class_mean(torch.from_numpy(x), torch.from_numpy(present))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("chunk", [None, 5])
def test_greedy_at_40_classes_picks_jax_channels_among_tie_pairs(chunk, monkeypatch):
    g, q, g_lab, q_lab = _tie_split()
    kw = dict(top_k=5, n_classes=40, max_channels=4, channel_chunk=chunk)
    want = jcd.greedy_channel_discovery(g, q, g_lab, q_lab, **kw)
    got = tcd.greedy_channel_discovery(torch.from_numpy(g), torch.from_numpy(q), g_lab, q_lab,
                                       **kw)
    first = want.per_iteration[0]
    assert (first[:6] != first[6:]).any()  # the tie pairs differ in their last bits
    assert got.selected == want.selected and got.recalls == want.recalls
    for a, b in zip(got.per_iteration, want.per_iteration):
        np.testing.assert_array_equal(a, b)
    # the sequential sum of the earlier port breaks a tie the other way
    monkeypatch.setattr(tcd, "_xla_cpu_sum", tcd._sequential_sum)
    seq = tcd.greedy_channel_discovery(g, q, g_lab, q_lab, **kw)
    assert any((a != b).any() for a, b in zip(seq.per_iteration, want.per_iteration))


def test_best_window_sweep_at_40_classes_picks_jax_starts_among_tie_pairs():
    g, q, g_lab, q_lab = _tie_split(n_base=3, segments=True)
    kw = dict(width=4, top_k=5, n_classes=40, stride=4)  # starts 0 and 4 tie
    want = jcd.best_window_sweep(g, q, g_lab, q_lab, **kw)
    got = tcd.best_window_sweep(torch.from_numpy(g), torch.from_numpy(q), g_lab, q_lab, **kw)
    assert (want.recalls[:, 0] != want.recalls[:, 1]).any()
    np.testing.assert_array_equal(got.recalls, want.recalls)
    np.testing.assert_array_equal(got.precisions, want.precisions)
    np.testing.assert_array_equal(got.best_start, want.best_start)
