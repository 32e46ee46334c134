"""The port's exact t-SNE (eval/tsne.py) against scikit-learn's TSNE with
the JAX CLI's parameters (n_components=3, init="pca", learning_rate=0.1,
max_iter=1000) and method="exact", its 3-D scatter PNG, and
`get_tsne_for_raw_eeg` against the JAX CLI's outputs."""

import os
import warnings

import numpy as np
import pytest
import torch

from cerebra_torch.cli import get_tsne_for_raw_eeg
from cerebra_torch.eval import tsne as T
from cerebra_torch.utils.plotting import scatter3d_image, tab20c_colours

torch.set_num_threads(1)


def _data(n=60, dim=40, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centres = np.repeat(rng.normal(size=(classes, dim)) * 2, n // classes, axis=0)
    return (rng.normal(size=(n, dim)) + centres).astype(np.float32)


def _sklearn_tsne(x, perplexity, init="pca"):
    from sklearn.manifold import TSNE

    model = TSNE(n_components=3, perplexity=perplexity, init=init, learning_rate=0.1,
                 max_iter=1000, method="exact")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        y = model.fit_transform(x)
    return y, model.kl_divergence_, model.n_iter_


def test_joint_probabilities_match_sklearn():
    """P to 1e-15 absolute (scikit-learn's binary search, the same float64
    steps, summed in another order: 6.5e-19 measured)."""
    from scipy.spatial.distance import squareform
    from sklearn.manifold._t_sne import _joint_probabilities
    from sklearn.metrics import pairwise_distances

    x = _data()
    d = pairwise_distances(x, squared=True)
    np.testing.assert_array_equal(T.squared_distances(torch.from_numpy(x)).numpy(), d)
    for perplexity in (5.0, 20.0, 59.0):
        want = _joint_probabilities(d, perplexity, 0)
        got = T.joint_probabilities(torch.from_numpy(d), perplexity).numpy()
        np.testing.assert_allclose(squareform(got, checks=False), want, rtol=0, atol=1e-15)
        assert np.all(np.diag(got) == 0.0)


def test_pca_init_matches_sklearn():
    """scikit-learn's PCA (float32 LAPACK SVD) with its sign rule, scaled to
    std 1e-4, against the port's float64 eigendecomposition: 1e-5 relative
    (7.6e-7 measured)."""
    from sklearn.decomposition import PCA

    for x in (_data(), _data(n=20, dim=50, seed=1)):  # N > D and N < D
        want = PCA(n_components=3).fit_transform(x).astype(np.float32)
        want = want / np.std(want[:, 0]) * 1e-4
        got = T.pca_init(torch.from_numpy(x), 3).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_exact_run_matches_sklearn_from_the_same_init():
    """Every float32 step as scikit-learn takes it: equal to the bit from
    the same initialisation (measured), held to 1e-6 of the extent."""
    from sklearn.decomposition import PCA

    x = _data()
    init = PCA(n_components=3).fit_transform(x).astype(np.float32)
    init = init / np.std(init[:, 0]) * 1e-4
    want, want_kl, want_it = _sklearn_tsne(x, 20.0, init=init)
    got, kl, it = T.tsne(torch.from_numpy(x), 3, 20.0, 0.1, 1000, init=torch.from_numpy(init))
    assert it == want_it + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert abs(kl - want_kl) <= 1e-9 * want_kl


def test_exact_run_with_pca_init_tracks_sklearn():
    """With each side's own PCA the float32 init differs in its last bits
    and 1000 steps carry that on: KL within 1 % (0.14 % measured), the
    embedding within 2 % of its extent (0.6 % measured)."""
    x = _data()
    want, want_kl, _ = _sklearn_tsne(x, 20.0)
    got, kl, _ = T.tsne(torch.from_numpy(x), 3, 20.0)
    assert abs(kl - want_kl) <= 1e-2 * want_kl
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_scatter_colours_are_matplotlibs_tab20c():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for n in (1, 5, 40):
        cmap = plt.get_cmap("tab20c", n)
        want = np.round(np.array([cmap(i)[:3] for i in range(n)]) * 255).astype(np.uint8)
        np.testing.assert_array_equal(tab20c_colours(n), want)
    pts = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    img = scatter3d_image(pts, np.array([[255, 0, 0], [0, 0, 255]], np.uint8))
    assert img.shape == (900, 1200, 3)
    assert (img == [255, 51, 51]).all(-1).any() and (img == [51, 51, 255]).all(-1).any()


def test_cli_writes_the_jax_clis_pngs(tmp_path):
    """The port's CLI on the CPU and the JAX CLI (scikit-learn and matplotlib,
    present here) on the same synthetic corpus: the same file names."""
    from cerebra.cli import get_tsne_for_raw_eeg as jax_cli

    argv = ["--synthetic", "--synthetic_classes", "3", "--synthetic_per_class", "8",
            "--synthetic_channels", "4", "--synthetic_samples", "40", "--time_low", "0",
            "--time_high", "40", "--perplexity", "5"]
    got = get_tsne_for_raw_eeg.main(argv + ["--log_dir", str(tmp_path / "t"), "--device", "cpu"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_cli.main(argv + ["--log_dir", str(tmp_path / "j")])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "SUB_1_RAW_EEG_features_distribution.png"]
    with open(got[0], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_tsne_for_raw_eeg.main(["--synthetic", "--log_dir", str(tmp_path)])
