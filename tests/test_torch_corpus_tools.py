"""The corpus transforms (each through the port's own model, weights carried
from flax by `params_from_jax`, DINO's window starts fed in), the label-wise
helpers, the per-class statistics, and the native top-k with its faiss stub
against cerebra/data/{transforms,labelwise,corpus}.py and the port's own
retrieval, on the same seeded corpora."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.data import corpus as jcorpus
from cerebra.data import labelwise as jlw
from cerebra.data import make_synthetic_corpus as jax_synthetic
from cerebra.data import transforms as jtr
from cerebra.models import autoencoders as jae
from cerebra.models import dino_model as jdm
from cerebra.models import lstm as jlstm
from cerebra_torch.data import corpus, labelwise, make_synthetic_corpus, transforms
from cerebra_torch.eval import faiss_stub, native_topk
from cerebra_torch.eval.retrieval import l2_topk
from cerebra_torch.models import (
    EEGAutoencoderConv,
    EEGAutoencoderFC,
    Model,
    RecurrentAutoencoder,
    params_from_jax,
)
from cerebra_torch.models import dino_model as tdm
from cerebra_torch.models.multicrop import MultiCropWrapper
from cerebra_torch.train.checkpoints import export_dino_pth

torch.set_num_threads(1)

CORPUS = dict(seed=2, n_per_class=3, n_classes=3, n_channels=5, n_samples=12, feature_dim=6)


@pytest.fixture(scope="module")
def corpora():
    return make_synthetic_corpus(**CORPUS), jax_synthetic(**CORPUS)


def _init(module, x, **kw):
    return jax.tree.map(np.asarray, module.init(jax.random.key(0), jnp.asarray(x), **kw)["params"])


def _port(module, params):
    module.load_state_dict(params_from_jax(params), strict=True)
    return module


@pytest.mark.parametrize("features_only", [True, False])
def test_lstm_features_match_jax(corpora, features_only):
    tc, jc = corpora
    jm = jlstm.Model(5, 7, 2, 4, n_classes=3)
    params = _init(jm, jc.eeg[:2])
    want = jtr.lstm_features(jc, jm, params, batch_size=4, features_only=features_only)
    got = transforms.lstm_features(tc, _port(Model(5, 7, 2, 4, n_classes=3), params),
                                   batch_size=4, features_only=features_only)
    assert got.shape == want.shape == (9, 7 if features_only else 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kind", ["recurrent", "fc", "conv"])
def test_autoencoder_reconstruct_matches_jax(corpora, kind):
    tc, jc = corpora
    T, C = tc.n_samples, tc.n_channels
    if kind == "recurrent":
        jm, tm = jae.RecurrentAutoencoder(T, C, 8), RecurrentAutoencoder(T, C, 8)
        params = _init(jm, jc.eeg[:2])
    elif kind == "fc":  # (B, T, C) flattens; channels x time_freq = C x T elements
        jm = jae.EEGAutoencoderFC(channels=C, time_freq=T, latent_dim=8, num_residual_blocks=1)
        tm = EEGAutoencoderFC(C, T, 8, num_residual_blocks=1)
        params = _init(jm, jc.eeg[:2], train=False)
    else:  # the conv autoencoder reads (B, C', T') = the corpus's (B, T, C)
        jm, tm = jae.EEGAutoencoderConv(in_channels=T, latent_dim=8), \
            EEGAutoencoderConv(T, 8, time_freq=C)
        params = _init(jm, jc.eeg[:2])
    if kind == "fc":  # JAX's transform applies the FC model in train mode (dropout):
        # its eval-mode reconstruction, as the port's transform runs it
        want = jtr._batched(lambda x: jm.apply({"params": params}, x, train=False)[1].reshape(
            x.shape), jnp.asarray(jc.eeg), 4)
    else:
        want = jtr.autoencoder_reconstruct(jc, jm, {"params": params}, batch_size=4).eeg
    got = transforms.autoencoder_reconstruct(tc, _port(tm, params), batch_size=4)
    assert got.eeg.shape == tc.eeg.shape and got.labels is tc.labels
    np.testing.assert_allclose(got.eeg, want, atol=1e-5)


def test_image_regressor_to_eeg_matches_jax(corpora):
    """A Dense regressor (image features → T·C pseudo-EEG)."""
    import flax.linen as nn

    tc, jc = corpora
    out = tc.n_samples * tc.n_channels
    jm = nn.Dense(out)
    params = _init(jm, jc.image_features[:2])
    want = jtr.image_regressor_to_eeg(jc, jc.image_features, jm, params, batch_size=4).eeg
    lin = torch.nn.Linear(6, out)
    lin.load_state_dict(params_from_jax(params))
    got = transforms.image_regressor_to_eeg(tc, tc.image_features, lin, batch_size=4).eeg
    assert got.shape == tc.eeg.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dino_features_match_jax(tmp_path, corpora):
    """The port's model's weights read by JAX (a reference-layout checkpoint)
    and JAX's window starts fed in: its per-batch key split per trial."""
    args = dict(arch="vit_tiny", patch_size=16, image_size=32, out_dim=16)
    tmodel = tdm.DinoModel(tdm.DinoArgs(**args), seed=1)
    wrapped = MultiCropWrapper(tmodel.backbone, tmodel.head)
    path = str(tmp_path / "checkpoint.pth")
    export_dino_pth(path, wrapped, wrapped, torch.zeros(1, 16), epoch=0)
    jmodel = jdm.DinoModel.from_torch_checkpoint(path, jdm.DinoArgs(**args))
    tc, jc = corpora
    key = jax.random.key(3)
    want = jtr.dino_features(jc, jmodel, key=key, batch_size=4)
    width = tc.n_samples * (32 // tc.n_samples + 1)  # tile_eeg_to_image's (C, T) = (T, C)ᵀ
    starts, k = [], key
    for start in range(0, tc.n, 4):
        k, sub = jax.random.split(k)
        n = min(4, tc.n - start)
        starts += [int(jax.random.randint(kk, (), 0, max(width - 32, 1)))
                   for kk in jax.random.split(sub, n)]
    got = transforms.dino_features(tc, tmodel, starts=np.array(starts), batch_size=4)
    assert got.shape == want.shape == (9, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)
    drawn = transforms.dino_features(tc, tmodel, generator=torch.Generator(), batch_size=4)
    assert drawn.shape == (9, 16) and np.isfinite(drawn).all()


def test_noise_replace_draws_the_noise_control(corpora):
    tc, _ = corpora
    got = transforms.noise_replace(tc, torch.Generator().manual_seed(0))
    assert got.eeg.shape == tc.eeg.shape and got.eeg.dtype == np.float32
    again = transforms.noise_replace(tc, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.eeg, again.eeg)
    np.testing.assert_array_equal(got.labels, tc.labels)


def test_label_wise_stats_and_labelwise_helpers_match_jax(corpora):
    tc, jc = corpora
    got, want = corpus.label_wise_stats(tc), jcorpus.label_wise_stats(jc)
    assert got.keys() == want.keys()
    for c in got:
        for k in ("mean", "std", "count"):
            np.testing.assert_array_equal(got[c][k], want[c][k])
    predict = (lambda f: f * 2.0)
    a = labelwise.load_data_label_wise(tc, "/img", predict)
    b = jlw.load_data_label_wise(jc, "/img", predict)
    assert a.keys() == b.keys()
    for c in a:
        assert a[c]["images"] == b[c]["images"]
        np.testing.assert_array_equal(np.stack(a[c]["eeg"]), np.stack(b[c]["eeg"]))
        np.testing.assert_array_equal(np.stack(a[c]["pred_eeg"]), np.stack(b[c]["pred_eeg"]))
    fa, la = labelwise.prepare_eeg_data(a)
    fb, lb = jlw.prepare_eeg_data(b)
    np.testing.assert_array_equal(fa, fb)
    assert la == lb
    va, vb = labelwise.prepare_data_for_vis(tc), jlw.prepare_data_for_vis(jc)
    np.testing.assert_array_equal(va[1], vb[1])
    assert va[2] == vb[2]
    np.testing.assert_array_equal(va[3], vb[3])
    images = np.random.default_rng(0).uniform(size=(tc.n, 3, 4, 4))
    ma, mb = labelwise.calc_eeg_mean(tc, images), jlw.calc_eeg_mean(jc, images)
    for c in ma:
        for part in ("eeg", "image"):
            for k in ("psum", "psum_sq", "mean", "std"):
                np.testing.assert_array_equal(ma[c][part][k], mb[c][part][k])
    ca, cb = labelwise.calc_mean(images, tc.labels), jlw.calc_mean(images, jc.labels)
    for c in ca:
        np.testing.assert_array_equal(ca[c]["mean"], cb[c]["mean"])


def test_native_topk_and_faiss_stub_match_the_port_retrieval():
    if not native_topk.available():
        pytest.skip("no C++ toolchain for the native top-k")
    rng = np.random.default_rng(6)
    gallery = rng.normal(size=(40, 7)).astype(np.float32)
    query = rng.normal(size=(9, 7)).astype(np.float32)
    gallery[5] = gallery[3]  # a tie: the lower index first
    query[0] = gallery[3]
    d_nat, i_nat = native_topk.topk_l2_native(gallery, query, 5)
    d_t, i_t = l2_topk(torch.from_numpy(gallery), torch.from_numpy(query), 5)
    np.testing.assert_array_equal(i_nat, i_t.numpy())
    np.testing.assert_allclose(d_nat, d_t.numpy(), atol=1e-4)
    assert list(i_nat[0, :2]) == [3, 5]
    index = faiss_stub.IndexFlatL2(7)
    assert index.is_trained and index.ntotal == 0
    index.add(gallery[:20])
    index.add(gallery[20:])
    D, I = index.search(query, 5)
    np.testing.assert_array_equal(I, i_nat)
    D, I = faiss_stub.IndexFlatL2(7).search(query, 2)  # an empty index: sentinels
    assert (I == -1).all()
    small = faiss_stub.IndexFlatL2(7)
    small.add(gallery[:3])
    D, I = small.search(query, 5)  # fewer than k: padded to k columns
    assert I.shape == (9, 5) and (I[:, 3:] == -1).all()
    saved = sys.modules.pop("faiss", None)
    try:
        mod = faiss_stub.install()  # no real faiss here: the stub, until the test ends
        assert sys.modules["faiss"] is mod and mod.IndexFlatL2 is faiss_stub.IndexFlatL2
        assert faiss_stub.install() is mod  # never shadows what is installed
    finally:
        sys.modules.pop("faiss", None)
        if saved is not None:
            sys.modules["faiss"] = saved
