"""Welch PSD, band powers, denoising (the band-pass and the ICA as a rank-n
projection), the MNE helpers, the EEG-image resize and time crop, the noise
control and the single-pair DINO loss of the port against the JAX package
(cerebra/signal/{psd,denoise,mne_compat,windows}.py, data/synthetic.py,
losses/dino.py, utils/config.py) on the same seeded inputs."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.data.synthetic import synthetic_eeg_noise as jax_noise
from cerebra.losses.dino import dino_single_pair_loss as jax_pair_loss
from cerebra.signal import denoise as jdn
from cerebra.signal import mne_compat as jmc
from cerebra.signal import psd as jpsd
from cerebra.signal import windows as jw
from cerebra.utils import config as jcfg
from cerebra_torch.data.synthetic import synthetic_eeg_noise
from cerebra_torch.losses.dino import dino_single_pair_loss
from cerebra_torch.signal import denoise, mne_compat, psd, windows
from cerebra_torch.utils import config

torch.set_num_threads(1)


def _x(*shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("nperseg,noverlap", [(64, None), (63, None), (64, 16), (500, None)])
def test_welch_psd_matches_jax(nperseg, noverlap):
    x = _x(3, 4, 300)
    f, got = psd.welch_psd(torch.from_numpy(x), 250.0, nperseg, noverlap)
    jf, want = jpsd.welch_psd(jnp.asarray(x), 250.0, nperseg, noverlap)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-9)


def test_welch_keeps_cerebras_doubling_at_odd_nperseg():
    """scipy doubles the last bin too at an odd nperseg; cerebra (and so the
    port) does not: every other bin agrees, the last reads half scipy's."""
    from scipy import signal as sps

    x = _x(2, 1024, dtype=np.float64)
    for nperseg, last in ((256, 1.0), (255, 0.5)):
        _, got = psd.welch_psd(torch.from_numpy(x), 100.0, nperseg)
        _, want = sps.welch(x, fs=100.0, nperseg=nperseg)
        got = got.numpy()
        np.testing.assert_allclose(got[..., :-1], want[..., :-1], rtol=1e-10)
        np.testing.assert_allclose(got[..., -1], last * want[..., -1], rtol=1e-10)


def test_band_powers_match_jax():
    x = _x(2, 3, 1000)
    bands = dict(psd.EEG_BANDS, empty=(300.0, 310.0))
    got = psd.band_powers(torch.from_numpy(x), 500.0, 256, bands)
    want = jpsd.band_powers(jnp.asarray(x), 500.0, 256, bands)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=2e-5,
                                   atol=1e-9)
    assert float(got["empty"].abs().max()) == 0.0


def test_remove_noise_matches_jax_and_scipy():
    """(N, T, C) f32 against JAX to 5e-4 of the peak (the 1 Hz poles carry
    f32 rounding: each side lies 1.7-1.9e-4 from f64), and f64 against
    scipy's sosfiltfilt over the time axis to 1e-9."""
    from scipy import signal as sps

    x = _x(2, 200, 5)
    got = denoise.remove_noise(torch.from_numpy(x), 1000.0)
    want = np.asarray(jdn.remove_noise(jnp.asarray(x), 1000.0))
    assert got.shape == x.shape
    assert np.abs(got.numpy() - want).max() < 5e-4 * np.abs(want).max()
    x64 = x.astype(np.float64)
    spec = sps.butter(4, [1.0 / 500.0, 50.0 / 500.0], btype="bandpass", output="sos")
    ref = sps.sosfiltfilt(spec, x64, axis=1)
    got64 = denoise.remove_noise(torch.from_numpy(x64), 1000.0).numpy()
    assert np.abs(got64 - ref).max() < 1e-9 * np.abs(ref).max()


@pytest.mark.parametrize("n", [3, 5])
def test_remove_noise_with_ica_is_the_jax_functions_projection(n):
    """The JAX function (sklearn FastICA fit + inverse per trial) at f64 is
    the rank-n PCA projection: equal to 1e-8 of the peak."""
    x = _x(3, 120, 8, dtype=np.float64) + np.linspace(0, 1, 8)
    got = denoise.remove_noise_with_ica(torch.from_numpy(x), n_components=n).numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # FastICA's convergence warnings
        want = jdn.remove_noise_with_ica(x, n_components=n)
    assert got.shape == x.shape
    assert np.abs(got - want).max() < 1e-8 * np.abs(want).max()
    full = denoise.remove_noise_with_ica(torch.from_numpy(x), n_components=8).numpy()
    np.testing.assert_allclose(full, x, atol=1e-12)  # every component kept: the trial itself


def test_mne_helpers_match_jax():
    eeg = _x(3, 50, 4)
    names, types = [f"ch{i}" for i in range(4)], ["eeg"] * 4
    got = mne_compat.create_raw_data(eeg, names, types, 256.0)
    want = jmc.create_raw_data(eeg, names, types, 256.0)
    np.testing.assert_array_equal(got.get_data(), want.get_data())
    assert mne_compat.create_info(names, types, 256.0) == jmc.create_info(names, types, 256.0)
    assert mne_compat.montage_available() == jmc.montage_available()
    t = np.arange(1024) / 256.0
    sig = np.sin(2 * np.pi * 2 * t) + np.sin(2 * np.pi * 10 * t) + np.sin(2 * np.pi * 60 * t)
    raw = mne_compat.RawBundle(np.tile(sig, (3, 1)).astype(np.float32), ["a", "b", "c"],
                               ["eeg"] * 3, 256.0)
    jraw = jmc.RawBundle(raw.data, raw.channel_names, raw.channel_types, 256.0)
    out = mne_compat.filter_frequency_bands(raw, 8.0, 14.0, 256.0, device="cpu")
    jout = jmc.filter_frequency_bands(jraw, 8.0, 14.0, 256.0)
    assert isinstance(out, mne_compat.RawBundle) and out.channel_names == ["a", "b", "c"]
    peak = np.abs(jout.get_data()).max()
    assert np.abs(out.get_data() - jout.get_data()).max() < 1e-5 * peak
    y = out.get_data()[0][100:-100]
    assert np.corrcoef(y, np.sin(2 * np.pi * 10 * t)[100:-100])[0, 1] > 0.98


@pytest.mark.parametrize("shape,size", [((512, 96), 224), ((40, 30), 64), ((40, 30), 16)])
def test_resize_eeg_to_image_matches_jax(shape, size):
    """Bilinear with antialias where an axis shrinks, as jax.image.resize:
    within 2e-5 (8.6e-6 measured at 512 x 96 → 224)."""
    x = _x(*shape)
    got = windows.resize_eeg_to_image(torch.from_numpy(x), size)
    want = np.asarray(jw.resize_eeg_to_image(jnp.asarray(x), size))
    assert got.shape == want.shape == (3, size, size)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_random_time_crop_matches_jax_at_its_start():
    x = _x(2, 50, 3)
    key = jax.random.key(3)
    start = int(jw._crop_starts(key, 1, 50, 20)[0])
    want = np.asarray(jw.random_time_crop(key, jnp.asarray(x), 20))
    got = windows.random_time_crop(torch.from_numpy(x), 20, start=start)
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = windows.random_time_crop(torch.from_numpy(x), 45, generator=torch.Generator())
    assert drawn.shape == (2, 45, 3)


def test_synthetic_eeg_noise_is_noise_plus_the_40hz_line():
    g = torch.Generator().manual_seed(4)
    got = synthetic_eeg_noise(3, 5, 100, generator=g)
    noise = torch.randn(3, 5, 100, generator=torch.Generator().manual_seed(4))
    key = jax.random.key(0)
    want_line = np.asarray(jax_noise(key, 3, 5, 100)) - np.asarray(
        jax.random.normal(key, (3, 5, 100)))
    np.testing.assert_allclose((got - noise).numpy(), want_line, atol=1e-6)


def test_dino_single_pair_loss_matches_jax():
    s, t = _x(4, 6, seed=1), _x(4, 6, seed=2)
    c = _x(1, 6, seed=3)
    want_loss, want_c = jax_pair_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(c), 0.04)
    st = torch.from_numpy(s).requires_grad_()
    loss, new_c = dino_single_pair_loss(st, torch.from_numpy(t), torch.from_numpy(c), 0.04)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(new_c.numpy(), np.asarray(want_c), rtol=1e-6)
    want_g = jax.grad(lambda a: jax_pair_loss(a, jnp.asarray(t), jnp.asarray(c), 0.04)[0])(
        jnp.asarray(s))
    loss.backward()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_g), atol=1e-6)


def test_config_helpers_match_jax(capsys):
    config.fix_random_seeds(7)
    a = (np.random.rand(), torch.rand(1).item())
    jcfg.fix_random_seeds(7)
    assert a == (np.random.rand(), torch.rand(1).item())
    assert config.get_sha() == jcfg.get_sha()
    import builtins

    saved = builtins.print
    try:
        config.setup_for_distributed(False)
        print("hidden")
        print("shown", force=True)
    finally:
        builtins.print = saved
    assert capsys.readouterr().out == "shown\n"
