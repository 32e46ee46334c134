"""The port's filters against cerebra/signal/filters.py: the banded
zero-phase product (f32), the exact IIR cascade (f32 against JAX, f64
against scipy), the FFT and FIR forms, the notch and the ingest chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.signal import filters as jf
from cerebra_torch.signal import filters as tf

torch.set_num_threads(1)


def test_design_and_zero_phase_matrix_match_jax():
    spec_j = jf.design_bandpass(14.0, 71.0, fs=1000.0, order=4)
    spec_t = tf.design_bandpass(14.0, 71.0, fs=1000.0, order=4)
    np.testing.assert_array_equal(spec_t.sos, spec_j.sos)
    np.testing.assert_array_equal(spec_t.zi, spec_j.zi)
    np.testing.assert_array_equal(tf.zero_phase_fir(spec_t, 33), jf.zero_phase_fir(spec_j, 33))
    want = np.asarray(jf.zero_phase_matrix(spec_j, 64, num_taps=33, dtype=jnp.float32))
    got = tf.zero_phase_matrix(spec_t, 64, num_taps=33, dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_filtfilt_matmul_matches_jax():
    spec = tf.design_bandpass(14.0, 71.0, fs=1000.0, order=4)
    x = np.random.default_rng(0).normal(size=(3, 4, 64)).astype(np.float32)
    w_j = jf.zero_phase_matrix(jf.design_bandpass(14.0, 71.0, 1000.0), 64, 33, jnp.float32)
    want = np.asarray(jf.filtfilt_matmul(w_j, jnp.asarray(x)))
    w_t = tf.zero_phase_matrix(spec, 64, num_taps=33, dtype=torch.float32)
    got = tf.filtfilt_matmul(w_t, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    bf = tf.filtfilt_matmul(w_t.to(torch.bfloat16), torch.from_numpy(x), out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), want, atol=5e-2)


# The exact IIR path: filtfilt / lfilter over the SOS cascade (the plain loop
# of sos_scan on the CPU). f32 against JAX relative to the output's peak:
# both sides run the same per-step updates in f32 and differ in rounding
# only; how far that rounding carries depends on the poles. At 14-71 Hz
# (1000 Hz) both lie within 4.1e-6 of an f64 evaluation and 3.3e-6 of each
# other; at 1-50 Hz the 1 Hz poles sit at the unit circle and each side lies
# 1.7-1.9e-4 from f64 (8.5e-5 from each other, measured on the CPU).
F32_BANDS = [((14.0, 71.0), 1e-5), ((1.0, 50.0), 5e-4)]


def _rel_peak(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("band,tol", F32_BANDS, ids=["14-71Hz", "1-50Hz"])
def test_filtfilt_and_lfilter_match_jax_f32(band, tol):
    x = np.random.default_rng(0).normal(size=(3, 4, 300)).astype(np.float32)
    sj = jf.design_bandpass(*band, fs=1000.0)
    st = tf.design_bandpass(*band, fs=1000.0)
    assert st.default_padlen == sj.default_padlen == 27
    got = tf.filtfilt(st, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel_peak(got, jf.filtfilt(sj, jnp.asarray(x))) < tol
    scale = x[..., 0]
    got = tf.lfilter(st, torch.from_numpy(x), zi_scale=torch.from_numpy(scale))
    want = jf.lfilter(sj, jnp.asarray(x), zi_scale=jnp.asarray(scale))
    assert _rel_peak(got, want) < tol
    assert _rel_peak(tf.lfilter(st, torch.from_numpy(x)), jf.lfilter(sj, jnp.asarray(x))) < tol


@pytest.mark.parametrize("kind", ["butter", "cheby1", "ellip", "notch"])
@pytest.mark.parametrize("padlen", [None, 0, 40])
def test_filtfilt_matches_scipy_f64(kind, padlen):
    """f64 against scipy.signal.sosfiltfilt / sosfilt to 1e-9 of the peak:
    the same recurrence in the same dtype (measured equal to the last bit)."""
    from scipy import signal as sps

    spec = (tf.design_notch(60.0, 1000.0) if kind == "notch"
            else tf.design_bandpass(14.0, 71.0, 1000.0, order=3, kind=kind))
    x = np.random.default_rng(1).normal(size=(2, 5, 257))
    kw = {} if padlen is None else {"padlen": padlen}
    got = tf.filtfilt(spec, torch.from_numpy(x), **kw)
    assert got.dtype == torch.float64
    assert _rel_peak(got, sps.sosfiltfilt(spec.sos, x, axis=-1, **kw)) < 1e-9
    zi = spec.zi[:, None, None, :] * x[None, :, :, 0, None]  # sosfilt's (S, ..., 2) layout
    want = sps.sosfilt(spec.sos, x, axis=-1, zi=zi)[0]
    got = tf.lfilter(spec, torch.from_numpy(x), zi_scale=torch.from_numpy(x[..., 0]))
    assert _rel_peak(got, want) < 1e-9


def test_sos_scan_reverse_is_the_flipped_forward_scan():
    spec = tf.design_bandpass(14.0, 71.0, 1000.0)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 90)))
    fwd = tf.sos_scan(spec.sos, x.flip(-1), spec.zi, x[..., -1]).flip(-1)
    rev = tf.sos_scan(spec.sos, x, spec.zi, x[..., -1], reverse=True)
    assert torch.equal(fwd, rev)
    assert torch.equal(tf.sos_scan(spec.sos, x), tf.lfilter(spec, x))
    with pytest.raises(ValueError, match="padlen"):
        tf.filtfilt(spec, x[..., :27])
    with pytest.raises(ValueError, match="together"):
        tf.sos_scan(spec.sos, x, spec.zi)


def test_fft_fir_notch_and_pipeline_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 3, 400)).astype(np.float32)
    sj, st = jf.design_bandpass(14.0, 71.0, 1000.0), tf.design_bandpass(14.0, 71.0, 1000.0)
    np.testing.assert_array_equal(tf.design_notch(50.0, 500.0, 20.0).sos,
                                  jf.design_notch(50.0, 500.0, 20.0).sos)
    np.testing.assert_array_equal(tf.design_notch(50.0, 500.0).zi, jf.design_notch(50.0, 500.0).zi)
    np.testing.assert_array_equal(tf.zero_phase_response(st, 64).numpy(),
                                  np.asarray(jf.zero_phase_response(sj, 64)))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    assert _rel_peak(tf.filtfilt_fft(st, xt), jf.filtfilt_fft(sj, xj)) < 1e-5
    assert _rel_peak(tf.filtfilt_fft(st, xt, padlen=0), jf.filtfilt_fft(sj, xj, padlen=0)) < 1e-5
    np.testing.assert_allclose(tf.filtfilt_fir(st, xt, 33).numpy(),
                               np.asarray(jf.filtfilt_fir(sj, xj, 33)), atol=1e-6)
    taps = np.hanning(8)  # an even tap count: 'same' pads one more on the right
    np.testing.assert_allclose(tf.filtfilt_fir(taps, xt).numpy(),
                               np.asarray(jf.filtfilt_fir(taps, xj)), atol=1e-5)
    for use_fft in (True, False):
        for notch in (60.0, None):
            got = tf.bandpass_notch_pipeline(xt, 1000.0, notch=notch, use_fft=use_fft)
            want = jf.bandpass_notch_pipeline(xj, 1000.0, notch=notch, use_fft=use_fft)
            assert _rel_peak(got, want) < 1e-5
    # half a second in from the edges the FFT form is the exact zero-phase
    # filter (f64, 2000 samples: 1.2e-6 of the peak at a 500-sample margin)
    long = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 2000)))
    diff = tf.filtfilt_fft(st, long) - tf.filtfilt(st, long)
    assert float(diff[..., 500:-500].abs().max()) < 1e-5
