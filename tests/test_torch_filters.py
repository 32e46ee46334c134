"""The port's zero-phase band-pass against cerebra/signal/filters.py (f32)."""

import jax.numpy as jnp
import numpy as np
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
