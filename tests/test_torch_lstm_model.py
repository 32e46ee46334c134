"""The port's `Model` against the JAX `Model`, and checkpoints across the two
packages in the reference `.pth` layout (f32, atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cerebra.models.lstm import Model as JaxModel
from cerebra.models.lstm import export_torch_state_dict, import_torch_state_dict
from cerebra_torch.models import Model, params_from_jax

torch.set_num_threads(1)

C, H, F, K, B, T = 6, 5, 7, 4, 3, 9


def jax_model_and_params(seed=0):
    model = JaxModel(input_size=C, lstm_size=H, lstm_layers=2, output_size=F, n_classes=K)
    params = model.init(jax.random.key(seed), jnp.zeros((1, T, C)))["params"]
    return model, jax.tree.map(np.asarray, params)


def eeg(seed=1):
    return np.random.default_rng(seed).normal(size=(B, T, C)).astype(np.float32)


def port_outputs(state_dict):
    model = Model(C, H, 2, F, n_classes=K)
    model.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        feats, cls = model(torch.from_numpy(eeg()))
    return feats.numpy(), cls.numpy()


def test_model_matches_jax():
    jm, params = jax_model_and_params()
    want_f, want_c = jm.apply({"params": params}, jnp.asarray(eeg()))
    got_f, got_c = port_outputs(params_from_jax(params))
    np.testing.assert_allclose(got_f, np.asarray(want_f), atol=1e-5)
    np.testing.assert_allclose(got_c, np.asarray(want_c), atol=1e-5)


def test_jax_export_loads_strict():
    jm, params = jax_model_and_params(seed=2)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_torch_state_dict({"params": params}).items()}
    got_f, got_c = port_outputs(sd)
    want_f, want_c = jm.apply({"params": params}, jnp.asarray(eeg()))
    np.testing.assert_allclose(got_f, np.asarray(want_f), atol=1e-5)
    np.testing.assert_allclose(got_c, np.asarray(want_c), atol=1e-5)


def test_port_state_dict_imports_into_jax():
    model = Model(C, H, 2, F, n_classes=K, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got_f, got_c = model(torch.from_numpy(eeg()))
    jm, _ = jax_model_and_params()
    params = import_torch_state_dict(model.state_dict())
    want_f, want_c = jm.apply(params, jnp.asarray(eeg()))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)


def test_features_only_is_the_last_hidden_state():
    _, params = jax_model_and_params()
    model = Model(C, H, 2, F, n_classes=K)
    model.load_state_dict(params_from_jax(params), strict=True)
    jm = JaxModel(input_size=C, lstm_size=H, lstm_layers=2, output_size=F, n_classes=K)
    want = jm.apply({"params": params}, jnp.asarray(eeg()), features_only=True)
    with torch.no_grad():
        got = model(torch.from_numpy(eeg()), features_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
