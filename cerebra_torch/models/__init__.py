"""Models: the LSTM encoder and the LSTM-stack kernels."""

from cerebra_torch.models.lstm import LSTMStack, Model, params_from_jax  # noqa: F401
