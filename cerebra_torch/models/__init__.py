"""Models: the LSTM encoders, the autoencoders and the LSTM-stack kernels."""

from cerebra_torch.models.autoencoders import (  # noqa: F401
    EEGAutoencoderConv,
    EEGAutoencoderFC,
    RecurrentAutoencoder,
    feature_matching_loss,
)
from cerebra_torch.models.lstm import InlineLSTM, LSTMStack, Model, params_from_jax  # noqa: F401
