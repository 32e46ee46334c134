"""Models: the LSTM encoders, the autoencoders, the LSTM-stack kernels and the
DINO ViT inference wrapper."""

from cerebra_torch.models.autoencoders import (  # noqa: F401
    EEGAutoencoderConv,
    EEGAutoencoderFC,
    RecurrentAutoencoder,
    feature_matching_loss,
)
from cerebra_torch.models.dino_model import DinoArgs, DinoModel, dino_image_transform  # noqa: F401
from cerebra_torch.models.lstm import (  # noqa: F401
    InlineLSTM,
    LSTMStack,
    Model,
    model_from_state_dict,
    params_from_jax,
)
