"""Models: the LSTM encoders, the autoencoders, the LSTM-stack kernels, the
DINO ViT inference wrapper, the hub's image backbones (the DINO and DINOv2
ViTs, XCiT, ResNet-50), Barlow Twins, the EEG Conformer, the EEG-ChannelNet
blocks and CustomModel."""

from cerebra_torch.models.autoencoders import (  # noqa: F401
    EEGAutoencoderConv,
    EEGAutoencoderFC,
    RecurrentAutoencoder,
    feature_matching_loss,
)
from cerebra_torch.models.barlow import BarlowTwins  # noqa: F401
from cerebra_torch.models.conformer import Conformer  # noqa: F401
from cerebra_torch.models.dino_model import DinoArgs, DinoModel, dino_image_transform  # noqa: F401
from cerebra_torch.models.lstm import (  # noqa: F401
    InlineLSTM,
    LSTMStack,
    Model,
    model_from_state_dict,
    params_from_jax,
)
from cerebra_torch.models.layers import (  # noqa: F401
    ConvLayer2D,
    ResidualBlock,
    SpatialBlock,
    TemporalBlock,
)
from cerebra_torch.models.mlp import CustomModel  # noqa: F401
from cerebra_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResnetFeatureRegressor,
    init_feature_regressor,
    resnet50,
)
from cerebra_torch.models.vit import VisionTransformer, vit_small_dinov2  # noqa: F401
from cerebra_torch.models.xcit import XCIT_CONSTRUCTORS, XCiT  # noqa: F401
