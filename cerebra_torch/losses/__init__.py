"""Losses of the LSTM distillation trainers, the DINO recipes and Barlow
Twins."""

from cerebra_torch.losses.barlow import barlow_twins_loss  # noqa: F401

from cerebra_torch.losses.cosine import (  # noqa: F401
    cosine_embedding_loss,
    cosine_similarity_loss,
)
from cerebra_torch.losses.dino import (  # noqa: F401
    dino_multicrop_loss,
    teacher_temp_schedule,
    update_center,
)
from cerebra_torch.losses.feature_dist import (  # noqa: F401
    feature_distribution_loss_v1,
    feature_distribution_loss_v2,
    feature_distribution_loss_v3,
)
from cerebra_torch.losses.kd import hinton_kd_loss, kl_kd_smooth_l1_loss  # noqa: F401
