"""Losses of the LSTM→DINOv2 and DINO ViT trainers."""

from cerebra_torch.losses.dino import (  # noqa: F401
    dino_multicrop_loss,
    teacher_temp_schedule,
    update_center,
)
from cerebra_torch.losses.feature_dist import feature_distribution_loss_v1  # noqa: F401
