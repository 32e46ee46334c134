"""Losses of the LSTM→DINOv2 trainer."""

from cerebra_torch.losses.dino import teacher_temp_schedule  # noqa: F401
from cerebra_torch.losses.feature_dist import feature_distribution_loss_v1  # noqa: F401
