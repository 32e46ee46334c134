"""Retrieval evaluation: exact L2 top-k, recall/precision and the score
artifacts; the greedy channel sweeps; accuracy, PCA, mAP and multi-scale
features."""

from cerebra_torch.eval.channel_discovery import (  # noqa: F401
    ChannelDiscoveryResult,
    WindowSweepResult,
    best_window_sweep,
    greedy_channel_discovery,
    per_channel_distances,
)
from cerebra_torch.eval.metrics import PCA, accuracy, compute_map, kmeans, multi_scale  # noqa: F401
from cerebra_torch.eval.retrieval import l2_topk, retrieval_recall_precision  # noqa: F401
from cerebra_torch.eval.scores import evaluate, save_score_artifacts  # noqa: F401
