"""Exact L2 top-k retrieval and the reference's recall/precision scores
(port of cerebra/eval/retrieval.py:26-87, faiss.IndexFlatL2 semantics)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 keys in IEEE total order (−0 below +0), the order in
    which XLA's TopK ranks equal-comparing values."""
    i = x.float().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def l2_topk(gallery: torch.Tensor, query: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN under squared L2: (distances (Nq, k), indices (Nq, k)),
    ascending by distance, ties to the lower gallery index.

    d(q, g) = ‖q‖² − 2 q·gᵀ + ‖g‖² in f32; the returned distances are
    clamped at 0. A stable sort gives the tie order (torch.topk promises
    none on CUDA)."""
    g = gallery.reshape(gallery.shape[0], -1).float()
    q = query.reshape(query.shape[0], -1).float()
    d2 = (q * q).sum(-1)[:, None] - 2.0 * (q @ g.t()) + (g * g).sum(-1)[None, :]
    dist, idx = torch.sort(d2, dim=1, stable=True)
    return dist[:, :k].clamp_min(0.0), idx[:, :k]


def retrieval_recall_precision(
    gallery_features: torch.Tensor,
    query_features: torch.Tensor,
    gallery_labels,
    query_labels,
    k: int = 5,
    n_classes: Optional[int] = None,
) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Per-class Recall/Precision with the reference's scoring
    (utils/Utilities.py:107-164): a query is a TP if any of its top-k
    neighbours shares its class; per class c, Recall = 100·TP_c/N_c and
    Precision = 100·inst_c/(N_c·k), each rounded to 2 decimals before the
    macro mean over the classes present in the query set.

    Returns (recall, precision, per-class recall, per-class precision), the
    per-class arrays indexed by class id (NaN for absent classes)."""
    g_lab = np.asarray(torch.as_tensor(gallery_labels).cpu())
    q_lab = np.asarray(torch.as_tensor(query_labels).cpu())
    if n_classes is None:
        n_classes = int(max(g_lab.max(), q_lab.max())) + 1
    _, idx = l2_topk(gallery_features, query_features, k)
    same = g_lab[idx.cpu().numpy()] == q_lab[:, None]
    tp_q = same.any(axis=1)
    inst_q = same.sum(axis=1)

    recall = np.full(n_classes, np.nan)
    precision = np.full(n_classes, np.nan)
    for c in np.unique(q_lab):
        m = q_lab == c
        n_c = int(m.sum())
        recall[c] = round(tp_q[m].sum() * 100.0 / n_c, 2)
        precision[c] = round(inst_q[m].sum() * 100.0 / (n_c * k), 2)
    present = ~np.isnan(recall)
    return (
        float(np.mean(recall[present])),
        float(np.mean(precision[present])),
        recall,
        precision,
    )
