"""Metric utilities beyond retrieval: top-k accuracy, PCA with whitening,
Oxford-style mAP and multi-scale inference (port of cerebra/eval/metrics.py;
utils/utils.py:506-513, 658-833)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cerebra_torch.eval.retrieval import total_order_key


def accuracy(output: torch.Tensor, target: torch.Tensor, topk: Sequence[int] = (1,)) -> List[float]:
    """Top-k accuracy over logits (utils/utils.py:506-513), ranked as
    `jax.lax.top_k` ranks: in IEEE total order, equal logits by the lower
    class index."""
    maxk = max(topk)
    pred = torch.sort(total_order_key(output), dim=1, descending=True,
                      stable=True).indices[:, :maxk]
    correct = pred == target[:, None]
    B = target.shape[0]
    return [float(correct[:, :k].sum() * 100.0 / B) for k in topk]


class PCA:
    """PCA with power whitening (utils/utils.py:658-709): eigendecompose a
    covariance, keep the top-dim components, scale by 1/λ^whit (numpy f64,
    as the JAX package)."""

    def __init__(self, dim: int = 256, whit: float = 0.5):
        self.dim = dim
        self.whit = whit
        self.mean: Optional[np.ndarray] = None
        self.dvt: Optional[np.ndarray] = None

    def train_pca(self, cov: np.ndarray) -> None:
        d, v = np.linalg.eigh(np.asarray(cov, dtype=np.float64))
        eps = d.max() * 1e-5
        d = np.where(d < eps, eps, d)
        idx = np.argsort(d)[::-1][: self.dim]
        d, v = d[idx], v[:, idx]
        self.dvt = np.diag(1.0 / d**self.whit) @ v.T

    def fit(self, x: np.ndarray) -> "PCA":
        x = np.asarray(x, dtype=np.float64)
        self.mean = x.mean(axis=0)
        self.train_pca(np.cov(x - self.mean, rowvar=False))
        return self

    def apply(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if self.mean is not None:
            x = x - self.mean
        return (self.dvt @ x.T).T


def compute_ap(ranks: np.ndarray, nres: int) -> float:
    """Average precision from zero-based positive ranks (utils/utils.py:712-745)."""
    ap = 0.0
    recall_step = 1.0 / nres
    for j, rank in enumerate(np.asarray(ranks)):
        precision_0 = 1.0 if rank == 0 else float(j) / rank
        precision_1 = float(j + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def compute_map(
    ranks: np.ndarray, gnd: List[dict], kappas: Sequence[int] = ()
) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray]:
    """Oxford/Paris-style mAP with ok/junk sets (utils/utils.py:748-816).
    ranks: (db_size, n_queries) zero-based."""
    nq = len(gnd)
    aps = np.zeros(nq)
    pr = np.zeros(len(kappas))
    prs = np.zeros((nq, len(kappas)))
    nempty = 0
    map_ = 0.0
    for i in range(nq):
        qgnd = np.array(gnd[i]["ok"])
        if qgnd.shape[0] == 0:
            aps[i] = float("nan")
            prs[i, :] = float("nan")
            nempty += 1
            continue
        qgndj = np.array(gnd[i].get("junk", []))
        pos = np.arange(ranks.shape[0])[np.isin(ranks[:, i], qgnd)]
        junk = np.arange(ranks.shape[0])[np.isin(ranks[:, i], qgndj)]
        k = 0
        ij = 0
        if len(junk):
            ip = 0
            while ip < len(pos):
                while ij < len(junk) and pos[ip] > junk[ij]:
                    k += 1
                    ij += 1
                pos[ip] -= k
                ip += 1
        ap = compute_ap(pos, len(qgnd))
        map_ += ap
        aps[i] = ap
        # precision@k over 1-based positions (utils/utils.py:807-810: pos += 1
        # before kq = min(max(pos), kappa) and the <= comparison)
        pos1 = pos + 1
        for j, kappa in enumerate(kappas):
            kq = min(max(pos1), kappa)
            prs[i, j] = (pos1 <= kq).sum() / kq if kq > 0 else 0.0
        pr = pr + prs[i, :]
    denom = max(nq - nempty, 1)
    return map_ / denom, aps, pr / denom, prs


def multi_scale(samples: torch.Tensor, model_fn) -> torch.Tensor:
    """3-scale feature averaging (utils/utils.py:819-833): scales 1, 1/√2,
    1/2; features summed, /3, L2-normalised over the whole array. samples:
    NHWC images. Each scale is torch's bilinear `F.interpolate` by the
    literal float scale, without antialiasing (the reference's call)."""
    v = None
    for s in (1.0, 1 / 2 ** 0.5, 0.5):
        if s == 1.0:
            inp = samples
        else:
            inp = F.interpolate(samples.permute(0, 3, 1, 2), scale_factor=s, mode="bilinear",
                                align_corners=False, antialias=False,
                                recompute_scale_factor=False).permute(0, 2, 3, 1)
        feats = model_fn(inp)
        v = feats if v is None else v + feats
    v = v / 3.0
    return v / torch.linalg.norm(v)


def _kmeans_pp(x: torch.Tensor, k: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy k-means++ seeding (scikit-learn's): the first centre uniform,
    each next one the best of 2 + ⌊ln k⌋ draws ∝ D², by the potential it
    leaves."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = [x[int(torch.randint(n, (1,), generator=generator))]]
    d2 = ((x - centers[0]) ** 2).sum(1)
    for _ in range(1, k):
        if float(d2.sum()) > 0:
            cand = torch.multinomial(d2 / d2.sum(), trials, replacement=True, generator=generator)
        else:
            cand = torch.randint(n, (trials,), generator=generator)
        cand_d2 = torch.minimum(d2[None], ((x[None] - x[cand][:, None]) ** 2).sum(-1))
        best = int(cand_d2.sum(1).argmin())
        centers.append(x[int(cand[best])])
        d2 = cand_d2[best]
    return torch.stack(centers)


def kmeans(x, n_clusters: int, generator: Optional[torch.Generator] = None
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Lloyd's k-means in f64 from k-means++ seeds, the best of 5 runs by
    inertia; a run stops after 300 steps or when the centres move
    less than 1e-4 times the mean feature variance (scikit-learn's KMeans
    defaults, which the JAX package calls; the card's machine has no
    scikit-learn). An empty cluster keeps its centre. → (labels (N,),
    centres (k, F), inertia)."""
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    tol = 1e-4 * float(x.var(0, correction=0).mean())
    best = None
    for _ in range(5):
        centers = _kmeans_pp(x, n_clusters, generator)
        for _ in range(300):
            labels = torch.cdist(x, centers).argmin(1)
            sums = torch.zeros_like(centers).index_add_(0, labels, x)
            counts = torch.bincount(labels, minlength=n_clusters)[:, None]
            moved = torch.where(counts > 0, sums / counts.clamp_min(1), centers)
            shift = float(((moved - centers) ** 2).sum())
            centers = moved
            if shift <= tol:
                break
        d2 = ((x[:, None] - centers[None]) ** 2).sum(-1)
        inertia = float(d2.min(1).values.sum())
        if best is None or inertia < best[2]:
            best = (d2.argmin(1).numpy(), centers.numpy(), inertia)
    return best
