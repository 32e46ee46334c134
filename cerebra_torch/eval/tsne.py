"""Exact t-SNE on a torch device: the embedding the raw-EEG t-SNE CLI draws
(cerebra/cli/get_tsne_for_raw_eeg.py:40-43 calls scikit-learn's
`TSNE(n_components=3, perplexity, init="pca", learning_rate=0.1,
max_iter=1000)`; the GPU machine has no scikit-learn).

It follows scikit-learn's TSNE step by step (sklearn/manifold/_t_sne.py),
with its dtypes: squared Euclidean distances rounded to float32; P by the
per-row binary search for the perplexity on them (float64), symmetrised and
normalised; the PCA initialisation with scikit-learn's sign rule (each
component's largest loading positive), float32, scaled to a first-column
std of 1e-4; Student-t degrees of freedom max(n_components − 1, 1); 250
iterations at early exaggeration 12 and momentum 0.5, then momentum 0.8,
each phase with fresh gains (+0.2 / ×0.8, at least 0.01) and update; the
error and the stopping checks (no progress, gradient norm) every 50
iterations. The embedding, its update and gains are float32, the
distances, P, Q and the gradient's sums float64.

One difference by construction: scikit-learn's default method is
Barnes–Hut (P over the 3·perplexity nearest neighbours, an approximate
gradient); this is its `method="exact"` (P over all pairs, the exact O(N²)
gradient), which a subject's ≤ 2000 trials make cheap on a GPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

MACHINE_EPSILON = float(np.finfo(np.double).eps)
_PERPLEXITY_TOLERANCE = 1e-5  # sklearn/manifold/_utils.pyx
_EPSILON_DBL = 1e-8
_BINARY_SEARCH_STEPS = 100
EXPLORATION_ITERS = 250
EARLY_EXAGGERATION = 12.0
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, N) squared Euclidean distances, computed in float64 and
    rounded to float32 (scikit-learn's upcast path for float32 data), with a
    zero diagonal; returned as float64."""
    xd = x.double()
    sq = (xd * xd).sum(dim=1)
    d = (sq[:, None] + sq[None, :] - 2.0 * (xd @ xd.T)).clamp_(min=0.0)
    d.fill_diagonal_(0.0)
    return d.float().double()


def joint_probabilities(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """P (N, N), zero diagonal, from squared distances (N, N): each row's
    conditional distribution exp(−β d²) with β found by bisection until its
    entropy is within 1e-5 of log(perplexity) (at most 100 steps, every row
    at once), then P = (P_cond + P_condᵀ) / sum, floored at machine epsilon
    off the diagonal (scikit-learn's `_joint_probabilities`)."""
    d = d2.double()
    n = d.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=d.device)
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    cond = torch.zeros_like(d)
    target = math.log(perplexity)
    for _ in range(_BINARY_SEARCH_STEPS):
        p = torch.exp(-d * beta[:, None]) * off
        sum_p = p.sum(dim=1)
        sum_p = torch.where(sum_p == 0.0, torch.full_like(sum_p, _EPSILON_DBL), sum_p)
        p = p / sum_p[:, None]
        entropy = torch.log(sum_p) + beta * (d * p).sum(dim=1)
        diff = entropy - target
        active = ~done
        cond[active] = p[active]
        converged = diff.abs() <= _PERPLEXITY_TOLERANCE
        up = active & ~converged & (diff > 0.0)  # too flat: sharpen
        down = active & ~converged & (diff <= 0.0)
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = torch.where(up, torch.where(beta_max == math.inf, beta * 2.0,
                                           (beta + beta_max) / 2.0), beta)
        beta = torch.where(down, torch.where(beta_min == -math.inf, beta / 2.0,
                                             (beta + beta_min) / 2.0), beta)
        done |= active & converged
        if bool(done.all()):
            break
    P = cond + cond.T
    P = P / torch.clamp(P.sum(), min=MACHINE_EPSILON)
    return torch.where(off, torch.clamp(P, min=MACHINE_EPSILON), torch.zeros_like(P))


def pca_init(x: torch.Tensor, n_components: int) -> torch.Tensor:
    """The PCA initialisation: the centred data's top principal scores (float64,
    through the smaller of the Gram and covariance matrices), each
    component's sign set so its largest loading is positive, rounded to
    float32 and scaled so the first column's std is 1e-4."""
    xc = x.double() - x.double().mean(dim=0, keepdim=True)
    n, dim = xc.shape
    if n <= dim:
        evals, u = torch.linalg.eigh(xc @ xc.T)
        u = u[:, -n_components:].flip(-1)
        s = evals[-n_components:].flip(-1).clamp(min=0.0).sqrt()
        scores = u * s
        loadings = (xc.T @ u) / s  # (D, k): the rows of Vt, as columns
    else:
        _, v = torch.linalg.eigh(xc.T @ xc)
        loadings = v[:, -n_components:].flip(-1)
        scores = xc @ loadings
    rows = torch.arange(n_components, device=x.device)
    signs = torch.sign(loadings[loadings.abs().argmax(dim=0), rows])
    emb = (scores * signs).float()
    return emb / emb[:, 0].std(unbiased=False) * 1e-4


def kl_and_grad(y: torch.Tensor, P: torch.Tensor, dof: float,
                compute_error: bool) -> Tuple[float, torch.Tensor]:
    """scikit-learn's exact `_kl_divergence`: (KL(P‖Q) or NaN, its gradient
    in y's dtype). Distances from y's float64 differences (scipy's pdist);
    the gradient's differences y_i − y_j in y's dtype, as its loop takes
    them."""
    dd = y.double()[:, None, :] - y.double()[None, :, :]  # (N, N, k)
    dist = ((dd * dd).sum(dim=-1) / dof + 1.0) ** ((dof + 1.0) / -2.0)
    dist.fill_diagonal_(0.0)
    Q = torch.clamp(dist / dist.sum(), min=MACHINE_EPSILON)
    error = math.nan
    if compute_error:
        off = P > 0.0
        error = float((P[off] * torch.log(torch.clamp(P[off], min=MACHINE_EPSILON)
                                          / Q[off])).sum())
    pqd = (P - Q) * dist
    diff = (y[:, None, :] - y[None, :, :]).double()  # (N, N, k)
    grad = torch.einsum("ij,ijk->ik", pqd, diff).to(y.dtype)
    return error, grad * (2.0 * (dof + 1.0) / dof)


def _gradient_descent(y: torch.Tensor, P: torch.Tensor, dof: float, it: int, max_iter: int,
                      momentum: float, learning_rate: float,
                      n_iter_without_progress: int) -> Tuple[torch.Tensor, float, int]:
    """scikit-learn's `_gradient_descent` with the exact objective."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        error, grad = kl_and_grad(y, P, dof, check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return y, error, i


def tsne(x: torch.Tensor, n_components: int = 3, perplexity: float = 30.0,
         learning_rate: float = 0.1, max_iter: int = 1000,
         init: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, float, int]:
    """Exact t-SNE of x (N, D) on x's device from `init` (N, n_components),
    by default the PCA initialisation → (embedding (N, n_components)
    float32, final KL divergence, iterations run)."""
    P = joint_probabilities(squared_distances(x), perplexity)
    y = pca_init(x, n_components) if init is None else init.to(x.device, torch.float32)
    dof = float(max(n_components - 1, 1))
    y, kl, it = _gradient_descent(y, P * EARLY_EXAGGERATION, dof, 0, EXPLORATION_ITERS, 0.5,
                                  learning_rate, EXPLORATION_ITERS)
    y, kl, it = _gradient_descent(y, P, dof, it + 1, max_iter, 0.8, learning_rate,
                                  N_ITER_WITHOUT_PROGRESS)
    return y, kl, it + 1
