"""Greedy channel discovery and the per-channel best-window sweep (port of
cerebra/eval/channel_discovery.py).

The reference sweeps channels greedily (TestRetrieval_Perils_DiscoverChannels
.py:125-353 for 96-ch Perils; TestRetrieval_DiscoverChannels.py:189-425 for
128-ch Spampinato): each iteration tries every remaining channel, rebuilds a
faiss gallery over the fixed set plus the candidate, and keeps the channel
with the best macro recall. Squared L2 over concatenated per-channel
features is additive across channels,

    d_{S∪{c}}(q, g) = Σ_{s∈S} d_s(q, g) + d_c(q, g),

so each channel's (Nq, Ng) distances are computed once, and an iteration is
an add and a top-k per candidate. The JAX package computes all of this as
plain XLA, outside any Pallas kernel; here it is torch matrix products and
`torch.topk` on the tensors' device.

Every channel's distances come from one function, `_channel_distance`, so
the resident D and the chunked path's on-the-fly distances are the same
bits, and both modes select the same channels with the same recalls.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from cerebra_torch.eval.retrieval import total_order_key

# Candidates evaluated at once when D is resident: the (chunk, Nq, Ng) block
# and its top-k temporaries stay a few GB at the Spampinato scale.
CANDIDATE_CHUNK = 16
# The best-window sweep's distance block: window starts are batched up to
# this many bytes of (starts, Nq, Ng) f32.
SWEEP_BLOCK_BYTES = 2 << 30


def _as_f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).float()


def _labels(x, device) -> torch.Tensor:
    x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.long)


def _channel_major(x: torch.Tensor) -> torch.Tensor:
    """(N, T, C) → (C, N, T), contiguous."""
    return x.permute(2, 0, 1).contiguous()


def _channel_distance(g_1: torch.Tensor, q_1: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Nq, Ng) squared-L2 distances for one channel's (N, T) slices, in the
    reference's f32 order: (‖q‖² − 2·q·gᵀ) + ‖g‖², written into `out`."""
    out = torch.matmul(q_1, g_1.t(), out=out)
    out.mul_(-2.0).add_((q_1 * q_1).sum(1)[:, None]).add_((g_1 * g_1).sum(1)[None, :])
    return out


def per_channel_distances(gallery, query) -> torch.Tensor:
    """Per-channel squared-L2 distance tensors: gallery (Ng, T, C), query
    (Nq, T, C) → (C, Nq, Ng) f32 on the gallery's device."""
    g = _channel_major(_as_f32(gallery))
    q = _channel_major(_as_f32(query).to(g.device))
    return _distances_cm(g, q)


def _distances_cm(g_cm: torch.Tensor, q_cm: torch.Tensor) -> torch.Tensor:
    D = torch.empty(g_cm.shape[0], q_cm.shape[1], g_cm.shape[1], device=g_cm.device)
    for c in range(g_cm.shape[0]):
        _channel_distance(g_cm[c], q_cm[c], out=D[c])
    return D


def topk_lower_index(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of d along its last axis in IEEE
    total order, ties to the lower index: the set `jax.lax.top_k(-d, k)`
    returns (its order within the k is not kept). `torch.topk` promises no
    order among equal values, so a row whose k-th key is shared with an
    entry outside the k is taken again through a stable sort; other rows
    keep topk's set."""
    key = total_order_key(d)
    vals, idx = torch.topk(key, k, dim=-1, largest=False)
    ambiguous = (key <= vals[..., -1:]).sum(-1) > k
    if bool(ambiguous.any()):
        rows = ambiguous.nonzero(as_tuple=True)
        idx[rows] = torch.sort(key[rows], dim=-1, stable=True).indices[..., :k]
    return idx


# XLA:CPU's tree-reduction rewrite turns a sum over more than this many
# elements into a reduce-window of this size over the symmetrically
# zero-padded axis, then a sum over the windows.
_XLA_CPU_REDUCE_WINDOW = 32


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _xla_cpu_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis in the f32 order of the JAX package's compiled
    `jnp.sum` on the CPU. Above _XLA_CPU_REDUCE_WINDOW elements the axis is
    padded to a multiple of the window, ⌊pad/2⌋ in front; each window is
    summed one element after the other from 0, skipping the padding, and
    the window sums are summed the same way (recursively past the window
    size). At 40 classes: (x0 + … + x19) + (x20 + … + x39). Up to 22
    elements XLA's loop is sequential too; from 23 to 32 LLVM vectorises it
    into lanes that depend on n and the host, and the last bit may differ."""
    n = x.shape[-1]
    w = _XLA_CPU_REDUCE_WINDOW
    if n <= w:
        return _sequential_sum(x)
    padded = -(-n // w) * w
    lo = (padded - n) // 2
    parts = [_sequential_sum(x[..., max(0, s - lo):min(n, s - lo + w)])
             for s in range(0, padded, w)]
    return _xla_cpu_sum(torch.stack(parts, -1))


def _class_mean(per_class: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Σ over the present classes / their count, the f32 sum in XLA:CPU's
    order (`_xla_cpu_sum`), so candidates whose recalls differ only by the
    order of their terms compare alike in both packages."""
    return _xla_cpu_sum(torch.where(present, per_class, 0.0)) / present.sum()


def recall_precision_for_distances(d: torch.Tensor, gallery_labels, query_labels, k: int,
                                   n_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Macro per-class (recall, precision) for a batch of (..., Nq, Ng)
    distance matrices, with the reference's semantics (utils/Utilities.py:
    107-164): TP = any same-class neighbour in the top k; the same-class
    count is credited only on TP queries; per-class values rounded to 2
    decimals before the macro average. → ((...,), (...,))."""
    g_lab = _labels(gallery_labels, d.device)
    q_lab = _labels(query_labels, d.device)
    same = g_lab[topk_lower_index(d, k)] == q_lab[:, None]  # (..., Nq, k)
    tp = same.any(-1).float()
    cir = same.sum(-1).float() * tp
    onehot = torch.nn.functional.one_hot(q_lab, n_classes).float()  # (Nq, n_classes)
    counts = onehot.sum(0)
    tp_c = tp @ onehot
    cir_c = cir @ onehot
    present = counts > 0
    # the final /100 as XLA compiles it: ×0.01 in f32 (a different last bit)
    recall_c = torch.round(tp_c * 100.0 / counts.clamp_min(1.0) * 100.0) * 0.01
    prec_c = torch.round(cir_c * 100.0 / (counts * k).clamp_min(1.0) * 100.0) * 0.01
    return _class_mean(recall_c, present), _class_mean(prec_c, present)


def recall_for_distances(d: torch.Tensor, gallery_labels, query_labels, k: int,
                         n_classes: int) -> torch.Tensor:
    """Macro per-class recall of `recall_precision_for_distances`."""
    return recall_precision_for_distances(d, gallery_labels, query_labels, k, n_classes)[0]


@dataclasses.dataclass
class ChannelDiscoveryResult:
    selected: List[int]  # greedy-ordered channel indices
    recalls: List[float]  # best recall after adding each channel
    per_iteration: List[np.ndarray]  # candidate-recall vector per iteration
    iteration_s: List[float] = dataclasses.field(default_factory=list)  # host seconds each


@dataclasses.dataclass
class WindowSweepResult:
    recalls: np.ndarray  # (C, n_windows)
    best_start: np.ndarray  # (C,) argmax window start per channel
    best_recall: np.ndarray  # (C,)
    precisions: Optional[np.ndarray] = None  # (C, n_windows)
    best_precision: Optional[np.ndarray] = None  # (C,) precision at the best-recall window


def _n_classes(n_classes, gallery_labels, query_labels) -> int:
    if n_classes is not None:
        return n_classes
    return int(max(np.asarray(gallery_labels).max(), np.asarray(query_labels).max())) + 1


def best_window_sweep(gallery, query, gallery_labels, query_labels, width: int = 1,
                      top_k: int = 5, n_classes: Optional[int] = None,
                      stride: int = 1) -> WindowSweepResult:
    """Per-channel best-time-window retrieval sweep: the computation behind
    the reference's logged per-channel "best ts" results
    (TestRetrieval_DiscoverChannels.py:141-187, 196-199). Squared L2 over a
    window [s, s+w) is ‖q_w‖² − 2·q_w·g_wᵀ + ‖g_w‖², so each channel's
    window starts go through batched products, as many starts at once as
    fit SWEEP_BLOCK_BYTES of (starts, Nq, Ng) distances."""
    g_cm = _channel_major(_as_f32(gallery))
    q_cm = _channel_major(_as_f32(query).to(g_cm.device))
    C, Ng, T = g_cm.shape
    Nq = q_cm.shape[1]
    if not 1 <= width <= T:
        raise ValueError(f"window width {width} must be in [1, T={T}]")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    n_classes = _n_classes(n_classes, gallery_labels, query_labels)
    g_lab, q_lab = _labels(gallery_labels, g_cm.device), _labels(query_labels, g_cm.device)
    starts = np.arange(0, T - width + 1, stride)
    cols = torch.as_tensor(starts, device=g_cm.device)[:, None] + torch.arange(
        width, device=g_cm.device)  # (S, w)
    per_block = max(1, SWEEP_BLOCK_BYTES // (4 * Nq * Ng))
    recalls = np.empty((C, len(starts)), dtype=np.float32)
    precisions = np.empty((C, len(starts)), dtype=np.float32)
    for c in range(C):
        for s0 in range(0, len(starts), per_block):
            idx = cols[s0:s0 + per_block]
            qw = q_cm[c][:, idx].transpose(0, 1)  # (s, Nq, w)
            gw = g_cm[c][:, idx].transpose(0, 1)  # (s, Ng, w)
            d = torch.bmm(qw, gw.transpose(1, 2)).mul_(-2.0)
            d.add_((qw * qw).sum(-1)[:, :, None]).add_((gw * gw).sum(-1)[:, None, :])
            r, p = recall_precision_for_distances(d, g_lab, q_lab, top_k, n_classes)
            recalls[c, s0:s0 + len(idx)] = r.cpu().numpy()
            precisions[c, s0:s0 + len(idx)] = p.cpu().numpy()
    best_idx = recalls.argmax(axis=1)
    return WindowSweepResult(
        recalls=recalls,
        best_start=starts[best_idx],
        best_recall=recalls[np.arange(C), best_idx],
        precisions=precisions,
        best_precision=precisions[np.arange(C), best_idx],
    )


def greedy_channel_discovery(gallery, query, gallery_labels, query_labels, top_k: int = 5,
                             n_classes: Optional[int] = None,
                             max_channels: Optional[int] = None,
                             stop_on_no_improvement: bool = True,
                             channel_chunk: Optional[int] = None) -> ChannelDiscoveryResult:
    """The full greedy sweep (TestRetrieval_Perils_DiscoverChannels.py:
    130-353) over gallery (Ng, T, C) and query (Nq, T, C), on the gallery's
    device.

    Stopping rule as the reference's (:331-351): keep the argmax channel
    each iteration; stop when the best candidate no longer improves on the
    best recall so far.

    `channel_chunk` None keeps the per-channel distance tensor D (C, Nq, Ng)
    resident (11.8 GB f32 at the Spampinato scale, 128 × 2400 × 9600) and
    evaluates CANDIDATE_CHUNK candidates at a time; a chunk keeps only the
    channel-major raw slices and computes each chunk's distances on the fly.
    A chunk that does not divide C leaves a shorter last chunk: eager torch
    has no compiled signature to share, so nothing is padded.
    """
    g_cm = _channel_major(_as_f32(gallery))
    q_cm = _channel_major(_as_f32(query).to(g_cm.device))
    C, Ng, _ = g_cm.shape
    Nq = q_cm.shape[1]
    n_classes = _n_classes(n_classes, gallery_labels, query_labels)
    g_lab, q_lab = _labels(gallery_labels, g_cm.device), _labels(query_labels, g_cm.device)
    if max_channels is None:
        max_channels = C
    D = None
    if channel_chunk is None:
        D = _distances_cm(g_cm, q_cm)
        g_cm = q_cm = None
        chunk = CANDIDATE_CHUNK
    else:
        chunk = channel_chunk

    accum = torch.zeros(Nq, Ng, device=D.device if D is not None else g_cm.device)

    def eval_chunk(c0: int) -> np.ndarray:
        c1 = min(c0 + chunk, C)
        if D is not None:
            block = accum[None] + D[c0:c1]
        else:
            block = torch.empty(c1 - c0, Nq, Ng, device=accum.device)
            for i, c in enumerate(range(c0, c1)):
                _channel_distance(g_cm[c], q_cm[c], out=block[i])
            block += accum
        return recall_for_distances(block, g_lab, q_lab, top_k, n_classes).cpu().numpy()

    result = ChannelDiscoveryResult(selected=[], recalls=[], per_iteration=[])
    best_so_far = -np.inf
    taken = np.zeros(C, dtype=bool)
    for _ in range(min(max_channels, C)):  # > C would re-select channel 0
        t0 = time.perf_counter()
        cand_recall = np.concatenate([eval_chunk(c0) for c0 in range(0, C, chunk)])
        cand_recall[taken] = -np.inf
        result.per_iteration.append(cand_recall.copy())
        best_c = int(np.argmax(cand_recall))
        best_r = float(cand_recall[best_c])
        if stop_on_no_improvement and best_r <= best_so_far:
            result.iteration_s.append(time.perf_counter() - t0)
            break
        best_so_far = best_r
        taken[best_c] = True
        result.selected.append(best_c)
        result.recalls.append(best_r)
        if D is not None:
            accum += D[best_c]
        else:
            accum += _channel_distance(g_cm[best_c], q_cm[best_c])
        result.iteration_s.append(time.perf_counter() - t0)
    return result
