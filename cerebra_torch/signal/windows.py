"""Time windows, temporal crops and EEG-as-image tiling and resizing (port of
cerebra/signal/windows.py).

Randomness is a `torch.Generator` (or a start passed in), not a JAX key: the
two give different numbers from one seed, so tests hand both the same starts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def time_window(eeg: torch.Tensor, time_low: int, time_high: int) -> torch.Tensor:
    """Static window over the time axis of (..., T, C)."""
    return eeg[..., time_low:time_high, :]


def _crop_starts(n: int, t_total: int, length: int, generator=None) -> torch.Tensor:
    """Reference boundary rule (LstmDistillation.py:555-560): draw start in
    [0, T), and if start+len overflows, shift back by the overflow."""
    starts = torch.randint(0, t_total, (n,), generator=generator)
    return starts - torch.clamp(starts + length - t_total, min=0)


def random_time_crop(eeg: torch.Tensor, length: int, start: Optional[int] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One temporal crop of (B, T, C) → (B, length, C) at `start`, drawn by
    the reference's boundary rule when None."""
    if start is None:
        start = int(_crop_starts(1, eeg.shape[-2], length, generator)[0])
    return eeg[..., start:start + length, :]


def multicrop_views(
    eeg: torch.Tensor,
    global_length: int = 300,
    local_length: int = 200,
    n_global: int = 2,
    n_local: int = 4,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DINO temporal multi-crop (LstmDistillation.py:518-569) of (B, T, C):
    (n_global, B, Lg, C) and (n_local, B, Ll, C), one start per view."""
    T = eeg.shape[-2]
    g_starts = _crop_starts(n_global, T, global_length, generator).tolist()
    l_starts = _crop_starts(n_local, T, local_length, generator).tolist()
    g = torch.stack([eeg[..., s:s + global_length, :] for s in g_starts])
    l = torch.stack([eeg[..., s:s + local_length, :] for s in l_starts])
    return g, l


def _tiled(eeg: torch.Tensor, size: int) -> torch.Tensor:
    """(..., C, T) → (..., size, W): each row repeated adjacently size//C+1
    times, each column size//T+1 times, rows cut to size."""
    C, T = eeg.shape[-2:]
    rep = eeg.repeat_interleave(size // C + 1, dim=-2).repeat_interleave(size // T + 1, dim=-1)
    return rep[..., :size, :]


def window_starts(shape, channels: int, samples: int, size: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Column-window starts of `tile_eeg_to_image`, uniform in
    [0, max(width - size, 1)) where width = samples·(size//samples + 1)."""
    width = samples * (size // samples + 1)
    return torch.randint(0, max(width - size, 1), tuple(shape), generator=generator)


def resize_eeg_to_image(eeg: torch.Tensor, size: int = 224) -> torch.Tensor:
    """EEG (T, C) → (3, size, size): a bilinear resize of the (T, C) plane,
    replicated over 3 channels. Antialiased as jax.image.resize is: a
    shrinking axis (T 512 → 224) takes the triangle filter widened by the
    scale, a growing one (C 96 → 224) plain bilinear."""
    img = F.interpolate(eeg[None, None].float(), size=(size, size), mode="bilinear",
                        align_corners=False, antialias=True)[0, 0].to(eeg.dtype)
    return img.unsqueeze(0).expand(3, size, size)


def tile_eeg_to_image(eeg: torch.Tensor, size: int = 224, start=None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """resizeEEGToImageSize semantics (utils/EEGDataset.py:248-303) of one
    (C, T) channel-first EEG: tile rows and columns (see `_tiled`), take the
    size-wide column window at `start` (drawn from `generator` when None)
    and replicate it over 3 channels → (3, size, size)."""
    C, T = eeg.shape
    if start is None:
        start = int(window_starts((), C, T, size, generator))
    window = _tiled(eeg, size)[:, start:start + size]
    return window.unsqueeze(0).expand(3, size, size)


def tile_eeg_views(eeg: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """`tile_eeg_to_image` over a batch and several views at once, NHWC:
    eeg (B, T, C) and starts (n_views, B) → (n_views, B, size, size, 3)."""
    rep = _tiled(eeg.transpose(1, 2), size)  # (B, size, W)
    cols = starts.to(eeg.device)[..., None] + torch.arange(size, device=eeg.device)
    n_views, B = starts.shape
    idx = cols[:, :, None, :].expand(n_views, B, size, size)
    img = torch.gather(rep.unsqueeze(0).expand(n_views, *rep.shape), 3, idx)
    return img.unsqueeze(-1).expand(n_views, B, size, size, 3)
