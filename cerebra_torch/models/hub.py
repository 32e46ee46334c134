"""Named pretrained-model registry, the reference's torch.hub surface (port of
cerebra/models/hub.py):

- `dino/hubconf.py:1-151`: named constructors (dino_vits16/8, dino_vitb16/8,
  dino_resnet50, dino_xcit_*) that build an architecture and load fixed
  fbaipublicfiles weights (strict load, `fc` stripped on the ResNet);
- `utils/utils.py:71-109` (`load_pretrained_weights`): a local checkpoint
  first (an optional `checkpoint_key`, `module.`/`backbone.` stripped), else
  the (model_name, patch_size) URL table, else random weights with the
  reference's message;
- `utils/utils.py:112-129` (`load_pretrained_linear_weights`): the same for
  the linear-probe weights (under a "state_dict" key).

Constructors return the port's `nn.Module` in eval mode on the CPU. Weights
come only from local files: a URL resolves to its basename in the directory
named by `CEREBRA_HUB_CACHE`, or in torch.hub's own checkpoint directory
(`torch.hub.get_dir()/checkpoints`, under `TORCH_HOME`). Nothing is
downloaded; a name whose file is absent gets random weights from `seed`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch

from cerebra_torch.models.resnet import import_torchvision_resnet50, resnet50
from cerebra_torch.models.vit import (
    import_dinov2_vit_torch,
    import_vit_torch,
    vit_base,
    vit_small,
    vit_small_dinov2,
)
from cerebra_torch.models.xcit import XCIT_CONSTRUCTORS, import_xcit_torch

_DINO_BASE = "https://dl.fbaipublicfiles.com/dino/"
_RANDOM = "There is no reference weights available for this model => We use random weights."

# (model_name, patch_size) → backbone weight URL, utils/utils.py:85-104. A
# patch_size of None matches on the name alone: the reference's elif-chain
# ignores patch_size for the xcit and resnet50 rows.
PRETRAINED_URLS: Dict[Tuple[str, Optional[int]], str] = {
    ("vit_small", 16): _DINO_BASE + "dino_deitsmall16_pretrain/dino_deitsmall16_pretrain.pth",
    ("vit_small", 8): _DINO_BASE + "dino_deitsmall8_pretrain/dino_deitsmall8_pretrain.pth",
    ("vit_base", 16): _DINO_BASE + "dino_vitbase16_pretrain/dino_vitbase16_pretrain.pth",
    ("vit_base", 8): _DINO_BASE + "dino_vitbase8_pretrain/dino_vitbase8_pretrain.pth",
    ("resnet50", None): _DINO_BASE + "dino_resnet50_pretrain/dino_resnet50_pretrain.pth",
    ("xcit_small_12_p16", None): _DINO_BASE + "dino_xcit_small_12_p16_pretrain/dino_xcit_small_12_p16_pretrain.pth",
    ("xcit_small_12_p8", None): _DINO_BASE + "dino_xcit_small_12_p8_pretrain/dino_xcit_small_12_p8_pretrain.pth",
    ("xcit_medium_24_p16", None): _DINO_BASE + "dino_xcit_medium_24_p16_pretrain/dino_xcit_medium_24_p16_pretrain.pth",
    ("xcit_medium_24_p8", None): _DINO_BASE + "dino_xcit_medium_24_p8_pretrain/dino_xcit_medium_24_p8_pretrain.pth",
}

# (model_name, patch_size) → linear-probe weight URL, utils/utils.py:113-124
LINEAR_URLS: Dict[Tuple[str, Optional[int]], str] = {
    ("vit_small", 16): _DINO_BASE + "dino_deitsmall16_pretrain/dino_deitsmall16_linearweights.pth",
    ("vit_small", 8): _DINO_BASE + "dino_deitsmall8_pretrain/dino_deitsmall8_linearweights.pth",
    ("vit_base", 16): _DINO_BASE + "dino_vitbase16_pretrain/dino_vitbase16_linearweights.pth",
    ("vit_base", 8): _DINO_BASE + "dino_vitbase8_pretrain/dino_vitbase8_linearweights.pth",
    ("resnet50", None): _DINO_BASE + "dino_resnet50_pretrain/dino_resnet50_linearweights.pth",
}

# the DINOv2 teacher (LstmDistillFromDinoV2Train.py:144-146's torch.hub call)
DINOV2_URLS: Dict[str, str] = {
    "dinov2_vits14": "https://dl.fbaipublicfiles.com/dinov2/dinov2_vits14/dinov2_vits14_pretrain.pth",
}


def _url_for(model_name: str, patch_size: int) -> Optional[str]:
    """utils/utils.py:85-104: the exact (name, patch) rows first, then the
    name-only rows."""
    return PRETRAINED_URLS.get((model_name, patch_size), PRETRAINED_URLS.get((model_name, None)))


def _cached_file(url: str) -> Optional[str]:
    """The local file of a hub URL: CEREBRA_HUB_CACHE/<basename>, else
    torch.hub.get_dir()/checkpoints/<basename>, else None."""
    name = url.rsplit("/", 1)[-1]
    candidates = []
    cache = os.environ.get("CEREBRA_HUB_CACHE")
    if cache:
        candidates.append(os.path.join(cache, name))
    candidates.append(os.path.join(torch.hub.get_dir(), "checkpoints", name))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def _fetch_state_dict(url: str):
    """A hub URL's state dict from its local file, or None."""
    path = _cached_file(url)
    if path is None:
        return None
    return torch.load(path, map_location="cpu", weights_only=False)


def _finish(model: torch.nn.Module, sd) -> torch.nn.Module:
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return model.eval()


def _build_vit(arch: str, patch_size: int, img_size: int, pretrained: bool, seed: int):
    ctor = {"vit_small": vit_small, "vit_base": vit_base}[arch]
    model = ctor(patch_size=patch_size, img_size=img_size,
                 generator=torch.Generator().manual_seed(seed))
    sd = _fetch_state_dict(PRETRAINED_URLS[(arch, patch_size)]) if pretrained else None
    if pretrained and sd is None:
        print(_RANDOM)  # utils/utils.py:109
    return _finish(model, None if sd is None else import_vit_torch(sd, depth=12))


def dino_vits16(pretrained: bool = True, img_size: int = 224, seed: int = 0):
    """ViT-Small/16 DINO (74.5% ImageNet k-NN, dino/hubconf.py:22-33)."""
    return _build_vit("vit_small", 16, img_size, pretrained, seed)


def dino_vits8(pretrained: bool = True, img_size: int = 224, seed: int = 0):
    """ViT-Small/8 DINO (78.3% ImageNet k-NN, dino/hubconf.py:36-48)."""
    return _build_vit("vit_small", 8, img_size, pretrained, seed)


def dino_vitb16(pretrained: bool = True, img_size: int = 224, seed: int = 0):
    """ViT-Base/16 DINO (76.1% ImageNet k-NN, dino/hubconf.py:51-64)."""
    return _build_vit("vit_base", 16, img_size, pretrained, seed)


def dino_vitb8(pretrained: bool = True, img_size: int = 224, seed: int = 0):
    """ViT-Base/8 DINO (77.4% ImageNet k-NN, dino/hubconf.py:67-80)."""
    return _build_vit("vit_base", 8, img_size, pretrained, seed)


def dino_resnet50(pretrained: bool = True, seed: int = 0):
    """ResNet-50 DINO, fc stripped (75.3% linear, dino/hubconf.py:83-97)."""
    model = resnet50(num_classes=0, generator=torch.Generator().manual_seed(seed))
    sd = _fetch_state_dict(PRETRAINED_URLS[("resnet50", None)]) if pretrained else None
    if pretrained and sd is None:
        print(_RANDOM)
    return _finish(model, None if sd is None else import_torchvision_resnet50(sd, num_classes=0))


def _build_xcit(name: str, pretrained: bool, seed: int):
    """dino_xcit_* (dino/hubconf.py:98-151), models/xcit.py."""
    model = XCIT_CONSTRUCTORS[name](generator=torch.Generator().manual_seed(seed))
    sd = _fetch_state_dict(PRETRAINED_URLS[(name, None)]) if pretrained else None
    if pretrained and sd is None:
        print(_RANDOM)
    if sd is not None:
        sd = import_xcit_torch(sd, depth=model.depth, patch_size=model.patch_size,
                               cls_attn_layers=model.cls_attn_layers)
    return _finish(model, sd)


def dino_xcit_small_12_p16(pretrained: bool = True, img_size: int = 224, seed: int = 0):
    """XCiT-S12/16 DINO (dino/hubconf.py:98-110). The grid follows the input,
    so `img_size` only keeps the JAX signature."""
    return _build_xcit("xcit_small_12_p16", pretrained, seed)


def dino_xcit_small_12_p8(pretrained: bool = True, img_size: int = 224, seed: int = 0):
    """XCiT-S12/8 DINO (dino/hubconf.py:112-124)."""
    return _build_xcit("xcit_small_12_p8", pretrained, seed)


def dino_xcit_medium_24_p16(pretrained: bool = True, img_size: int = 224, seed: int = 0):
    """XCiT-M24/16 DINO (dino/hubconf.py:126-138)."""
    return _build_xcit("xcit_medium_24_p16", pretrained, seed)


def dino_xcit_medium_24_p8(pretrained: bool = True, img_size: int = 224, seed: int = 0):
    """XCiT-M24/8 DINO (dino/hubconf.py:140-151)."""
    return _build_xcit("xcit_medium_24_p8", pretrained, seed)


def dinov2_vits14(pretrained: bool = True, img_size: int = 518, seed: int = 0):
    """DINOv2 ViT-S/14, the reference's frozen distillation teacher
    (LstmDistillFromDinoV2Train.py:144-146)."""
    model = vit_small_dinov2(img_size=img_size, generator=torch.Generator().manual_seed(seed))
    sd = _fetch_state_dict(DINOV2_URLS["dinov2_vits14"]) if pretrained else None
    if pretrained and sd is None:
        print(_RANDOM)
    return _finish(model, None if sd is None else import_dinov2_vit_torch(sd, depth=12))


HUB: Dict[str, Callable] = {
    "dino_vits16": dino_vits16,
    "dino_vits8": dino_vits8,
    "dino_vitb16": dino_vitb16,
    "dino_vitb8": dino_vitb8,
    "dino_resnet50": dino_resnet50,
    "dino_xcit_small_12_p16": dino_xcit_small_12_p16,
    "dino_xcit_small_12_p8": dino_xcit_small_12_p8,
    "dino_xcit_medium_24_p16": dino_xcit_medium_24_p16,
    "dino_xcit_medium_24_p8": dino_xcit_medium_24_p8,
    "dinov2_vits14": dinov2_vits14,
}


def load(name: str, **kw):
    """`torch.hub.load("facebookresearch/dino", name)`: the constructor by name."""
    if name not in HUB:
        raise ValueError(f"unknown hub model {name!r}; available: {sorted(HUB)}")
    return HUB[name](**kw)


def load_pretrained_weights(model_name: str, patch_size: int, pretrained_weights: str = "",
                            checkpoint_key: Optional[str] = "teacher", depth: int = 12):
    """utils/utils.py:71-109. Returns the state dict to load, or None for the
    final "random weights" branch (callers keep their init): for vit_* and
    xcit_* the port's state dict of that family, for any other name the raw
    torch state dict.

    1. `pretrained_weights` names a local file: torch.load, select
       `checkpoint_key` if present, drop `head.`, strip prefixes, import.
    2. else the (model_name, patch_size) URL table, from local files only."""
    def _import(sd):
        if model_name.startswith("vit_"):
            return import_vit_torch(sd, depth=depth)
        if model_name.startswith("xcit_"):
            m = XCIT_CONSTRUCTORS[model_name]()
            return import_xcit_torch(sd, depth=m.depth, patch_size=m.patch_size,
                                     cls_attn_layers=m.cls_attn_layers)
        print(f"{model_name} has no importer here; returning the raw torch state dict "
              "for the caller's own importer.")
        return sd

    if pretrained_weights and os.path.isfile(pretrained_weights):
        sd = torch.load(pretrained_weights, map_location="cpu", weights_only=False)
        if checkpoint_key is not None and checkpoint_key in sd:
            print(f"Take key {checkpoint_key} in provided checkpoint dict")
            sd = sd[checkpoint_key]
        sd = {k: v for k, v in sd.items() if not k.startswith(("head.", "module.head."))}
        out = _import(sd)
        print(f"Pretrained weights found at {pretrained_weights} and loaded")
        return out
    print("Please use the `--pretrained_weights` argument to indicate the path of the "
          "checkpoint to evaluate.")
    url = _url_for(model_name, patch_size)
    sd = _fetch_state_dict(url) if url else None
    if sd is not None:
        print("Since no pretrained weights have been provided, we load the reference "
              "pretrained DINO weights.")
        return _import(sd)
    print(_RANDOM)
    return None


def load_pretrained_linear_weights(model_name: str, patch_size: int):
    """utils/utils.py:112-129 → {"weight": (out, in), "bias": (out,)} for an
    nn.Linear probe, or None ("random linear weights")."""
    url = LINEAR_URLS.get((model_name, patch_size), LINEAR_URLS.get((model_name, None)))
    sd = _fetch_state_dict(url) if url else None
    if sd is None:
        print("We use random linear weights.")
        return None
    sd = sd["state_dict"]  # utils/utils.py:127
    print("We load the reference pretrained linear weights.")
    return {"weight": torch.as_tensor(sd["module.linear.weight"]).float(),
            "bias": torch.as_tensor(sd["module.linear.bias"]).float()}
