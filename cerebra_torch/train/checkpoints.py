"""Reference `.pth` checkpoints of the DINO recipes (port of the `.pth` half
of cerebra/train/checkpoints.py; the orbax half has no counterpart: the
port's auto-resume writes `torch.save` files, `train/resume.py`).

The reference saves student/teacher/optimizer/epoch/args/dino_loss
(LstmDistillation.py:634-646, dino/main_dino.py:297-309) under the
MultiCropWrapper names `backbone.*`, `head.mlp.{0,2,4}.*` and
`head.last_layer.weight_{g,v}`, the student with DDP's `module.` prefix.
The port's modules hold those names already, so the weights map one to one;
the optimizer slot is a torch AdamW state dict whose ids are positions in
the reference student's parameter registration order (weight_g before
weight_v), grouped as its get_params_groups does, which the port's own
optimizer order is not: ids are mapped by name, in the JAX package's order.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cerebra_torch.models.lstm import strip_prefixes

_LSTM_KIND_ORDER = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
_FROZEN_GAIN = "head.last_layer.weight_g"
_TORCH_ADAMW_GROUP_DEFAULTS = dict(
    lr=0.0005, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.04, amsgrad=False,
    maximize=False, foreach=None, capturable=False, differentiable=False, fused=None,
)


def wrapped_to_torch_state_dict(model: nn.Module, ddp_module_prefix: bool = False
                                ) -> Dict[str, torch.Tensor]:
    """A MultiCropWrapper(backbone, head) → the reference state dict (f32 CPU
    copies), with DDP's `module.` prefix when asked (the reference student
    is DDP-wrapped)."""
    pre = "module." if ddp_module_prefix else ""
    return {pre + k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()}


def torch_state_dict_to_wrapped(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Inverse: `module.` stripped, the `backbone.*` and `head.*` entries as
    f32 tensors, ready for the port's MultiCropWrapper.load_state_dict."""
    return {k: v for k, v in strip_prefixes(sd, ("module.",)).items()
            if k.startswith(("backbone.", "head."))}


def _registration_order(keys) -> list:
    """State-dict keys in nn.Module parameter registration order for the
    reference student MultiCropWrapper(backbone=Model, head=DINOHead)
    (utils/utils.py:607-612; cerebra/train/checkpoints.py:150-179): torch
    optimizer ids are positions in this order, not dict order."""

    def rank(k):
        if k.startswith("backbone.lstm."):
            kind, layer = k[len("backbone.lstm."):].rsplit("_l", 1)
            return (0, int(layer), _LSTM_KIND_ORDER.index(kind), k)
        if k.startswith("backbone.fc."):
            return (1, 0, 0 if k.endswith(".weight") else 1, k)
        if k.startswith("backbone.head."):
            return (2, 0, 0 if k.endswith(".weight") else 1, k)
        if k.startswith("head.mlp."):
            return (3, int(k.split(".")[2]), 0 if k.endswith(".weight") else 1, k)
        if k == _FROZEN_GAIN:  # weight_norm registers g, then v
            return (4, 0, 0, k)
        if k == "head.last_layer.weight_v":
            return (4, 0, 1, k)
        return (5, 0, 0, k)

    return sorted(keys, key=rank)


def _grouped_param_names(shapes: Mapping[str, tuple], frozen_gain: bool = True) -> list:
    """The reference get_params_groups (utils/utils.py:636-647): group 0 the
    regularized parameters, group 1 biases and 1-D ones, by their shapes in
    the `.pth` layout (the gain is (out, 1) there); ids enumerate group 0,
    then group 1. `frozen_gain` leaves out the weight-norm gain, which
    norm_last_layer=True freezes and get_params_groups skips."""
    ordered = _registration_order(shapes)
    if frozen_gain:
        ordered = [k for k in ordered if k != _FROZEN_GAIN]

    def plain(k):
        return k.endswith(".bias") or len(shapes[k]) == 1

    return [[k for k in ordered if not plain(k)], [k for k in ordered if plain(k)]]


def adamw_state_to_torch(optimizer, model: nn.Module, lr: float = 0.0005,
                         weight_decay: float = 0.04, norm_last_layer: bool = True) -> dict:
    """The port's AdamW moments (`ScheduledAdamW` over `model`) → the
    `torch.optim.AdamW.state_dict()` of the reference student
    (cerebra/train/checkpoints.py:251-288): ids in the reference's two
    groups, each entry's step the optimizer's count (optax keeps one),
    moments of a parameter without state zero."""
    named = dict(model.named_parameters())
    shapes = {k: tuple(p.shape) for k, p in named.items()}
    step = float(optimizer.count)
    state, param_groups, next_id = {}, [], 0
    for gi, names in enumerate(_grouped_param_names(shapes, frozen_gain=norm_last_layer)):
        ids = []
        for k in names:
            p = named[k]
            st = optimizer.inner.state.get(p, {})
            state[next_id] = {
                "step": torch.tensor(step),
                "exp_avg": st.get("exp_avg", torch.zeros_like(p)).detach().float().cpu().clone(),
                "exp_avg_sq": st.get("exp_avg_sq",
                                     torch.zeros_like(p)).detach().float().cpu().clone(),
            }
            ids.append(next_id)
            next_id += 1
        g = dict(_TORCH_ADAMW_GROUP_DEFAULTS, lr=lr,
                 weight_decay=weight_decay if gi == 0 else 0.0, params=ids)
        param_groups.append(g)
    return {"state": state, "param_groups": param_groups}


def adamw_state_from_torch(opt_sd: Mapping, optimizer, model: nn.Module) -> int:
    """Inverse (cerebra/train/checkpoints.py:291-346): a reference torch
    AdamW state dict → the port's `ScheduledAdamW` over `model`, moments
    by name. Tolerates what reference runs write: the frozen gain absent
    from the ids (found by the id count), and lazy state (a parameter whose
    gradient was cancelled since the start has an id and no entry: it keeps
    zero moments). Every parameter's step, and the optimizer's count that
    indexes the schedules, is the largest step among the entries (optax
    keeps one count). → that step."""
    named = dict(model.named_parameters())
    shapes = {k: tuple(p.shape) for k, p in named.items()}
    ids = [i for g in opt_sd["param_groups"] for i in g["params"]]
    flat = None
    for frozen_gain in (True, False):
        names = [k for g in _grouped_param_names(shapes, frozen_gain) for k in g]
        if len(names) == len(ids):
            flat = names
            break
    if flat is None:
        n_all = sum(map(len, _grouped_param_names(shapes, False)))
        raise ValueError(f"optimizer state has {len(ids)} params; expected {n_all} (or one "
                         f"fewer with a frozen weight-norm gain)")
    entries = [(named[k], opt_sd["state"].get(pid)) for k, pid in zip(flat, ids)]
    steps = [float(np.asarray(e["step"])) for _, e in entries if e is not None]
    step = max(steps) if steps else float(optimizer.count)
    trained = {id(p) for p in optimizer.params}
    for p in optimizer.params:  # lazy or absent entries: zero moments
        optimizer.inner.state[p] = {"step": torch.tensor(step),
                                    "exp_avg": torch.zeros_like(p),
                                    "exp_avg_sq": torch.zeros_like(p)}
    for p, e in entries:
        if e is None or id(p) not in trained:
            continue
        st = optimizer.inner.state[p]
        st["exp_avg"] = torch.as_tensor(e["exp_avg"]).to(p.device, p.dtype).clone()
        st["exp_avg_sq"] = torch.as_tensor(e["exp_avg_sq"]).to(p.device, p.dtype).clone()
    optimizer.count = int(step)
    return int(step)


def export_dino_pth(path: str, student: nn.Module, teacher: nn.Module, center: torch.Tensor,
                    epoch: int, args: Optional[dict] = None, optimizer=None, lr: float = 0.0005,
                    weight_decay: float = 0.04, norm_last_layer: bool = True) -> None:
    """Write the LstmDistillation.py:634-646 checkpoint (port of
    cerebra/train/checkpoints.py:349-386): a torch AdamW "optimizer" slot
    when `optimizer` is given (`norm_last_layer` as the run's flag, so the
    frozen gain is left out of the ids as the reference does), epoch + 1."""
    payload = {
        "student": wrapped_to_torch_state_dict(student, ddp_module_prefix=True),
        "teacher": wrapped_to_torch_state_dict(teacher),
        "optimizer": (adamw_state_to_torch(optimizer, student, lr, weight_decay,
                                           norm_last_layer) if optimizer is not None else {}),
        "epoch": int(epoch) + 1,
        "args": args or {},
        "dino_loss": {"center": center.detach().float().cpu().clone()},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def import_dino_pth(path: str, student: Optional[nn.Module] = None,
                    teacher: Optional[nn.Module] = None, optimizer=None
                    ) -> Tuple[Dict, Dict, torch.Tensor, int]:
    """Read a reference-layout checkpoint (port of
    cerebra/train/checkpoints.py:389-411) → (student state dict, teacher
    state dict, center, epoch). Loads the weights into `student` and
    `teacher` when given (strictly), and with `optimizer` (a
    `ScheduledAdamW` over `student`) restores the "optimizer" slot's AdamW
    moments (`adamw_state_from_torch`), the restart_from_checkpoint
    contract (utils/utils.py:152-184)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    student_sd = torch_state_dict_to_wrapped(ckpt["student"])
    teacher_sd = torch_state_dict_to_wrapped(ckpt["teacher"])
    center = torch.as_tensor(np.asarray(ckpt.get("dino_loss", {}).get("center", np.zeros((1, 1))),
                                        dtype=np.float32))
    epoch = int(ckpt.get("epoch", 0))
    if student is not None:
        student.load_state_dict(student_sd, strict=True)
    if teacher is not None:
        teacher.load_state_dict(teacher_sd, strict=True)
    if optimizer is not None and ckpt.get("optimizer"):
        adamw_state_from_torch(ckpt["optimizer"], optimizer, student)
    return student_sd, teacher_sd, center, epoch
