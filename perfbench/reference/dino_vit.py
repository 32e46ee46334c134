"""The DINO ViT step, plainly (dino/main_dino.py:273-309, as the
CerebralSignalNetworks fork runs it): EEG-image views at the window starts
drawn for the step, the EMA teacher on the two global views, the student on
all six with stochastic depth from the masks drawn for the step, DINOHead,
the centred multi-crop cross-entropy, the last-layer cancel in the first
epochs, the per-parameter clip, AdamW on the cosine schedules, the EMA of
the teacher and of the center.

Every draw comes in as data. `draws` holds, for each step, "starts"
(global (n_global, B), local (n_local, B)) and "masks": for each group
(global, local), a list over the blocks of None (no drop) or the pair
(attention, MLP) of bool keep masks (n_views, B).

The loss is a mean over samples, so the student runs in chunks of
`chunk` samples, each chunk's gradient weighted by its share and summed;
the teacher runs over the whole batch first, since the center takes all of
its outputs. `run` returns tensors (the CPU tests compare them whole),
`follow` the norms that `perfbench/compare.py` compares."""

import torch

from perfbench.reference import exact_f32, nets
from perfbench.reference.dino import schedules
from perfbench.reference.losses import dino_multicrop
from perfbench.reference.optim import adamw, clip_each, ema
from perfbench.reference.precision import ROUNDINGS
from perfbench.reference.vit import eeg_images, vit_cls


def _chunk_masks(masks, rows: slice):
    """The blocks' masks of a group for the samples `rows`, view by view
    (the images' order)."""
    return [None if m is None else tuple(h[:, rows].reshape(-1) for h in m) for m in masks]


def _half(draw: dict, B: int) -> dict:
    """The draws of the first B samples."""
    return {"starts": [s[:, :B] for s in draw["starts"]],
            "masks": [[None if m is None else tuple(h[:, :B] for h in m) for m in group]
                      for group in draw["masks"]]}


def run(cfg: dict, params0: dict, batches, steps, draws, niter: int, chunk: int,
        rounding: str = "f32", half: bool = False, frozen: bool = False) -> dict:
    """batches: the batch (B, T, C) of each step, steps their indices in the
    schedules, draws each step's draws (module docstring). Student and
    teacher start from `params0`, the center from zeros; the weight-norm
    gains stay fixed. With `half` each step trains on the first half of its
    samples; with `frozen` each step leaves the state as it was. → the
    losses, each step's gradient norms before the clip, the first step's
    gradients before the clip, and the student, teacher and center after
    the steps."""
    q = ROUNDINGS[rounding]
    sizes = (cfg["global_size"], cfg["local_size"])
    lr, wd, mom, temps = schedules(cfg, batches[0].shape[0], niter)

    def features(p, images, masks=None):
        return vit_cls(images, p, "backbone.", cfg, masks, q)

    def project(p, feats):
        return nets.dino_head(feats, p, "head.", cfg["head_nlayers"], q)

    with exact_f32():
        trained = [k for k in params0 if not k.endswith("weight_g")]
        student = {k: v.detach().clone().float().requires_grad_(k in trained)
                   for k, v in params0.items()}
        teacher = {k: v.detach().clone().float() for k, v in params0.items()}
        center = torch.zeros(1, cfg["out_dim"], device=batches[0].device)
        decayed = {k for k in trained if params0[k].dim() > 1}
        state, losses, grad_steps, first = {}, [], [], None
        for t, (eeg, it, draw) in enumerate(zip(batches, steps, draws), start=1):
            if half:
                eeg = eeg[:eeg.shape[0] // 2]
                draw = _half(draw, eeg.shape[0])
            B, epoch = eeg.shape[0], it // niter
            eeg = eeg.float()
            n_teacher = draw["starts"][0].shape[0]
            with torch.no_grad():
                t_out = torch.cat([
                    project(teacher, features(teacher, eeg_images(
                        eeg[b:b + chunk], draw["starts"][0][:, b:b + chunk], sizes[0]))).reshape(
                        n_teacher, -1, cfg["out_dim"])
                    for b in range(0, B, chunk)], 1)
            grads = {k: torch.zeros_like(student[k]) for k in trained}
            loss = 0.0
            for b in range(0, B, chunk):
                rows = slice(b, b + chunk)
                feats = torch.cat([
                    features(student, eeg_images(eeg[rows], starts[:, rows], size),
                             _chunk_masks(masks, rows))
                    for starts, size, masks in zip(draw["starts"], sizes, draw["masks"])])
                c = min(chunk, B - b)
                s_out = project(student, feats).reshape(-1, c, cfg["out_dim"])
                part, _ = dino_multicrop(s_out, t_out[:, rows], center, float(temps[epoch]),
                                         cfg["student_temp"], cfg["center_momentum"])
                part = part * (c / B)
                for k, g in zip(trained, torch.autograd.grad(part, [student[k] for k in trained])):
                    grads[k] += g
                loss += float(part.detach())
            if epoch < cfg["freeze_last_layer"]:
                for k in grads:
                    if "last_layer" in k.split("."):
                        grads[k].zero_()
            losses.append(loss)
            grad_steps.append({k: 0.0 if frozen else float(g.norm()) for k, g in grads.items()})
            if first is None:
                first = {k: torch.zeros_like(g) if frozen else g.clone() for k, g in grads.items()}
            clip_each(grads, cfg["clip_grad"])
            if not frozen:
                adamw(student, grads, state, t, float(lr[it]), float(wd[it]), decayed)
                ema(teacher, {k: v.detach() for k, v in student.items()}, float(mom[it]))
                m = cfg["center_momentum"]
                center = center * m + t_out.reshape(-1, cfg["out_dim"]).mean(0, keepdim=True) * (
                    1.0 - m)
        return {"losses": losses, "grad_steps": grad_steps, "grads": first,
                "student": {k: v.detach() for k, v in student.items()}, "teacher": teacher,
                "center": center}


def judged(name: str, change: torch.Tensor) -> torch.Tensor:
    """The part of a leaf's change that is compared: of a qkv bias, its q
    and v thirds only. The k third's gradient is 0 in exact arithmetic (it
    adds one constant to all of a query's scores, which the softmax takes
    out), so AdamW's update there is each side's rounding noise scaled up
    to the step size, not a result of the step."""
    if name.endswith("attn.qkv.bias"):
        D = change.shape[0] // 3
        return torch.cat([change[:D], change[2 * D:]])
    return change


def change_norm(name: str, new: torch.Tensor, old: torch.Tensor) -> float:
    """The norm of the judged part of a leaf's change."""
    return float(judged(name, new.detach().float() - old.float()).norm())


def follow(cfg: dict, params0: dict, batches, steps, draws, niter: int, chunk: int,
           rounding: str = "f32", half: bool = False, frozen: bool = False) -> dict:
    """`run`'s steps as `compare.gaps` reads them: each leaf's first gradient
    before the clip, its largest over the steps, its change and the
    teacher's over the steps (`change_norm`), and the center's norm."""
    out = run(cfg, params0, batches, steps, draws, niter, chunk, rounding, half, frozen)
    trained = list(out["grads"])
    return {"losses": out["losses"], "grad_norms": out["grad_steps"][0],
            "grad_max": {k: max(s[k] for s in out["grad_steps"]) for k in trained},
            "update_norms": {k: change_norm(k, out["student"][k], params0[k]) for k in trained},
            "teacher_norms": {k: change_norm(k, out["teacher"][k], params0[k]) for k in trained},
            "center_norm": float(out["center"].norm())}
