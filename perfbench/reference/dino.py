"""The DINO-LSTM step, plainly (LstmDistillation.py:526-651): temporal
multi-crop views drawn from (seed, step), the EMA teacher on the global
views, the student on all of them, the multi-crop cross-entropy with its
center, the last-layer cancel in the first epochs, the per-parameter clip,
AdamW on the cosine schedules, the EMA of the teacher and of the center.
`follow` takes the steps the program took first, on the global batch (with
data parallelism, the ranks' rows in rank order), and returns what
`perfbench/compare.py` compares."""

import numpy as np
import torch

from perfbench.reference import exact_f32, nets
from perfbench.reference.losses import dino_multicrop
from perfbench.reference.optim import adamw, clip_each, cosine, ema, teacher_temps
from perfbench.reference.precision import ROUNDINGS


def crop_starts(seed: int, step: int, T: int, cfg: dict):
    """The views' starts of one step: a CPU torch.Generator seeded from
    SeedSequence([seed, step]); each start drawn in [0, T) and moved back by
    its overflow past T (LstmDistillation.py:555-560), globals first."""
    gen = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    out = []
    for n, length in ((cfg["n_global"], cfg["global_length"]),
                      (cfg["n_local"], cfg["local_length"])):
        s = torch.randint(0, T, (n,), generator=gen)
        out.append((s - torch.clamp(s + length - T, min=0)).tolist())
    return out


def schedules(cfg: dict, global_batch: int, niter: int):
    e = cfg["epochs"]
    return (cosine(cfg["lr"] * global_batch / 256.0, cfg["min_lr"], e, niter,
                   min(cfg["warmup_epochs"], e)),
            cosine(cfg["weight_decay"], cfg["weight_decay_end"], e, niter),
            cosine(cfg["momentum_teacher"], 1.0, e, niter),
            teacher_temps(cfg["warmup_teacher_temp"], cfg["teacher_temp"],
                          cfg["warmup_teacher_temp_epochs"], e))


def _views(eeg, starts, length):
    return torch.stack([eeg[:, s:s + length] for s in starts])


def follow(cfg: dict, params0: dict, batches, steps, seed: int, niter: int,
           rounding: str = "f32", half: bool = False, frozen: bool = False) -> dict:
    """batches: the global batch (B, T, C) of each step, steps their
    indices in the schedules. Student and teacher start from `params0`,
    the center from zeros; the weight-norm gains stay fixed. `half` and
    `frozen` are the faults of `feature_distill.follow`."""
    q = ROUNDINGS[rounding]
    L, nl = cfg["lstm_layers"], cfg["head_nlayers"]
    lr, wd, mom, temps = schedules(cfg, batches[0].shape[0], niter)

    def encode(p, prefix, group):
        n, B = group.shape[:2]
        return nets.lstm_last(group.reshape(n * B, *group.shape[2:]), p, f"{prefix}lstm.", L, q)

    def project(p, feats):
        return nets.dino_head(feats, p, "head.", nl, q)

    with exact_f32():
        trained = [k for k in params0 if not k.endswith("weight_g")]
        student = {k: v.detach().clone().float().requires_grad_(k in trained)
                   for k, v in params0.items()}
        teacher = {k: v.detach().clone().float() for k, v in params0.items()}
        center = torch.zeros(1, cfg["out_dim"], device=batches[0].device)
        decayed = {k for k in trained if params0[k].dim() > 1}
        state, losses, grad_steps = {}, [], []
        for t, (eeg, it) in enumerate(zip(batches, steps), start=1):
            if half:
                eeg = eeg[:eeg.shape[0] // 2]
            B = eeg.shape[0]
            g_starts, l_starts = crop_starts(seed, it, eeg.shape[1], cfg)
            g = _views(eeg.float(), g_starts, cfg["global_length"])
            loc = _views(eeg.float(), l_starts, cfg["local_length"])
            with torch.no_grad():
                t_out = project(teacher, encode(teacher, "backbone.", g)).reshape(len(g_starts), B, -1)
            s_out = project(student, torch.cat([encode(student, "backbone.", g),
                                                encode(student, "backbone.", loc)]))
            s_out = s_out.reshape(len(g_starts) + len(l_starts), B, -1)
            epoch = it // niter
            loss, new_center = dino_multicrop(s_out, t_out, center, float(temps[epoch]),
                                              cfg["student_temp"], cfg["center_momentum"])
            grads = dict(zip(trained, torch.autograd.grad(loss, [student[k] for k in trained])))
            if epoch < cfg["freeze_last_layer"]:
                for k in grads:
                    if "last_layer" in k.split("."):
                        grads[k].zero_()
            clip_each(grads, cfg["clip_grad"])
            losses.append(float(loss.detach()))
            grad_steps.append({k: 0.0 if frozen else float(v.norm()) for k, v in grads.items()})
            if not frozen:
                adamw(student, grads, state, t, float(lr[it]), float(wd[it]), decayed)
                ema(teacher, {k: v.detach() for k, v in student.items()}, float(mom[it]))
                center = new_center
        return {"losses": losses, "grad_norms": grad_steps[0],
                "grad_max": {k: max(s[k] for s in grad_steps) for k in trained},
                "update_norms": {k: float((student[k].detach() - params0[k].float()).norm())
                                 for k in trained},
                "teacher_norms": {k: float((teacher[k] - params0[k].float()).norm())
                                  for k in trained},
                "center_norm": float(center.norm())}
