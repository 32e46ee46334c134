"""The LSTM→DINOv2 training step, plainly: band-pass by the FIR matrix,
crop, the student, FeatureDistributionLoss v1 at the epoch's teacher
temperature, RMSprop. `follow` takes the steps the program took first and
returns what `perfbench/compare.py` compares."""

import torch

from perfbench.reference import exact_f32, nets
from perfbench.reference.filter import fir_matrix
from perfbench.reference.losses import feature_distribution_v1
from perfbench.reference.optim import rmsprop, teacher_temps
from perfbench.reference.precision import ROUNDINGS, mm


def follow(cfg: dict, params0: dict, batches, epochs, rounding: str = "f32",
           half: bool = False, frozen: bool = False) -> dict:
    """batches: [(raw (B, C, T_raw), teacher features (B, F), labels (B,))]
    in step order, epochs the epoch of each. Two faults the comparison
    must catch: with `half` each step sees only the first half of its
    rows; with `frozen` each step leaves the state as it was (no update,
    and the optimizer never sees a gradient)."""
    q = ROUNDINGS[rounding]
    with exact_f32():
        W = fir_matrix(cfg, params0[next(iter(params0))].device)
        temps = teacher_temps(cfg["warmup_teacher_temp"], cfg["teacher_temp"],
                              cfg["warmup_teacher_temp_epochs"], cfg["num_epochs"])
        p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
        state, losses, grad_steps = {}, [], []
        for (raw, feats_t, labels), epoch in zip(batches, epochs):
            if half:
                n = raw.shape[0] // 2
                raw, feats_t, labels = raw[:n], feats_t[:n], labels[:n]
            eeg = mm(raw.float(), W, q).transpose(1, 2)[:, cfg["time_low"]:cfg["time_high"]]
            feats, logits = nets.distill_model(eeg, p, cfg["lstm_layers"], q)
            loss = feature_distribution_v1(feats, feats_t.float(), labels, logits,
                                           float(temps[epoch]), cfg["alpha"], cfg["beta"])
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            losses.append(float(loss.detach()))
            grad_steps.append({k: 0.0 if frozen else float(g.norm()) for k, g in grads.items()})
            if not frozen:
                rmsprop(p, grads, state, cfg["learning_rate"], cfg["rmsprop_alpha"],
                        cfg["rmsprop_eps"])
        return {"losses": losses, "grad_norms": grad_steps[0],
                "grad_max": {k: max(s[k] for s in grad_steps) for k in p},
                "update_norms": {k: float((p[k].detach() - params0[k].float()).norm())
                                 for k in p}}
