"""The LSTM→DINOv2 training step of `bench.py` and the train CLI: a batch
of raw (C, T_raw) windows gathered on the device in the recipe's epoch
order, the zero-phase band-pass `filtfilt_matmul`, the crop to [time_low,
time_high), then `train/steps.py::feature_distill_step` (the student, the
recipe's loss at the epoch's teacher temperature, the optimizer)."""

import numpy as np
import torch

from perfbench import counts, feed
from perfbench.reference import feature_distill as plain
from perfbench.trace import span


class Run:
    def __init__(self, cell: dict, cfg: dict, seed: int, device: torch.device):
        from cerebra_torch.losses import teacher_temp_schedule
        from cerebra_torch.models.lstm import Model
        from cerebra_torch.signal.filters import design_bandpass, filtfilt_matmul, zero_phase_matrix
        from cerebra_torch.train.optim import make_optimizer
        from cerebra_torch.train.recipes import FeatureDistillConfig, distill_loss
        from cerebra_torch.train.steps import feature_distill_step

        self.cfg, self.seed = cfg, seed
        B, N = cell["batch"], cell["corpus_trials"]
        if N % B:
            raise ValueError(f"corpus of {N} trials is not a whole number of batches of {B}")
        C, H, L = cfg["input_size"], cfg["lstm_size"], cfg["lstm_layers"]
        F, K, T_raw = cfg["output_size"], cfg["n_classes"], cfg["raw_samples"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.batch, self.steps_per_epoch = B, N // B
        self.counts = counts.feature_distill(cfg, B)

        gen = torch.Generator(device=device).manual_seed(seed)
        specs = (feed.lstm_specs("lstm.", C, H, L) + feed.linear_specs("fc", H, F)
                 + feed.linear_specs("head", F, K))
        self.params0 = feed.draw_params(specs, gen, device)
        self.raw = torch.randn(N, C, T_raw, generator=gen, device=device)
        self.teacher = torch.randn(N, F, generator=gen, device=device)
        self.labels = torch.randint(0, K, (N,), generator=gen, device=device)
        self.order = feed.order_table(seed, range(cfg["num_epochs"]), N, B, device)

        self.model = Model(C, H, L, F, include_top=True, n_classes=K, dtype=self.dtype,
                           device=device)
        feed.load_params(self.model, self.params0)
        self.opt = make_optimizer(cfg["optimizer"], self.model.parameters(), cfg["learning_rate"])
        recipe = FeatureDistillConfig(
            num_epochs=cfg["num_epochs"], batch_size=B, learning_rate=cfg["learning_rate"],
            optimizer=cfg["optimizer"], lstm_size=H, lstm_layers=L, loss=cfg["loss"],
            alpha=cfg["alpha"], beta=cfg["beta"], warmup_teacher_temp=cfg["warmup_teacher_temp"],
            teacher_temp=cfg["teacher_temp"],
            warmup_teacher_temp_epochs=cfg["warmup_teacher_temp_epochs"], dtype=self.dtype)
        temps = teacher_temp_schedule(cfg["warmup_teacher_temp"], cfg["teacher_temp"],
                                      cfg["warmup_teacher_temp_epochs"], cfg["num_epochs"])
        self.loss_fn = distill_loss(recipe, temps.astype(np.float32))
        self.fir = zero_phase_matrix(design_bandpass(*cfg["band"], fs=cfg["fs"],
                                                     order=cfg["filter_order"]),
                                     T_raw, num_taps=cfg["num_taps"], dtype=self.dtype,
                                     device=device)
        self.filter, self.train_step = filtfilt_matmul, feature_distill_step
        self.k = 0

    def epoch(self, k: int) -> int:
        """The epoch of step k; past the recipe's last epoch the schedule
        and the order start again."""
        return (k // self.steps_per_epoch) % self.cfg["num_epochs"]

    def gather(self, k: int):
        idx = self.order[k % len(self.order)]
        return self.raw[idx], self.teacher[idx], self.labels[idx]

    def step(self) -> torch.Tensor:
        k, self.k = self.k, self.k + 1
        with span("perfbench.gather"):
            raw, feats, labels = self.gather(k)
        with span("perfbench.filter"):
            x = self.filter(self.fir, raw, out_dtype=self.dtype)
        eeg = x.transpose(1, 2)[:, self.cfg["time_low"]:self.cfg["time_high"], :]
        with span("perfbench.step"):
            return self.train_step(self.model, self.opt, self.loss_fn, eeg, feats, labels,
                                   self.epoch(k))

    def first_steps(self, n: int) -> None:
        alpha = self.opt.param_groups[0]["alpha"]
        named = list(self.model.named_parameters())
        losses, grads = [], None
        for i in range(n):
            losses.append(self.step())
            if i == 0:  # RMSprop's first square average is (1 − alpha)·g²
                grads = [self.opt.state[p]["square_avg"].sum() / (1 - alpha)
                         if p in self.opt.state else torch.zeros((), device=p.device)
                         for _, p in named]
        self.n_first = n
        self.readings = {
            "losses": torch.stack(losses).float().tolist(),
            "grad_norms": {k: float(v) ** 0.5 for (k, _), v in zip(named, torch.stack(grads).tolist())},
            "update_norms": {k: float((p.detach() - self.params0[k]).norm()) for k, p in named}}

    def free(self) -> None:
        del self.model, self.opt, self.loss_fn, self.fir

    def reference(self, rounding: str = "f32", half: bool = False, frozen: bool = False) -> dict:
        ks = range(self.n_first)
        return plain.follow(self.cfg, self.params0, [self.gather(k) for k in ks],
                            [self.epoch(k) for k in ks], rounding, half, frozen)
