"""The DINO-LSTM step of `lstm_distillation` (`train/recipes.py::
make_dino_lstm`, `train/steps.py::make_dino_step`): a batch of (T, C)
trials gathered on the device in the recipe's epoch order, and the step
with the views of `step_generator(seed, step)`, as
`dino_selfdistill_train`'s loop body takes it."""

import torch

from perfbench import counts, feed
from perfbench.reference import dino as plain
from perfbench.trace import span


def head_specs(prefix: str, cfg: dict):
    dims = [cfg["embed_dim"]] + [cfg["head_hidden_dim"]] * (cfg["head_nlayers"] - 1) + [
        cfg["head_bottleneck_dim"]]
    specs = []
    for i, (a, b) in enumerate(zip(dims, dims[1:])):  # trunc_normal(0.02) at ±100σ: normal
        specs += [(f"{prefix}mlp.{2 * i}.weight", (b, a), ("normal", 0.02)),
                  (f"{prefix}mlp.{2 * i}.bias", (b,), ("const", 0.0))]
    return specs + [(f"{prefix}last_layer.weight_v", (cfg["out_dim"], dims[-1]), ("normal", 0.02)),
                    (f"{prefix}last_layer.weight_g", (cfg["out_dim"], 1), ("const", 1.0))]


def recipe_config(cfg: dict, seed: int, batch: int):
    from cerebra_torch.train.recipes import DinoSelfDistillConfig

    return DinoSelfDistillConfig(
        epochs=cfg["epochs"], batch_size_per_device=batch,
        out_dim=cfg["out_dim"], embed_dim=cfg["embed_dim"], lstm_layers=cfg["lstm_layers"],
        lr=cfg["lr"], min_lr=cfg["min_lr"], warmup_epochs=cfg["warmup_epochs"],
        weight_decay=cfg["weight_decay"], weight_decay_end=cfg["weight_decay_end"],
        momentum_teacher=cfg["momentum_teacher"], teacher_temp=cfg["teacher_temp"],
        warmup_teacher_temp=cfg["warmup_teacher_temp"],
        warmup_teacher_temp_epochs=cfg["warmup_teacher_temp_epochs"],
        clip_grad=cfg["clip_grad"], freeze_last_layer=cfg["freeze_last_layer"],
        global_length=cfg["global_length"], local_length=cfg["local_length"],
        n_global=cfg["n_global"], n_local=cfg["n_local"], seed=seed,
        dtype=getattr(torch, cfg["dtype"]))


class Run:
    def __init__(self, cell: dict, cfg: dict, seed: int, device: torch.device):
        from cerebra_torch.train.recipes import make_dino_lstm, step_generator

        self.cfg, self.seed = cfg, seed
        B, N = cell["batch"], cell["corpus_trials"]
        self.batch = B
        if N % B:
            raise ValueError(f"corpus of {N} trials is not a whole number of batches of {B}")
        C, H, L = cfg["input_size"], cfg["embed_dim"], cfg["lstm_layers"]
        self.counts = counts.dino(cfg, B)

        gen = torch.Generator(device=device).manual_seed(seed)
        self.params0 = feed.draw_params(
            feed.lstm_specs("backbone.lstm.", C, H, L) + head_specs("head.", cfg), gen, device)
        self.corpus = torch.randn(N, cfg["samples"], C, generator=gen, device=device)

        self.state, self.train_step, self.niter = make_dino_lstm(recipe_config(cfg, seed, B), N,
                                                                 C, device)
        feed.load_params(self.state.student, self.params0)
        feed.load_params(self.state.teacher, self.params0)
        self.start = cell["start_step"]  # where the run resumes in the schedules
        self.state.step = self.state.optimizer.count = self.start
        self.end = cfg["epochs"] * self.niter
        first = self.start // self.niter
        self.base = first * self.niter
        self.order = feed.order_table(seed, range(first, cfg["epochs"]), N, B, device)
        self.views = step_generator

    def gather(self, it: int) -> torch.Tensor:
        return self.corpus[self.order[it - self.base]]

    def step(self) -> torch.Tensor:
        it = self.state.step
        if it >= self.end:
            raise RuntimeError(f"step {it} is past the schedules' {self.end} steps")
        with span("perfbench.gather"):
            batch = self.gather(it)
        with span("perfbench.step"):
            self.state, metrics = self.train_step(self.state, batch, self.views(self.seed, it))
        return metrics["loss"]

    def first_steps(self, n: int) -> None:
        student = self.state.student
        named = [(k, p) for k, p in student.named_parameters() if p.requires_grad]
        inner = self.state.optimizer.inner
        beta1 = inner.param_groups[0]["betas"][0]
        losses, grads = [], None
        for i in range(n):
            losses.append(self.step())
            if i == 0:  # AdamW's first moment is (1 − beta1)·g
                grads = [inner.state[p]["exp_avg"].norm() / (1 - beta1) if p in inner.state
                         else torch.zeros((), device=p.device) for _, p in named]
        teacher = dict(self.state.teacher.named_parameters())
        self.n_first = n
        self.readings = {
            "losses": torch.stack(losses).float().tolist(),
            "grad_norms": dict(zip([k for k, _ in named], torch.stack(grads).tolist())),
            "update_norms": {k: float((p.detach() - self.params0[k]).norm()) for k, p in named},
            "teacher_norms": {k: float((teacher[k].detach() - self.params0[k]).norm())
                              for k, _ in named},
            "center_norm": float(self.state.center.norm())}

    def free(self) -> None:
        del self.state, self.train_step

    def reference(self, rounding: str = "f32", half: bool = False, frozen: bool = False) -> dict:
        steps = [self.start + i for i in range(self.n_first)]
        return plain.follow(self.cfg, self.params0, [self.gather(it) for it in steps],
                            steps, self.seed, self.niter, rounding, half, frozen)
