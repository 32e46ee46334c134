"""The DINO ViT step of `main_dino` (`train/dino_vit.py::make_dino_vit`,
`train/steps.py::make_dino_step`) as the CLI builds it, the batch aside:
a batch of (T, C) trials gathered on the device in the recipe's epoch
order, and the step with its EEG-image views drawn from the recipe's
generator, as `dino_vit_train`'s loop body takes it. The fused half-blocks
are on auto (K5-K8 on CUDA tensors, their plain versions on the CPU) and
the flash attention off.

The checked steps' draws are fed to the reference as data: before each,
the state of the recipe's generator (the views' window starts) and of the
device's default generator (the student's drop-path masks) is kept, and
the draws are replayed from it in the order the step makes them
(`step_draws`)."""

import numpy as np
import torch

from perfbench import feed
from perfbench.counts import vit as vit_counts
from perfbench.drivers.dino import head_specs
from perfbench.reference import dino_vit as plain
from perfbench.reference.vit import drop_path_keeps
from perfbench.trace import span


def vit_specs(prefix: str, cfg: dict):
    """The ViT's parameters as the port initialises them: trunc_normal(0.02)
    at ±100σ (a normal) for the dense layers, CLS and positions; the patch
    convolution's lecun normal (truncated at ±2σ, drawn here untruncated);
    zero biases and unit LayerNorm gains."""
    D, p, F = cfg["embed_dim"], cfg["patch_size"], cfg["embed_dim"] * cfg["mlp_ratio"]
    grid = (cfg["global_size"] // p) ** 2
    lecun = float(np.sqrt(1.0 / (3 * p * p)) / 0.87962566103423978)
    specs = [(f"{prefix}cls_token", (1, 1, D), ("normal", 0.02)),
             (f"{prefix}pos_embed", (1, grid + 1, D), ("normal", 0.02)),
             (f"{prefix}patch_embed.proj.weight", (D, 3, p, p), ("normal", lecun)),
             (f"{prefix}patch_embed.proj.bias", (D,), ("const", 0.0))]
    for i in range(cfg["depth"]):
        b = f"{prefix}blocks.{i}."
        for norm in ("norm1", "norm2"):
            specs += [(f"{b}{norm}.weight", (D,), ("const", 1.0)),
                      (f"{b}{norm}.bias", (D,), ("const", 0.0))]
        for name, n_out, n_in in (("attn.qkv", 3 * D, D), ("attn.proj", D, D),
                                  ("mlp.fc1", F, D), ("mlp.fc2", D, F)):
            specs += [(f"{b}{name}.weight", (n_out, n_in), ("normal", 0.02)),
                      (f"{b}{name}.bias", (n_out,), ("const", 0.0))]
    return specs + [(f"{prefix}norm.weight", (D,), ("const", 1.0)),
                    (f"{prefix}norm.bias", (D,), ("const", 0.0))]


def recipe_config(cfg: dict, seed: int, batch: int):
    from cerebra_torch.train.dino_vit import DinoVitConfig

    return DinoVitConfig(
        arch=cfg["arch"], patch_size=cfg["patch_size"], out_dim=cfg["out_dim"],
        epochs=cfg["epochs"], batch_size_per_device=batch, lr=cfg["lr"], min_lr=cfg["min_lr"],
        warmup_epochs=cfg["warmup_epochs"], weight_decay=cfg["weight_decay"],
        weight_decay_end=cfg["weight_decay_end"], momentum_teacher=cfg["momentum_teacher"],
        teacher_temp=cfg["teacher_temp"], warmup_teacher_temp=cfg["warmup_teacher_temp"],
        warmup_teacher_temp_epochs=cfg["warmup_teacher_temp_epochs"],
        clip_grad=cfg["clip_grad"], freeze_last_layer=cfg["freeze_last_layer"],
        local_crops_number=cfg["n_local"], global_size=cfg["global_size"],
        local_size=cfg["local_size"], norm_last_layer=cfg["norm_last_layer"], seed=seed,
        dtype=getattr(torch, cfg["dtype"]), drop_path_rate=cfg["drop_path_rate"])


def rng_state(device: torch.device) -> torch.Tensor:
    return torch.cuda.get_rng_state(device) if device.type == "cuda" else torch.get_rng_state()


def step_draws(cfg: dict, B: int, T: int, C: int, views_state, device, device_state) -> dict:
    """One step's draws, replayed from the states kept before it: the window
    starts of `make_eeg_image_view_fn` (globals, then locals, from the
    recipe's generator) and the student's drop-path masks (`Block._mask`
    on the device's default generator: for each group, globals first, each
    block with a drop rate its attention's mask, then its MLP's)."""
    from cerebra_torch.signal.windows import window_starts

    views = torch.Generator().manual_seed(0)
    views.set_state(views_state)
    counts = (cfg["n_global"], cfg["n_local"])
    sizes = (cfg["global_size"], cfg["local_size"])
    starts = [window_starts((n, B), C, T, size, views) for n, size in zip(counts, sizes)]
    keeps = drop_path_keeps(cfg["drop_path_rate"], cfg["depth"])
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        if device.type == "cuda":
            torch.cuda.set_rng_state(device_state, device)
        else:
            torch.set_rng_state(device_state)
        masks = [[None if keep == 1.0 else
                  tuple((torch.rand(n * B, device=device) < keep).reshape(n, B) for _ in range(2))
                  for keep in keeps] for n in counts]
    return {"starts": starts, "masks": masks}


class Run:
    def __init__(self, cell: dict, cfg: dict, seed: int, device: torch.device):
        from cerebra_torch.train.dino_vit import make_dino_vit

        self.cfg, self.device = cfg, device
        B, N = cell["batch"], cell["corpus_trials"]
        self.batch, self.chunk = B, cell["reference_chunk"]
        if N % B:
            raise ValueError(f"corpus of {N} trials is not a whole number of batches of {B}")
        self.counts = vit_counts.dino_vit(cfg, B)

        gen = torch.Generator(device=device).manual_seed(seed)
        self.params0 = feed.draw_params(
            vit_specs("backbone.", cfg) + head_specs("head.", cfg), gen, device)
        self.corpus = torch.randn(N, cfg["trial_samples"], cfg["trial_channels"], generator=gen,
                                  device=device)

        self.state, self.train_step, self.views, self.niter = make_dino_vit(
            recipe_config(cfg, seed, B), N, device)
        backbone = self.state.student.backbone
        shape = (backbone.embed_dim, backbone.depth, backbone.num_heads)
        if shape != (cfg["embed_dim"], cfg["depth"], cfg["num_heads"]):
            raise ValueError(f"the recipe's ViT is (D, depth, heads) = {shape}, not the "
                             f"configuration's")
        feed.load_params(self.state.student, self.params0)
        feed.load_params(self.state.teacher, self.params0)
        self.start = cell["start_step"]  # where the run resumes in the schedules
        self.state.step = self.state.optimizer.count = self.start
        self.end = cfg["epochs"] * self.niter
        first = self.start // self.niter
        self.base = first * self.niter
        self.order = feed.order_table(seed, range(first, cfg["epochs"]), N, B, device)

    def gather(self, it: int) -> torch.Tensor:
        return self.corpus[self.order[it - self.base]]

    def step(self) -> torch.Tensor:
        it = self.state.step
        if it >= self.end:
            raise RuntimeError(f"step {it} is past the schedules' {self.end} steps")
        with span("perfbench.gather"):
            batch = self.gather(it)
        with span("perfbench.step"):
            self.state, metrics = self.train_step(self.state, batch, self.views)
        return metrics["loss"]

    def first_steps(self, n: int) -> None:
        """n steps, each leaf's gradient norm read as the clip gets it (after
        the last-layer cancel) on the first, the draws kept for each."""
        opt = self.state.optimizer
        named = [(k, p) for k, p in self.state.student.named_parameters() if p.requires_grad]
        grads = []

        def step_reading_grads():
            if not grads:
                grads.append(torch.stack([p.grad.float().norm() for _, p in named]))
            type(opt).step(opt)

        opt.step = step_reading_grads
        losses, self.kept = [], []
        try:
            for _ in range(n):
                self.kept.append((self.state.step, self.views.get_state(),
                                  rng_state(self.device)))
                losses.append(self.step())
        finally:
            del opt.step
        teacher = dict(self.state.teacher.named_parameters())
        if not grads:  # the step never reached the optimizer
            grads.append(torch.zeros(len(named)))
        self.readings = {
            "losses": torch.stack(losses).float().tolist(),
            "grad_norms": dict(zip([k for k, _ in named], grads[0].tolist())),
            "update_norms": {k: plain.change_norm(k, p, self.params0[k]) for k, p in named},
            "teacher_norms": {k: plain.change_norm(k, teacher[k], self.params0[k])
                              for k, _ in named},
            "center_norm": float(self.state.center.norm())}

    def free(self) -> None:
        del self.state, self.train_step

    def inputs(self):
        """The checked steps as the reference takes them: each step's batch,
        its index in the schedules and its draws."""
        T, C = self.corpus.shape[1:]
        steps = [it for it, _, _ in self.kept]
        draws = [step_draws(self.cfg, self.batch, T, C, views, self.device, dev)
                 for _, views, dev in self.kept]
        return [self.gather(it) for it in steps], steps, draws

    def reference(self, rounding: str = "f32", half: bool = False, frozen: bool = False) -> dict:
        return plain.follow(self.cfg, self.params0, *self.inputs(), self.niter, self.chunk,
                            rounding, half, frozen)
