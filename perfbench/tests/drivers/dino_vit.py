"""The DINO ViT step (`perfbench/drivers/dino_vit.py`) in the CPU tests:
its sizes there, and its faults planted underneath the timed path."""

import torch


def small(cell: dict, cfg: dict, dtype: str):
    """The cell and configuration at ViT-Ti/16 widths on 32- and 16-px views
    of short trials (the program fixes DINOHead's hidden and bottleneck
    widths; `vit_tiny` fixes D 192, 3 heads, depth 12)."""
    cfg = dict(cfg, arch="vit_tiny", patch_size=16, embed_dim=192, num_heads=3, out_dim=32,
               global_size=32, local_size=16, trial_samples=40, trial_channels=8, epochs=4,
               warmup_epochs=1, dtype=dtype)
    return dict(cell, batch=4, corpus_trials=32, start_step=9, warmup_steps=1, trace_steps=2,
                reference_chunk=3), cfg


def plant(monkeypatch, fault: str) -> None:
    """`frozen`: the step returns its state unchanged; `half`: the loss and
    the center take the first half of each batch's samples, the mean over
    them."""
    import cerebra_torch.train.dino_vit as dino_vit
    import cerebra_torch.train.steps as steps

    if fault == "frozen":
        make = dino_vit.make_dino_vit

        def make_frozen(*args, **kwargs):
            state, _, gen, niter = make(*args, **kwargs)
            return state, lambda s, batch, g: (s, {"loss": torch.zeros(())}), gen, niter

        monkeypatch.setattr(dino_vit, "make_dino_vit", make_frozen)
        return
    loss = steps.dino_multicrop_loss

    def half_loss(student, teacher, *args, **kwargs):
        n = student.shape[1] // 2
        return loss(student[:, :n], teacher[:, :n], *args, **kwargs)

    monkeypatch.setattr(steps, "dino_multicrop_loss", half_loss)
