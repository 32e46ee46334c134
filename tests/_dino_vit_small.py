"""The benchmark's DINO ViT cell (`perfbench/configs/dino_vits8.json`,
driver `perfbench/drivers/dino_vit.py`) at a size the CPU holds: a ViT of
D 32, 2 heads and depth 2 at patch 8 on 32- and 16-px views of (40, 8)
trials, out_dim 64, built by `make_dino_vit` (its `vit_tiny` made this
narrow) and run through the recipe's own step."""

import torch

from cerebra_torch.models.vit import VisionTransformer
from perfbench.run import HERE, load_json

CELL = {"config": "dino_vits8", "traffic": "b4", "chips": 1, "batch": 4, "corpus_trials": 32,
        "start_step": 9, "check_steps": 3, "warmup_steps": 0, "trace_steps": 0,
        "reference_chunk": 3, "libraries": [], "limits": {}}


def config(dtype: str = "float32") -> dict:
    return dict(load_json(HERE, "configs", "dino_vits8.json"), arch="vit_tiny", patch_size=8,
                embed_dim=32, depth=2, num_heads=2, out_dim=64, global_size=32, local_size=16,
                trial_samples=40, trial_channels=8, epochs=4, warmup_epochs=1, dtype=dtype)


def small_run(monkeypatch, fused: bool, dtype: str = "float32", seed: int = 2 ** 31 + 5):
    """The driver's `Run` of the small cell; `fused` sets every block's
    fused flags (on the CPU: the kernels' plain versions; off: the unfused
    path)."""
    import cerebra_torch.train.dino_vit as dino_vit
    from perfbench.drivers.dino_vit import Run

    monkeypatch.setattr(dino_vit, "vit_tiny", lambda patch_size=16, **kw: VisionTransformer(
        patch_size=patch_size, embed_dim=32, depth=2, num_heads=2, **kw))
    run = Run(CELL, config(dtype), seed, torch.device("cpu"))
    for model in (run.state.student, run.state.teacher):
        for blk in model.backbone.blocks:
            blk.use_fused_attn = blk.use_fused_mlp = fused
    return run
