"""The port's DINO ViT step (the recipe `make_dino_vit` builds, as
`main_dino` runs it) against the benchmark's plain reference
(`perfbench/reference/dino_vit.py`: plain torch in f32 with TF32 off) on the
CPU, at D 32, 2 heads, depth 2, patch 8, 32- and 16-px views, out_dim 64
(`tests/_dino_vit_small.py`), from the same seeded weights and the same
draws (window starts, drop-path masks): three steps, with the fused
half-blocks (their plain versions) and without, the program in f32 and in
bf16. Compared: each step's loss, every leaf's first gradient as the clip
gets it, every leaf's change over the three steps, the teacher's change,
and the center.

Each gap is a vector's: |program − reference| over |reference|, for a leaf
the larger of its own norm and the median leaf's (`perfbench/compare.py`'s
scale, so a leaf whose values are all near 0 is not judged against its own
rounding). The k third of each qkv bias is left out of the changes: its
gradient is 0 in exact arithmetic, and AdamW scales each side's rounding
noise there up to the step size (`perfbench/reference/dino_vit.py::
judged`).

Tolerances, f32: 1e-5 for the loss, the center and the gradients (the two
sum in other orders; readings up to 1.5e-7, 1.2e-7, 6.5e-7); 1e-3 for the
changes (AdamW's first steps divide each element's gradient by its own
magnitude, which scales the order-of-sums noise of the smallest elements
up; readings up to 3.4e-4). bf16: the products round their operands to 8
bits, one part in 256, and the changes again by AdamW's division: 1e-3 for
the loss, 4e-2 for the gradients, 0.25 for the changes, 1e-2 for the
center (readings up to 4.0e-4, 2.0e-2, 0.146, 4.0e-3; two seeds, fused and
not). They are tight: the reference with its products' operands rounded
to fp8 (`perfbench/reference/precision.py`) in the program's place reads
0.13-0.18, 0.48-0.52 and 0.056 for the last three, and fails each."""

import statistics

import pytest
import torch

from perfbench.reference import dino_vit as plain
from tests._dino_vit_small import small_run

torch.set_num_threads(1)

TOL = {"float32": {"loss": 1e-5, "grads": 1e-5, "changes": 1e-3, "center": 1e-5},
       "bfloat16": {"loss": 1e-3, "grads": 4e-2, "changes": 0.25, "center": 1e-2}}


def program_steps(monkeypatch, fused: bool, dtype: str):
    """The driver's run of three steps, with each leaf's first gradient as
    the clip got it, and the reference's inputs."""
    import cerebra_torch.train.optim as optim

    run = small_run(monkeypatch, fused, dtype)
    names = {id(p): k for k, p in run.state.student.named_parameters()}
    grads, clip = {}, optim.per_param_clip

    def reading_clip(params, *args, **kwargs):
        if not grads:
            grads.update({names[id(p)]: p.grad.detach().float().clone() for p in params})
        return clip(params, *args, **kwargs)

    monkeypatch.setattr(optim, "per_param_clip", reading_clip)
    run.first_steps(3)
    out = {"losses": run.readings["losses"], "grads": grads,
           "student": {k: p.detach().float() for k, p in run.state.student.named_parameters()},
           "teacher": {k: p.detach().float() for k, p in run.state.teacher.named_parameters()},
           "center": run.state.center.float()}
    return run, out


def reference(run, rounding: str = "f32") -> dict:
    return plain.run(run.cfg, run.params0, *run.inputs(), run.niter, run.chunk, rounding)


def _rel(a: torch.Tensor, b: torch.Tensor, scale: float) -> float:
    return float((a - b).norm()) / max(float(b.norm()), scale, 1e-30)


def gaps(prog: dict, ref: dict, params0: dict) -> dict:
    """The worst leaf's gap of each compared quantity."""
    def worst(a: dict, b: dict) -> float:
        scale = statistics.median(float(v.norm()) for v in b.values())
        return max(_rel(a[k], b[k], scale) for k in b)

    trained = list(ref["grads"])
    change = {side: {who: {k: plain.judged(k, out[who][k] - params0[k].float()) for k in trained}
                     for who in ("student", "teacher")} for side, out in (("p", prog), ("r", ref))}
    return {"loss": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
            "grads": worst(prog["grads"], ref["grads"]),
            "changes": max(worst(change["p"][w], change["r"][w]) for w in ("student", "teacher")),
            "center": _rel(prog["center"], ref["center"], 0.0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False])
def test_three_steps_match_the_plain_reference(monkeypatch, fused, dtype):
    run, prog = program_steps(monkeypatch, fused, dtype)
    assert set(prog["grads"]) == {k for k in run.params0 if not k.endswith("weight_g")}
    got = gaps(prog, reference(run), run.params0)
    assert all(got[k] <= TOL[dtype][k] for k in got), got


def test_fp8_products_fail_the_bf16_tolerances(monkeypatch):
    """The reference with fp8-rounded products in the program's place is
    outside the bf16 tolerances of the gradients, the changes and the
    center."""
    run, _ = program_steps(monkeypatch, True, "bfloat16")
    ref = reference(run)
    got = gaps(reference(run, "fp8"), ref, run.params0)
    assert all(got[k] > TOL["bfloat16"][k] for k in ("grads", "changes", "center")), got
