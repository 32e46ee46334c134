"""The comparison that decides `correct`: the program's readings of its
first training steps against the plain reference's (`reference/`).

Every number is a gap between two norms, taken by the worst leaf and
measured against the reference's norm of that leaf or of the median leaf,
whichever is larger:

- `loss_gap`: each of the first steps' losses, relative to the reference's;
- `grad_gap`: each leaf's first gradient as the optimizer got it (after the
  clip and the last-layer cancel, where the recipe has them);
- `update_gap`: each leaf's change over the first steps. Leaves whose
  gradient stays under a thousandth of the median leaf's on every step are
  left out: they move by round-off alone;
- `teacher_gap`, `center_gap` (DINO): the EMA teacher's change over the
  same leaves, and the center's norm after the first steps.

A number fails where it exceeds its limit; the limits are the cell's, set
from the readings `PERF.md` lists."""

import statistics

NEGLIGIBLE = 1e-3


def worst_leaf(prog: dict, ref: dict, keys) -> float:
    scale = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], scale, 1e-30) for k in keys)


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap of `worst_leaf` for the first gradient and the
    change, for a look at which leaves set a reading."""
    out = {}
    for key in ("grad_norms", "update_norms"):
        scale = statistics.median(ref[key].values())
        out[key] = {k: abs(prog[key][k] - ref[key][k]) / max(ref[key][k], scale, 1e-30)
                    for k in ref[key]}
    return out


def gaps(prog: dict, ref: dict) -> dict:
    out = {"loss_gap": max(abs(p - r) / max(abs(r), 1e-30)
                           for p, r in zip(prog["losses"], ref["losses"])),
           "grad_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"], list(ref["grad_norms"]))}
    floor = NEGLIGIBLE * statistics.median(ref["grad_max"].values())
    moved = [k for k, g in ref["grad_max"].items() if g >= floor]
    out["update_gap"] = worst_leaf(prog["update_norms"], ref["update_norms"], moved)
    if "teacher_norms" in ref:
        out["teacher_gap"] = worst_leaf(prog["teacher_norms"], ref["teacher_norms"], moved)
        out["center_gap"] = abs(prog["center_norm"] - ref["center_norm"]) / ref["center_norm"]
    return out


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limit; a number the run could
    not read counts as failed."""
    return {name: {"value": values.get(name, float("inf")), "limit": limit}
            for name, limit in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
