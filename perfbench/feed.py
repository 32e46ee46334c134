"""What the cells feed the program, made from the seed: weights and corpora
on the device in a few large draws of a `torch.Generator` there, and the
recipes' epoch order (`np.random.default_rng((seed, epoch)).permutation`,
the order `train/recipes.py` draws its batches in) as one table of row
indices on the device, so a step gathers its rows without the host."""

import numpy as np
import torch


def draw_params(specs, gen: torch.Generator, device) -> dict:
    """{name: f32 tensor} from specs [(name, shape, init)], init one of
    ("uniform", bound), ("normal", std), ("const", value): all uniform
    leaves from one draw, all normal leaves from another."""
    sizes = {kind: sum(int(np.prod(shape)) for _, shape, (k, _) in specs if k == kind)
             for kind in ("uniform", "normal")}
    pools = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device),
             "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    used = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, (kind, a) in specs:
        n = int(np.prod(shape))
        if kind == "const":
            out[name] = torch.full(shape, float(a), device=device)
            continue
        flat = pools[kind][used[kind]:used[kind] + n]
        used[kind] += n
        out[name] = ((2.0 * flat - 1.0) * a if kind == "uniform" else flat * a).reshape(shape)
    return out


def load_params(module: torch.nn.Module, params: dict) -> None:
    """Copy the drawn values into the program's parameters of the same names."""
    own = dict(module.named_parameters())
    missing = set(params) ^ set(own)
    if missing:
        raise KeyError(f"parameters of the program and the draw differ: {sorted(missing)}")
    with torch.no_grad():
        for name, value in params.items():
            own[name].copy_(value)


def lstm_specs(prefix: str, C: int, H: int, L: int):
    bound = 1.0 / np.sqrt(H)  # torch.nn.LSTM's default range
    specs = []
    for l in range(L):
        n = C if l == 0 else H
        specs += [(f"{prefix}weight_ih_l{l}", (4 * H, n), ("uniform", bound)),
                  (f"{prefix}weight_hh_l{l}", (4 * H, H), ("uniform", bound)),
                  (f"{prefix}bias_ih_l{l}", (4 * H,), ("uniform", bound)),
                  (f"{prefix}bias_hh_l{l}", (4 * H,), ("uniform", bound))]
    return specs


def linear_specs(name: str, n_in: int, n_out: int):
    bound = 1.0 / np.sqrt(n_in)  # torch.nn.Linear's default range
    return [(f"{name}.weight", (n_out, n_in), ("uniform", bound)),
            (f"{name}.bias", (n_out,), ("uniform", bound))]


def epoch_order(seed: int, epoch: int, n: int, batch: int) -> np.ndarray:
    """(n // batch, batch) rows of one epoch in the recipes' order."""
    order = np.random.default_rng((seed, epoch)).permutation(n)
    return order[:n // batch * batch].reshape(-1, batch)


def order_table(seed: int, epochs, n: int, batch: int, device) -> torch.Tensor:
    """The epochs' batches, one after the other, as (steps, batch) int64."""
    rows = np.concatenate([epoch_order(seed, e, n, batch) for e in epochs])
    return torch.from_numpy(rows).to(device)
