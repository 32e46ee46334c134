"""One set of dropout masks for flax and the port: masks drawn with numpy in
the order flax's `nn.Dropout.__call__` runs (or fed in, traced arrays
included, to a jitted function), returned to JAX through
`flax.linen.intercept_methods`, then replayed to the port's modules as their
`drop(x, rate)`. Both sides compute flax's x/keep where kept, else 0."""

import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn


class DropoutMasks:
    """Draws each mask from `seed` when it is called, or takes them from
    `feed` in order; `masks` and `rates` record what each call used."""

    def __init__(self, seed: int = 0, feed=None):
        self.rng = np.random.default_rng(seed)
        self.feed = None if feed is None else iter(feed)
        self.masks, self.rates = [], []

    def interceptor(self, next_fun, args, kwargs, context):
        module = context.module
        if not (isinstance(module, nn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        deterministic = kwargs.get("deterministic", module.deterministic)
        if len(args) > 1:
            deterministic = args[1]
        if deterministic or module.rate == 0.0:
            return next_fun(*args, **kwargs)
        x, keep = args[0], 1.0 - module.rate
        mask = self.rng.random(x.shape) < keep if self.feed is None else next(self.feed)
        self.masks.append(mask)
        self.rates.append(module.rate)
        return jnp.where(mask, x / keep, jnp.zeros((), x.dtype))

    def intercept(self):
        """The context in which flax's dropouts take this object's masks."""
        return nn.intercept_methods(self.interceptor)

    def replay(self):
        """`drop(x, rate)` for the port: the recorded masks in order."""
        return replay(self.masks)

    def drawn(self) -> int:
        return len(self.masks)

    def draw_again(self, seed: int) -> list:
        """New numpy masks of the recorded shapes and rates."""
        rng = np.random.default_rng(seed)
        return [rng.random(np.shape(m)) < 1.0 - r for m, r in zip(self.masks, self.rates)]


def replay(masks):
    """`drop(x, rate)` that applies `masks` (numpy) in order."""
    it = iter(masks)

    def drop(x: torch.Tensor, rate: float) -> torch.Tensor:
        mask = torch.from_numpy(np.asarray(next(it)))
        assert tuple(mask.shape) == tuple(x.shape), (mask.shape, x.shape)
        return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    return drop
