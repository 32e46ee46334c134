"""Plain float32 references of what the timed paths compute, in plain
PyTorch and NumPy. They import neither `jax` nor the JAX package nor
anything of `cerebra_torch`, and take from the benchmark only the inputs
it made: weights, corpus rows and the seed. Everything the program derives
from those (the filter matrix, the crops, the schedules) is worked out here
again."""

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
