"""cerebra_torch — the PyTorch/CUDA port of `cerebra` for one NVIDIA H100.

The JAX package `cerebra/` is the reference; this package mirrors its
subpackage and module names so each counterpart is easy to find. It imports
torch, numpy and scipy only — never jax and nothing under `cerebra` — so it
runs on a machine without JAX.

Every Pallas kernel on a ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use (`kernels/_build.py`). A tensor on the
CPU takes the kernel's plain PyTorch version; a CUDA tensor launches the
kernel or raises.
"""
