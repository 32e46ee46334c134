"""What a matrix product's operands are rounded to before it multiplies:
`f32` leaves them as they are (the reference); `fp8` is the step below the
bfloat16 that the configurations state, as fp8 training takes it: each
operand rounded to float8 e4m3 and each gradient that flows back into it to
e5m2, with one scale a tensor (its largest magnitude to the format's
largest). The control of `correct` is the reference run with `fp8`."""

import torch


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def f32(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


ROUNDINGS = {"f32": f32, "fp8": fp8}


def mm(a: torch.Tensor, b: torch.Tensor, q=f32) -> torch.Tensor:
    """a @ b with both operands rounded by `q`, accumulated in f32."""
    return q(a) @ q(b)
