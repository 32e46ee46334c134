"""Operations and bytes of each layer at a cell's shapes, and the peaks of
one H100 (`peaks.json`).

A driver's counts are {"layers": {<layer>: {"flops", "bytes"}}, "step_flops",
"dtype"}: each layer's operations and bytes a step, under the name of its
file in `layers/`, and the whole step's operations.

Operations are the matrix products the algorithm needs, 2 per
multiply-add; recompute is not counted, nor the cell's elementwise math.
Bytes count each layer input, weight, output, cotangent and weight
gradient once, in the dtype it has there, and no residual: so the LSTM
stack's bound is the same whatever kernels implement it."""

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, "peaks.json")) as _f:
    PEAKS = json.load(_f)

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def stack_flops(T: int, B: int, C: int, H: int, L: int, fwd: bool = True, bwd: bool = False,
                need_dx: bool = False) -> int:
    """The stack over (T, B): the forward's x·W_ih + h·W_hh; the backward's
    dW_ih and dW_hh, dh = dgates·W_hhᵀ and the chain dgates·W_ihᵀ to each
    layer below (and to dx)."""
    G = 4 * H
    ins = [C] + [H] * (L - 1)
    gates = 2 * T * B * sum((n + H) * G for n in ins)
    flops = gates if fwd else 0
    if bwd:
        flops += gates + 2 * T * B * G * (H * L + H * (L - 1) + (C if need_dx else 0))
    return flops


def stack_bytes(T: int, B: int, C: int, H: int, L: int, stream: int, bwd: bool) -> int:
    """The stack returning h[T−1]: x, the weights and the intermediate
    layers' outputs (written once, read once) in the stream dtype, h[T−1];
    with `bwd` its cotangent and the f32 weight gradients."""
    ins = [C] + [H] * (L - 1)
    weights = sum((n + H) * 4 * H + 4 * H for n in ins)
    total = stream * (T * B * C + weights + 2 * (L - 1) * T * B * H + B * H)
    if bwd:
        total += stream * B * H + 4 * weights
    return total


def dense_flops(rows: int, dims, bwd: bool, first_dx: bool = True) -> int:
    """An MLP of widths dims[0] → … → dims[-1] over `rows`: the forward, and
    with `bwd` the weight gradients and the input gradients (the first
    layer's only with `first_dx`)."""
    fwd = sum(2 * rows * a * b for a, b in zip(dims, dims[1:]))
    if not bwd:
        return fwd
    dx = fwd if first_dx else fwd - 2 * rows * dims[0] * dims[1]
    return fwd + fwd + dx


def filter_flops(rows: int, T: int) -> int:
    """The band-pass as the dense (T, T) product it is defined as."""
    return 2 * rows * T * T


def bound_s(flops: int, nbytes: int, dtype: str) -> float:
    """The least time on one chip: operations at the dtype's peak, or bytes
    at the HBM's, whichever is longer."""
    return max(flops / PEAKS["flops_per_s"][dtype], nbytes / PEAKS["hbm_bytes_per_s"])


def layer_roofline(record: dict, layer: str):
    """The layer's `bound_s` over its device seconds a step, in %; None
    where the trace gives it no time or the counts have no entry for it."""
    t = record.get("trace")
    c = record["counts"]["layers"].get(layer)
    s = t["layer_s"].get(layer, 0.0) if t else 0.0
    if c is None or s <= 0:
        return None
    return bound_s(c["flops"], c["bytes"], record["counts"]["dtype"]) / (s / t["steps"]) * 100


def feature_distill(cfg: dict, B: int) -> dict:
    """Counts a step of the LSTM→DINOv2 student at batch B."""
    T = cfg["time_high"] - cfg["time_low"]
    C, H, L = cfg["input_size"], cfg["lstm_size"], cfg["lstm_layers"]
    stream = DTYPE_BYTES[cfg["dtype"]]
    lstm = stack_flops(T, B, C, H, L, bwd=True)
    head = dense_flops(B, [H, cfg["output_size"], cfg["n_classes"]], bwd=True)
    filt = filter_flops(B * C, cfg["raw_samples"])
    return {"layers": {"lstm_stack": {"flops": lstm,
                                      "bytes": stack_bytes(T, B, C, H, L, stream, bwd=True)}},
            "step_flops": lstm + head + filt, "dtype": cfg["dtype"]}


def dino(cfg: dict, B: int) -> dict:
    """Counts a DINO-LSTM step over a batch of B: the student's forward and
    backward over every view, the teacher's forward over the global ones,
    the head on both."""
    C, H, L = cfg["input_size"], cfg["embed_dim"], cfg["lstm_layers"]
    stream = DTYPE_BYTES[cfg["dtype"]]
    Tg, Tl = cfg["global_length"], cfg["local_length"]
    bg, bl = cfg["n_global"] * B, cfg["n_local"] * B
    lstm = (stack_flops(Tg, bg, C, H, L, bwd=True) + stack_flops(Tl, bl, C, H, L, bwd=True)
            + stack_flops(Tg, bg, C, H, L))
    nbytes = (stack_bytes(Tg, bg, C, H, L, stream, True) + stack_bytes(Tl, bl, C, H, L, stream, True)
              + stack_bytes(Tg, bg, C, H, L, stream, False))
    dims = [H] + [cfg["head_hidden_dim"]] * (cfg["head_nlayers"] - 1) + [
        cfg["head_bottleneck_dim"], cfg["out_dim"]]
    head = dense_flops(bg + bl, dims, bwd=True) + dense_flops(bg, dims, bwd=False)
    return {"layers": {"lstm_stack": {"flops": lstm, "bytes": nbytes}},
            "step_flops": lstm + head, "dtype": cfg["dtype"]}
