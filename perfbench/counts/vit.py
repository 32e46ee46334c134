"""Operations and bytes of a DINO ViT step (`perfbench/counts`' rules): the
student's forward and backward over both view groups and the teacher's
forward over the global one, by layer (`vit_attn`, `vit_mlp`), and the
whole step with the patch convolution and DINOHead. A backward counts twice
its forward's products (the input's and the weights' gradients); the
attention cores' recompute of the scores is not counted. The token stream
is f32 whatever the compute dtype; the half-blocks' weights are cast to it
(`_prep`) and their gradients are f32."""

from perfbench.counts import DTYPE_BYTES, dense_flops

STREAM = 4  # the residual stream's f32 bytes


def tokens(cfg: dict, size: int) -> int:
    """Patches of a size-px view, and the CLS token."""
    return (size // cfg["patch_size"]) ** 2 + 1


def attn_flops(S: int, N: int, D: int) -> int:
    """One attention half-block's forward over S sequences of N tokens: the
    qkv and proj products, the scores q·kᵀ and the weighted sum p·v."""
    return 2 * S * N * 4 * D * D + 4 * S * N * N * D


def mlp_flops(S: int, N: int, D: int, F: int) -> int:
    """One MLP half-block's forward: fc1 and fc2."""
    return 4 * S * N * D * F


def half_bytes(rows: int, D: int, weights: int, cdt: int, bwd: bool) -> int:
    """A half-block call over `rows` tokens: the stream in and out and the
    weights in the compute dtype; with `bwd` also the cotangent in, the
    input's gradient out and the f32 weight gradients."""
    total = STREAM * 2 * rows * D + cdt * weights
    return total + (STREAM * 2 * rows * D + 4 * weights if bwd else 0)


def dino_vit(cfg: dict, B: int) -> dict:
    """Counts of a DINO ViT step over a batch of B."""
    D, F, depth, p = cfg["embed_dim"], cfg["embed_dim"] * cfg["mlp_ratio"], cfg["depth"], \
        cfg["patch_size"]
    cdt = DTYPE_BYTES[cfg["dtype"]]
    groups = [(cfg["n_global"] * B, tokens(cfg, cfg["global_size"])),
              (cfg["n_local"] * B, tokens(cfg, cfg["local_size"]))]
    w_attn, w_mlp = 4 * D * D + 6 * D, 2 * D * F + F + 3 * D
    layers = {"vit_attn": {"flops": 0, "bytes": 0}, "vit_mlp": {"flops": 0, "bytes": 0}}
    embed = 0
    for g, (S, N) in enumerate(groups):
        passes = 3 + (g == 0)  # the student's forward and backward; the teacher's forward
        for name, flops, w in (("vit_attn", attn_flops(S, N, D), w_attn),
                               ("vit_mlp", mlp_flops(S, N, D, F), w_mlp)):
            layers[name]["flops"] += depth * passes * flops
            layers[name]["bytes"] += depth * (half_bytes(S * N, D, w, cdt, True)
                                              + (half_bytes(S * N, D, w, cdt, False) if g == 0
                                                 else 0))
        # the patch convolution: its forward and weight gradient, and the teacher's forward
        embed += (2 + (g == 0)) * 2 * S * (N - 1) * 3 * p * p * D
    dims = [D] + [cfg["head_hidden_dim"]] * (cfg["head_nlayers"] - 1) + [
        cfg["head_bottleneck_dim"], cfg["out_dim"]]
    rows = (cfg["n_global"] + cfg["n_local"]) * B
    head = dense_flops(rows, dims, bwd=True) + dense_flops(cfg["n_global"] * B, dims, bwd=False)
    return {"layers": layers,
            "step_flops": sum(l["flops"] for l in layers.values()) + embed + head,
            "dtype": cfg["dtype"]}
