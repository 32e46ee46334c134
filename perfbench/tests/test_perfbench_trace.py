"""The reduction of a device trace to the per-layer readings."""

from perfbench import trace

LAYERS = [{"name": "signal", "span": "perfbench.filter"},
          {"name": "lstm_stack", "kernels": ["wave_fwd_kernel", "vit::"]}]


def events():
    dev = [("at::cuda::spin_kernel(long)", 0.0, 1.0, 1),
           ("void (anonymous namespace)::wave_fwd_kernel<1, 1, 1>(bf16 const*, int)", 2.0, 3.0, 2),
           ("nvjet_gemm", 3.5, 4.0, 3),  # launched inside the filter's span
           ("elementwise_kernel(x)", 3.8, 4.5, 4),
           ("void vit::gemm_tc<true, false, vit::EpiPartial>(x)", 5.0, 5.5, 5)]
    return {"dev": dev, "launch": {2: 1.5, 3: 1.6, 4: 1.7, 5: 1.8},
            "spans": [("perfbench.filter", 1.55, 1.65)],
            "host": sorted([(1.0, 6.0, "perfbench.step"), (4.6, 4.9, "aten::mm"),
                            (3.05, 3.3, "cudaLaunchKernel")])}


def test_reduce():
    r = trace.reduce(events(), LAYERS, k=2)
    assert r["stretch_s"] == 3.5  # first kernel after the marker to the last's end
    assert r["busy_s"] == 2.5  # the union: 2-3, 3.5-4.5, 5-5.5
    assert r["layer_s"] == {"signal": 0.5, "lstm_stack": 1.5}
    assert abs(r["other_s"] - 0.7) < 1e-12  # claimed by no layer
    assert r["breakdown"]["idle_gaps"] == [["cudaLaunchKernel", 0.25], ["aten::mm", 0.25]]
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["(anonymous namespace)::wave_fwd_kernel<1, 1, 1>"] == 0.5


def test_union():
    assert trace.union([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]


def test_short_names():
    assert trace.short("void vit::gemm_tc<true, false, vit::EpiPartial>(a, b)") == \
        "vit::gemm_tc<true, false, vit::EpiPartial>"
    assert trace.short("nvjet_tst_64x8") == "nvjet_tst_64x8"
