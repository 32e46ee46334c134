"""The reduction of a device trace to the per-layer readings: layers by
harness span, by the program's own spans and by kernel name."""

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


def test_attribute_to_the_innermost_span():
    """Each operation goes to the shortest span around its launch, whatever
    thread the span is on; one launched outside every span, or with no
    launch time, goes to none."""
    spans = [("cerebra_torch.step", 0.0, 10.0),
             ("cerebra_torch.step.backward", 4.0, 9.0),
             ("cerebra_torch.lstm.bwd", 4.5, 8.0),  # autograd's thread
             ("cerebra_torch.lstm.bwd.scan", 5.0, 6.0)]
    dev = [("a", 20.0, 21.0, 1), ("b", 21.0, 23.0, 2), ("c", 23.0, 23.5, 3),
           ("d", 24.0, 24.25, 4), ("e", 25.0, 26.0, 5), ("f", 26.0, 27.0, 6)]
    launch = {1: 1.0, 2: 5.5, 3: 7.0, 4: 8.5, 5: 11.0}  # 6 has no launch time
    assert trace.attribute(dev, launch, spans) == {
        "cerebra_torch.step": 1.0, "cerebra_torch.lstm.bwd.scan": 2.0,
        "cerebra_torch.lstm.bwd": 0.5, "cerebra_torch.step.backward": 0.25}


STACK = {"name": "lstm_stack",
         "program_spans": ["cerebra_torch.lstm.fwd", "cerebra_torch.lstm.bwd"],
         "kernels": ["not read where program_spans is"]}
GEMM = "void vit::gemm_tc<false, true, vit::EpiF32>(x)"


def program_events():
    """A step's program spans (the stack's backward on autograd's thread,
    inside the main thread's `step.backward`), and one product kernel's
    name launched inside the stack's products and again outside every
    stack span."""
    dev = [("at::cuda::spin_kernel(long)", 0.0, 1.0, 1),
           ("elementwise_kernel(copy)", 2.0, 2.25, 2),  # launched in lstm.prepare
           ("wave_fwd_kernel<1, 1, 1>(x)", 2.25, 3.25, 3),
           ("scan_bwd_kernel<bf16>(x)", 3.5, 5.5, 4),
           (GEMM, 5.5, 6.0, 5),  # launched in lstm.bwd.products
           ("elementwise_kernel(cast)", 6.0, 6.125, 6),  # in lstm.bwd, outside its children
           (GEMM, 6.5, 6.75, 7),  # launched in step.backward, outside every stack span
           ("nvjet_gemm", 7.0, 7.5, 8)]  # in step.optimizer
    spans = [(0.1, 0.9, "cerebra_torch.step"), (0.15, 0.2, "cerebra_torch.lstm.prepare"),
             (0.2, 0.3, "cerebra_torch.lstm.fwd"), (0.4, 0.8, "cerebra_torch.step.backward"),
             (0.45, 0.7, "cerebra_torch.lstm.bwd"), (0.5, 0.55, "cerebra_torch.lstm.bwd.scan"),
             (0.55, 0.6, "cerebra_torch.lstm.bwd.products"),
             (0.8, 0.9, "cerebra_torch.step.optimizer")]
    launch = {2: 0.17, 3: 0.25, 4: 0.52, 5: 0.57, 6: 0.65, 7: 0.75, 8: 0.85}
    return {"dev": dev, "launch": launch, "spans": [], "host": sorted(spans)}


def test_program_span_layer_claims_by_the_innermost_span():
    """The stack owns what is launched inside its forward and backward
    spans and under them, whatever the kernel's name; the same product
    launched outside them goes to a kernel layer listed after it, or to no
    layer; the input's copy in `lstm.prepare` goes to no layer."""
    vit = {"name": "vit_block", "kernels": ["vit::"]}
    r = trace.reduce(program_events(), [STACK, vit], k=1)
    assert r["layer_s"] == {"lstm_stack": 3.625, "vit_block": 0.25}
    assert r["other_s"] == 0.75  # the prepare's copy and the optimizer's product
    r = trace.reduce(program_events(), [STACK], k=1)
    assert r["layer_s"] == {"lstm_stack": 3.625} and r["other_s"] == 1.0


def test_layers_claim_in_kind_order():
    """Harness spans, then program spans, then kernel names, each in name
    order; a layer's kind is the first key of KINDS it has."""
    files = trace.load_layers()
    order = [trace.KINDS.index(trace.kind(l)) for l in files]
    assert order == sorted(order)
    assert trace.kind(STACK) == "program_spans"
    assert trace.under("cerebra_torch.lstm.bwd.scan", STACK["program_spans"])
    assert not trace.under("cerebra_torch.lstm.bwdx", STACK["program_spans"])
    assert not trace.under("cerebra_torch.lstm.prepare", STACK["program_spans"])


def test_union():
    assert trace.union([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]


def test_short_names():
    assert trace.short("void vit::gemm_tc<true, false, vit::EpiPartial>(a, b)") == \
        "vit::gemm_tc<true, false, vit::EpiPartial>"
    assert trace.short("nvjet_tst_64x8") == "nvjet_tst_64x8"
