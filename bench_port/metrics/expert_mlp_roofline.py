"""The routed-expert kernel's share of its roofline over the traced
slice: the bounds of its calls there over its kernels' device time, in
percent.  A decode step calls it once a layer; each call's bound is the
family's ``expert_bound_s`` (the distinct experts' weights read once,
2 x 3 x d_model x d_expert FLOPs a routed row) at the mean routed rows
and distinct experts a call that the port's device counters of the
decode path hold (the shape's ``counters``).  Where there are no
counters (a CPU run), the distinct experts are the expectation for the
step's rows, E (1 - (1 - k / E)^rows).  None where the family has no
experts or the slice ran no expert kernel."""

from bench_port.trace import kernel_seconds

KERNELS = ("moe_rows_kernel",)


def read(rec):
    shape = rec["shape"]
    steps = [c for c in rec["slice_calls"] if c.kind == "decode"]
    seconds = kernel_seconds(rec.get("trace") or {}, KERNELS)
    if not hasattr(shape, "expert_bound_s") or seconds <= 0 or not steps:
        return None
    counters = shape.counters
    bound = 0.0
    for c in steps:
        if counters and counters["calls"] > 0:
            rows = counters["routed_rows"] / counters["calls"]
            experts = counters["distinct_experts"] / counters["calls"]
        else:
            rows = len(c.contexts) * shape.top_k
            experts = shape.expected_experts(len(c.contexts))
        bound += shape.n_layers * shape.expert_bound_s(rows, experts, rec["peaks"])
    return 100.0 * bound / seconds
