"""Device milliseconds a decode step of the grouped expert products
(``moe_rows_kernel``: gate-up with SiLU·up, then down; two launches a
layer) over the traced slice: their device time there over the slice's
decode steps.  A prefill launches them only up to ``GROUPED_MAX_ROWS``
routed rows (``ops/moe_experts.py``: 128 tokens at top 8); longer ones
compute their experts as matrix products, so in a cell whose prompts are
longer the kernels' time is the decode steps' alone.  The route, the
grouping and the combine, which every prefill launches too, are left out
(at decode ~5% of the layer's expert time; ``PERF.md``'s kernel table).
None where the slice ran none of them."""

from bench_port.trace import kernel_seconds

KERNELS = ("moe_rows_kernel",)


def read(rec):
    steps = [c for c in rec["slice_calls"] if c.kind == "decode"]
    seconds = kernel_seconds(rec.get("trace") or {}, KERNELS)
    if seconds <= 0 or not steps:
        return None
    return 1e3 * seconds / len(steps)
