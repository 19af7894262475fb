"""The decode kernel's share of its roofline over the traced slice: the
bounds of its calls there (the family's ``decode_attention_bound_s``, the
live rows' contexts, summed over the layers of each step) over its
kernels' device time, in percent."""

from bench_port.mfu import roofline_share

KERNELS = ("paged_decode_bf16_kernel",)


def read(rec):
    return roofline_share(rec, "decode", KERNELS)
