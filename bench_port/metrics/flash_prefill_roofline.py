"""The prefill kernel's share of its roofline over the traced slice:
the bounds of its calls there (the family's ``prefill_attention_bound_s``,
summed over the layers of each prefill) over its kernels' device time, in
percent."""

from bench_port.mfu import roofline_share

KERNELS = ("flash_bf16_kernel", "flash_merge_kernel")


def read(rec):
    return roofline_share(rec, "prefill", KERNELS)
