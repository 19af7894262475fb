"""The prefill kernel's share of its roofline over the traced slice:
the bounds of its calls there (``roofline.prefill_attention``, one call a
layer of each prefill) over its kernels' device time, in percent."""

from bench_port.mfu import roofline_share

KERNELS = ("flash_bf16_kernel", "flash_merge_kernel")


def read(rec):
    return roofline_share(rec, "prefill", KERNELS)
