"""Model FLOPs of the window's prefill calls over their device time
(CUDA events around each call) at the chip's bf16 peak, in percent.
FLOPs from shapes (the family's ``shape(config).prefill_flops``)."""

from bench_port.mfu import utilisation


def read(rec):
    return utilisation(rec, "prefill")
