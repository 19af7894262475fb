"""Model FLOPs of the window's decode steps, live rows only, over their
device time (CUDA events around each step) at the chip's bf16 peak, in
percent.  FLOPs from shapes (the family's ``shape(config).decode_flops``)."""

from bench_port.mfu import utilisation


def read(rec):
    return utilisation(rec, "decode")
