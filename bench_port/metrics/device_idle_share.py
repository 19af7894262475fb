"""Share of the traced slice in which no kernel ran on the device while
a request waited or ran (the loop outside ``loop.wait``), in percent."""

from bench_port.mfu import idle_share


def read(rec):
    return idle_share(rec)
