"""Median host-clock time of the router's ``get_pod_scores`` call, over
the requests admitted in the window (the benchmark's clock around the
call)."""

import statistics


def read(rec):
    times = [lv.route_s * 1e3 for lv in rec["lives"] if lv.scores is not None]
    return statistics.median(times) if times else None
