"""Median time to first token, host clock, from each request's scheduled
arrival to its first token, over the requests due in the window: the
traced run's reading of what ``run.end_to_end`` computes.  The profiled
slice slows the window's last seconds, so it reads above an untraced
run's."""

import statistics


def read(rec):
    ttft = [(lv.times[0] - lv.due) * 1e3 for lv in rec["lives"] if lv.times]
    return statistics.median(ttft) if ttft else None
