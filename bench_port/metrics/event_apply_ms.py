"""Milliseconds the port's event pool spent on a frame in the window:
its decode and apply seconds (``Pool.stage_stats()``) over the frames
it applied."""


def read(rec):
    start, end = rec["stages"]
    frames = end.get("apply_msgs", 0) - start.get("apply_msgs", 0)
    if not end or frames <= 0:
        return None
    seconds = sum(end[k] - start[k] for k in ("decode_s", "apply_s"))
    return 1e3 * seconds / frames
