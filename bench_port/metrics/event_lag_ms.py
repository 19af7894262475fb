"""Milliseconds from the hand-off of a frame to the port's event pool
(``add_tasks``) until the batch holding it was flushed into the index,
over the frames it applied in the window: ``Pool.stage_stats()``'s
``lag_s`` over its ``apply_msgs``.  None where the pool keeps no
``lag_s``."""


def read(rec):
    start, end = rec["stages"]
    if "lag_s" not in end or "lag_s" not in start:
        return None
    frames = end["apply_msgs"] - start["apply_msgs"]
    if frames <= 0:
        return None
    return 1e3 * (end["lag_s"] - start["lag_s"]) / frames
