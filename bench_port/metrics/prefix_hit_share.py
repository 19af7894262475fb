"""Share of the window's prompt tokens that a pod's prefix cache served
(the blocks its prefill reused), in percent."""


def read(rec):
    served = [lv for lv in rec["lives"] if lv.blocks is not None]
    total = sum(len(lv.req.prompt) for lv in served)
    if not total:
        return None
    return 100.0 * sum(lv.cached * rec["block_size"] for lv in served) / total
