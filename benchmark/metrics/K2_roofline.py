"""Kernel K2's share of its roofline: the least time the card could take
for the traced window's K2 work (benchmark/work.py, counted from the input)
over K2's device time in the trace."""

UNIT = "%"


def read(rec):
    t = rec.get("kernel_s", {}).get("K2", 0.0)
    bound = rec.get("bound_s", {}).get("K2")
    if t <= 0 or bound is None:
        return None
    return 100.0 * bound / t
