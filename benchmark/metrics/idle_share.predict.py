"""The share of the unprofiled stretch in which no operation ran on the
card: 1 - the device's busy time (the union of its kernels' intervals in
the device trace of the same batches) over that stretch's seconds.  The
trace's own window is longer by the profiler's host cost."""

UNIT = "%"


def read(rec):
    if rec.get("entry") != "predict" or rec.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["plain_s"])
