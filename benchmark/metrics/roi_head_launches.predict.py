"""Kernels a batch that the host launched inside the `RoI head` stage (at
any depth), from the span stretch's device trace; None on a record with
no RoI head span."""

UNIT = "kernels"


def read(rec):
    kernels = rec.get("span_kernels") or {}
    if rec.get("entry") != "predict" or "RoI head" not in kernels:
        return None
    return kernels["RoI head"]
