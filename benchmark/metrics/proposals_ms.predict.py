"""The card's ms a batch from the program's stage mark of the second
stage's proposals (decode and NMS at ROI_BUDGET) to the RoI head's; None
on a record with no second stage."""

UNIT = "ms"


def read(rec):
    stages = rec.get("stage_ms") or {}
    if rec.get("entry") != "predict" or "proposals" not in stages:
        return None
    return stages["proposals"] / rec["batches"]
