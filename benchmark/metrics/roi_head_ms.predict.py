"""The card's ms a batch from the program's stage marks of the RoI head
(keypoints, pooling, attention, shared layers) and of the refined boxes,
to the end of the batch; None on a record with no second stage."""

UNIT = "ms"
STAGES = ("RoI head", "refined boxes")


def read(rec):
    stages = rec.get("stage_ms") or {}
    if rec.get("entry") != "predict" or "RoI head" not in stages:
        return None
    return sum(stages.get(s, 0.0) for s in STAGES) / rec["batches"]
