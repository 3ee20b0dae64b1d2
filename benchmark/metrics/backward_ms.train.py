"""The card's ms a step from the trainer's stage marks of the backward
and the optimizer (to the end of the step)."""

UNIT = "ms"
STAGES = ("backward", "optimizer")


def read(rec):
    if rec.get("entry") != "train" or not rec.get("stage_ms"):
        return None
    return sum(rec["stage_ms"].get(s, 0.0) for s in STAGES) / rec["batches"]
