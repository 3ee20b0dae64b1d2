"""The card's ms a batch from the program's stage marks of the BEV
backbone and center head and of the decode and NMS."""

UNIT = "ms"
STAGES = ("bev+head", "decode+nms", "proposals")


def read(rec):
    if rec.get("entry") != "predict" or not rec.get("stage_ms"):
        return None
    return sum(rec["stage_ms"].get(s, 0.0) for s in STAGES) / rec["batches"]
