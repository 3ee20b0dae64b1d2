"""The card's ms a step from the program's stage marks of the pillar
table, the plan and its row-padded maps, and the VFE (or the dense
gather)."""

UNIT = "ms"
STAGES = ("table", "plan", "row-pad maps", "vfe", "gather")


def read(rec):
    if rec.get("entry") != "train" or not rec.get("stage_ms"):
        return None
    return sum(rec["stage_ms"].get(s, 0.0) for s in STAGES) / rec["batches"]
