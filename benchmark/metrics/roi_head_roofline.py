"""The PDV RoI head's share of its roofline: the least time the card could
take for the traced RoI heads' work (benchmark/work_pdv.py, counted by the
reference's voxel lists on the program's RoIs) over the device time of the
ops launched inside the `RoI head` stage in the span stretch."""

UNIT = "%"


def read(rec):
    t = (rec.get("span_device_ms") or {}).get("RoI head", 0.0)
    bound = (rec.get("bound_s") or {}).get("roi_head")
    if rec.get("entry") != "predict" or t <= 0 or bound is None:
        return None
    return 100.0 * bound / (t * 1e-3 * rec["batches"])
