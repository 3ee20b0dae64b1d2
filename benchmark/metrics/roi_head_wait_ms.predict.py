"""The card's idle ms a batch charged to the RoI head's host work: the
span stretch's waits (`benchmark/spans.py`'s rule) of the stages `RoI
head` and `refined boxes` and the spans nested in them; None on a record
with no RoI head span."""

UNIT = "ms"
SPANS = ("RoI head", "refined boxes", "pool", "attention", "shared fc",
         "bev keypoints")


def read(rec):
    waits = rec.get("span_wait_ms")
    if (rec.get("entry") != "predict" or waits is None
            or "RoI head" not in rec.get("span_kernels", {})):
        return None
    return sum(waits.get(s, 0.0) for s in SPANS)
