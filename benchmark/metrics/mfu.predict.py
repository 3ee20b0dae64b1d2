"""The predict step's share of the card's bf16 peak: the useful
operations of the traced frames (benchmark/work.py) over the seconds the
same batches took unprofiled."""

from benchmark import work

UNIT = "%"


def read(rec):
    if rec.get("entry") != "predict" or not rec.get("flops"):
        return None
    return 100.0 * rec["flops"] / rec["plain_s"] / work.PEAK_BF16
