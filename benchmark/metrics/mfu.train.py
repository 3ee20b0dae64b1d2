"""The training step's share of the card's bf16 peak: the useful
operations (forward, input and weight gradients) of the traced steps
(benchmark/work.py) over the seconds the same steps took unprofiled."""

from benchmark import work

UNIT = "%"


def read(rec):
    if rec.get("entry") != "train" or not rec.get("flops"):
        return None
    return 100.0 * rec["flops"] / rec["plain_s"] / work.PEAK_BF16
