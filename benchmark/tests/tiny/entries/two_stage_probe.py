"""An entry that exists for the tests: `predict` closed loop on the cell's
configuration, its weights drawn by `Run.setup`'s defaults (the attention's
projections included), and only the center head's maps compared with the
reference (`head_gap`).
With a second stage on, `predict` returns the refined boxes, which nothing
here compares: the probe shows that a cell can bring its entry as a file,
not that a RoI head is right.  It runs untraced only."""

import time

from benchmark import checks, harness
from benchmark.reference import network

KIND = "predict"


def head_gap(sd, frames, rcfg, device):
    """The worst relative L2 gap of the program's head maps to the
    reference's over frames [(points, valid, maps)]."""
    gaps = checks.GapSum()
    for pts, valid, maps in frames:
        ref, _ = network.forward(sd, pts[None].to(device),
                                 valid[None].to(device), rcfg)
        for h, (m, r) in enumerate(zip(maps, ref)):
            for k in r:
                gaps.add((h, k), m[k].to(device), r[k][0])
    return gaps.worst()


def run(r):
    if r.trace:
        raise ValueError("the two-stage probe runs untraced only")
    r.setup()
    b = int(r.mix["batch"])
    host, nb = harness._pinned_batches(r.pool, b, ("points", "points_valid"))
    model, maps = r.model, []

    def batch(i):
        x = harness._to(host, i % nb, r.device)
        return {k: v.cpu() for k, v in model.predict(
            x["points"], x["points_valid"]).items()}

    for i in range(nb):            # warm-up: every distinct batch once
        batch(i)
    r.e2e_setup = time.perf_counter() - r.t_start
    # one center-head call a frame: the window's first pass keeps them all
    hook = model.center_head.register_forward_hook(
        lambda mod, inp, out: maps.append(out))
    i, t0 = 0, time.perf_counter()
    while i < nb or time.perf_counter() - t0 < r.seconds:
        batch(i)
        i += 1
        if i == nb:
            hook.remove()
    r.e2e = {"frames_per_s": (i * b / (time.perf_counter() - t0),
                              "frames/s")}
    peak = r.memory_peak()
    del model, batch
    r.free_program()
    frames = [(r.pool["points"][f], r.pool["points_valid"][f],
               [{k: v[0] for k, v in h.items()} for h in maps[f]])
              for f in range(nb * b)]
    numbers = {"head_gap": head_gap(r.reference_weights(), frames, r.rcfg,
                                    r.device)}
    return i, 0, numbers, peak
