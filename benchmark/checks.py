"""The comparisons that decide `correct`: what the timed path produced
against the plain reference (`reference/`), which recomputes from the same
points, GT and seeded weights.

Predict cells:
* `head_gap`: the worst relative L2 gap, over the head outputs (per head and
  output, all checked frames together), of the program's maps against the
  reference's float32 maps from the points;
* `box_miss`: the share of kept boxes, the program's and the reference's
  together, that the other side does not keep (same label, score and box),
  where the reference decodes and suppresses (rotated NMS) the program's
  own maps: the decode stage checked by itself, from the program's state.

Train cells (the first three steps of the window's own trainer):
* `loss_gap_<k>`: the relative gap of step k's loss;
* `grad_gap`: the first step's clipped gradient, read back from Adam's
  first moment: the worst leaf's gap of norms over the larger of the
  reference leaf's norm and the median leaf's;
* `change_gap`: the same for each leaf's change over the three steps, on
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others move by Adam's rounding alone);
* `grad_gap_median`, `change_gap_median`: the median leaf's gap;
* `bn_var_gap`: the first step's batch-norm variances (the program's read
  back from its running statistics): the median layer's relative L2 gap
  (`bn_var_gap_max` the worst layer's).
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference import boxes as ref_boxes
from benchmark.reference import network, train as ref_train

# a box slot matches where both keep it with the same label, a score within
# SCORE_TOL and every box number within BOX_TOL * max(1, |value|)
SCORE_TOL = 1e-5
BOX_TOL = 1e-4


class GapSum:
    """Running sums of squared gaps and references per key."""

    def __init__(self):
        self.num, self.den = {}, {}

    def add(self, key, got, ref):
        d = (got.double() - ref.double())
        self.num[key] = self.num.get(key, 0.0) + float((d * d).sum())
        self.den[key] = self.den.get(key, 0.0) + float(
            (ref.double() ** 2).sum())

    def worst(self):
        return max((self.num[k] / max(self.den[k], 1e-30)) ** 0.5
                   for k in self.num)


def box_mismatch(got, ref):
    """(boxes of either side that the other does not keep, boxes kept by
    both sides together) of two decode outputs.  Kept boxes are matched as
    sets, so one suppression decided the other way near the NMS threshold
    (float32 against float64 IoU) counts its own boxes, not every slot
    after it."""
    def kept(o):
        m = o["mask"].cpu()
        return (o["labels"].cpu().long()[m], o["scores"].cpu().double()[m],
                o["boxes"].cpu().double()[m])

    gl, gs, gb = kept(got)
    rl, rs, rb = kept(ref)
    same = ((gl[:, None] == rl[None, :])
            & ((gs[:, None] - rs[None, :]).abs() <= SCORE_TOL)
            & ((gb[:, None, :] - rb[None, :, :]).abs()
               <= BOX_TOL * torch.clamp(rb[None, :, :].abs(), min=1.0)
               ).all(-1))
    matched, used = 0, torch.zeros(len(rl), dtype=torch.bool)
    for i in range(len(gl)):
        cand = torch.nonzero(same[i] & ~used)[:, 0]
        if len(cand):
            used[cand[0]] = True
            matched += 1
    return len(gl) + len(rl) - 2 * matched, len(gl) + len(rl)


def predict_numbers(sd, frames, cfg, prec=network.F32, device="cuda"):
    """frames: (points (P, F), valid (P,), the head maps the program
    computed for it [{name: (H, W, ch)}], its output dict).  With
    prec=FP8 the frames' maps and outputs are ignored and the control (the
    reference in float8) takes the program's place."""
    gaps = GapSum()
    miss = kept = 0
    for pts, valid, maps, out in frames:
        ref_maps, _ = network.forward(sd, pts[None].to(device),
                                      valid[None].to(device), cfg)
        ref_maps = [{k: v[0] for k, v in m.items()} for m in ref_maps]
        if prec is not network.F32:
            maps, _ = network.forward(sd, pts[None].to(device),
                                      valid[None].to(device), cfg,
                                      prec=prec)
            maps = [{k: prec.q(v[0]) for k, v in m.items()} for m in maps]
            out = ref_boxes.decode(maps, cfg, quant=prec.q)
        for h, (m, r) in enumerate(zip(maps, ref_maps)):
            for k in r:
                gaps.add((h, k), m[k].to(device), r[k])
        ref_out = ref_boxes.decode([{k: v.to(device).float()
                                     for k, v in m.items()} for m in maps],
                                   cfg)
        a, b = box_mismatch(out, ref_out)
        miss, kept = miss + a, kept + b
    return {"head_gap": gaps.worst(),
            "box_miss": miss / max(kept, 1), "boxes_kept": kept}


def _gaps(got, ref):
    """Per leaf |got - ref| / max(ref, median ref)."""
    med = statistics.median(ref.values())
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}


def train_numbers(program, sd, batches, cfg, opt, total_steps,
                  prec=network.F32):
    """program: {"losses": [3 floats], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}} read from the trainer; the reference
    follows the same three steps from the same weights and batches.
    Returns (numbers, the reference's readings and the worst leaves)."""
    losses, grads, params, stats = ref_train.train_steps(
        sd, batches, cfg, opt, total_steps, prec)
    ref_bn = {k: v.double().cpu() for k, (_, v) in stats.items()}
    g_norm = {k: float(v.double().norm()) for k, v in grads.items()}
    med = statistics.median(g_norm.values())
    moved = [k for k in g_norm if g_norm[k] >= 1e-3 * med]
    c_norm = {k: float((params[k].double() - sd[k].double()).norm())
              for k in moved}
    out = {f"loss_gap_{i + 1}": abs(a - b) / max(abs(b), 1e-30)
           for i, (a, b) in enumerate(zip(program["losses"], losses))}
    g = _gaps(program["grad_norms"], g_norm)
    c = _gaps({k: program["change_norms"][k] for k in moved}, c_norm)
    bv = {k: float((program["bn_vars"][k] - v).norm() / v.norm())
          for k, v in ref_bn.items()}
    out.update(bn_var_gap=statistics.median(bv.values()),
               bn_var_gap_max=max(bv.values()))
    out.update(grad_gap=max(g.values()),
               grad_gap_median=statistics.median(g.values()),
               change_gap=max(c.values()),
               change_gap_median=statistics.median(c.values()))
    worst = {"grad": sorted(g, key=g.get)[-3:],
             "change": sorted(c, key=c.get)[-3:]}
    return out, {"losses": losses, "grad_norms": g_norm,
                 "change_norms": c_norm, "worst": worst}
