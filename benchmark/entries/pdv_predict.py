"""The two-stage CenterPoint (`SECOND_STAGE`: proposals, the PDV RoI head,
refined boxes) through `CenterPoint.predict`, closed loop as
`harness.run_predict` runs the one-stage model, held to
`reference/pdv.py`.

On the checked batches the entry keeps, per frame, the center head's maps,
the proposals (`CenterPoint.proposals`' output), the RoI head's RoIs and
mask as it receives them and its cls logits and residuals (hooks), and the
refined output.  After the window:

* `head_gap`: the worst relative L2 gap of the head maps to the
  reference's float32 maps (`network.forward`'s, which `pdv.forward`
  computes), per head and output over the checked frames;
* `proposal_miss`: the share of proposals, the program's and the
  reference's together, that the other side lacks (`checks.box_mismatch`),
  where the program's are the RoIs the head received with the decode's
  scores and labels, and the reference decodes and suppresses the
  program's own maps at the proposal settings (`pdv.proposal_pp`);
* `roi_gap`: the worst relative L2 gap, of `cls_logit` and of
  `reg_deltas` over the valid RoIs of all checked frames, to the
  reference's float32 RoI head on the program's RoIs;
* `refined_miss`: the share of valid RoIs whose refined box or score
  differs from the reference's (`pdv.refine_boxes` of its own logits and
  residuals) by more than `BOX_TOL` or `SCORE_TOL`; `refined_box_err` and
  `refined_score_err`, the largest such gaps, are reported unlimited.

`control(cell, seed, device)` gives the same numbers with the reference in
float8 in the program's place.  `--trace 1` adds the RoI head's work
(`work_pdv.py`) and the spans' waits, launches and device time.
"""

from __future__ import annotations

import bisect
import random
import sys
import time

import torch

from benchmark import checks, harness, scene, spans, tracing, weights, work
from benchmark import work_pdv
from benchmark.reference import pdv

KIND = "predict"
# A refined RoI matches where its score is within SCORE_TOL of the
# reference's and each number of its box within BOX_TOL on the scale of
# its residual: the RoI's BEV diagonal for x and y and its height for z
# (the residual times it is the shift), the reference box's own size for
# each size (the residual is a log-ratio), radians for the heading.  On an
# H100 the bf16 program's RoIs reach these gaps in under 1% of RoIs (99th
# percentiles 0.031 and 0.247 over 20 seeds), the float8 control's in most
# (medians 0.013-0.024 and 0.36-0.50, 90th percentiles 0.047-0.089 and
# 0.76-1.49).
SCORE_TOL = 0.05
BOX_TOL = 0.25
# the spans of the RoI head (the stage marks and the spans nested in them)
ROI_SPANS = ("RoI head", "refined boxes", "pool", "attention", "shared fc",
             "bev keypoints")


def roi_cfg(config, rcfg):
    """The reference's view of a two-stage configuration."""
    m = config["MODEL"]
    return dict(rcfg, roi_budget=int(m.get("ROI_BUDGET", 128)),
                roi_grid_size=int(m.get("ROI_GRID_SIZE", 6)),
                roi_attention=bool(m.get("ROI_ATTENTION", False)))


@torch.no_grad()
def calibrate(sd, points, valid, rcfg):
    """Every batch norm's running mean and variance, the first stage's as
    `weights.calibrate` sets them and the RoI head's, from the batch
    statistics of one train-mode forward of `pdv.forward` over (points,
    valid) on its own proposals, in place."""
    stats = {}
    pdv.forward(dict(sd, _stats=stats), points, valid, rcfg, train=True)
    for prefix, (mean, var) in stats.items():
        sd[prefix + ".mean"] = mean.float()
        sd[prefix + ".var"] = var.float()
    return sd


class Seen:
    """What the program computes for each frame of a batch while `on`: the
    center head's maps, the proposals, the RoI head's input and output."""

    def __init__(self, model):
        self.on = False
        self.maps, self.props, self.heads = [], [], []
        model.center_head.register_forward_hook(self._maps)
        model.roi_head.register_forward_hook(self._head)
        proposals = model.proposals

        def keep(preds):
            out = proposals(preds)
            if self.on:
                self.props.append(out)
            return out

        model.proposals = keep

    def _maps(self, mod, args, out):
        if self.on:
            self.maps.append(out)

    def _head(self, mod, args, out):
        if self.on:
            self.heads.append({"rois": args[0], "mask": args[1],
                               "cls": out[0], "reg": out[1]})

    def take(self):
        """[(maps, proposals, head)] a frame since the last take."""
        got = list(zip(self.maps, self.props, self.heads))
        self.maps, self.props, self.heads = [], [], []
        return got


def numbers(sd, frames, rcfg, device):
    """frames: (points (P, F), valid (P,), maps [{name: (H, W, ch)}],
    proposals {scores, labels (R,)}, head {rois (R, 7), mask (R,), cls (R,),
    reg (R, 7)}, refined {boxes (R, 7), scores (R,)}) -> the numbers."""
    maps_gap, roi = checks.GapSum(), checks.GapSum()
    miss = kept = bad = rois = 0
    box_err = score_err = 0.0
    for pts, valid, maps, prop, head, refined in frames:
        mask = head["mask"].to(device)
        given = {"boxes": head["rois"][None].to(device), "mask": mask[None],
                 "scores": prop["scores"][None].to(device),
                 "labels": prop["labels"][None].to(device)}
        ref_maps, ref = pdv.forward(sd, pts[None].to(device),
                                    valid[None].to(device), rcfg,
                                    proposals=given)
        for h, (m, r) in enumerate(zip(maps, ref_maps)):
            for k in r:
                maps_gap.add((h, k), m[k].to(device), r[k][0])
        ref_prop = pdv.propose([{k: v.to(device).float()
                                 for k, v in m.items()} for m in maps], rcfg)
        a, b = checks.box_mismatch(
            dict(given, boxes=given["boxes"][0], mask=mask,
                 scores=given["scores"][0], labels=given["labels"][0]),
            dict(ref_prop, boxes=ref_prop["boxes"][:, :7]))
        miss, kept = miss + a, kept + b
        roi.add("cls", head["cls"].to(device)[mask], ref["cls_logit"][0][mask])
        roi.add("reg", head["reg"].to(device)[mask],
                ref["reg_deltas"][0][mask])
        err = _box_err(refined["boxes"].to(device)[mask],
                       ref["boxes"][0][mask], given["boxes"][0][mask])
        ds = (refined["scores"].to(device)[mask].double()
              - ref["scores"][0][mask].double()).abs()
        bad += int(((err > BOX_TOL) | (ds > SCORE_TOL)).sum())
        rois += int(mask.sum())
        box_err = max(box_err, float(err.max()) if len(err) else 0.0)
        score_err = max(score_err, float(ds.max()) if len(ds) else 0.0)
    return {"head_gap": maps_gap.worst(), "proposal_miss": miss / max(kept, 1),
            "proposals_kept": kept, "roi_gap": roi.worst(),
            "refined_miss": bad / max(rois, 1), "rois_checked": rois,
            "refined_box_err": box_err, "refined_score_err": score_err}


def _box_err(got, ref, rois):
    """Each refined box's largest gap to the reference's, on the scale of
    its residual (BOX_TOL's comment)."""
    rois, ref = rois.double(), ref.double()
    d = (got.double() - ref).abs()
    dims = rois[:, 3:6].clamp(min=1e-5)
    diag = torch.sqrt(dims[:, 0] ** 2 + dims[:, 1] ** 2)
    scale = torch.cat([diag[:, None], diag[:, None], dims[:, 2:],
                       ref[:, 3:6].clamp(min=1e-5),
                       torch.ones_like(diag)[:, None]], -1)
    return (d / scale).amax(-1)


def stretch(run_one, n):
    """`spans.stretch`'s waits, kernels and clock a batch, and the device
    ms a batch of the ops launched inside each of ROI_SPANS
    (`span_device_ms`), from one device trace with the program's spans
    recorded; {} where the program has no span recorder."""
    try:
        from detzero_tpu_torch.core import profiling
        recording, align = profiling.recording, profiling.align
    except (ImportError, AttributeError):
        return {}
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with recording() as rec:
            for i in range(n):
                run_one(i)
            torch.cuda.synchronize()
    ops, launch, host = spans.read_events(
        prof.profiler.kineto_results.events())
    clock = align(rec, host)
    ops = [(s, e, launch.get(c), k) for s, e, c, k, _ in ops]
    named = [(s.name, s.start_ns, s.end_ns) for s in rec]
    got = spans.attribute(ops, named)
    return {"span_wait_ms": {k: v / 1e6 / n
                             for k, v in got["wait_ns"].items()},
            "span_idle_ms": got["idle_ns"] / 1e6 / n,
            "span_kernels": {k: v / n for k, v in got["kernels"].items()},
            "span_device_ms": {k: v / 1e6 / n for k, v in device_ns(
                ops, named, ROI_SPANS).items()},
            "span_clock": {k.replace("_ns", "_us"): v / 1e3
                           for k, v in clock.items()}}


def device_ns(ops, named, names):
    """{name: the device ns of the ops (start, end, launch, is_kernel)
    launched inside a span of that name}; spans (name, start, end) of one
    name do not overlap."""
    out = {}
    for name in names:
        spans_ = sorted((s, e) for nm, s, e in named if nm == name)
        starts = [s for s, _ in spans_]
        total = 0
        for s, e, at, _ in ops:
            j = -1 if at is None else bisect.bisect_right(starts, at) - 1
            if j >= 0 and at < spans_[j][1]:
                total += e - s
        out[name] = total
    return out


def run(r):
    r.rcfg = roi_cfg(r.config, r.rcfg)
    r.setup(calibrate=calibrate)
    b = int(r.mix["batch"])
    host, nb = harness._pinned_batches(r.pool, b, ("points", "points_valid"))
    model, dev = r.model, r.device
    seen = Seen(model)
    predict = r.fault.get("predict_call", lambda m, p, v: m.predict(p, v))

    def batch(i):
        x = harness._to(host, i % nb, dev)
        out = predict(model, x["points"], x["points_valid"])
        return {k: v.cpu() for k, v in out.items()}

    for i in range(nb):          # warm-up: every distinct batch once
        batch(i)
    harness._sync(dev)
    rng = random.Random(r.seed)
    n_check = int(r.mix["check_batches"])
    n_first = harness.TRACED["predict"] if r.trace else nb
    check = set(rng.sample(range(n_first), min(n_check, n_first)))
    saved, rois_of, missing = {}, {}, [0]

    def one(i):
        seen.on = i in check or r.trace
        out = batch(i)
        if seen.on:
            got = seen.take()
            if len(got) != b:
                missing[0] += b - len(got)
            rois_of[i] = [(h["rois"], h["mask"]) for _, _, h in got]
            if i in check:
                saved[i] = (out, got)
        return out

    harness._settle()
    setup_s = time.perf_counter() - r.t_start
    if r.trace:
        n = harness.TRACED["predict"]
        rec = tracing.traced(one, n, [model])
        rec.update(stretch(one, n))
        frames = [(i % nb) * b + j for i in range(n) for j in range(b)]
        works = r.work_of(frames)
        roi_works = [work_pdv.frame_work(
            r.pool["points"][(i % nb) * b + j].to(dev),
            r.pool["points_valid"][(i % nb) * b + j].to(dev), rois[0],
            mask[0], r.rcfg, r.shapes) for i in range(n) for j, (rois, mask) in
            enumerate(rois_of[i])]
        rec["bound_s"] = {
            "K2": sum(work.k2_bound([works[f]]) for f in frames),
            "roi_head": sum(work_pdv.bound_s(w) for w in roi_works)}
        rec["flops"] = (sum(work.flops(works[f], False) for f in frames)
                        + sum(w["ops"] for w in roi_works))
        rec.update(batches=n, frames=n * b)
        r.record.update(rec)
        harness._report_trace(rec)
        _report_spans(rec)
        attempted = n
    else:
        i = 0
        before = harness._cpu_s()
        t0 = time.perf_counter()
        while True:
            one(i)
            i += 1
            e = time.perf_counter()
            if e - t0 >= r.seconds and i > max(check):
                break
        harness._report_window(f"{i} batches", e - t0, before)
        r.e2e = {"frames_per_s": (i * b / (e - t0), "frames/s")}
        attempted = i
    r.e2e_setup = setup_s
    peak = r.memory_peak()
    del model, batch, one, seen
    r.free_program()
    frames = []
    for i in sorted(saved):
        out, got = saved[i]
        for j, (maps, prop, head) in enumerate(got):
            f = (i % nb) * b + j
            frames.append((r.pool["points"][f], r.pool["points_valid"][f],
                           [{k: v[0] for k, v in h.items()} for h in maps],
                           {k: v[0] for k, v in prop.items()},
                           {k: v[0] for k, v in head.items()},
                           {k: v[j] for k, v in out.items()}))
    return attempted, missing[0], numbers(r.reference_weights(), frames,
                                          r.rcfg, dev), peak


def _report_spans(rec):
    """One line on standard error: the RoI head's spans a batch."""
    if "span_wait_ms" not in rec:
        return
    print("spans a batch: wait ms " + ", ".join(
        f"{k} {rec['span_wait_ms'].get(k, 0.0):.4f}" for k in ROI_SPANS)
        + f"; idle {rec['span_idle_ms']:.4f}; RoI head kernels "
        f"{rec['span_kernels'].get('RoI head', 0.0)}, device ms "
        f"{rec['span_device_ms']}", file=sys.stderr)


@torch.no_grad()
def control(cell, seed, device):
    """The numbers with the reference in float8 in the program's place, on
    the frames a run checks first."""
    r = harness.Run(cell, seed, 0, False, device, time.perf_counter())
    rcfg = roi_cfg(r.config, r.rcfg)
    shapes = harness.state_shapes(harness.build_model(r.config, "meta"))
    pool = scene.make_pool(r.mix, seed, int(r.config["NUM_POINT_BUDGET"]),
                           int(r.config["MAX_OBJS"]), device)
    sd = calibrate(weights.make(shapes, seed, device), pool["points"][:1],
                   pool["points_valid"][:1], rcfg)
    frames = []
    for f in range(int(r.mix["batch"]) * int(r.mix["check_batches"])):
        pts, valid = pool["points"][f], pool["points_valid"][f]
        maps, out = pdv.forward(sd, pts[None], valid[None], rcfg,
                                prec=pdv.FP8)
        frames.append((pts, valid,
                       [{k: pdv.FP8.q(v[0]) for k, v in m.items()}
                        for m in maps],
                       {"scores": out["roi_scores"][0],
                        "labels": out["roi_labels"][0]},
                       {"rois": out["rois"][0], "mask": out["roi_mask"][0],
                        "cls": out["cls_logit"][0],
                        "reg": out["reg_deltas"][0]},
                       {"boxes": out["boxes"][0], "scores": out["scores"][0]}))
    return numbers(sd, frames, rcfg, device)
