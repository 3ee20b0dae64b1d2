"""The quality ladder on synthetic sequences (port of
tools/ladder_synthetic.py).

The reference's product is the pipeline ladder DET 76.24 -> +TRK 76.44 ->
+GRM/PRM 79.79 -> +CRM 81.70 APH on Waymo val.  No Waymo data ships with
the repository, so this tool runs the same ladder on HELD-OUT synthetic
sequences (`SyntheticWaymoDataset`) with the native evaluator:

  stage 0  DET        raw detector output
  stage 1  +TRK       track + combine (drop re-merge off)
  stage 2  +GRM/PRM   geometry + position refinement
  stage 3  +CRM       confidence rescoring

Modes:
  --make_refine_data OUT_DIR : run DET + track + daemon over TRAIN-seed
      sequences and dump per-class refining records (with the CRM IoU
      label of each record) as OUT_DIR/<class>/<seq>.pkl, the layout
      `train_refine` reads.
  --relabel_crm DIR : rewrite each record's iou_gt in place as the IoU of
      its GRM/PRM-REFINED boxes against the GT (CRM must score the boxes
      it sees at inference); needs the --grm/--prm models.
  default : run the ladder on val-seed sequences, print the 4-row table
      (envelope AP) and append it to --out_md (LADDER_TORCH.md; '' writes
      nothing).
  --recipe WORK_DIR : the three in order, as run_synthetic_ladder.sh runs
      them (`run_recipe`): records of --train_n_seq train-seed sequences,
      GRM/PRM/CRM a class for --refine_steps steps with the relabel
      before CRM, then the ladder on --n_seq val-seed sequences.

    python -m detzero_tpu_torch.tools.ladder_synthetic \
        --cfg_file configs/det_model_cfgs/centerpoint_synthetic_v3.yaml \
        --ckpt output/centerpoint_synthetic_v3/default/ckpt \
        [--device cuda] [--val_seed 1234] [--n_seq 8] \
        [--grm Vehicle=CFG:CKPT ...] [--prm ...] [--crm ...]

The detector is the config's CenterPoint in float32 with the newest
checkpoint of --ckpt (what `train_det` writes), run on --device (the card
unless `--device cpu`; no fallback).  On the card the eval convs (K2) run
in bf16 whatever the model's dtype, so the card's boxes differ from the
CPU's by that rounding.  The refiners run on the same device.
`main(argv)` runs in-process and returns what it computed.
"""

from __future__ import annotations

import argparse
import datetime
import pickle
import time
from pathlib import Path

import numpy as np

DEFAULT_CFG = "configs/det_model_cfgs/centerpoint_synthetic.yaml"
DEFAULT_OUT_MD = "LADDER_TORCH.md"
STAGES = ("grm", "prm", "crm")
CLASSES = ("Vehicle", "Pedestrian", "Cyclist")   # the recipe's refiners
REFINE_CFG = "configs/ref_model_cfgs/synthetic_{}.yaml"
REFINE_BATCH = 4


def build_synthetic(cfg, seed, n_seq, logger=None):
    """The config's synthetic dataset at `seed`, `n_seq` sequences of 16
    frames, in test mode."""
    from detzero_tpu_torch.tools.common import build_detection_dataset

    cfg = cfg.__class__({**cfg})
    cfg["SYNTHETIC_SEED"] = int(seed)
    cfg["SYNTHETIC_LENGTH"] = int(n_seq) * 16
    return build_detection_dataset(cfg, training=False, logger=logger)


def run_det(cfg, ckpt_dir, dataset, logger, batch_size=4, nms_pre=256,
            nms_post=128, device="cuda", timings=None):
    """Detector inference over the whole dataset -> det_annos list, on
    `device` (the card unless the caller names the CPU; no card raises).

    nms_pre/nms_post stay far below the Waymo-scale budgets, as the
    reference's: synthetic scenes hold at most 32 objects.  The score
    floor is 0 (AP integrates over all operating points).  `timings`,
    when a dict, gets `test_det.run_inference`'s."""
    import torch

    from detzero_tpu_torch.core.checkpoint import CheckpointManager
    from detzero_tpu_torch.data.waymo_dataset import build_dataloader
    from detzero_tpu_torch.tools.common import build_detector, resolve_device
    from detzero_tpu_torch.tools.test_det import run_inference

    model = build_detector(cfg, resolve_device(str(device)),
                           dtype=torch.float32)
    step = CheckpointManager(ckpt_dir).restore(model) \
        if Path(ckpt_dir).is_dir() else None
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    logger.info(f"detector checkpoint step {step}")
    decode = {"SCORE_THRESH": 0.0, "NMS_THRESH": 0.7,
              "NMS_PRE_MAXSIZE": nms_pre, "NMS_POST_MAXSIZE": nms_post}
    cfg = {**cfg, "TTA": False,
           "MODEL": {**cfg["MODEL"], "POST_PROCESSING": decode}}
    loader = build_dataloader(dataset, batch_size, shuffle=False,
                              drop_last=False)
    return run_inference(model, dataset, loader, cfg, timings=timings)


def scene_tables(dataset):
    """Per-frame raw points / GT boxes / GT names."""
    pts, gtb, gtn = [], [], []
    for i in range(len(dataset)):
        p, b, n = dataset.generate_scene(i)
        pts.append(p)
        gtb.append(b)
        gtn.append(n)
    return pts, gtb, gtn


def eval_stage(preds_per_frame, gt_boxes, gt_names, class_names,
               ap_mode="envelope"):
    from detzero_tpu_torch.pipeline.evaluator import evaluate_detection

    gts = [{"gt_boxes": b, "name": n, "num_points": np.full(len(b), 120)}
           for b, n in zip(gt_boxes, gt_names)]
    return evaluate_detection(preds_per_frame, gts,
                              class_names=tuple(class_names),
                              ap_mode=ap_mode)


def det_annos_to_preds(det_annos):
    return [{"boxes_lidar": np.asarray(d["boxes_lidar"])[:, :7],
             "score": np.asarray(d["score"]), "name": np.asarray(d["name"])}
            for d in det_annos]


def frames_to_preds(frames, class_names):
    out = []
    for fr in frames:
        names = np.asarray([class_names[int(l)] for l in fr["labels"]])
        out.append({"boxes_lidar": np.asarray(fr["boxes"]).reshape(-1, 7),
                    "score": np.asarray(fr["scores"]), "name": names})
    return out


def load_stages(args, device, kinds, logger):
    """{kind: (model, sampler kwargs) or {class: pair}} of the refiners
    named by --<kind> CLS=CFG:CKPT lists or --<kind>_cfg/_ckpt."""
    from detzero_tpu_torch.tools.run_offboard import load_refiner

    stages = {}
    for stage in kinds:
        per_cls = getattr(args, stage)
        cfg_p = getattr(args, f"{stage}_cfg")
        ck = getattr(args, f"{stage}_ckpt")
        if per_cls:
            stages[stage] = {}
            for spec in per_cls:
                cls, rest = spec.split("=", 1)
                scfg, sck = rest.split(":", 1)
                stages[stage][cls] = load_refiner(scfg, sck, device)
                logger.info(f"{stage}[{cls}]: loaded {scfg} @ {sck}")
        elif cfg_p and ck:
            stages[stage] = load_refiner(cfg_p, ck, device)
            logger.info(f"{stage}: loaded {cfg_p} @ {ck}")
    return stages


def relabel_crm(root, pipe, logger):
    """Rewrite every record's iou_gt under root/<class>/*.pkl as the IoU of
    the boxes `pipe` refines against the GT.  Returns {path: records}."""
    from detzero_tpu_torch.pipeline import daemon

    out = {}
    for cls_dir in sorted(d for d in Path(root).iterdir() if d.is_dir()):
        for pkl_p in sorted(cls_dir.glob("*.pkl")):
            with open(pkl_p, "rb") as f:
                recs = pickle.load(f)
            g, c, h, _ = pipe.refine(recs)
            ious = daemon.generate_iou_gt(recs, g or None, c or None,
                                          h or None)
            for oid, rec in recs.items():
                rec["iou_gt"] = ious[oid]
            with open(pkl_p, "wb") as f:
                pickle.dump(recs, f)
            out[pkl_p] = recs
            logger.info(f"relabeled {pkl_p} ({len(recs)} tracks)")
    return out


def make_refine_data(out_root, seqs, frame_of, pts, gtb, class_names):
    """DET frames -> track -> daemon (with GT) -> IoU labels -> per-class
    <out_root>/<class>/<seq>.pkl.  Returns the records written a class."""
    from detzero_tpu_torch.pipeline import daemon
    from detzero_tpu_torch.pipeline.offboard import OffboardPipeline

    out_root = Path(out_root)
    pipe = OffboardPipeline()
    n_rec = {c: 0 for c in class_names}
    for seq, frames in seqs.items():
        fids = frame_of[seq]
        tr = pipe.track(frames)
        objs = daemon.prepare_object_data(
            tr, [pts[i] for i in fids], [np.eye(4)] * len(fids),
            gt_boxes=[gtb[i] for i in fids])
        ious = daemon.generate_iou_gt(objs, None)
        per_cls = {c: {} for c in class_names}
        for oid, rec in objs.items():
            rec = dict(rec)
            rec["iou_gt"] = ious[oid]
            per_cls[class_names[int(rec.get("label", 0))]][oid] = rec
        for cls, d in per_cls.items():
            if not d:
                continue
            out = out_root / cls / f"{seq}.pkl"
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out, "wb") as f:
                pickle.dump(d, f)
            n_rec[cls] += len(d)
    return n_rec


def format_table(rows, class_names):
    hdr = f"| stage | mean AP L2 | mean APH L2 | " \
          f"{' | '.join(c + ' AP' for c in class_names)} |"
    sep = "|" + "---|" * (3 + len(class_names))
    lines = [hdr, sep]
    for name, res in rows:
        cells = [f"{res['mean']['AP_L2']:.4f}", f"{res['mean']['APH_L2']:.4f}"]
        cells += [f"{res[c]['AP_L2']:.4f}" for c in class_names]
        lines.append(f"| {name} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def iou_gt_of(root):
    """{record file: {object id: iou_gt}} under root/<class>/."""
    return {p: {oid: np.asarray(r["iou_gt"]) for oid, r in
                pickle.loads(p.read_bytes()).items()}
            for p in sorted(Path(root).glob("*/*.pkl"))}


def train_refiners(kind, data, models, device, steps, class_names,
                   logger, log_every=10):
    """`train_refine` of `kind` at REFINE_CFG, one model a class, on the
    records under `data`, in-process.  A class without records (train_refine
    returns None, as the reference's) or whose tracks cannot fill one batch
    (train_refine raises TooFewTracks; the reference's training would loop
    on an empty epoch) is left out and keeps its unrefined boxes.  Returns
    {class: {"spec": CLS=CFG:CKPT, "ckpt", "seconds"} or {"skipped": why}}."""
    from detzero_tpu_torch.tools import train_refine

    yaml = REFINE_CFG.format(kind)
    out = {}
    for cls in class_names:
        t0 = time.perf_counter()
        try:
            trainer = train_refine.main(
                ["--cfg_file", yaml, "--device", str(device),
                 "--output_dir", str(models), "--extra_tag", cls,
                 "--max_steps", str(steps), "--batch_size", str(REFINE_BATCH),
                 "--log_every", str(log_every),
                 "--set", "DATA_PATH", str(data), "CLASS_NAME", cls])
        except train_refine.TooFewTracks as e:
            out[cls] = {"skipped": str(e)}
        else:
            out[cls] = {"skipped": "no records"} if trainer is None else {}
        if "skipped" in out[cls]:
            logger.info(f"{kind} {cls}: {out[cls]['skipped']}: not trained")
            continue
        ckpt = Path(models) / Path(yaml).stem / cls / "ckpt"
        out[cls] = {"spec": f"{cls}={yaml}:{ckpt}", "ckpt": ckpt,
                    "seconds": time.perf_counter() - t0}
        logger.info(f"{kind} {cls}: {steps} steps in "
                    f"{out[cls]['seconds']:.1f} s")
    return out


def run_recipe(ckpt, cfg_file, work, device="cuda", train_seq=24, val_seq=8,
               refine_steps=1500, det_batch=4, train_seed=0, val_seed=1234,
               out_md=DEFAULT_OUT_MD, refine_log_every=10):
    """The whole ladder from a trained detector (run_synthetic_ladder.sh):
      1. refining records of `train_seq` train-seed sequences under
         work/refine_data;
      2. GRM and PRM a class, CRM's labels rewritten from the boxes they
         refine, then CRM a class, `refine_steps` steps at batch
         REFINE_BATCH, under work/models;
      3. the 4-row ladder on `val_seq` val-seed sequences, appended to
         `out_md` ('' writes nothing).
    Every step runs `main` or `train_refine.main` on `device`.  Returns
    {"records": the refine-data result, "relabel_changed": records whose
    iou_gt the relabel changed, "refiners": {kind: train_refiners'},
    "ladder": the ladder result, "seconds": {step: wall seconds}}."""
    from detzero_tpu_torch.core.logger import create_logger

    logger = create_logger()
    work = Path(work)
    data, models = work / "refine_data", work / "models"
    det = ["--cfg_file", str(cfg_file), "--ckpt", str(ckpt), "--device",
           str(device), "--batch_size", str(det_batch)]
    res = {"refiners": {}, "seconds": {}}
    t0 = time.perf_counter()
    res["records"] = main(det + ["--make_refine_data", str(data), "--n_seq",
                                 str(train_seq), "--train_seed",
                                 str(train_seed)])
    res["seconds"]["records"] = time.perf_counter() - t0
    stage_args = []
    for kind in STAGES:
        if kind == "crm":
            # CRM's labels are the IoU of the GRM/PRM-REFINED boxes against
            # the GT: CRM must score the boxes it sees at inference, so it
            # trains only after GRM/PRM exist
            t0 = time.perf_counter()
            before = iou_gt_of(data)
            main(det + ["--relabel_crm", str(data)] + stage_args)
            after = iou_gt_of(data)
            res["relabel_changed"] = sum(
                not np.array_equal(v, after[p][oid])
                for p, recs in before.items() for oid, v in recs.items())
            res["seconds"]["relabel"] = time.perf_counter() - t0
            logger.info(f"relabel: iou_gt of {res['relabel_changed']} "
                        f"records changed")
        t0 = time.perf_counter()
        trained = train_refiners(kind, data, models, device, refine_steps,
                                 CLASSES, logger, refine_log_every)
        res["refiners"][kind] = trained
        res["seconds"][kind] = time.perf_counter() - t0
        specs = [r["spec"] for r in trained.values() if "spec" in r]
        if specs:
            # all classes ride ONE --<kind> occurrence: argparse's nargs=*
            # keeps only the last of a repeated flag
            stage_args += [f"--{kind}", *specs]
    t0 = time.perf_counter()
    res["ladder"] = main(det + ["--n_seq", str(val_seq), "--val_seed",
                                str(val_seed), "--out_md", out_md]
                         + stage_args)
    res["seconds"]["ladder"] = time.perf_counter() - t0
    logger.info("wall seconds a step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in res["seconds"].items()))
    return res


def parse_args(argv=None):
    p = argparse.ArgumentParser("synthetic pipeline ladder")
    p.add_argument("--cfg_file", default=DEFAULT_CFG)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--device", default="cuda",
                   help="device of the detector and the refiners ('cuda' "
                        "by default; 'cpu' runs every kernel's plain "
                        "version)")
    p.add_argument("--val_seed", type=int, default=1234)
    p.add_argument("--n_seq", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--make_refine_data", default=None,
                   help="dump refining records for TRAIN-seed sequences "
                        "to this directory instead of running the ladder")
    p.add_argument("--relabel_crm", default=None,
                   help="refine-data dir: recompute each record's iou_gt "
                        "as the IoU of its GRM/PRM-REFINED boxes vs GT; "
                        "needs --grm/--prm models; rewrites pkls in place")
    p.add_argument("--recipe", default=None, metavar="WORK_DIR",
                   help="run the whole recipe (records, the nine refiner "
                        "trainings, the ladder) under this directory")
    p.add_argument("--train_n_seq", type=int, default=24,
                   help="--recipe: train-seed sequences of the records")
    p.add_argument("--refine_steps", type=int, default=1500,
                   help="--recipe: steps of each refiner training")
    p.add_argument("--train_seed", type=int, default=0)
    p.add_argument("--out_md", default=DEFAULT_OUT_MD,
                   help="markdown file the ladder table is appended to "
                        "('' writes nothing)")
    for stage in STAGES:
        p.add_argument(f"--{stage}_cfg", default=None)
        p.add_argument(f"--{stage}_ckpt", default=None)
        p.add_argument(f"--{stage}", nargs="*", default=None,
                       metavar="CLS=CFG:CKPT",
                       help=f"per-class {stage} models, e.g. "
                            f"Vehicle=cfgs/v.yaml:out/v/ckpt (all classes "
                            f"in one occurrence of the flag)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns, by mode: run_recipe's result; {"relabeled": {path:
    records}};
    {"n_records": {class: count}, "det_annos", "timings"}; or {"rows":
    [(stage, results)], "table", "waymo101", "det_annos", "timings"}."""
    from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
    from detzero_tpu_torch.core.logger import create_logger
    from detzero_tpu_torch.pipeline.offboard import OffboardPipeline
    from detzero_tpu_torch.tools.common import resolve_device
    from detzero_tpu_torch.tools.run_track import group_by_sequence

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.recipe:
        return run_recipe(args.ckpt, args.cfg_file, args.recipe, args.device,
                          args.train_n_seq, args.n_seq, args.refine_steps,
                          args.batch_size, args.train_seed, args.val_seed,
                          args.out_md)
    logger = create_logger()
    cfg = cfg_from_yaml_file(args.cfg_file, Config())
    class_names = list(cfg.get("CLASS_NAMES",
                               ["Vehicle", "Pedestrian", "Cyclist"]))

    # ---------------- CRM-relabel mode (no detector needed) -------------
    if args.relabel_crm:
        stages = load_stages(args, device, ("grm", "prm"), logger)
        pipe = OffboardPipeline(class_names=class_names, **stages)
        return {"relabeled": relabel_crm(args.relabel_crm, pipe, logger)}

    seed = args.train_seed if args.make_refine_data else args.val_seed
    dataset = build_synthetic(cfg, seed, args.n_seq, logger)
    logger.info(f"{len(dataset)} frames, seed {seed}")
    timings = {}
    det_annos = run_det(cfg, args.ckpt, dataset, logger, args.batch_size,
                        device=device, timings=timings)
    pts, gtb, gtn = scene_tables(dataset)

    seqs = group_by_sequence(det_annos, class_names)
    frame_of = {}  # seq -> list of global frame indices
    for d in det_annos:
        frame_of.setdefault(d["sequence_name"], []).append(int(d["frame_id"]))

    # ---------------- refine-data mode ----------------------------------
    if args.make_refine_data:
        n_rec = make_refine_data(args.make_refine_data, seqs, frame_of, pts,
                                 gtb, class_names)
        logger.info(f"refine records written: {n_rec} -> "
                    f"{args.make_refine_data}")
        return {"n_records": n_rec, "det_annos": det_annos,
                "timings": timings}

    # ---------------- ladder mode ---------------------------------------
    stages = load_stages(args, device, STAGES, logger)
    rows = []  # (stage_name, results)
    det_preds = det_annos_to_preds(det_annos)
    rows.append(("DET", eval_stage(det_preds, gtb, gtn, class_names)))
    # envelope against waymo101 on this run: both are recorded so that
    # the protocols' difference is on the table
    r101 = eval_stage(det_preds, gtb, gtn, class_names, ap_mode="waymo101")
    logger.info(
        f"DET mean AP_L2 envelope {rows[0][1]['mean']['AP_L2']:.4f} vs "
        f"waymo101 {r101['mean']['AP_L2']:.4f} (delta "
        f"{rows[0][1]['mean']['AP_L2'] - r101['mean']['AP_L2']:+.4f})")

    def run_ladder(pipe, label):
        t0 = time.perf_counter()
        all_preds = [None] * len(dataset)
        for seq, frames in seqs.items():
            fids = frame_of[seq]
            res = pipe.run_sequence(frames, [pts[i] for i in fids],
                                    [np.eye(4)] * len(fids))
            for local_i, fr_preds in enumerate(
                    frames_to_preds(res["frames"], class_names)):
                all_preds[fids[local_i]] = fr_preds
        empty = {"boxes_lidar": np.zeros((0, 7)), "score": np.zeros(0),
                 "name": np.zeros(0, object)}
        all_preds = [p if p is not None else dict(empty) for p in all_preds]
        rows.append((label, eval_stage(all_preds, gtb, gtn, class_names)))
        timings[label] = {"wall_s": time.perf_counter() - t0,
                          "stages": pipe.timer.as_dict()}

    run_ladder(OffboardPipeline(class_names=class_names), "+TRK")
    if "grm" in stages or "prm" in stages:
        run_ladder(OffboardPipeline(class_names=class_names,
                                    grm=stages.get("grm"),
                                    prm=stages.get("prm")), "+GRM/PRM")
    if "crm" in stages:
        run_ladder(OffboardPipeline(class_names=class_names,
                                    grm=stages.get("grm"),
                                    prm=stages.get("prm"),
                                    crm=stages.get("crm")), "+CRM")

    # ---------------- report --------------------------------------------
    table = format_table(rows, class_names)
    logger.info("\n" + table)
    if args.out_md:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M")
        with open(args.out_md, "a") as f:
            f.write(f"\n## Ladder run {stamp} "
                    f"(ckpt={args.ckpt}, seed={args.val_seed}, "
                    f"n_seq={args.n_seq}, device={device_name(device)})"
                    f"\n\n{table}\n")
        logger.info(f"appended to {args.out_md}")
    return {"rows": rows, "table": table, "waymo101": r101,
            "det_annos": det_annos, "timings": timings}


def device_name(device):
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


if __name__ == "__main__":
    main()
