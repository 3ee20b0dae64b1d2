"""Detection inference and evaluation CLI (port of tools/test_det.py;
reference detection/tools/test.py surface), with test-time augmentation
(`--set TTA True`: each frame's variants fused by WBF) and the result
pickle that the tracking stage reads:

    python -m detzero_tpu_torch.tools.test_det \
        --cfg_file configs/det_model_cfgs/centerpoint_5sweeps.yaml \
        --save_to_file
    python -m detzero_tpu_torch.tools.test_det \
        --cfg_file configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml \
        --device cpu --save_to_file --max_batches 4

Restores the newest checkpoint of `--ckpt` (by default the experiment's
<output_dir>/<cfg stem>/<extra_tag>/ckpt, where train_det writes), runs
`run_inference` over the test split and scores the detections with the
dataset's `evaluation`.  `main(argv)` runs in-process and returns what it
computed (`--eval_all`: one such dict a checkpoint).

`--data_parallel` under torchrun or SLURM shards each global batch
(BATCH_SIZE_PER_DEVICE x the ranks, the tail padded) over the ranks, one
card each, and gathers the detections to rank 0 in the dataset's order;
rank 0 alone writes result.pkl and evaluates, the others return None.
Under TTA, with one rank, or without the flag, rank 0 runs the
single-process evaluation alone (the reference shards only when it has
more than one device and no TTA, tools/test_det.py:51).
"""

from __future__ import annotations

import itertools
import pickle
import time

import numpy as np
import torch

# seconds between looks at the checkpoint directory under --eval_all
POLL_S = 30.0


def decode_kwargs(cfg):
    """CenterPoint.predict's decode arguments from MODEL.POST_PROCESSING."""
    pp = cfg.get("MODEL", {}).get("POST_PROCESSING", {})
    return dict(score_thresh=float(pp.get("SCORE_THRESH", 0.1)),
                nms_thresh=float(pp.get("NMS_THRESH", 0.7)),
                nms_pre=int(pp.get("NMS_PRE_MAXSIZE", 1024)),
                nms_post=int(pp.get("NMS_POST_MAXSIZE", 256)))


def fuse_tta(dicts, batch, class_names):
    """One frame's TTA variants (prediction dicts in the order of
    batch["tta_name"]) -> one dict: each variant's boxes carried back to
    the original frame, then WBF over all of them with n_models = the
    number of variants."""
    from detzero_tpu_torch.data import tta as tta_mod
    from detzero_tpu_torch.ops import wbf

    names, boxes, scores = [], [], []
    for d, name in zip(dicts, batch["tta_name"]):
        boxes.append(tta_mod.invert_boxes(d["boxes_lidar"], name))
        names.append(d["name"])
        scores.append(d["score"])
    n, b, s = wbf.wbf_online(
        np.concatenate(names), np.concatenate(boxes), np.concatenate(scores),
        class_names=tuple(class_names), n_models=len(dicts))
    return {"name": n, "score": s, "boxes_lidar": b,
            "frame_id": dicts[0]["frame_id"],
            "sequence_name": dicts[0]["sequence_name"],
            "pose": dicts[0]["pose"]}


def run_inference(model, dataset, loader, cfg, max_batches=None,
                  timings=None):
    """The detections of `loader(0)`'s batches (all, or the first
    `max_batches`) in the reference's result schema: one dict a frame
    (name, score, boxes_lidar, frame_id, sequence_name, pose; with TTA the
    fused variants of the frame).  `model.predict` runs on the model's
    device.  `timings`, when a dict, gets the host seconds spent waiting
    for the loader ("load_s"), in predict up to the detections on the host
    ("predict_s") and in the TTA fusion ("wbf_s"), and the frames
    ("frames") and samples ("samples") seen."""
    device = next(model.parameters()).device
    kwargs = decode_kwargs(cfg)
    tta = bool(cfg.get("TTA", False))
    t = {"load_s": 0.0, "predict_s": 0.0, "wbf_s": 0.0, "frames": 0,
         "samples": 0}
    det_annos = []
    epoch = loader(0)
    batches = itertools.islice(epoch, max_batches)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        t1 = time.perf_counter()
        if batch is None:
            break
        pts = torch.from_numpy(batch["points"]).to(device)
        pv = torch.from_numpy(batch["points_valid"]).to(device)
        with torch.no_grad():
            preds = model.predict(pts, pv, **kwargs)
        dicts = dataset.generate_prediction_dicts(batch, preds)
        t2 = time.perf_counter()
        if tta:
            dicts = [fuse_tta(dicts, batch, cfg.get("CLASS_NAMES"))]
        t["wbf_s"] += time.perf_counter() - t2
        t["load_s"] += t1 - t0
        t["predict_s"] += t2 - t1
        t["samples"] += len(batch["points"])
        t["frames"] += len(dicts)
        det_annos.extend(dicts)
    epoch.close()
    if timings is not None:
        timings.update(t)
    return det_annos


def gather_frames(det_annos, world, batch_size, n_frames):
    """Every rank's `run_inference` output (a dict a sample, batch_size
    a batch, as many full batches on every rank: the loader pads the tail
    global batch) in the dataset's order: global batch by global batch,
    each rank's slice in rank order, cut at `n_frames`, which drops the
    padding at the end."""
    from detzero_tpu_torch.parallel.trainer import eval_gather

    gathered = eval_gather(det_annos)
    per_rank = len(gathered) // world
    return [gathered[r * per_rank + i]
            for g in range(0, per_rank, batch_size) for r in range(world)
            for i in range(g, g + batch_size)][:n_frames]


def main(argv=None):
    from detzero_tpu_torch.core.checkpoint import CheckpointManager
    from detzero_tpu_torch.data.waymo_dataset import build_dataloader
    from detzero_tpu_torch.core.mesh import broadcast_object
    from detzero_tpu_torch.tools.common import (
        base_parser, build_detection_dataset, build_detector,
        init_data_parallel, load_config, setup_experiment,
    )

    parser = base_parser("detzero_tpu_torch detection eval")
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint directory (default: the "
                             "experiment's ckpt/)")
    parser.add_argument("--save_to_file", action="store_true")
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--eval_all", action="store_true",
                        help="poll the ckpt dir and evaluate every new "
                             "checkpoint (reference repeat_eval_ckpt)")
    parser.add_argument("--max_waiting_mins", type=float, default=30.0)
    parser.add_argument("--ap_mode", default="envelope",
                        choices=["envelope", "waymo101"],
                        help="waymo101 = exact 101-score-cutoff protocol")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard eval batches over the ranks of a "
                             "torchrun or SLURM launch, one card each "
                             "(reference DistributedSampler eval, "
                             "datasets/__init__.py:16-36); global batch = "
                             "BATCH_SIZE_PER_DEVICE * ranks")
    args = parser.parse_args(argv)
    device, rank, world = init_data_parallel(args.device)
    cfg = load_config(args)
    dp = args.data_parallel and world > 1 and not cfg.get("TTA", False)
    if world > 1 and not dp and rank != 0:
        return None             # rank 0 runs the single-process evaluation
    if not dp:
        world = 1
    exp_dir, logger = setup_experiment(args, cfg, "test")

    dataset = build_detection_dataset(cfg, training=False, logger=logger)
    model = build_detector(cfg, device)
    batch_size = 1 if cfg.get("TTA", False) else \
        int(cfg.get("OPTIMIZATION", {}).get("BATCH_SIZE_PER_DEVICE", 1))
    if dp:
        logger.info(f"data-parallel eval over {world} ranks, global batch "
                    f"{batch_size * world}")
    loader = build_dataloader(dataset, batch_size, shuffle=False,
                              num_workers=args.workers, drop_last=False,
                              rank=rank if dp else 0, world=world)
    mgr = CheckpointManager(args.ckpt or (exp_dir / "ckpt"))

    def eval_one(step, tag=""):
        timings = {}
        det_annos = run_inference(model, dataset, loader, cfg,
                                  max_batches=args.max_batches,
                                  timings=timings)
        if dp:
            n_frames = len(dataset)
            if args.max_batches is not None:
                n_frames = min(n_frames,
                               args.max_batches * batch_size * world)
            det_annos = gather_frames(det_annos, world, batch_size,
                                      n_frames)
            if rank != 0:
                return None
        out = None
        if args.save_to_file:
            out = exp_dir / f"result{tag}.pkl"
            with open(out, "wb") as f:
                pickle.dump(det_annos, f)
            logger.info(f"saved {len(det_annos)} frames to {out}")
        table, res = dataset.evaluation(det_annos, cfg.get("CLASS_NAMES", []),
                                        ap_mode=args.ap_mode)
        logger.info("\n" + str(table))
        return {"det_annos": det_annos, "table": table, "results": res,
                "result_path": out, "step": step, "timings": timings}

    if args.eval_all:
        # checkpoint watcher (reference repeat_eval_ckpt, test.py:88-134):
        # poll for new checkpoints, evaluate each once, record in a list file
        done_file = exp_dir / "eval_list.txt"
        done = set(done_file.read_text().split()) if done_file.exists() \
            else set()
        evaluated = []
        waited = 0.0
        while waited < args.max_waiting_mins * 60:
            # rank 0's look at the directory decides for every rank
            step = broadcast_object(mgr.latest_step() if rank == 0
                                    else None) if dp else mgr.latest_step()
            if step is None or str(step) in done:
                time.sleep(POLL_S)
                waited += POLL_S
                continue
            mgr.restore(model, step=step)
            logger.info(f"evaluating checkpoint step {step}")
            evaluated.append(eval_one(step, tag=f"_{step}"))
            done.add(str(step))
            if rank == 0:
                done_file.write_text("\n".join(sorted(done)))
            waited = 0.0
        logger.info("eval watcher timed out")
        return evaluated

    step = mgr.restore(model)
    if step is not None:
        logger.info(f"loaded checkpoint step {step}")
    else:
        logger.warning("no checkpoint found — evaluating a random init")
    return eval_one(step)


if __name__ == "__main__":
    main()
