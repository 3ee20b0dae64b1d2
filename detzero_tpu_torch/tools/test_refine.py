"""Refining inference CLI (port of tools/test_refine.py; reference
refining/tools/test.py + eval_utils.py): runs the model over the eval
records, reports the input-to-output box recall at IoU 0.7 against the
matched GT, and with --save_to_file pickles {seq: {oid: refined}} as
<Class>_{geometry|position|confidence}_<split>.pkl.

    python -m detzero_tpu_torch.tools.test_refine \
        --cfg_file configs/ref_model_cfgs/vehicle_grm.yaml --save_to_file

Objects run through `BatchedRefiner` (--batch_size objects a forward,
8 by default), or with --tta (GRM and PRM; CRM has none) one object a
forward over its variants, fused.  The newest checkpoint of --ckpt (by
default the experiment's ckpt/, where train_refine writes) is restored.
`main(argv)` runs in-process and returns {results, recall_in, recall_out,
boxes, result_path, step, timings}.
"""

from __future__ import annotations

import pickle
import time
from collections import defaultdict

import numpy as np
import torch

STAGE = {"GeometryTransformer": "geometry", "PositionTransformer": "position",
         "ConfidencePointNet": "confidence"}


def decoded(model, kind, dataset, n, anchors, batch_size, use_tta):
    """Yields (i, sample, decoded) over the first n records: with TTA one
    object at a time (its variants as the batch), else chunks of
    4 x batch_size samples through BatchedRefiner."""
    from detzero_tpu_torch.models.refining import tta as tta_mod
    from detzero_tpu_torch.models.refining.batched import (
        BatchedRefiner, forward_decode,
    )

    device = next(model.parameters()).device
    if use_tta:
        for i in range(n):
            s = dataset[i]
            if kind == "grm":
                ex = tta_mod.grm_tta_expand(s)
                keys = ("query_pts", "query_sizes", "memory_pts",
                        "memory_mask")
            else:
                ex = tta_mod.prm_tta_expand(s)
                keys = ("query_pts", "query_boxes", "memory_pts", "pad_mask")
            arrs = [torch.from_numpy(ex[k]).to(device) for k in keys]
            if kind == "grm":
                arrs.append(torch.from_numpy(anchors).to(device))
            with torch.no_grad():
                # PRM: each variant's centers decode against its own
                # query boxes, before the inverse-transform fuse
                res = forward_decode(model, kind, *arrs)
            if kind == "grm":
                yield i, s, tta_mod.grm_tta_fuse(res.cpu().numpy())
            else:
                yield i, s, tta_mod.prm_tta_fuse(*(r.cpu().numpy()
                                                   for r in res))
        return
    refiner = BatchedRefiner(model, kind, batch_size=batch_size)
    chunk = 4 * batch_size          # bounds the host's sample memory
    for c0 in range(0, n, chunk):
        idx = list(range(c0, min(c0 + chunk, n)))
        samples = []
        for i in idx:
            s = dataset[i]
            if kind == "grm":
                s["anchors"] = anchors
            samples.append(s)
        yield from zip(idx, samples, refiner.run(samples))


def main(argv=None):
    from detzero_tpu_torch.core.checkpoint import CheckpointManager
    from detzero_tpu_torch.data import refine_features as rf
    from detzero_tpu_torch.ops import box_np
    from detzero_tpu_torch.tools.common import (
        base_parser, load_config, resolve_device, setup_experiment,
    )
    from detzero_tpu_torch.tools.train_refine import (
        MODEL_KIND, build_refine_dataset, build_refine_model, size_anchors,
    )

    parser = base_parser("detzero_tpu_torch refining eval")
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint directory (default: the "
                             "experiment's ckpt/)")
    parser.add_argument("--save_to_file", action="store_true")
    parser.add_argument("--split", default="val")
    parser.add_argument("--max_tracks", type=int, default=None)
    parser.add_argument("--tta", action="store_true",
                        help="GRM/PRM test-time augmentation: variant "
                             "fan-out + inverse fuse (models/refining/tta)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args)
    exp_dir, logger = setup_experiment(args, cfg, "test")

    dataset = build_refine_dataset(cfg, training=False, logger=logger)
    if len(dataset) == 0:
        logger.error("no refining records found")
        return None
    # the reference draws one sample to size its model's init; drawn here
    # too, so that the eval samples that follow are the reference's
    dataset[0]
    name = cfg["MODEL"]["NAME"]
    kind = MODEL_KIND[name]
    cls = cfg.get("CLASS_NAME", "Vehicle")
    anchors = size_anchors(cfg)
    model = build_refine_model(cfg, device)
    step = CheckpointManager(args.ckpt or (exp_dir / "ckpt")).restore(model)
    if step is not None:
        logger.info(f"loaded checkpoint step {step}")
    else:
        logger.warning("no checkpoint found — refining with a random init")
    use_tta = args.tta or bool(cfg.get("DATA_CONFIG", {}).get("TTA", False))
    use_tta = use_tta and kind != "crm"    # CRM has no TTA
    n = len(dataset) if args.max_tracks is None else min(args.max_tracks,
                                                         len(dataset))

    results = defaultdict(dict)
    in_hits = out_hits = total = 0
    t0 = time.perf_counter()
    for i, s, dec in decoded(model, kind, dataset, n, anchors,
                             int(args.batch_size or 8), use_tta):
        rec = dataset.records[i]
        seq, oid = rec.get("_key", ("seq0", i))
        boxes = np.asarray(rec["boxes_global"], np.float32).copy()
        if kind == "grm":
            size = np.asarray(dec)
            refined = boxes.copy()
            refined[:, 3:6] = size[None, :]
            results[seq][oid] = {"size": size, "boxes_global": refined}
        elif kind == "prm":
            c_loc, h_loc = dec
            t = int(np.asarray(s["pad_mask"]).sum())
            c, h = rf.revert_prm_to_world(np.asarray(c_loc)[:t],
                                          np.asarray(h_loc)[:t], s["init_box"])
            refined = boxes.copy()
            refined[: len(c), :3] = c[: len(boxes)]
            refined[: len(h), 6] = h[: len(boxes)]
            results[seq][oid] = {"centers": c, "headings": h,
                                 "boxes_global": refined}
        else:
            t = int(np.asarray(s["pad_mask"]).sum())
            results[seq][oid] = {"new_score": np.asarray(dec)[:t]}
            refined = boxes
        # input-vs-output recall vs GT (eval_utils.py:15-69 semantics)
        if "gt_boxes" in rec and np.asarray(rec.get("matched", [0])).any():
            m = np.asarray(rec["matched"], bool)
            gt = np.asarray(rec["gt_boxes"], np.float32)[m]
            inp, outp = boxes[m], refined[m]
            for j in range(len(gt)):
                total += 1
                in_hits += box_np.boxes_iou3d(
                    inp[j][None, :7], gt[j][None])[0, 0] >= 0.7
                out_hits += box_np.boxes_iou3d(
                    outp[j][None, :7], gt[j][None])[0, 0] >= 0.7
    seconds = time.perf_counter() - t0
    recall_in = in_hits / total if total else None
    recall_out = out_hits / total if total else None
    if total:
        logger.info(f"box recall@0.7 input {recall_in:.4f} -> output "
                    f"{recall_out:.4f} ({total} boxes)")
    out = None
    if args.save_to_file:
        out = exp_dir / f"{cls}_{STAGE[name]}_{args.split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(dict(results), f)
        logger.info(f"saved {sum(len(v) for v in results.values())} tracks "
                    f"to {out}")
    return {"results": dict(results), "recall_in": recall_in,
            "recall_out": recall_out, "boxes": total, "result_path": out,
            "step": step, "timings": {"tracks": n, "seconds": seconds}}


if __name__ == "__main__":
    main()
