"""Refining datasets over daemon object records (port of
detzero_tpu/data/refine_dataset.py).  Every draw, the augmentation's, the
samplers' and CRM's negatives', comes from the dataset's `rng` in the
reference's order: `rng=np.random.RandomState(s)` gives the reference's
samples once its `ds.rng` (which its sampler shares) is that RandomState.
Without `rng`, eval mode seeds 0 as the reference does and training draws
from an unseeded RandomState, as the reference's.

Re-derives the reference's per-class refining datasets
(refining/detzero_refine/datasets/): load per-sequence object pkls, class
filter + class-balanced resampling (cyclists upsampled, dataset.py:160-163),
CRM IoU-label join (:119-122), per-sample feature assembly via
data/refine_features, fixed-shape collate.

Track-level augmentations (geometry_augment.py / position_augment.py
semantics): track-consistent flip/rotation/scaling applied to boxes AND
cropped points before feature extraction.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from detzero_tpu_torch.core.registry import DATASETS
from detzero_tpu_torch.data import refine_features as rf


def augment_full_track(obj, rng, flip=True, rot=0.78539816, scale=(0.95, 1.05)):
    """Track-consistent global flip/rot/scale of boxes + per-frame points
    (geometry_augment.py:9 augment_full_track). The SAME transform applies
    to gt_boxes: scaling them alone would leave augmented PRM residual
    targets rotated out of alignment by meters (GRM's sizes are
    flip/rotation-invariant)."""
    boxes = np.asarray(obj["boxes_global"], np.float64).copy()
    pts = [np.asarray(p, np.float64).copy() for p in obj["pts"]]
    gt = (np.asarray(obj["gt_boxes"], np.float64).copy()
          if "gt_boxes" in obj else None)
    if flip and rng.rand() < 0.5:
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        for p in pts:
            if len(p):
                p[:, 1] = -p[:, 1]
        if gt is not None:
            gt[:, 1] = -gt[:, 1]
            gt[:, 6] = -gt[:, 6]
    ang = rng.uniform(-rot, rot)
    c, s = np.cos(ang), np.sin(ang)
    rotm = np.array([[c, -s], [s, c]])
    boxes[:, :2] = boxes[:, :2] @ rotm.T
    boxes[:, 6] += ang
    for p in pts:
        if len(p):
            p[:, :2] = p[:, :2] @ rotm.T
    if gt is not None:
        gt[:, :2] = gt[:, :2] @ rotm.T
        gt[:, 6] += ang
    sc = rng.uniform(*scale)
    boxes[:, :6] *= sc
    for p in pts:
        if len(p):
            p[:, :3] *= sc
    if gt is not None:
        gt[:, :6] *= sc
    out = dict(obj)
    out["boxes_global"] = boxes.astype(np.float32)
    out["pts"] = [p.astype(np.float32) for p in pts]
    if gt is not None:
        out["gt_boxes"] = gt.astype(np.float32)
    return out


class RefineDatasetBase:
    """Loads {oid: record} dicts from per-sequence pkls under
    DATA_PATH/<ClassName>/ (daemon output layout)."""

    def __init__(self, dataset_cfg, class_name: str, training: bool,
                 root_path=None, logger=None, records=None, rng=None):
        self.cfg = dataset_cfg
        self.class_name = class_name
        self.training = training
        self.rng = rng if rng is not None else np.random.RandomState(
            0 if not training else None)
        self.records = []
        if records is not None:
            self.records = list(records)
        else:
            root = Path(root_path or dataset_cfg.get("DATA_PATH",
                                                     "data/waymo/refining"))
            cls_dir = root / class_name
            caches = sorted(cls_dir.glob("*.dzrc")) if cls_dir.exists() else []
            if caches:
                # mmap-backed lazy records (data/record_cache.py): pickles
                # stay the inter-stage artifact, the cache is the training
                # layout — host RSS no longer scales with dataset size
                from detzero_tpu_torch.data.record_cache import (
                    RecordCache, RecordListView,
                )
                self.records = RecordListView([RecordCache(p)
                                               for p in caches])
            elif cls_dir.exists():
                for p in sorted(cls_dir.glob("*.pkl")):
                    with open(p, "rb") as f:
                        seq = pickle.load(f)
                    for oid, rec in seq.items():
                        rec = dict(rec)
                        rec["_key"] = (p.stem, oid)
                        self.records.append(rec)
        # GRM/PRM train only on GT-matched tracklets (reference
        # dataset.py:108-112: unmatched tracks are kept only for CRM, as
        # negatives). False-positive tracks can outnumber the matched ones
        # several times over, and would fill GRM/PRM batches with
        # zero-weight samples.
        self._negatives = []
        if training and self._matched_tracks_only():
            pos = [r for r in self.records
                   if np.asarray(r.get("matched", [False])).any()]
            self._negatives = [r for r in self.records
                               if not np.asarray(r.get("matched",
                                                       [False])).any()]
            self.records = pos
        if training and class_name == "Cyclist":
            self.records = self.records * int(dataset_cfg.get("CYCLIST_REPEAT",
                                                              50))
        if logger:
            logger.info(f"{class_name} {type(self).__name__}: "
                        f"{len(self.records)} tracks"
                        + (f" (+{len(self._negatives)} negative)"
                           if self._negatives else ""))

    def _matched_tracks_only(self) -> bool:
        return True

    def __len__(self):
        return len(self.records)

    def maybe_augment(self, rec):
        if self.training and self.cfg.get("AUGMENT", True):
            return augment_full_track(rec, self.rng)
        return rec

    @staticmethod
    def collate_batch(samples):
        out = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        return out


@DATASETS.register("WaymoGeometryDataset")
class WaymoGeometryDataset(RefineDatasetBase):
    def __init__(self, dataset_cfg, class_name, training, **kw):
        super().__init__(dataset_cfg, class_name, training, **kw)
        self.sampler = rf.GRMSample(
            query_num=int(dataset_cfg.get("QUERY_NUM", 3)),
            query_points=int(dataset_cfg.get("QUERY_POINTS", 256)),
            memory_points=int(dataset_cfg.get("MEMORY_POINTS", 4096)),
            training=training, rng=self.rng)

    def __getitem__(self, i):
        rec = self.maybe_augment(self.records[i])
        s = self.sampler(rec)
        if "gt_boxes" in rec and np.asarray(rec.get("matched",
                                                    [False])).any():
            m = np.asarray(rec["matched"], bool)
            s["gt_size"] = np.asarray(rec["gt_boxes"], np.float32)[m][0, 3:6]
            s["has_gt"] = np.array(True)
        else:
            s["gt_size"] = np.zeros(3, np.float32)
            s["has_gt"] = np.array(False)
        return s


@DATASETS.register("WaymoPositionDataset")
class WaymoPositionDataset(RefineDatasetBase):
    def __init__(self, dataset_cfg, class_name, training, **kw):
        super().__init__(dataset_cfg, class_name, training, **kw)
        self.sampler = rf.PRMSample(
            query_num=int(dataset_cfg.get("QUERY_NUM", 200)),
            query_points=int(dataset_cfg.get("QUERY_POINTS", 256)),
            memory_points=int(dataset_cfg.get("MEMORY_POINTS", 48)),
            training=training, rng=self.rng)

    def __getitem__(self, i):
        rec = self.maybe_augment(self.records[i])
        s = self.sampler(rec)
        qn = self.sampler.query_num
        fi = s["frame_idx"]  # original track rows of each query slot
        gt_c = np.zeros((qn, 3), np.float32)
        gt_h = np.zeros(qn, np.float32)
        if "gt_boxes" in rec:
            gt_rows = np.asarray(rec["gt_boxes"],
                                 np.float32).reshape(-1, 7)[fi]
            gt = rf.boxes_to_init_coords(gt_rows, s["init_box"])
            # center: RESIDUAL vs the input trajectory (reference
            # target_assign.py:44 center_reg = traj_gt - traj; decode adds
            # the input box back). heading: ABSOLUTE gt heading in init
            # coords (reference target_assign.py:50 bins traj_gt[:, 6]
            # directly and decode_torch:102 never adds the input heading
            # back) — the input headings carry per-frame pi-flips, so a
            # heading RESIDUAL target is bimodal frame-to-frame and
            # unlearnable, while the absolute heading is near-constant
            # along a track in init coords
            gt_c[:] = gt[:, :3] - s["local_boxes"][:, :3]
            gt_h[:] = np.arctan2(np.sin(gt[:, 6]), np.cos(gt[:, 6]))
        s["gt_centers"] = gt_c
        s["gt_headings"] = gt_h
        s["gt_mask"] = s["pad_mask"] & np.asarray(
            rec.get("matched", np.ones(len(rec["boxes_global"]), bool)),
            bool)[fi]
        return s


@DATASETS.register("WaymoConfidenceDataset")
class WaymoConfidenceDataset(RefineDatasetBase):
    """CRM training alternates matched tracklets with random FP tracklets
    50/50 (reference waymo_confidence_dataset.py:36-46) and samples track
    frames WITHOUT the matched restriction — every frame carries an honest
    IoU label (unmatched frames/tracks label as negatives)."""

    def __init__(self, dataset_cfg, class_name, training, iou_labels=None, **kw):
        super().__init__(dataset_cfg, class_name, training, **kw)
        self.iou_labels = iou_labels or {}
        self.sampler = rf.PRMSample(
            query_num=int(dataset_cfg.get("QUERY_NUM", 200)),
            query_points=int(dataset_cfg.get("QUERY_POINTS", 256)),
            memory_points=8, training=training, matched_only=False,
            rng=self.rng)

    def __len__(self):
        if self.training and self._negatives:
            return len(self.records) * 2
        return len(self.records)

    def __getitem__(self, i):
        if self.training and self._negatives:
            rec = (self.records[i // 2] if i % 2 == 0 else
                   self._negatives[self.rng.randint(len(self._negatives))])
        else:
            rec = self.records[i]
        s = self.sampler(rec)
        qn = self.sampler.query_num
        ious = np.full(qn, -1.0, np.float32)
        key = rec.get("_key")
        lab = self.iou_labels.get(key) if key is not None else None
        if lab is None and "iou_gt" in rec:
            lab = rec["iou_gt"]
        if lab is not None:
            # gather per-slot labels by original track row (training
            # subsamples frames); padded slots stay -1 (ignored)
            lab = np.asarray(lab, np.float32)
            ious[s["pad_mask"]] = lab[s["frame_idx"][s["pad_mask"]]]
        return {"query_pts": s["query_pts"], "pad_mask": s["pad_mask"],
                "gt_ious": ious}
