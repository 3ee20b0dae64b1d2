"""Offboard auto-labeling pipeline (port of
detzero_tpu/pipeline/offboard.py).

The reference has NO orchestrator — stages talk through pickles on disk
(SURVEY §3.5).  This module keeps the same stage boundaries and artifact
schemas and runs them in order for one sequence:

  1. detection (CenterPoint [+TTA/WBF]) -> frame detections (runs before,
     `tools/test_det.py`)
  2. offline tracking (fwd+reverse)     -> object tracks + drop data
  3. daemon: per-object point cropping  -> refining records
  4. GRM / PRM / CRM refinement         -> sizes / centers+headings / scores
  5. combine (+drop re-merge)           -> final frame boxes
  6. evaluation (`tools/detzero_eval.py`)

Tracking, the crop and the combine are host code (NumPy, the native
cropper); the refiners' forward runs where their weights are (the card,
as `tools/run_offboard.py` loads them), through `BatchedRefiner`.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from detzero_tpu_torch.core.profiling import StageTimer
from detzero_tpu_torch.data import refine_features as rf
from detzero_tpu_torch.models.refining.batched import BatchedRefiner
from detzero_tpu_torch.models.refining.target_assign import (
    DEFAULT_SIZE_ANCHORS,
)
from detzero_tpu_torch.models.tracking import DetZeroTracker
from detzero_tpu_torch.pipeline import daemon

_SAMPLER_KEYS = {
    "grm": (("query_num", 3), ("query_points", 256), ("memory_points", 4096)),
    "prm": (("query_num", 200), ("query_points", 256), ("memory_points", 48)),
}


def _sampler_kwargs(cfg, kind):
    """Normalize a stage's sampler config into GRMSample/PRMSample kwargs.
    Accepts either a plain kwargs dict ({'query_num': ...}) or a full
    Config, whose sampler knobs live at the top level as QUERY_NUM/
    QUERY_POINTS/MEMORY_POINTS."""
    cfg = cfg or {}
    out = {}
    for key, default in _SAMPLER_KEYS[kind]:
        val = cfg.get(key, cfg.get(key.upper(), default))
        out[key] = int(val)
    return out


class OffboardPipeline:
    """Run stages 2-5 given per-frame detections (stage 1 runs before, in
    `tools/test_det.py`)."""

    def __init__(self, track_cfg=None, class_names=("Vehicle", "Pedestrian",
                                                    "Cyclist"),
                 grm=None, prm=None, crm=None, size_anchors=None,
                 refine_batch: int = 8):
        """grm/prm/crm: optional (model, sampler_cfg) pairs, OR
        {class_name: pair} dicts for per-class models (the reference
        trains one GRM/PRM/CRM per class); stages without a model pass
        boxes through unchanged.  The model is an `nn.Module` that carries
        its own weights (the reference's triples hold flax params beside
        the model); it runs on the device its parameters are on.
        sampler_cfg is either a sampler kwargs dict or a full Config (see
        _sampler_kwargs)."""
        self.tracker = DetZeroTracker(track_cfg or {})
        self.timer = StageTimer()
        self.class_names = list(class_names)
        self.grm = grm
        self.prm = prm
        self.crm = crm
        self.size_anchors = size_anchors or DEFAULT_SIZE_ANCHORS
        self.refine_batch = int(refine_batch)
        self._refiners = {}

    # ------------------------------------------------------------------
    def track(self, det_frames):
        """det_frames: list of {'boxes' (N,7 lidar), 'scores', 'labels',
        'pose'} -> tracker output (object tracks + drop)."""
        return self.tracker(det_frames)

    def prepare_objects(self, track_result, frame_points, poses, **kw):
        return daemon.prepare_object_data(track_result, frame_points, poses,
                                          **kw)

    # ------------------------------------------------------------------
    def _cls_name(self, rec):
        label = rec.get("label", 0)
        return (self.class_names[int(label)]
                if not isinstance(label, str) else label)

    def _pair(self, kind, cls):
        """Resolve a stage's (model, sampler_cfg) for class `cls`:
        per-class dict stages look up the class (missing class = stage
        skipped for those objects); plain pairs serve every class."""
        stage = getattr(self, kind)
        if stage is None:
            return None
        if isinstance(stage, dict):
            return stage.get(cls)
        return stage

    def _refiner(self, kind, cls, pair):
        """One BatchedRefiner per configured model."""
        key = (kind, cls if isinstance(getattr(self, kind), dict) else None)
        if key not in self._refiners:
            self._refiners[key] = BatchedRefiner(
                pair[0], kind, batch_size=self.refine_batch)
        return self._refiners[key]

    def refine(self, obj_records, rng=None):
        """Run whichever of GRM/PRM/CRM are configured over all objects.
        Returns (grm_sizes, prm_centers, prm_headings, crm_scores) dicts.

        Every sampler emits static shapes, so objects stack into batches
        of `refine_batch` (BatchedRefiner).  Per-class stage dicts process
        each class's objects through its own model; plain pairs process
        every object through one model.  The samplers draw from `rng`
        (RandomState(0) by default) in the reference's order: class by
        class, GRM's samples, then PRM's (shared with CRM)."""
        rng = rng or np.random.RandomState(0)
        grm_sizes, prm_centers, prm_headings, crm_scores = {}, {}, {}, {}
        oids = list(obj_records.keys())
        if not oids:
            return grm_sizes, prm_centers, prm_headings, crm_scores

        by_cls = {}
        for oid in oids:
            by_cls.setdefault(self._cls_name(obj_records[oid]),
                              []).append(oid)

        for cls, ids in by_cls.items():
            grm = self._pair("grm", cls)
            prm = self._pair("prm", cls)
            crm = self._pair("crm", cls)
            if grm is not None:
                sampler = rf.GRMSample(rng=rng,
                                       **_sampler_kwargs(grm[1], "grm"))
                samples = []
                for oid in ids:
                    s = sampler(obj_records[oid])
                    s["anchors"] = np.asarray(self.size_anchors.get(
                        cls, self.size_anchors[self.class_names[0]]),
                        np.float32)
                    samples.append(s)
                refiner = self._refiner("grm", cls, grm)
                for oid, size in zip(ids, refiner.run(samples)):
                    grm_sizes[oid] = np.asarray(size)

            if prm is not None or crm is not None:
                cfg = (prm or crm)[1]
                sampler = rf.PRMSample(training=False, rng=rng,
                                       **_sampler_kwargs(cfg, "prm"))
                samples = [sampler(obj_records[oid]) for oid in ids]
                if prm is not None:
                    refiner = self._refiner("prm", cls, prm)
                    for oid, s, (c_loc, h_loc) in zip(
                            ids, samples, refiner.run(samples)):
                        t = int(s["pad_mask"].sum())
                        c, h = rf.revert_prm_to_world(
                            np.asarray(c_loc)[:t], np.asarray(h_loc)[:t],
                            s["init_box"])
                        prm_centers[oid] = c
                        prm_headings[oid] = h
                if crm is not None:
                    refiner = self._refiner("crm", cls, crm)
                    for oid, s, conf in zip(
                            ids, samples, refiner.run(samples)):
                        t = int(s["pad_mask"].sum())
                        crm_scores[oid] = np.asarray(conf)[:t]
        return grm_sizes, prm_centers, prm_headings, crm_scores

    # ------------------------------------------------------------------
    def run_sequence(self, det_frames, frame_points, poses, gt_boxes=None,
                     gt_ids=None, combine_drop: bool = False):
        """Full stages 2-5 for one sequence. Returns final frame-level boxes
        (global frame) + intermediate artifacts.

        combine_drop: re-merge the tracker's dropped (deduped) boxes into
        the final frames. OFF by default like the reference
        (combine_output.py:160 'not combine dropped objects when used as
        auto labels' — re-adding suppressed near-duplicates costs
        precision under Hungarian matching)."""
        with self.timer("track"):
            tr = self.track(det_frames)
        with self.timer("prepare_objects"):
            objs = self.prepare_objects(tr, frame_points, poses,
                                        gt_boxes=gt_boxes, gt_ids=gt_ids)
        with self.timer("refine"):
            grm_sizes, prm_centers, prm_headings, crm_scores = \
                self.refine(objs)
        with self.timer("combine"):
            frames = daemon.combine_output(
                objs,
                grm_sizes=grm_sizes or None,
                prm_centers=prm_centers or None,
                prm_headings=prm_headings or None,
                crm_scores=crm_scores or None,
                drop_data=tr["drop"] if combine_drop else None,
                num_frames=len(det_frames),
            )
        return {"frames": frames, "tracks": tr, "objects": objs,
                "timings": self.timer.as_dict()}

    # ------------------------------------------------------------------
    @staticmethod
    def save_artifact(obj, path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(obj, f)

    @staticmethod
    def load_artifact(path):
        with open(path, "rb") as f:
            return pickle.load(f)
