"""Offline multi-object track manager (forward + reverse pass).

Independent re-derivation of the reference TrackManager (track_manager.py:12):
  * forward pass per frame: KF predict -> two-stage association -> update
    matched -> spawn tracks from strong leftovers -> merge BEV-overlapping
    tracks keeping the oldest;
  * tracks that miss keep extending with predicted-only boxes (hit=False) up
    to max_age, so the post-processor can trim or backfill them;
  * reverse pass: each track is re-seeded at its first observed frame with a
    negative time step and extended backwards through earlier frames using
    association only (no spawning), consuming detections no forward track
    claimed.

Everything is per-sequence host code (the tracker is sequential by nature);
sequences parallelize across processes in the runner.

Port of detzero_tpu/models/tracking/track_manager.py, unchanged but for the
imports (numpy and scipy).
"""

from __future__ import annotations

import numpy as np

from detzero_tpu_torch.core.registry import MOTION_FILTERS
from detzero_tpu_torch.models.tracking import kalman as _kalman  # registers filters
from detzero_tpu_torch.models.tracking.association import (
    affinity_matrix, associate_one_stage, associate_two_stage,
    hungarian_match,
)


class Track:
    __slots__ = ("tid", "label", "kf", "frames", "boxes", "scores", "hits",
                 "alive", "birth_frame", "state", "velocities", "kf_vels")

    def __init__(self, tid, label, kf, frame_idx, box, score):
        self.tid = tid
        self.label = label
        self.kf = kf
        self.frames = [frame_idx]
        self.boxes = [np.asarray(box, float)]
        # per-frame KF (vx, vy), mirroring the reference's boxes_global
        # [:, 7:9] record (velocity is 0 at birth)
        self.kf_vels = [np.zeros(2)]
        self.scores = [float(score)]
        # hit code per frame (reference convention): 0 = predicted-only
        # miss, 1 = tight (stage-1) update, 2 = loose (stage-2) match that
        # left the KF state untouched
        self.hits = [1]
        self.alive = True
        self.birth_frame = frame_idx

    @property
    def num_hits(self):
        return int(np.sum(np.asarray(self.hits) > 0))

    @property
    def age(self):
        return len(self.frames)


class TrackManager:
    def __init__(self, cfg=None):
        cfg = cfg or {}
        self.filter_name = cfg.get("FILTER", "CenterKalmanFilter")
        self.filter_cfg = cfg.get("FILTER_CFG", {})
        self.tight_thresh = cfg.get("TIGHT_THRESH", [0.2, 0.1, 0.1])
        self.loose_thresh = cfg.get("LOOSE_THRESH", [0.3, 0.15, 0.15])
        # defaults = the reference's shipped config (waymo_detzero_track
        # .yaml SECOND_STAGE: SCORE_THRESHOLD 0.1, POINT_THRESHOLD 0,
        # TRACK_AGE DEATH_AGE -1): low-score detections still reach the
        # tracker (only spawn gating), tracks never age out
        self.score_thresh = float(cfg.get("SCORE_THRESH", 0.1))
        self.min_points = int(cfg.get("MIN_POINTS", 0))
        # MAX_AGE < 0 = tracks never age out (reference DEATH_AGE: -1)
        self.max_age = int(cfg.get("MAX_AGE", -1))
        self.merge_thresh = cfg.get("TRACK_MERGE_THRESH", [0.5, 0.4, 0.4])
        self.metric = cfg.get("METRIC", "iou_bev")
        self.reverse = bool(cfg.get("REVERSE", True))
        self.dt = float(cfg.get("DELTA_T", 0.1))
        # reference-parity semantics (VERDICT r1 #4): stage-2 pool is weak
        # dets only; stage-2 matches record the PREDICTED box and skip the
        # KF update. Threads through to the filters via FILTER_CFG.
        self.parity = bool(cfg.get("PARITY", True))
        self.filter_cfg = dict(self.filter_cfg or {})
        self.filter_cfg.setdefault("PARITY", self.parity)

    # ------------------------------------------------------------------
    def forward(self, seq):
        """seq: list of frame dicts {boxes (N,7) global, scores, labels,
        num_points(optional)}. Returns (tracks, used_masks)."""
        tracks: list[Track] = []
        next_id = 0
        used = []  # per-frame bool mask of consumed detections

        for f, frame in enumerate(seq):
            boxes = np.asarray(frame["boxes"], float).reshape(-1, 7)
            scores = np.asarray(frame.get("scores", np.ones(len(boxes))), float)
            labels = np.asarray(frame.get("labels", np.zeros(len(boxes), int)))
            npts = np.asarray(frame.get("num_points", np.full(len(boxes), 1e9)))
            used_f = np.zeros(len(boxes), bool)

            active = [t for t in tracks
                      if t.alive and (self.max_age < 0
                                      or (f - t.frames[-1]) <= self.max_age)]
            pred_boxes = np.array([t.kf.predict() for t in active]).reshape(-1, 7)
            trk_labels = np.array([t.label for t in active], dtype=object)

            if len(boxes):
                matches, stages, new_idx, unmatched_t, _dropped = \
                    associate_two_stage(
                        boxes, labels, scores, npts, pred_boxes, trk_labels,
                        tight_thresh=self.tight_thresh,
                        loose_thresh=self.loose_thresh,
                        score_thresh=self.score_thresh,
                        min_points=self.min_points,
                        metric=self.metric, parity=self.parity,
                    )
            else:
                matches, stages, new_idx = [], [], []
                unmatched_t = list(range(len(active)))

            for (d, t), stage in zip(matches, stages):
                trk = active[t]
                two_stage = bool(stage) and self.parity
                trk.kf.update(boxes[d], scores[d], two_stage=two_stage)
                trk.frames.append(f)
                # a stage-2 match keeps the PREDICTED box (the KF state was
                # not updated — reference track.info() reports self.bbox)
                trk.boxes.append(trk.kf.current_box() if two_stage
                                 else boxes[d].copy())
                trk.scores.append(float(scores[d]))
                trk.hits.append(2 if two_stage else 1)
                trk.kf_vels.append(np.asarray(trk.kf.velocity[:2], float))
                used_f[d] = True
            for t in unmatched_t:
                trk = active[t]
                trk.frames.append(f)
                trk.boxes.append(trk.kf.current_box())
                trk.scores.append(trk.scores[-1])
                trk.hits.append(0)
                trk.kf_vels.append(np.asarray(trk.kf.velocity[:2], float))
            for d in new_idx:
                kf = MOTION_FILTERS.build(
                    self.filter_name, boxes[d], scores[d], labels[d], f,
                    cfg=self.filter_cfg, delta_t=self.dt,
                )
                tracks.append(Track(next_id, labels[d], kf, f, boxes[d], scores[d]))
                used_f[d] = True
                next_id += 1

            self._merge_overlapping(tracks, f)
            used.append(used_f)

        if self.reverse:
            self._reverse_pass(tracks, seq, used)
        return tracks, used

    # ------------------------------------------------------------------
    def _merge_overlapping(self, tracks, frame_idx):
        """Keep the oldest track per BEV-overlap cluster at this frame
        (reference overlap_track_merge, track_manager.py:262)."""
        cur = [t for t in tracks if t.alive and t.frames[-1] == frame_idx]
        if len(cur) < 2:
            return
        boxes = np.stack([t.boxes[-1] for t in cur])
        aff = affinity_matrix(boxes, boxes, "iou_bev")
        thr = self.merge_thresh
        for i in range(len(cur)):
            for j in range(i + 1, len(cur)):
                if cur[i].label != cur[j].label:
                    continue
                li = int(cur[i].label) if not isinstance(cur[i].label, str) else 0
                t = thr[li] if isinstance(thr, (list, tuple)) else thr
                if aff[i, j] > t:
                    older, newer = ((cur[i], cur[j])
                                    if cur[i].birth_frame <= cur[j].birth_frame
                                    else (cur[j], cur[i]))
                    newer.alive = False

    # ------------------------------------------------------------------
    def _reverse_pass(self, tracks, seq, used):
        """Extend each surviving track backwards from its birth frame."""
        # reverse-KFs keyed by track, seeded lazily when their birth frame is
        # reached in the reverse sweep
        rev_kf = {}
        # Distractor pool from the FORWARD results (reference
        # reverse_tracking_module, track_manager.py:219-237): at each frame
        # the association pool of track rows is the reverse-track predictions
        # CONCATENATED with the frame's existing non-start forward-track
        # boxes; a weak det that matches a distractor row is absorbed
        # (discarded) instead of being grabbed by a reverse track.
        distract = {}
        for t in tracks:
            if not (t.alive and t.num_hits > 0):
                continue
            for i, fr in enumerate(t.frames):
                if i == 0:
                    continue  # 'start' row: becomes a reverse seed, not a distractor
                distract.setdefault(fr, []).append((t.boxes[i], t.label))
        for f in range(len(seq) - 1, -1, -1):
            # seed reverse filters for tracks born at f+? (birth > f)
            cands = [t for t in tracks
                     if t.alive and t.num_hits > 0 and t.birth_frame - f > 0
                     and (self.max_age < 0
                          or t.birth_frame - f <= self.max_age)]
            if not cands:
                continue
            for t in cands:
                if t.tid not in rev_kf:
                    first_hit = int(np.argmax(np.asarray(t.hits) > 0))
                    rev_kf[t.tid] = MOTION_FILTERS.build(
                        self.filter_name, t.boxes[first_hit],
                        t.scores[first_hit], t.label, t.birth_frame,
                        cfg=self.filter_cfg, delta_t=-self.dt,
                    )
            boxes = np.asarray(seq[f]["boxes"], float).reshape(-1, 7)
            if not len(boxes):
                continue
            scores = np.asarray(seq[f].get("scores", np.ones(len(boxes))))
            labels = np.asarray(seq[f].get("labels", np.zeros(len(boxes), int)))
            npts = np.asarray(seq[f].get("num_points", np.full(len(boxes), 1e9)))
            free = ~used[f]
            free_idx = np.where(free)[0]
            if not len(free_idx):
                # still advance the reverse filters
                for t in cands:
                    rev_kf[t.tid].predict()
                continue
            pred = np.array([rev_kf[t.tid].predict() for t in cands]).reshape(-1, 7)
            trk_labels = np.array([t.label for t in cands], dtype=object)
            if self.parity:
                # reference reverse pass = only_two_stage
                # (data_association.py:126): ONLY weak detections, loose
                # threshold, and every match applies with two_stage=True
                # (track_manager.py:239) — the KF state stays untouched
                # and the track records the predicted box. The track rows
                # are the reverse predictions + the frame's non-start
                # forward boxes as discard-on-match distractors
                # (track_manager.py:219-237).
                weak = (scores[free_idx] < self.score_thresh) | \
                       (npts[free_idx] < self.min_points)
                pool = free_idx[weak]
                n_real = len(cands)
                dis = distract.get(f, [])
                if dis:
                    pred = np.concatenate(
                        [pred, np.asarray([b[:7] for b, _ in dis],
                                          float).reshape(-1, 7)])
                    trk_labels = np.concatenate(
                        [trk_labels,
                         np.array([l for _, l in dis], dtype=object)])
                m, _, _ = associate_one_stage(
                    boxes[pool], labels[pool], pred, trk_labels,
                    self.loose_thresh, self.metric)
                matches = [(d, t) for d, t in m if t < n_real]
                stages = [1] * len(matches)
                free_idx = pool
            else:
                matches, stages, _new, _unm, _drop = associate_two_stage(
                    boxes[free_idx], labels[free_idx], scores[free_idx],
                    npts[free_idx], pred, trk_labels,
                    tight_thresh=self.tight_thresh,
                    loose_thresh=self.loose_thresh,
                    score_thresh=0.0, min_points=0, metric=self.metric,
                    parity=False,
                )
            for (d, t), stage in zip(matches, stages):
                di = int(free_idx[d])
                trk = cands[t]
                two_stage = bool(stage) and self.parity
                rev_kf[trk.tid].update(boxes[di], scores[di],
                                       two_stage=two_stage)
                # prepend to the track
                trk.frames.insert(0, f)
                trk.boxes.insert(0, rev_kf[trk.tid].current_box()
                                 if two_stage else boxes[di].copy())
                trk.scores.insert(0, float(scores[di]))
                trk.hits.insert(0, 2 if two_stage else 1)
                # the reverse filter runs with delta_t=-dt, so its state
                # velocity is ALREADY forward-time — no negation
                trk.kf_vels.insert(0, np.asarray(
                    rev_kf[trk.tid].velocity[:2], float))
                trk.birth_frame = f
                used[f][di] = True
