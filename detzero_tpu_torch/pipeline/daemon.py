"""Pipeline glue between tracking and refining (port of
detzero_tpu/pipeline/daemon.py; reference daemon/).

  * prepare_object_data — crop each tracked object's per-frame points with
    1.1x-enlarged global boxes and regroup everything object-level
    (prepare_object_data.py:15,56,241-313 semantics);
  * generate_iou_gt — per-box 3D IoU of (GRM size + PRM center)-combined
    boxes vs GT, the CRM training labels (generate_iou_gt.py:14);
  * combine_output — merge GRM size / PRM center / CRM score back into
    frame-level detections, optionally re-merging the tracker's drop data
    (combine_output.py:27,44,102).

All host-side: NumPy, and the per-object crop in the native C++ cropper
(`detzero_tpu_torch.native.crop_points_multi`) with the same canonical
point-in-box test.  The frames each route cropped are counted in
NATIVE_FRAMES and NUMPY_FRAMES (the NumPy route is the reference's, for a
machine without g++).
"""

from __future__ import annotations

import numpy as np

from detzero_tpu_torch.ops import box_np

# frames cropped by the native cropper and by the NumPy route, summed over
# prepare_object_data calls
NATIVE_FRAMES = 0
NUMPY_FRAMES = 0


def crop_object_points(frame_points_global, boxes_global, enlarge: float = 1.1):
    """points (N, 3+) in GLOBAL frame; boxes (M, 7) global. Returns a list of
    per-box point arrays (a point may fall in several enlarged boxes)."""
    out = []
    for b in np.asarray(boxes_global, float):
        eb = b.copy()
        eb[3:6] *= enlarge
        m = box_np.points_in_rotated_box(frame_points_global, eb)
        out.append(np.asarray(frame_points_global, np.float32)[m])
    return out


def prepare_object_data(track_result, frame_points, poses, nlz_col=None,
                        intensity_col: int = 3, enlarge: float = 1.1,
                        gt_boxes=None, gt_ids=None):
    """Build the per-object refining records for one sequence.

    Args:
        track_result: output of DetZeroTracker (dict with 'tracks').
        frame_points: list of (Ni, 3+) LIDAR-frame points per frame.
        poses: list of (4, 4) lidar->global poses per frame.
    Returns {obj_id: {'boxes_global', 'score', 'sample_idx', 'hit', 'state',
    'label', 'pose', 'pts' [per-frame cropped global points]}} — the
    reference's refining input pickle schema (prepare_object_data.py:241-313).
    """
    # transform each frame's points to global once
    global_pts = []
    for pts, pose in zip(frame_points, poses):
        pts = np.asarray(pts, np.float32)
        if nlz_col is not None and pts.shape[1] > nlz_col:
            pts = pts[pts[:, nlz_col] == -1]
            pts = np.delete(pts, nlz_col, axis=1)
        if pts.shape[1] > intensity_col:
            pts = pts.copy()
            pts[:, intensity_col] = np.tanh(pts[:, intensity_col])
        g = pts.copy()
        pose = np.asarray(pose, float)
        g[:, :3] = pts[:, :3] @ pose[:3, :3].T + pose[:3, 3]
        global_pts.append(g)

    # batch all (box, frame) crop queries per frame: the threaded C++
    # cropper (native.crop_points_multi — the roiaware_pool3d analog)
    # scans each frame's cloud once per box in parallel; NumPy fallback
    # keeps toolchain-free environments working
    global NATIVE_FRAMES, NUMPY_FRAMES
    from detzero_tpu_torch import native
    use_native = native.available()
    queries = {}  # frame -> list of (oid, row, box)
    for oid, t in track_result["tracks"].items():
        boxes = np.asarray(t["boxes_global"], float)
        frames = np.asarray(t["sample_idx"], int)
        for row, (b, f) in enumerate(zip(boxes, frames)):
            queries.setdefault(int(f), []).append((oid, row, b))
    crops = {}  # (oid, row) -> points
    for f, q in queries.items():
        boxes_f = np.stack([b for _, _, b in q])[:, :7]
        if use_native:
            got = native.crop_points_multi(global_pts[f], boxes_f, enlarge)
            NATIVE_FRAMES += 1
        else:
            NUMPY_FRAMES += 1
            got = []
            for b in boxes_f:
                eb = b.copy()
                eb[3:6] *= enlarge
                m = box_np.points_in_rotated_box(global_pts[f], eb)
                got.append(global_pts[f][m])
        for (oid, row, _), c in zip(q, got):
            crops[(oid, row)] = c

    out = {}
    for oid, t in track_result["tracks"].items():
        boxes = np.asarray(t["boxes_global"], float)
        frames = np.asarray(t["sample_idx"], int)
        pts_per_frame = [crops[(oid, row)] for row in range(len(boxes))]
        rec = {
            "boxes_global": boxes.astype(np.float32),
            "score": np.asarray(t["score"], np.float32),
            "sample_idx": frames,
            "hit": np.asarray(t["hit"], bool),
            "state": t.get("state", "dynamic"),
            "label": t.get("label", 0),
            "pose": [np.asarray(poses[f], np.float32) for f in frames],
            "pts": pts_per_frame,
        }
        if gt_boxes is not None:
            rec["gt_boxes"], rec["matched"] = _match_gt(boxes, frames, gt_boxes,
                                                        gt_ids)
        out[oid] = rec
    return out


def _match_gt(boxes, frames, gt_boxes_per_frame, gt_ids_per_frame,
              iou_thresh: float = 0.3):
    """Per-box GT match flags + best-overlap GT boxes.

    The best-IoU GT box is stored for EVERY row (zeros only when the frame
    has no GT at all): `matched` gates the refinement targets, but CRM's
    IoU labels must be honest on unmatched rows too (the reference computes
    IoU vs the gt trajectory for every frame, generate_iou_gt.py:44-51 —
    near-misses are its negatives)."""
    matched = np.zeros(len(boxes), bool)
    gts = np.zeros((len(boxes), 7), np.float32)
    for i, (b, f) in enumerate(zip(boxes, frames)):
        g = np.asarray(gt_boxes_per_frame[f], float).reshape(-1, 7)
        if not len(g):
            continue
        iou = box_np.boxes_iou3d(b[None, :7], g)[0]
        j = int(np.argmax(iou))
        gts[i] = g[j]
        if iou[j] >= iou_thresh:
            matched[i] = True
    return gts, matched


def generate_iou_gt(obj_records, refined_sizes, refined_centers=None,
                    refined_headings=None):
    """CRM label generation: per-box 3D IoU of the refined boxes vs matched GT
    (generate_iou_gt.py:14). Unmatched boxes get IoU -1 (ignore)."""
    out = {}
    for oid, rec in obj_records.items():
        boxes = np.asarray(rec["boxes_global"], float).copy()
        size = refined_sizes.get(oid) if isinstance(refined_sizes, dict) else refined_sizes
        if size is not None:
            boxes[:, 3:6] = np.asarray(size)[None, :]
        if refined_centers is not None and oid in refined_centers:
            boxes[:, :3] = refined_centers[oid]
        if refined_headings is not None and oid in refined_headings:
            boxes[:, 6] = refined_headings[oid]
        ious = np.full(len(boxes), -1.0, np.float32)
        if "gt_boxes" in rec:
            # honest IoU on every row vs the best-overlap GT (reference
            # generate_iou_gt.py:44-51 diag IoU over the whole track):
            # zero GT rows (frame had no GT) give IoU 0 — CRM negatives
            ious[:] = [box_np.boxes_iou3d(b[None, :7], g[None])[0, 0]
                       for b, g in zip(boxes, rec["gt_boxes"])]
        out[oid] = ious
    return out


def combine_output(obj_records, grm_sizes=None, prm_centers=None,
                   prm_headings=None, crm_scores=None, drop_data=None,
                   num_frames=None):
    """Merge refinement outputs into frame-level detections
    (combine_output.py:102 combine_final + convert_frame_format:44).

    Returns list (per frame) of {'boxes' (N, 7) global, 'scores',
    'obj_ids', 'labels'}.
    """
    if num_frames is None:
        num_frames = 1 + max(
            (int(r["sample_idx"].max()) for r in obj_records.values()
             if len(r["sample_idx"])), default=-1)
    frames = [{"boxes": [], "scores": [], "obj_ids": [], "labels": []}
              for _ in range(num_frames)]
    for oid, rec in obj_records.items():
        boxes = np.asarray(rec["boxes_global"], float).copy()
        scores = np.asarray(rec["score"], float).copy()
        label = rec.get("label", 0)
        if grm_sizes is not None and oid in grm_sizes:
            boxes[:, 3:6] = np.asarray(grm_sizes[oid])[None, :]
        if prm_centers is not None and oid in prm_centers:
            boxes[:, :3] = prm_centers[oid]
        if prm_headings is not None and oid in prm_headings:
            boxes[:, 6] = prm_headings[oid]
        if crm_scores is not None and oid in crm_scores:
            scores = np.asarray(crm_scores[oid], float)
        for b, s, f in zip(boxes, scores, rec["sample_idx"]):
            frames[f]["boxes"].append(b[:7])
            frames[f]["scores"].append(s)
            frames[f]["obj_ids"].append(oid)
            frames[f]["labels"].append(label)
    if drop_data is not None:
        for f, drop in enumerate(drop_data[:num_frames]):
            dlabels = drop.get("labels", [0] * len(drop.get("boxes", [])))
            for b, s, l in zip(drop.get("boxes", []),
                               drop.get("scores", []), dlabels):
                frames[f]["boxes"].append(np.asarray(b[:7], float))
                frames[f]["scores"].append(float(s))
                frames[f]["obj_ids"].append(-1)
                frames[f]["labels"].append(l)
    for fr in frames:
        fr["boxes"] = (np.stack(fr["boxes"]) if fr["boxes"]
                       else np.zeros((0, 7)))
        fr["scores"] = np.asarray(fr["scores"], float)
        fr["obj_ids"] = np.asarray(fr["obj_ids"])
        fr["labels"] = np.asarray(fr["labels"])
    return frames
