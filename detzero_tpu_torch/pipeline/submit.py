"""Waymo leaderboard submission writer (port of
detzero_tpu/pipeline/submit.py; reference evaluator/waymo_submit.py):
predictions -> a `metrics_pb2.Objects` .bin keyed by context_name +
frame_timestamp_micros, with track ids where asked.

The .bin is always written, by the package's own codec
(`protos/waymo_metrics_pb2.py`, no `google.protobuf`), byte for byte what
the reference's generated classes write on the same records.  Its
`Label.Box` takes waymo_label.proto's field numbers (width = 4,
length = 5), which disagree with waymo_dataset.proto's; which one the
public schema has is open (README.md).
"""

from __future__ import annotations

import uuid
from pathlib import Path

import numpy as np

from detzero_tpu_torch.protos import waymo_metrics_pb2

TYPE_MAP = {"Vehicle": 1, "Pedestrian": 2, "Cyclist": 4, "Sign": 3}


def build_submission_records(frame_preds, frame_meta, tracking: bool = False):
    """frame_preds: list of {'boxes_lidar' (N, 7+), 'score', 'name',
    'obj_ids'(opt)}; frame_meta: list of {'context_name',
    'frame_timestamp_micros'}.  Returns a list of plain-dict objects.

    Boxes wider than 7 (velocity columns, as a WITH_VELOCITY model
    predicts) give their first 7 columns: the reference reshapes them to
    (-1, 7), which raises or silently mixes boxes."""
    records = []
    for pred, meta in zip(frame_preds, frame_meta):
        boxes = np.asarray(pred["boxes_lidar"])
        boxes = boxes[:, :7] if boxes.ndim == 2 else boxes.reshape(-1, 7)
        for i in range(len(boxes)):
            b = boxes[i]
            rec = {
                "context_name": meta["context_name"],
                "frame_timestamp_micros": int(meta["frame_timestamp_micros"]),
                "box": {"center_x": float(b[0]), "center_y": float(b[1]),
                        "center_z": float(b[2]), "length": float(b[3]),
                        "width": float(b[4]), "height": float(b[5]),
                        "heading": float(b[6])},
                "score": float(np.asarray(pred["score"])[i]),
                "type": TYPE_MAP.get(str(np.asarray(pred["name"])[i]), 0),
            }
            if tracking:
                ids = pred.get("obj_ids")
                rec["id"] = (str(ids[i]) if ids is not None
                             else uuid.uuid4().hex)
            records.append(rec)
    return records


def write_submission(records, out_path, tracking: bool = False):
    """Serialize records to a metrics_pb2.Objects .bin at out_path;
    returns the path.  (The reference's `account` and `method` arguments
    went only into its .pkl fallback, which this writer does not have.)"""
    objs = waymo_metrics_pb2.Objects()
    for r in records:
        o = objs.objects.add()
        o.context_name = r["context_name"]
        o.frame_timestamp_micros = r["frame_timestamp_micros"]
        for k, v in r["box"].items():
            setattr(o.object.box, k, v)
        o.score = r["score"]
        o.object.type = r["type"]
        if tracking and "id" in r:
            o.object.id = r["id"]
    with open(out_path, "wb") as f:
        f.write(objs.SerializeToString())
    return Path(out_path)

