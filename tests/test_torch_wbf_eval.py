"""WBF (detzero_tpu_torch.ops.wbf), the Waymo-protocol evaluator
(detzero_tpu_torch.pipeline.evaluator) and the ensembling CLI
(detzero_tpu_torch.tools.ensemble_dets) against the reference's on the
CPU.  WBF "fused" is numpy on the bit-identical box_np in both packages,
so clusters, boxes and scores are equal exactly; "members" with more than
32 boxes takes the reference's XLA iou3d and the port's K7 plain version,
so clusters are equal and boxes within 1e-5 (the two IoU matrices differ
by 6.6e-6 at most on the case below, float32 clips in two orders; the
test holds the gap under 1e-5).  The evaluator is numpy on both sides:
its results are equal exactly, and the reference's golden cases
(tests/test_evaluator_golden.py) hold on the port's evaluator."""

import pickle

import numpy as np
import pytest

from detzero_tpu.ops import box_np as ref_box_np
from detzero_tpu.ops import wbf as ref_wbf
from detzero_tpu.pipeline import evaluator as ref_evaluator
from detzero_tpu_torch.ops import box_np, wbf
from detzero_tpu_torch.pipeline import evaluator
from detzero_tpu_torch.tools import ensemble_dets
from tools import ensemble_dets as ref_ensemble_dets

import test_evaluator_golden as golden

CLASSES = ("Vehicle", "Pedestrian", "Cyclist")
SIZES = {"Vehicle": (4.5, 2.0, 1.6), "Pedestrian": (0.9, 0.9, 1.7),
         "Cyclist": (1.8, 0.8, 1.7)}


def clustered(seed, n_objects=12, copies=5, jitter=0.15):
    """(names, boxes (N, 7), scores): `copies` jittered detections of each
    of n_objects objects of the three classes, as TTA variants or
    ensemble members give them, in a shuffled order."""
    rng = np.random.RandomState(seed)
    names, boxes = [], []
    for i in range(n_objects):
        cls = CLASSES[i % 3]
        base = np.array([*rng.uniform(-30, 30, 2), rng.uniform(-1, 1),
                         *SIZES[cls], rng.uniform(-np.pi, np.pi)])
        for _ in range(copies):
            b = base.copy()
            b[:3] += rng.randn(3) * jitter
            b[3:6] *= rng.uniform(0.9, 1.1, 3)
            b[6] += rng.randn() * 0.05
            boxes.append(b)
            names.append(cls)
    order = rng.permutation(len(boxes))
    return (np.array(names)[order], np.array(boxes)[order],
            rng.uniform(0.05, 1.0, len(boxes))[order])


def _same_fusion(a, b):
    fa, sa, ca, ea = a
    fb, sb, cb, eb = b
    assert ca == cb
    assert np.array_equal(fa, fb) and np.array_equal(sa, sb)
    assert (ea is None) == (eb is None)
    if ea is not None:
        assert np.array_equal(ea, eb)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_mode_exact(seed):
    names, boxes, scores = clustered(seed)
    for cls in CLASSES:
        m = names == cls
        for kw in ({"iou_thresh": 0.5}, {"iou_thresh": 0.3, "n_models": 5,
                                         "conf_type": "max",
                                         "skip_thresh": 0.2}):
            _same_fusion(
                ref_wbf.weighted_boxes_fusion_3d(boxes[m], scores[m], **kw),
                wbf.weighted_boxes_fusion_3d(boxes[m], scores[m], **kw))
    for n_models in (1, 5):
        a = ref_wbf.wbf_online(names, boxes, scores, n_models=n_models)
        b = wbf.wbf_online(names, boxes, scores, n_models=n_models)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert len(b[0]) < len(names)


def test_members_mode_on_the_cpu():
    """60 boxes of one class: the reference's XLA IoU matrix against the
    port's K7 plain version (gap under 1e-5), then equal clusters and
    fused boxes within 1e-5."""
    names, boxes, scores = clustered(3, n_objects=36, copies=5)
    m = names == "Vehicle"
    assert m.sum() == 60
    b = boxes[m][np.argsort(-scores[m], kind="stable")]
    gap = np.abs(ref_wbf._pairwise_iou3d(b) -
                 wbf._pairwise_iou3d(b, device="cpu")).max()
    assert gap < 1e-5
    ref = ref_wbf.weighted_boxes_fusion_3d(boxes[m], scores[m], 0.3,
                                           iou_mode="members", n_models=5)
    got = wbf.weighted_boxes_fusion_3d(boxes[m], scores[m], 0.3,
                                       iou_mode="members", n_models=5,
                                       device="cpu")
    assert ref[2] == got[2] and len(got[2]) < 60
    assert np.abs(ref[0] - got[0]).max() <= 1e-5
    assert np.array_equal(ref[1], got[1])
    # 32 boxes or fewer take box_np on either device
    small = wbf._pairwise_iou3d(b[:32], device="meta")
    assert np.array_equal(small, ref_wbf._pairwise_iou3d(b[:32]))
    with pytest.raises(ValueError, match="CUDA"):
        wbf._pairwise_iou3d(b, device="meta")


def test_damping_and_tracking_fusion():
    names, boxes, scores = clustered(4, n_objects=6, copies=3)
    ids = np.arange(len(boxes)) * 7
    for n_models in (1, 3, 8):
        a = ref_wbf.weighted_tracking_boxes_fusion_3d(
            boxes, scores, ids, 0.4, 0.1, n_models=n_models)
        b = wbf.weighted_tracking_boxes_fusion_3d(
            boxes, scores, ids, 0.4, 0.1, n_models=n_models)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    one = wbf.weighted_boxes_fusion_3d(boxes, scores, 0.4)
    three = wbf.weighted_boxes_fusion_3d(boxes, scores, 0.4, n_models=3)
    sizes = np.array([len(c) for c in one[2]])
    assert np.allclose(three[1], one[1] * np.minimum(sizes, 3) / 3)
    empty = wbf.weighted_boxes_fusion_3d(boxes, scores * 0, 0.4,
                                         skip_thresh=0.5)
    assert empty[0].shape == (0, 7) and empty[2] == []


def test_boxes_iou3d_prefilter_equals_the_oracle():
    """The port's 3D IoU, which clips only the pairs whose BEV circles
    meet and whose heights overlap, against the reference's oracle on
    every pair: clustered boxes, boxes that touch along an edge, corner to
    corner, at the circles' distance and a hair beyond, stacked with and
    without a shared height, zero-size boxes, and empty sets."""
    _, a, _ = clustered(5, n_objects=9, copies=4)
    base = np.array([0, 0, 0, 4.0, 2.0, 1.6, 0.3])
    r = 0.5 * np.hypot(4.0, 2.0)
    c, s = np.cos(0.3), np.sin(0.3)
    edge = [base + [4.0 * c, 4.0 * s, 0, 0, 0, 0, 0],
            base + [4.0 * c - 2.0 * s, 4.0 * s + 2.0 * c, 0, 0, 0, 0, 0],
            base + [2 * r, 0, 0, 0, 0, 0, 0.5],
            base + [2 * r + 1e-4, 0, 0, 0, 0, 0, 0.2],
            base + [0.1, 0.1, 0, -4.0, 0, 0, 0],
            base + [0, 0, 1.6, 0, 0, 0, 0],         # stacked, faces touch
            base + [0.5, 0, 1.0, 0, 0, 0, 0], base]
    b = np.concatenate([a[::3], np.stack(edge)])
    for x, y in ((a, b), (b, b), (np.stack(edge), a), (a[:0], b)):
        want = ref_box_np.boxes_iou3d(x, y)
        got = box_np.boxes_iou3d(x, y)
        assert got.shape == want.shape and np.array_equal(got, want)
        if x is y:
            assert (got > 0).sum() > len(b) and (got == 0).any()


# ----------------------------------------------------------------------
GOLDEN = sorted(k for k in dir(golden) if k.startswith("test_"))


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_cases_on_the_port(name, monkeypatch):
    """Each golden case of the reference with the port's evaluator in
    place of the reference's: the analytic AP and APH that the case
    asserts hold on the port."""
    for fn in ("evaluate_detection", "_average_precision",
               "_integrate_pr_capped"):
        monkeypatch.setattr(golden, fn, getattr(evaluator, fn))
    getattr(golden, name)()


def detection_set(seed=0, n_frames=20):
    """n_frames frames of the three classes: GT (a third of it hard, at
    most 5 points, at ranges across the three bins), detections that
    jitter, miss and add false positives, scores in [0, 1)."""
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_frames):
        n = rng.randint(4, 12)
        cls = np.array(CLASSES)[rng.randint(0, 3, n)]
        r = rng.uniform(2, 70, n)
        a = rng.uniform(-np.pi, np.pi, n)
        gb = np.zeros((n, 7))
        gb[:, 0], gb[:, 1] = r * np.cos(a), r * np.sin(a)
        gb[:, 3:6] = [SIZES[c] for c in cls]
        gb[:, 6] = rng.uniform(-np.pi, np.pi, n)
        npts = np.where(rng.rand(n) < 0.33, rng.randint(1, 6, n),
                        rng.randint(6, 500, n))
        keep = rng.rand(n) > 0.15
        pb = gb[keep] + np.c_[rng.randn(keep.sum(), 3) * 0.2,
                              rng.randn(keep.sum(), 3) * 0.1,
                              rng.randn(keep.sum(), 1) * 0.3]
        n_fp = rng.randint(0, 4)
        fp = np.zeros((n_fp, 7))
        fp[:, :2] = rng.uniform(-70, 70, (n_fp, 2))
        fp[:, 3:6] = [4.5, 2.0, 1.6]
        preds.append({"boxes_lidar": np.concatenate([pb, fp]),
                      "name": np.concatenate([cls[keep], np.array(
                          CLASSES)[rng.randint(0, 3, n_fp)]]),
                      "score": rng.rand(keep.sum() + n_fp)})
        gts.append({"gt_boxes": gb, "name": cls, "num_points": npts})
    return preds, gts


@pytest.mark.parametrize("ap_mode", ["envelope", "waymo101"])
def test_detection_results_exact(ap_mode):
    preds, gts = detection_set()
    want = ref_evaluator.evaluate_detection(preds, gts, CLASSES,
                                            ap_mode=ap_mode)
    got = evaluator.evaluate_detection(preds, gts, CLASSES, ap_mode=ap_mode)
    assert got == want
    assert 0 < got["mean"]["AP_L2"] < 1
    assert evaluator.format_results_table(got) == \
        ref_evaluator.format_results_table(want)


def tracking_sequences(seed=1, n_seq=2, n_frames=12):
    """(pred_frames, gt_frames) pairs: objects of the three classes
    moving 1 m a frame, tracked with noise, an id switch, misses and
    false positives."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_seq):
        n = 6
        cls = np.array(CLASSES)[np.arange(n) % 3]
        start = rng.uniform(-30, 30, (n, 2))
        vel = rng.uniform(-1, 1, (n, 2))
        gtf, prf = [], []
        for f in range(n_frames):
            gb = np.zeros((n, 7))
            gb[:, :2] = start + vel * f
            gb[:, 3:6] = [SIZES[c] for c in cls]
            gtf.append({"boxes": gb, "obj_ids": np.arange(n), "name": cls})
            keep = rng.rand(n) > 0.1
            pb = gb[keep].copy()
            pb[:, :2] += rng.randn(keep.sum(), 2) * 0.1
            ids = np.arange(n)[keep] + 100 + (f > n_frames // 2)
            fp = np.zeros((1, 7))
            fp[0, :2] = rng.uniform(-30, 30, 2)
            fp[0, 3:6] = SIZES["Vehicle"]
            prf.append({"boxes": np.concatenate([pb, fp]),
                        "obj_ids": np.concatenate([ids, [999]]),
                        "name": np.concatenate([cls[keep], ["Vehicle"]])})
        out.append((prf, gtf))
    return out


def test_tracking_results_exact():
    seqs = tracking_sequences()
    for pred, gt in seqs:
        want = ref_evaluator.evaluate_tracking(pred, gt)
        assert evaluator.evaluate_tracking(pred, gt) == want
        assert 0 < want["MOTA"] < 1 and want["mismatch"] > 0
    want = ref_evaluator.evaluate_tracking_by_class(seqs)
    assert evaluator.evaluate_tracking_by_class(seqs) == want
    assert set(want) == {*CLASSES, "mean"}


def test_ensemble_cli(tmp_path):
    """Three jittered copies of the detection set's detections fused, and
    the fused result scored against its GT, by both packages' CLIs."""
    preds, gts = detection_set(seed=2, n_frames=6)
    rng = np.random.RandomState(3)
    paths = []
    for m in range(3):
        res = [{"frame_id": i, "sequence_name": "seq0",
                "name": p["name"],
                "boxes_lidar": p["boxes_lidar"] + rng.randn(
                    *p["boxes_lidar"].shape) * 0.02,
                "score": rng.rand(len(p["score"]))}
               for i, p in enumerate(preds)]
        paths.append(tmp_path / f"r{m}.pkl")
        paths[-1].write_bytes(pickle.dumps(res))
    (tmp_path / "gt.pkl").write_bytes(pickle.dumps(gts))
    results = [pickle.loads(p.read_bytes()) for p in paths]
    want = ref_ensemble_dets.fuse_result_lists(results)
    fused, res = ensemble_dets.main(
        ["--results", *map(str, paths), "--output",
         str(tmp_path / "out" / "fused.pkl"), "--gt_path",
         str(tmp_path / "gt.pkl")])
    assert pickle.loads((tmp_path / "out" / "fused.pkl").read_bytes()) \
        .__len__() == len(want) == 6
    for a, b in zip(want, fused):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert res == ref_evaluator.evaluate_detection(want, gts, CLASSES)
    assert ensemble_dets.main(["--results", str(paths[0]), "--output",
                               str(tmp_path / "one.pkl")])[1] is None
