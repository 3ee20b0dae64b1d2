"""detzero_tpu_torch imports neither jax, flax, yaml, google.protobuf,
google_crc32c nor detzero_tpu, nor at import matplotlib or open3d (predict, one training step, the two-stage
predict and loss, one step of the training entry point from its config
and loader, the inference entry point on its checkpoint, the tracker on
its output, the refining stage (the daemon's records of those tracks, one
GRM training step, GRM's inference on its checkpoint), and preprocessing
and the offboard pipeline (a tfrecord through the codec and the native CRC,
infos, GT database, run_offboard on that tree, a submission .bin) run
with them blocked; no source file of the package, nor chip_smoke.py or
chip_profile.py, names them in an import), and on CPU tensors every
kernel wrapper takes its plain version (no launch counted); on a tensor that is neither CPU nor CUDA a wrapper raises instead
of falling back; and without a card the model is built only when the
caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from detzero_tpu_torch.ops import (iou_bev, nms, rowpad_conv, rowpad_nbr,
                                   stream_vfe, wbf)

REPO = Path(__file__).resolve().parent.parent

MAIN_PATH = [
    "detzero_tpu_torch", "detzero_tpu_torch._build",
    "detzero_tpu_torch.convert",
    "detzero_tpu_torch.ops.pillars", "detzero_tpu_torch.ops.box_ops",
    "detzero_tpu_torch.ops.box_coder", "detzero_tpu_torch.ops.iou_bev",
    "detzero_tpu_torch.ops.nms", "detzero_tpu_torch.ops.rowpad_conv",
    "detzero_tpu_torch.ops.rowpad_nbr",
    "detzero_tpu_torch.ops.stream_vfe", "detzero_tpu_torch.models.layers",
    "detzero_tpu_torch.models.detection.backbone2d",
    "detzero_tpu_torch.models.detection.backbone3d_pillar",
    "detzero_tpu_torch.models.detection.backbone3d_pallas",
    "detzero_tpu_torch.models.detection.center_head",
    "detzero_tpu_torch.models.detection.centerpoint",
    "detzero_tpu_torch.ops.gaussian", "detzero_tpu_torch.ops.losses",
    "detzero_tpu_torch.ops.iou3d", "detzero_tpu_torch.core.optim",
    "detzero_tpu_torch.parallel.trainer",
    "detzero_tpu_torch.models.detection.pdv_head",
    "detzero_tpu_torch.ops.box_np", "detzero_tpu_torch.core.yaml_subset",
    "detzero_tpu_torch.core.config", "detzero_tpu_torch.core.registry",
    "detzero_tpu_torch.core.logger", "detzero_tpu_torch.core.checkpoint",
    "detzero_tpu_torch.data.point_encoder",
    "detzero_tpu_torch.data.processor",
    "detzero_tpu_torch.data.database_sampler",
    "detzero_tpu_torch.data.augmentor", "detzero_tpu_torch.data.tta",
    "detzero_tpu_torch.data.dataset", "detzero_tpu_torch.data.waymo_dataset",
    "detzero_tpu_torch.tools.common", "detzero_tpu_torch.tools.train_det",
    "detzero_tpu_torch.native", "detzero_tpu_torch.ops.wbf",
    "detzero_tpu_torch.pipeline", "detzero_tpu_torch.pipeline.evaluator",
    "detzero_tpu_torch.models.tracking",
    "detzero_tpu_torch.models.tracking.association",
    "detzero_tpu_torch.models.tracking.kalman",
    "detzero_tpu_torch.models.tracking.post_process",
    "detzero_tpu_torch.models.tracking.target_assign",
    "detzero_tpu_torch.models.tracking.track_manager",
    "detzero_tpu_torch.models.tracking.tracker",
    "detzero_tpu_torch.tools.test_det", "detzero_tpu_torch.tools.run_track",
    "detzero_tpu_torch.tools.eval_track",
    "detzero_tpu_torch.tools.ensemble_dets",
    "detzero_tpu_torch.models.refining",
    "detzero_tpu_torch.models.refining.target_assign",
    "detzero_tpu_torch.models.refining.modules",
    "detzero_tpu_torch.models.refining.grm",
    "detzero_tpu_torch.models.refining.prm",
    "detzero_tpu_torch.models.refining.crm",
    "detzero_tpu_torch.models.refining.batched",
    "detzero_tpu_torch.models.refining.tta",
    "detzero_tpu_torch.data.refine_features",
    "detzero_tpu_torch.data.refine_dataset",
    "detzero_tpu_torch.data.record_cache",
    "detzero_tpu_torch.pipeline.daemon",
    "detzero_tpu_torch.tools.prepare_object_data",
    "detzero_tpu_torch.tools.build_record_cache",
    "detzero_tpu_torch.tools.train_refine",
    "detzero_tpu_torch.tools.test_refine",
    "detzero_tpu_torch.protos", "detzero_tpu_torch.protos.wire",
    "detzero_tpu_torch.protos.waymo_dataset_pb2",
    "detzero_tpu_torch.protos.waymo_label_pb2",
    "detzero_tpu_torch.protos.waymo_metrics_pb2",
    "detzero_tpu_torch.data.tfrecord_io",
    "detzero_tpu_torch.data.waymo_preprocess",
    "detzero_tpu_torch.core.profiling",
    "detzero_tpu_torch.pipeline.offboard", "detzero_tpu_torch.pipeline.submit",
    "detzero_tpu_torch.utils", "detzero_tpu_torch.utils.webviewer",
    "detzero_tpu_torch.tools.create_waymo_infos",
    "detzero_tpu_torch.tools.combine_output",
    "detzero_tpu_torch.tools.detzero_eval",
    "detzero_tpu_torch.tools.run_offboard",
    "detzero_tpu_torch.core.mesh", "detzero_tpu_torch.utils.common",
    "detzero_tpu_torch.utils.kitti_convert",
    "detzero_tpu_torch.utils.visualize", "detzero_tpu_torch.ops.kde",
    "detzero_tpu_torch.tools.eval_oracle",
    "detzero_tpu_torch.tools.ladder_synthetic",
    "detzero_tpu_torch.tools.analyze_trace",
]

SCRIPT = """
import importlib, json, sys
sys.modules["jax"] = None      # any import of jax now raises
sys.modules["flax"] = None
sys.modules["yaml"] = None
sys.modules["google.protobuf"] = None
sys.modules["google_crc32c"] = None
# the drawing libraries are imported by the functions that draw only
sys.modules["matplotlib"] = None
sys.modules["open3d"] = None
# TensorBoard's writer would load TensorFlow (12 s); the trainer runs
# without it, as on the card's machine
sys.modules["torch.utils.tensorboard"] = None
import numpy as np, torch
torch.set_num_threads(1)
for name in {mods!r}:
    importlib.import_module(name)
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
from detzero_tpu_torch.ops import (iou_bev, nms, rowpad_conv, rowpad_nbr,
                                   stream_vfe)
cfg = {{"CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
        "VOXEL_CAPACITIES": (256, 128, 64, 32), "BEV_LAYER_NUMS": (1, 1)}}
m = CenterPoint(cfg, 3, pc_range=(-3.2, -3.2, -2.0, 3.2, 3.2, 2.0),
                voxel_size=(0.2, 0.2, 0.5), dtype=torch.float32,
                device="cpu")
m.init_parameters(torch.Generator().manual_seed(0))
rng = np.random.RandomState(0)
pts = torch.from_numpy(rng.uniform(-3, 3, (1, 512, 5)).astype(np.float32))
out = m.predict(pts, torch.ones(1, 512, dtype=torch.bool), score_thresh=0.0)
# one training step at batch 2 through the trainer
from detzero_tpu_torch.core.optim import build_optimizer
from detzero_tpu_torch.parallel.trainer import Trainer
gb = torch.zeros(2, 4, 9)
gb[:, 0, :7] = torch.tensor([1.0, 1.0, 0.0, 4.4, 2.0, 1.6, 0.3])
gv = torch.zeros(2, 4, dtype=torch.bool)
gv[:, 0] = True
opt = build_optimizer({{"OPTIMIZER": "adam_onecycle", "LR": 0.003,
                       "WEIGHT_DECAY": 0.01, "GRAD_NORM_CLIP": 10.0}}, 5, m)
loss, aux, gnorm = Trainer(m, opt).step(dict(
    points=pts.expand(2, -1, -1), points_valid=torch.ones(2, 512,
                                                          dtype=torch.bool),
    gt_boxes=gb, gt_classes=torch.zeros(2, 4, dtype=torch.int32),
    gt_valid=gv))
# the two-stage model: predict, and one loss with its gradient
cfg2 = dict(cfg, SECOND_STAGE=True, ROI_BUDGET=8, ROI_GRID_SIZE=2,
            ROI_ATTENTION=True)
m2 = CenterPoint(cfg2, 3, pc_range=(-3.2, -3.2, -2.0, 3.2, 3.2, 2.0),
                 voxel_size=(0.2, 0.2, 0.5), dtype=torch.float32,
                 device="cpu")
m2.init_parameters(torch.Generator().manual_seed(0))
out2 = m2.predict(pts, torch.ones(1, 512, dtype=torch.bool))
loss2, _ = m2.loss(pts.expand(2, -1, -1), torch.ones(2, 512, dtype=torch.bool),
                   gb, torch.zeros(2, 4, dtype=torch.int32), gv,
                   generator=torch.Generator().manual_seed(1))
loss2.backward()
# the training entry point: config, synthetic dataset, loader, one step;
# then the inference entry point on its checkpoint, one frame saved, and
# the tracker on that frame
import tempfile
from detzero_tpu_torch.tools import run_track, test_det, train_det
with tempfile.TemporaryDirectory() as tmp:
    small = ["--set", "MODEL.PILLAR_ROW_BUDGET", "16",
             "MODEL.BEV_LAYER_NUMS", "[1, 1]"]
    common = ["--cfg_file",
              "configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml",
              "--device", "cpu", "--workers", "0", "--output_dir", tmp]
    cli = train_det.main(common + ["--max_steps", "1"] + small).step_count
    det = test_det.main(common + ["--save_to_file", "--max_batches", "1"]
                        + small)
    tracked = run_track.main(["--data_path", str(det["result_path"]),
                              "--output_dir", tmp + "/track"])
    cli = [cli, det["step"], len(det["det_annos"]),
           list(tracked["tracks"])]
    # the refining stage: the daemon's records of two tracks of 3 frames,
    # one GRM training step on them, and GRM's inference on its checkpoint
    import pickle
    from pathlib import Path
    from detzero_tpu_torch.pipeline import daemon
    from detzero_tpu_torch.tools import test_refine, train_refine
    box = np.array([2.0, 1.0, 0.0, 4.4, 2.0, 1.6, 0.3], np.float32)
    tr = {{"tracks": {{k: {{"boxes_global": np.stack([box + [k + f, 0, 0, 0,
                                                              0, 0, 0]
                                                      for f in range(3)]),
                         "score": np.ones(3, np.float32),
                         "sample_idx": np.arange(3), "hit": np.ones(3),
                         "label": 0}} for k in range(2)}}}}
    frames = [np.random.RandomState(f).uniform(-4, 4, (4096, 4))
              .astype(np.float32) for f in range(3)]
    recs = daemon.prepare_object_data(tr, frames, [np.eye(4)] * 3,
                                      gt_boxes=[box[None]] * 3)
    Path(tmp, "ref", "Vehicle").mkdir(parents=True)
    Path(tmp, "ref", "Vehicle", "seq.pkl").write_bytes(pickle.dumps(recs))
    rcli = ["--cfg_file", "configs/ref_model_cfgs/synthetic_grm.yaml",
            "--device", "cpu", "--workers", "0", "--output_dir", tmp,
            "--batch_size", "1"]
    rset = ["--set", "DATA_PATH", tmp + "/ref", "MODEL.D_MODEL", "16",
            "QUERY_POINTS", "8", "MEMORY_POINTS", "32"]
    refine = [train_refine.main(rcli + ["--max_steps", "1"] + rset)
              .step_count,
              test_refine.main(rcli + ["--save_to_file"] + rset)["step"],
              daemon.NATIVE_FRAMES + daemon.NUMPY_FRAMES > 0]
    # preprocessing and the offboard pipeline: a record of one frame through
    # the codec and the native CRC, infos and GT database, run_offboard on
    # that tree (no refiners), a submission .bin read back
    import zlib
    from detzero_tpu_torch.data import tfrecord_io
    from detzero_tpu_torch.data import waymo_preprocess as wp
    from detzero_tpu_torch.pipeline import submit
    from detzero_tpu_torch.protos import waymo_dataset_pb2 as wpb
    from detzero_tpu_torch.protos import waymo_metrics_pb2 as mpb
    from detzero_tpu_torch.tools import create_waymo_infos, run_offboard
    fr = wpb.Frame()
    fr.context.name = "ctx"
    fr.timestamp_micros = 7
    fr.pose.transform.extend(np.eye(4).ravel().tolist())
    cal = fr.context.laser_calibrations.add()
    cal.name = wpb.LaserName.TOP
    cal.beam_inclination_min, cal.beam_inclination_max = -0.3, 0.05
    cal.extrinsic.transform.extend(np.eye(4).ravel().tolist())
    las = fr.lasers.add()
    las.name = wpb.LaserName.TOP
    ri = np.zeros((8, 32, 4), np.float32)
    ri[:, :, 0] = 10.0
    ri[..., 3] = -1
    las.ri_return1.range_image_compressed = wp.encode_matrix(ri)
    lbl = fr.laser_labels.add()
    lbl.box.length, lbl.box.width, lbl.box.height = 4.0, 2.0, 1.5
    lbl.box.center_x = 9.0
    lbl.type = wpb.Label.TYPE_VEHICLE
    root = Path(tmp, "waymo")
    (root / "raw").mkdir(parents=True)
    (root / "ImageSets").mkdir()
    (root / "ImageSets" / "val.txt").write_text("seg")
    tfrecord_io.write_tfrecord(root / "raw" / "seg.tfrecord",
                               [fr.SerializeToString()] * 2)
    infos = create_waymo_infos.main([
        "--stage", "infos", "--raw_dir", str(root / "raw"), "--out_dir",
        str(root / "proc"), "--split_file", str(root / "ImageSets" / "val.txt"),
        "--workers", "1"])
    db = create_waymo_infos.main([
        "--stage", "gt_database", "--infos_path",
        str(root / "waymo_infos_val.pkl"), "--out_dir", str(root / "proc"),
        "--db_out", str(root / "db.pkl")])
    dets = [{{"boxes_lidar": i["annos"]["gt_boxes_lidar"],
             "score": np.ones(1), "name": i["annos"]["name"],
             "sequence_name": "seg", "frame_id": k, "pose": i["pose"]}}
            for k, i in enumerate(infos)]
    (root / "dets.pkl").write_bytes(pickle.dumps(dets))
    off = run_offboard.main(["--det_path", str(root / "dets.pkl"),
                             "--points_root", str(root / "proc"),
                             "--output_dir", str(root / "off")])
    recs = submit.build_submission_records(
        dets, [{{"context_name": "ctx", "frame_timestamp_micros": 7}}] * 2)
    objs = mpb.Objects()
    objs.ParseFromString(submit.write_submission(
        recs, root / "sub.bin").read_bytes())
    offboard = [len(infos), len(db["Vehicle"]),
                len(list(tfrecord_io.read_tfrecord(
                    root / "raw" / "seg.tfrecord", verify_crc=True))),
                sorted(off["timings"]), len(objs.objects)]
bad = sorted(k for k in sys.modules
             if (k.split(".")[0] in ("jax", "flax", "jaxlib", "detzero_tpu",
                                     "yaml", "google_crc32c", "matplotlib",
                                     "open3d")
                 or k.startswith("google.protobuf"))
             and sys.modules[k] is not None)
print(json.dumps({{"bad": bad, "kept": int(out["mask"].sum()),
    "finite": bool(torch.isfinite(loss) and torch.isfinite(gnorm)),
    "two_stage": [list(out2["boxes"].shape), int(out2["mask"].sum()),
                  bool(torch.isfinite(out2["boxes"]).all()),
                  bool(torch.isfinite(loss2))],
    "cli": cli, "refine": refine, "offboard": offboard, "launches": [stream_vfe.LAUNCHES, rowpad_conv.LAUNCHES,
                 rowpad_conv.CONV_LAUNCHES, rowpad_conv.DW_LAUNCHES,
                 iou_bev.LAUNCHES, iou_bev.OVERLAP_LAUNCHES,
                 iou_bev.PAIRWISE_LAUNCHES, nms.LAUNCHES,
                 rowpad_nbr.LAUNCHES, rowpad_conv.SLIDING_LAUNCHES]}}))
"""


def test_port_imports_no_jax_and_cpu_takes_plain_versions():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(mods=MAIN_PATH)], cwd=REPO,
        capture_output=True, text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["kept"] > 0
    assert res["finite"]
    assert res["two_stage"] == [[1, 8, 7], 8, True, True]
    assert res["cli"] == [1, 1, 1, ["synthetic_000"]]
    assert res["refine"] == [1, 1, True]
    assert res["offboard"] == [2, 1, 2, ["combine", "prepare_objects",
                                         "refine", "track"], 2]
    assert res["launches"] == [0] * 10


def _imported_roots(path):
    """The top-level package of every import statement in a file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*REPO.glob("detzero_tpu_torch/**/*.py"), REPO / "chip_smoke.py",
     REPO / "chip_profile.py"]))
def test_no_source_imports_jax_yaml_or_the_reference(path):
    roots = _imported_roots(REPO / path)
    assert not roots & {"jax", "jaxlib", "flax", "optax", "orbax", "yaml",
                        "detzero_tpu", "google", "google_crc32c"}, path


def test_wrappers_raise_off_cpu_and_cuda():
    """A 'meta' tensor is neither on the CPU nor on a card: the wrappers
    must refuse it, not fall back to the plain versions."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        iou_bev.boxes_iou_bev(torch.empty(4, 5, **meta),
                              torch.empty(4, 5, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        nms.nms_walk(torch.empty(4, 4, **meta),
                     torch.empty(4, dtype=torch.bool, **meta), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        stream_vfe.stream_rowpad_feats(
            torch.empty(10, 6, **meta), torch.empty(10, dtype=torch.int32,
                                                    **meta),
            torch.empty(10, dtype=torch.int32, **meta),
            torch.empty(5, dtype=torch.int32, **meta), nz=2, ny=4,
            row_budget=8)
    with pytest.raises(ValueError, match="CUDA"):
        rowpad_conv.rowpad_conv_fused(
            torch.empty(4, 2 * 3, 8, **meta),
            torch.empty(4, 16, 8, dtype=torch.int32, **meta),
            torch.empty(27, 3, 8, **meta), torch.empty(8, **meta),
            torch.empty(8, **meta),
            torch.empty(4, 2, 8, dtype=torch.bool, **meta), nz=2, cin=3,
            cout=8)
    nbr = torch.empty(4, 16, 8, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        rowpad_conv.rowpad_conv(torch.empty(4, 2 * 3, 8, **meta), nbr,
                                torch.empty(27, 3, 16, **meta), nz=2, cin=3,
                                cout=16)
    with pytest.raises(ValueError, match="CUDA"):
        rowpad_conv.rowpad_conv_dw(torch.empty(4, 2 * 3, 8, **meta), nbr,
                                   torch.empty(4, 2 * 16, 8, **meta), nz=2,
                                   cin=3, cout=16)
    with pytest.raises(ValueError, match="CUDA"):
        rowpad_conv.rowpad_conv_sliding(
            torch.empty(4, 2 * 3, 8, dtype=torch.bfloat16, **meta), nbr,
            torch.empty(27, 3, 16, **meta), nz=2, cin=3, cout=16)
    with pytest.raises(ValueError, match="CUDA"):
        rowpad_nbr.rowpad_nbr(torch.empty(4, 8, dtype=torch.int32, **meta),
                              torch.empty(4, 8, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        iou_bev.boxes_iou_bev_pairwise(torch.empty(4, 5, **meta),
                                       torch.empty(4, 5, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        iou_bev.boxes_overlap_bev(torch.empty(4, 5, **meta),
                                  torch.empty(7, 5, **meta))
    with pytest.raises(ValueError, match="CUDA"):    # WBF "members", n > 32
        wbf._pairwise_iou3d(np.zeros((33, 7)), device="meta")
    assert [stream_vfe.LAUNCHES, rowpad_conv.LAUNCHES,
            rowpad_conv.CONV_LAUNCHES, rowpad_conv.DW_LAUNCHES,
            iou_bev.LAUNCHES, iou_bev.OVERLAP_LAUNCHES,
            iou_bev.PAIRWISE_LAUNCHES, nms.LAUNCHES, rowpad_nbr.LAUNCHES,
            rowpad_conv.SLIDING_LAUNCHES] == [0] * 10


def test_model_needs_a_device_without_cuda(monkeypatch):
    """With no card, CenterPoint() without a device raises instead of
    building on the CPU, for either stage; device="cpu" builds there."""
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(pc_range=(-3.2, -3.2, -2.0, 3.2, 3.2, 2.0),
              voxel_size=(0.2, 0.2, 0.5))
    cfg = {"VOXEL_CAPACITIES": (256, 128, 64, 32), "BEV_LAYER_NUMS": (1, 1)}
    for extra in ({}, {"SECOND_STAGE": True, "ROI_BUDGET": 8,
                       "ROI_GRID_SIZE": 2}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CenterPoint(dict(cfg, **extra), 3, **kw)
        m = CenterPoint(dict(cfg, **extra), 3, device="cpu", **kw)
        assert {p.device.type for p in m.parameters()} == {"cpu"}
