"""detzero_tpu_torch imports neither jax, flax nor detzero_tpu (predict and
one training step run with jax blocked), and on CPU tensors every kernel
wrapper takes its plain version (no launch counted);
on a tensor that is neither CPU nor CUDA a wrapper raises instead of falling
back."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from detzero_tpu_torch.ops import iou_bev, nms, rowpad_conv, stream_vfe

REPO = Path(__file__).resolve().parent.parent

MAIN_PATH = [
    "detzero_tpu_torch", "detzero_tpu_torch._build",
    "detzero_tpu_torch.convert",
    "detzero_tpu_torch.ops.pillars", "detzero_tpu_torch.ops.box_ops",
    "detzero_tpu_torch.ops.box_coder", "detzero_tpu_torch.ops.iou_bev",
    "detzero_tpu_torch.ops.nms", "detzero_tpu_torch.ops.rowpad_conv",
    "detzero_tpu_torch.ops.stream_vfe", "detzero_tpu_torch.models.layers",
    "detzero_tpu_torch.models.detection.backbone2d",
    "detzero_tpu_torch.models.detection.backbone3d_pillar",
    "detzero_tpu_torch.models.detection.backbone3d_pallas",
    "detzero_tpu_torch.models.detection.center_head",
    "detzero_tpu_torch.models.detection.centerpoint",
    "detzero_tpu_torch.ops.gaussian", "detzero_tpu_torch.ops.losses",
    "detzero_tpu_torch.ops.iou3d", "detzero_tpu_torch.core.optim",
    "detzero_tpu_torch.parallel.trainer",
]

SCRIPT = """
import importlib, json, sys
sys.modules["jax"] = None      # any import of jax now raises
sys.modules["flax"] = None
import numpy as np, torch
torch.set_num_threads(1)
for name in {mods!r}:
    importlib.import_module(name)
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
from detzero_tpu_torch.ops import iou_bev, nms, rowpad_conv, stream_vfe
cfg = {{"CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
        "VOXEL_CAPACITIES": (256, 128, 64, 32), "BEV_LAYER_NUMS": (1, 1)}}
m = CenterPoint(cfg, 3, pc_range=(-3.2, -3.2, -2.0, 3.2, 3.2, 2.0),
                voxel_size=(0.2, 0.2, 0.5), dtype=torch.float32)
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
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "flax", "jaxlib", "detzero_tpu")
             and sys.modules[k] is not None)
print(json.dumps({{"bad": bad, "kept": int(out["mask"].sum()),
    "finite": bool(torch.isfinite(loss) and torch.isfinite(gnorm)),
    "launches": [stream_vfe.LAUNCHES, rowpad_conv.LAUNCHES,
                 rowpad_conv.CONV_LAUNCHES, rowpad_conv.DW_LAUNCHES,
                 iou_bev.LAUNCHES, iou_bev.PAIRWISE_LAUNCHES,
                 nms.LAUNCHES]}}))
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
    assert res["launches"] == [0] * 7


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
        iou_bev.boxes_iou_bev_pairwise(torch.empty(4, 5, **meta),
                                       torch.empty(4, 5, **meta))
    assert [stream_vfe.LAUNCHES, rowpad_conv.LAUNCHES,
            rowpad_conv.CONV_LAUNCHES, rowpad_conv.DW_LAUNCHES,
            iou_bev.LAUNCHES, iou_bev.PAIRWISE_LAUNCHES,
            nms.LAUNCHES] == [0] * 7
