"""CenterPoint inference, eval mode (port of the reference's centerpoint.py:
the `CenterPointNet` network and the `CenterPoint` wrapper in one module).

The path of one sample: pillar table (stream mode) -> stream VFE (kernel K1)
-> plan and row-padded neighbour maps -> sparse 3D backbone (kernel K2, 20
convs) -> z-conv and densify -> 2D BEV backbone and center head (cuDNN) ->
decode and rotated NMS (kernel K3 and the NMS walk kernel).

Numerics on the card: importing this module sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`, so float32 work is never silently
run in TF32.  The model computes in its `dtype` (bfloat16 on the card, as the
reference's flagship does); parameters and BN statistics stay float32 and
the BN affine is folded in float32.

The config is a plain dict with the reference's keys.  Only the inference
path is ported: SECOND_STAGE and training wait for later work.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from detzero_tpu_torch.models.detection.backbone2d import BaseBEVBackbone
from detzero_tpu_torch.models.detection.backbone3d_pallas import (
    PallasResBackbone8x, SparseConvBNReLU, augment_plan_rowpad,
)
from detzero_tpu_torch.models.detection.backbone3d_pillar import (
    build_pillar_plan, plan_grids,
)
from detzero_tpu_torch.models.detection.center_head import (
    HM_BIAS, CenterHead, decode_predictions,
)
from detzero_tpu_torch.models.layers import trunc_normal_fan_in
from detzero_tpu_torch.ops.pillars import build_pillar_table
from detzero_tpu_torch.ops.stream_vfe import stream_rowpad_feats

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# all three reference backbones share one param tree and one network; the
# port runs them on the row-padded backbone
_BACKBONES = ("pillar_pallas", "pillar", "sorted")


class CenterPoint(nn.Module):
    """Geometry, network and decode.  Submodules `backbone3d`,
    `backbone2d` and `center_head` carry the reference's param-tree names,
    so `convert.convert_centerpoint` output loads with strict=True."""

    def __init__(self, model_cfg: Mapping[str, Any], num_classes: int, *,
                 pc_range, voxel_size, max_voxels: int = 150_000,
                 max_points: int = 200_000, max_objs: int = 500,
                 num_point_features: int = 5, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        cfg = dict(model_cfg)
        if cfg.get("SECOND_STAGE", False):
            raise NotImplementedError("SECOND_STAGE is not ported yet")
        if cfg.get("BACKBONE3D", "pillar") not in _BACKBONES:
            raise ValueError(f"unknown BACKBONE3D {cfg['BACKBONE3D']!r}")
        if cfg.get("DOWNSAMPLE_SITE_MODE", "principal") != "principal":
            raise NotImplementedError("only the 'principal' site mode is "
                                      "ported")
        self.dtype = dtype
        self.pc_range = tuple(float(v) for v in pc_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        nx = round((self.pc_range[3] - self.pc_range[0]) / self.voxel_size[0])
        ny = round((self.pc_range[4] - self.pc_range[1]) / self.voxel_size[1])
        nz = round((self.pc_range[5] - self.pc_range[2]) / self.voxel_size[2])
        self.grid_zyx = (nz, ny, nx)
        self.feature_map_stride = int(cfg.get("FEATURE_MAP_STRIDE", 8))
        groups = cfg.get("CLASS_IDS_EACH_HEAD")
        if groups is None:
            groups = [[i] for i in range(num_classes)]
        self.class_ids_each_head = tuple(tuple(g) for g in groups)
        capacities = tuple(cfg.get(
            "VOXEL_CAPACITIES", (max_voxels, max_voxels // 2,
                                 max_voxels // 4, max_voxels // 8)))
        self.pillar_capacities = tuple(cfg.get("PILLAR_CAPACITIES",
                                               capacities))
        self.row_budget = int(cfg.get("PILLAR_ROW_BUDGET", 128))
        self.bev_hw = (-(-ny // self.feature_map_stride),
                       -(-nx // self.feature_map_stride))

        channels = (16, 32, 64, 128)
        self.backbone3d = PallasResBackbone8x(
            self.grid_zyx, num_point_features, channels,
            blocks_per_level=int(cfg.get("BLOCKS_PER_LEVEL", 2)),
            residual=bool(cfg.get("BACKBONE_RESIDUAL", True)), device=device)
        bev_in = channels[3] * plan_grids(self.grid_zyx)[4][0]
        self.backbone2d = BaseBEVBackbone(
            bev_in, layer_nums=tuple(cfg.get("BEV_LAYER_NUMS", (5, 5))),
            num_filters=tuple(cfg.get("BEV_NUM_FILTERS", (128, 256))),
            device=device)
        self.center_head = CenterHead(
            256 * 2, self.class_ids_each_head,
            with_velocity=bool(cfg.get("WITH_VELOCITY", True)),
            with_iou=bool(cfg.get("WITH_IOU", True)), device=device)
        self.eval()

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator):
        """Random weights as flax would draw them (truncated-normal fan-in
        kernels, zero biases, heatmap bias -2.19, identity BN), from
        `generator`, which must live on the parameters' device.  Not the
        reference's random stream."""
        for name, mod in self.named_modules():
            if isinstance(mod, SparseConvBNReLU):
                kv, cin, _ = mod.kernel.shape
                mod.kernel.copy_(trunc_normal_fan_in(
                    mod.kernel.shape, kv * cin, generator,
                    mod.kernel.device))
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                cin = w.shape[0 if isinstance(mod, nn.ConvTranspose2d)
                              else 1]
                w.copy_(trunc_normal_fan_in(
                    w.shape, cin * w.shape[2] * w.shape[3], generator,
                    w.device))
                if mod.bias is not None:
                    mod.bias.fill_(HM_BIAS if name.endswith("hm_out")
                                   else 0.0)
        return self

    # ---------------- the stages of one sample ----------------

    def build_table(self, points, points_valid):
        """points (P, num_point_features) f32, points_valid (P,) -> pillar
        table with the sorted stream."""
        return build_pillar_table(
            points, points_valid, self.grid_zyx, self.voxel_size,
            self.pc_range, self.pillar_capacities[0], feats_mode="stream")

    def vfe(self, stream):
        """Kernel K1: stream -> (ny, nz*F, B) per-voxel means."""
        return stream_rowpad_feats(
            stream["payload"], stream["lane"], stream["z"], stream["wstart"],
            nz=self.grid_zyx[0], ny=self.grid_zyx[1],
            row_budget=self.row_budget, out_dtype=self.dtype)

    def build_plan(self, table):
        plan = build_pillar_plan(table, self.grid_zyx, self.pillar_capacities)
        return augment_plan_rowpad(plan, self.grid_zyx, self.row_budget)

    def bev_head(self, spatial_features):
        """(H, W, C) BEV map -> per-head prediction dicts."""
        return self.center_head(self.backbone2d(
            spatial_features.to(self.dtype)))

    def decode(self, preds, **decode_kwargs):
        return decode_predictions(
            preds, self.class_ids_each_head, self.bev_hw,
            self.feature_map_stride, self.voxel_size, self.pc_range,
            **decode_kwargs)

    @torch.no_grad()
    def forward_one(self, points, points_valid):
        """One sample's raw head outputs (list of dicts of (H, W, C))."""
        table = self.build_table(points, points_valid)
        rp_feats = self.vfe(table["stream"])
        plan = self.build_plan(table)
        return self.bev_head(self.backbone3d(rp_feats, plan))

    @torch.no_grad()
    def predict(self, points, points_valid, **decode_kwargs):
        """points (B, P, F), points_valid (B, P) -> dict of batched padded
        detections: boxes (B, K, 9), scores, labels, mask (B, K)."""
        outs = [self.decode(self.forward_one(p, v), **decode_kwargs)
                for p, v in zip(points, points_valid)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
