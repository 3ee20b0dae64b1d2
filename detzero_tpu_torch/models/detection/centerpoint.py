"""CenterPoint (port of the reference's centerpoint.py: the `CenterPointNet`
network and the `CenterPoint` wrapper in one module), inference and the
training loss, with or without the PDV second stage.

Inference, one sample at a time: pillar table (stream mode) -> stream VFE
(kernel K1) -> plan and row-padded neighbour maps -> sparse 3D backbone
(kernel K2, 20 convs) -> z-conv and densify -> 2D BEV backbone and center
head (cuDNN) -> decode and rotated NMS (kernel K3 and the NMS walk kernel).

Training, a batch at once (`loss`): each sample's table, VFE (K1) and plan,
then the samples stacked along the BEV-row axis (`stack_plans`) -> the 3D
backbone in train mode (20 forward convs of kernel K4; backward: 19 K4
input gradients, the stem has none, and 20 K5 weight gradients) with masked
batch BN over the whole batch -> 2D backbone and head with BN over N*H*W ->
gaussian targets and the focal + L1 + IoU-branch loss (kernel K6 for the
matched-pair IoU, one launch per head).  `predict` always runs eval mode and
`loss` train mode, as the reference's separate eval and train networks do.

Two-stage (SECOND_STAGE, the PDV RoI head): the table is built in dense
mode and gathered into the row-padded layout (no K1), the plan carries each
level's point centroids, the 3D backbone also returns its level-2 and
level-3 compact tables, and after the center head: proposals (decode + NMS
of the detached head outputs at ROI_BUDGET, K3 and the walk once per
sample, in training too), BEV keypoint features, and the RoI head
(`pdv_head.py`) over the whole batch.  `predict` returns the refined boxes;
`loss` adds the mean RoI loss, whose targets take kernel K7 once per sample.
The features, BEV map and proposals enter the second stage detached, so its
loss trains only `roi_head`.

Numerics on the card: importing this module sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`, so float32 work is never silently
run in TF32.  The model computes in its `dtype` (bfloat16 on the card, as the
reference's flagship does); parameters and BN statistics stay float32 and
the BN affine is folded in float32.

The config is a plain dict with the reference's keys.  The model is built
on the card unless the caller asks for another device (`device="cpu"`).

Stage timing: `stage_hook`, when set to a callable, is called with a stage's
name where each stage of `prepare`, `network`, `predict` and `loss` begins
(chip_smoke.py records a CUDA event there); None costs one attribute test.
The same marks are stages of the active `core/profiling` recording, under a
`predict` span a call, a `sample` span a sample of it and a `prepare` span
a sample of `prepare`; with no recording they cost one more test.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Mapping

import torch
from torch import nn

from detzero_tpu_torch.core import profiling
from detzero_tpu_torch.models.detection.backbone2d import BaseBEVBackbone
from detzero_tpu_torch.models.detection.backbone3d_pallas import (
    PallasResBackbone8x, SparseConvBNReLU, augment_plan_rowpad, stack_plans,
)
from detzero_tpu_torch.models.detection.backbone3d_pillar import (
    build_pillar_plan, lossless_row_budget, plan_grids,
)
from detzero_tpu_torch.models.detection.center_head import (
    HM_BIAS, CenterHead, assign_targets, center_head_loss,
    decode_predictions,
)
from detzero_tpu_torch.models.detection.pdv_head import (
    PDVHead, assign_roi_targets, pdv_loss, pdv_predict, subsample_rois,
)
from detzero_tpu_torch.models.layers import DenseGeneral, trunc_normal_fan_in
from detzero_tpu_torch.ops import pillars
from detzero_tpu_torch.ops.box_ops import (
    bilinear_sample_bev, box_keypoints_bev,
)
from detzero_tpu_torch.ops.stream_vfe import stream_rowpad_feats

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# all three reference backbones share one param tree and one network; the
# port runs them on the row-padded backbone
_BACKBONES = ("pillar_pallas", "pillar", "sorted")
# the second stage pools these multi-scale tables: (name, level, stride)
_ROI_LEVELS = (("x_conv3", 2, 4), ("x_conv4", 3, 8))


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None.  Raises when no card is
    there: the model never falls back to the CPU unless asked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CenterPoint builds on CUDA unless a device is "
                           "given, and torch finds no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


class CenterPoint(nn.Module):
    """Geometry, network and decode.  Submodules `backbone3d`,
    `backbone2d` and `center_head` carry the reference's param-tree names,
    so `convert.convert_centerpoint` output loads with strict=True."""

    stage_hook = None

    def __init__(self, model_cfg: Mapping[str, Any], num_classes: int, *,
                 pc_range, voxel_size, max_voxels: int = 150_000,
                 max_points: int = 200_000, max_objs: int = 500,
                 num_point_features: int = 5, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = dict(model_cfg)
        if cfg.get("BACKBONE3D", "pillar") not in _BACKBONES:
            raise ValueError(f"unknown BACKBONE3D {cfg['BACKBONE3D']!r}")
        self.site_mode = cfg.get("DOWNSAMPLE_SITE_MODE", "principal")
        if self.site_mode not in pillars.SITE_MODES:
            raise ValueError(f"unknown DOWNSAMPLE_SITE_MODE "
                             f"{self.site_mode!r}")
        self.dtype = dtype
        self.max_objs = int(max_objs)
        self.with_velocity = bool(cfg.get("WITH_VELOCITY", True))
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
        # the reference's 'pillar' and 'sorted' routes keep every pillar
        # of a row; 'pillar_pallas' drops those past 128 a row, as there
        budget = cfg.get("PILLAR_ROW_BUDGET")
        if budget is None:
            budget = 128 if cfg.get("BACKBONE3D", "pillar") == \
                "pillar_pallas" else lossless_row_budget(self.grid_zyx)
        self.row_budget = int(budget)
        self.bev_hw = (-(-ny // self.feature_map_stride),
                       -(-nx // self.feature_map_stride))
        self.second_stage = bool(cfg.get("SECOND_STAGE", False))
        self.roi_budget = int(cfg.get("ROI_BUDGET", 128))
        self.roi_sampler = dict(cfg.get("ROI_SAMPLER") or {})

        channels = (16, 32, 64, 128)
        self.backbone3d = PallasResBackbone8x(
            self.grid_zyx, num_point_features, channels,
            blocks_per_level=int(cfg.get("BLOCKS_PER_LEVEL", 2)),
            residual=bool(cfg.get("BACKBONE_RESIDUAL", True)),
            with_multi_scale=self.second_stage, device=device)
        bev_in = channels[3] * plan_grids(self.grid_zyx)[4][0]
        self.backbone2d = BaseBEVBackbone(
            bev_in, layer_nums=tuple(cfg.get("BEV_LAYER_NUMS", (5, 5))),
            num_filters=tuple(cfg.get("BEV_NUM_FILTERS", (128, 256))),
            device=device)
        self.center_head = CenterHead(
            256 * 2, self.class_ids_each_head,
            with_velocity=self.with_velocity,
            with_iou=bool(cfg.get("WITH_IOU", True)), device=device)
        if self.second_stage:
            # 5 BEV keypoints of the 2D backbone's 512 channels per RoI
            self.roi_head = PDVHead(
                self.pc_range, self.voxel_size,
                [channels[lvl] for _, lvl, _ in _ROI_LEVELS],
                extra_channels=5 * 256 * 2,
                grid_size=int(cfg.get("ROI_GRID_SIZE", 6)),
                with_attention=bool(cfg.get("ROI_ATTENTION", False)),
                device=device)
        self.eval()

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator):
        """Random weights as flax would draw them (truncated-normal fan-in
        kernels, zero biases, heatmap bias -2.19, identity BN and
        LayerNorm), from `generator`, which must live on the parameters'
        device.  Not the reference's random stream."""
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(trunc_normal_fan_in(
                    mod.weight.shape, mod.in_features, generator,
                    mod.weight.device))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, DenseGeneral):
                mod.kernel.copy_(trunc_normal_fan_in(
                    mod.kernel.shape, math.prod(mod.in_shape), generator,
                    mod.kernel.device))
                mod.bias.zero_()
            elif isinstance(mod, SparseConvBNReLU):
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

    def _stage(self, name):
        if self.stage_hook is not None:
            self.stage_hook(name)
        if profiling.ACTIVE is not None:
            profiling.ACTIVE.mark(name)

    # ---------------- the stages of one sample ----------------

    def build_table(self, points, points_valid):
        """points (P, num_point_features) f32, points_valid (P,) -> pillar
        table: the sorted stream for K1, or with a second stage the dense
        per-voxel means (whose xyz columns are the centroids)."""
        return pillars.build_pillar_table(
            points, points_valid, self.grid_zyx, self.voxel_size,
            self.pc_range, self.pillar_capacities[0],
            feats_mode="dense" if self.second_stage else "stream")

    def vfe(self, stream):
        """Kernel K1: stream -> (ny, nz*F, B) per-voxel means."""
        return stream_rowpad_feats(
            stream["payload"], stream["lane"], stream["z"], stream["wstart"],
            nz=self.grid_zyx[0], ny=self.grid_zyx[1],
            row_budget=self.row_budget, out_dtype=self.dtype)

    def build_plan(self, table):
        plan = build_pillar_plan(table, self.grid_zyx, self.pillar_capacities,
                                 site_mode=self.site_mode,
                                 with_centroids=self.second_stage)
        self._stage("row-pad maps")
        return augment_plan_rowpad(plan, self.grid_zyx, self.row_budget)

    def prepare(self, points, points_valid):
        """points (N, P, F), points_valid (N, P) -> (rp_feats, plan): each
        sample's table, row-padded features (one K1 launch, or with a
        second stage the dense table gathered) and plan, stacked along the
        BEV-row axis into one (N*ny, nz*F, B) table and one plan."""
        feats, plans = [], []
        for i, (p, v) in enumerate(zip(points, points_valid)):
            with profiling.span("prepare", "index", i):
                self._stage("table")
                table = self.build_table(p, v)
                self._stage("plan")
                plan = self.build_plan(table)
                self._stage("gather" if self.second_stage else "vfe")
                if self.second_stage:
                    dense = table["feats"]
                    feats.append(pillars.rowpad_gather(
                        dense.reshape(dense.shape[0], -1).to(self.dtype),
                        plan[0]["rp_gidx"], plan[0]["rp_gvalid"]))
                else:
                    feats.append(self.vfe(table["stream"]))
            plans.append(plan)
        self._stage("stack")
        return torch.cat(feats), stack_plans(plans)

    def bev_head(self, spatial_features):
        """([N,] H, W, C) BEV maps -> per-head prediction dicts."""
        return self.center_head(self.backbone2d(
            spatial_features.to(self.dtype)))

    def network(self, rp_feats, plan):
        """`prepare`'s output -> (per-head dicts of (N, H, W, C) maps, the
        second stage's dict of (N, R, ...) tensors or None)."""
        self._stage("backbone3d")
        out3d = self.backbone3d(rp_feats, plan)
        self._stage("bev+head")
        if not self.second_stage:
            return self.bev_head(out3d["spatial_features"]), None
        bev = self.backbone2d(out3d["spatial_features"].to(self.dtype))
        preds = self.center_head(bev)
        self._stage("proposals")
        prop = self.proposals(preds)
        self._stage("RoI head")
        return preds, self.refine(prop, bev, out3d["multi_scale_3d_features"])

    def proposals(self, preds):
        """The second stage's proposals of a batch: decode + NMS of the
        detached head outputs per sample (one K3 and one walk launch each),
        ROI_BUDGET boxes.  Returns boxes (N, R, 9), scores, labels, mask."""
        r = self.roi_budget
        decs = [self.decode([{k: v[b].detach() for k, v in h.items()}
                             for h in preds], top_k=r, score_thresh=0.0,
                            nms_pre=4 * r, nms_post=r)
                for b in range(preds[0]["hm"].shape[0])]
        return {k: torch.stack([d[k] for d in decs]) for k in decs[0]}

    def refine(self, proposals, bev, multi_scale):
        """The RoI head on a batch's proposals: BEV keypoint features of
        each RoI from the 2D backbone's map, grid pooling over the
        multi-scale tables, all detached.  Returns rois (N, R, 7),
        roi_mask, roi_scores, roi_labels (N, R), cls_logit (N, R) and
        reg_deltas (N, R, 7)."""
        n, r = proposals["mask"].shape
        rois = proposals["boxes"][..., :7]
        with profiling.span("bev keypoints"):
            kps = box_keypoints_bev(rois.reshape(n * r, 7)).reshape(
                n, r * 5, 2)
            bev = bev.detach()
            extra = torch.stack([bilinear_sample_bev(
                bev[b], kps[b], self.voxel_size, self.pc_range,
                self.feature_map_stride) for b in range(n)])
        grids = plan_grids(self.grid_zyx)
        levels = [dict(multi_scale[name],
                       features=multi_scale[name]["features"].detach(),
                       stride=stride, grid_zyx=grids[lvl])
                  for name, lvl, stride in _ROI_LEVELS]
        cls, reg = self.roi_head(rois, proposals["mask"], levels,
                                 extra.reshape(n, r, -1).to(self.dtype))
        return {"rois": rois, "roi_mask": proposals["mask"],
                "roi_scores": proposals["scores"],
                "roi_labels": proposals["labels"],
                "cls_logit": cls, "reg_deltas": reg}

    def decode(self, preds, **decode_kwargs):
        return decode_predictions(
            preds, self.class_ids_each_head, self.bev_hw,
            self.feature_map_stride, self.voxel_size, self.pc_range,
            **decode_kwargs)

    @contextlib.contextmanager
    def _mode(self, train: bool):
        was = self.training
        self.train(train)
        try:
            yield
        finally:
            self.train(was)

    @torch.no_grad()
    def forward_one(self, points, points_valid):
        """One sample's raw head outputs in eval mode (list of dicts of
        (H, W, C))."""
        with self._mode(False):
            preds, _ = self.network(*self.prepare(points[None],
                                                  points_valid[None]))
        return [{k: v[0] for k, v in h.items()} for h in preds]

    @torch.no_grad()
    def predict(self, points, points_valid, **decode_kwargs):
        """points (B, P, F), points_valid (B, P) -> dict of batched padded
        detections: boxes (B, K, 9), scores, labels, mask (B, K); with a
        second stage the refined boxes (B, R, 7) of the proposals, scored
        sqrt(sigmoid(cls) * proposal score) (decode_kwargs unused, as in
        the reference)."""
        outs = []
        with profiling.span("predict"), self._mode(False):
            for i, (p, v) in enumerate(zip(points, points_valid)):
                with profiling.span("sample", "index", i):
                    preds, roi = self.network(*self.prepare(p[None],
                                                            v[None]))
                    self._stage("decode+nms" if roi is None
                                else "refined boxes")
                    if roi is None:
                        outs.append(self.decode(
                            [{k: x[0] for k, x in h.items()} for h in preds],
                            **decode_kwargs))
                        continue
                    boxes, scores = pdv_predict(
                        roi["cls_logit"][0], roi["reg_deltas"][0],
                        roi["rois"][0], roi["roi_scores"][0])
                    outs.append({"boxes": boxes, "scores": scores,
                                 "labels": roi["roi_labels"][0],
                                 "mask": roi["roi_mask"][0]})
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def targets(self, gt_boxes, gt_classes, gt_valid):
        """Per-head targets of a batch (gt_boxes (N, M, 7|9), gt_classes
        (N, M) global ids, gt_valid (N, M))."""
        return assign_targets(
            gt_boxes, gt_classes, gt_valid, self.class_ids_each_head,
            self.bev_hw, self.feature_map_stride, self.voxel_size,
            self.pc_range, self.max_objs, with_velocity=self.with_velocity)

    def head_loss(self, preds, targets):
        """-> (per-sample loss (N,), aux dict of (N,))."""
        return center_head_loss(preds, targets, self.bev_hw,
                                self.feature_map_stride, self.voxel_size,
                                self.pc_range)

    def roi_per_image(self) -> int:
        return int(self.roi_sampler.get("ROI_PER_IMAGE", self.roi_budget))

    def roi_draws(self, n, generator=None):
        """The random numbers `subsample_rois` takes for n samples: uniforms
        (n, 3, ROI_BUDGET) in [0, 1) and integers (n, ROI_PER_IMAGE) in
        [0, 2^30), from `generator` (torch's default one when None), on the
        model's device."""
        dev = next(self.parameters()).device
        gdev = generator.device if generator is not None else dev
        u = torch.rand((n, 3, self.roi_budget), generator=generator,
                       device=gdev)
        d = torch.randint(0, 1 << 30, (n, self.roi_per_image()),
                          generator=generator, device=gdev)
        return u.to(dev), d.to(dev)

    def roi_loss(self, roi, gt_boxes, gt_valid, draws):
        """The RoI loss of a batch: per sample the RoI targets (one K7
        launch), the fg/bg subsample with `draws` (`roi_draws`' pair) and
        `pdv_loss`.  Returns (per-sample loss (N,), aux dict of (N,))."""
        uniforms, ints = draws
        losses, auxes = [], []
        for b in range(roi["rois"].shape[0]):
            rois, mask = roi["rois"][b], roi["roi_mask"][b]
            tgt = assign_roi_targets(rois, mask, gt_boxes[b][:, :7],
                                     gt_valid[b])
            idx, valid = subsample_rois(
                tgt["roi_iou"], mask, uniforms[b], ints[b],
                roi_per_image=self.roi_per_image(),
                fg_ratio=float(self.roi_sampler.get("FG_RATIO", 0.5)),
                hard_bg_ratio=float(self.roi_sampler.get("HARD_BG_RATIO",
                                                         0.8)))
            idx = idx.long()
            sub = {k: t[idx] for k, t in tgt.items()}
            keep = valid & mask[idx]
            sub["fg_mask"] = sub["fg_mask"] & keep
            loss, aux = pdv_loss(roi["cls_logit"][b][idx],
                                 roi["reg_deltas"][b][idx], sub, rois[idx],
                                 keep)
            losses.append(loss)
            auxes.append(aux)
        return torch.stack(losses), {k: torch.stack([a[k] for a in auxes])
                                     for k in auxes[0]}

    def loss(self, points, points_valid, gt_boxes, gt_classes, gt_valid,
             generator=None, roi_draws=None):
        """Training loss of a batch in train mode: (mean over samples of the
        per-sample loss, aux dict of per-sample terms).  Updates the BN
        running statistics.  With a second stage the mean RoI loss is
        added; its subsample uses `roi_draws` when given, else draws from
        `generator` (`roi_draws()`)."""
        with self._mode(True):
            preds, roi = self.network(*self.prepare(points, points_valid))
            self._stage("targets+loss")
            per_sample, aux = self.head_loss(
                preds, self.targets(gt_boxes, gt_classes, gt_valid))
            total = per_sample.mean()
            if roi is not None:
                if roi_draws is None:
                    roi_draws = self.roi_draws(points.shape[0], generator)
                self._stage("RoI targets+loss")
                roi_loss, roi_aux = self.roi_loss(roi, gt_boxes, gt_valid,
                                                  roi_draws)
                total = total + roi_loss.mean()
                aux.update(roi_aux)
        return total, aux
