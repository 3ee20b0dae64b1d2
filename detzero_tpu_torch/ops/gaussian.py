"""CenterNet gaussian-heatmap targets (port of `detzero_tpu/ops/gaussian.py`):
every GT's gaussian is drawn into a (num_gt, C, H, W) stack and the heatmap
is its max over the GTs, one vectorised pass with no host loop.  At the
flagship size (500 GT slots, 2 classes, 188 x 188) the stack is 141 MB of
float32, which the card holds easily."""

from __future__ import annotations

import torch


def gaussian_radius(det_size_hw, min_overlap: float = 0.5):
    """CornerNet radius rule.  det_size_hw: (..., 2) box extent in feature
    cells (height, width)."""
    height, width = det_size_hw[..., 0], det_size_hw[..., 1]

    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * 1.0 * c1, min=0.0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 4 * 4.0 * c2, min=0.0))) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_gaussians(centers, radii, class_ids, valid, num_classes: int, hw):
    """All GT gaussians -> (num_classes, H, W) heatmap.  centers (M, 2)
    feature-map (x, y); radii (M,) integer radii; class_ids (M,) in
    [0, num_classes); valid (M,) bool."""
    h, w = hw
    dev = centers.device
    icx = torch.floor(centers[:, 0]).to(torch.int32)[:, None, None]
    icy = torch.floor(centers[:, 1]).to(torch.int32)[:, None, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
    dx = (xs - icx).float()
    dy = (ys - icy).float()
    r = radii[:, None, None].float()
    sigma = (2 * r + 1) / 6.0
    g = torch.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
    window = ((xs - icx).abs() <= r) & ((ys - icy).abs() <= r)
    g = torch.where(window & valid[:, None, None]
                    & (g >= torch.finfo(torch.float32).eps), g, 0.0)
    cls = torch.where(valid, class_ids, 0).long()
    onehot = torch.eye(num_classes, dtype=torch.bool, device=dev)[cls]
    contrib = torch.where(onehot[:, :, None, None], g[:, None], 0.0)
    return contrib.amax(0)


def assign_center_targets(gt_boxes, gt_classes, gt_valid, num_classes: int,
                          hw, feature_map_stride: int, voxel_size, pc_range,
                          max_objs: int, min_radius: int = 2,
                          gaussian_overlap: float = 0.1,
                          with_velocity: bool = True):
    """One head's targets of one sample.  gt_boxes (M, 7[+2 vel]) in the
    lidar frame; gt_classes (M,) the class index inside this head; gt_valid
    (M,).  Returns dict(heatmap (C, H, W), anno_box (max_objs, 8[+2]) as
    [dx_off, dy_off, z, log dx, log dy, log dz, sin, cos, vx, vy],
    inds (max_objs,) int32, mask (max_objs,))."""
    h, w = hw
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    x0, y0 = float(pc_range[0]), float(pc_range[1])
    coord_x = torch.clamp((gt_boxes[:, 0] - x0) / vx / feature_map_stride,
                          0.0, w - 1.001)
    coord_y = torch.clamp((gt_boxes[:, 1] - y0) / vy / feature_map_stride,
                          0.0, h - 1.001)
    centers = torch.stack([coord_x, coord_y], 1)
    cx_int = coord_x.to(torch.int32)
    cy_int = coord_y.to(torch.int32)

    dx_f = gt_boxes[:, 3] / vx / feature_map_stride
    dy_f = gt_boxes[:, 4] / vy / feature_map_stride
    ok = gt_valid & (dx_f > 0) & (dy_f > 0)
    radius = gaussian_radius(torch.stack([dy_f, dx_f], -1), gaussian_overlap)
    radius = torch.clamp(radius.to(torch.int32), min=min_radius)

    heatmap = draw_gaussians(centers, radius, gt_classes, ok, num_classes, hw)

    inds = torch.where(ok, cy_int * w + cx_int, 0)
    code = [coord_x - cx_int.float(), coord_y - cy_int.float(),
            gt_boxes[:, 2],
            torch.log(torch.clamp(gt_boxes[:, 3], min=1e-6)),
            torch.log(torch.clamp(gt_boxes[:, 4], min=1e-6)),
            torch.log(torch.clamp(gt_boxes[:, 5], min=1e-6)),
            torch.sin(gt_boxes[:, 6]), torch.cos(gt_boxes[:, 6])]
    if with_velocity and gt_boxes.shape[1] >= 9:
        code += [gt_boxes[:, 7], gt_boxes[:, 8]]
    anno = torch.where(ok[:, None], torch.stack(code, 1), 0.0)

    def pad_to(x, n):
        if x.shape[0] >= n:
            return x[:n]
        return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])

    return {"heatmap": heatmap, "anno_box": pad_to(anno, max_objs),
            "inds": pad_to(inds, max_objs).to(torch.int32),
            "mask": pad_to(ok, max_objs)}
