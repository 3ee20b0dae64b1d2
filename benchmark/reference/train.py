"""The detector's training step in plain PyTorch, float32: CenterNet
targets, the focal + L1 + IoU-branch loss, autograd, the global-norm clip
and Adam with decoupled weight decay on the one-cycle cosine schedule
(the `adam_onecycle` of the configuration)."""

from __future__ import annotations

import math

import torch

from benchmark.reference import boxes as box_ops
from benchmark.reference import network

REG_ORDER = ("center", "center_z", "dim", "rot", "vel")


def gaussian_radius(h, w, min_overlap):
    """CornerNet's radius rule for a box of h x w feature cells."""
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def head_targets(gt_boxes, local_cls, ok, n_cls, cfg):
    """One head's targets of one frame: heatmap (C, H, W), anno (M, 10)
    [dx, dy, z, log dims, sin, cos, vx, vy], inds (M,), mask (M,)."""
    h, w = cfg["bev_hw"]
    stride = cfg["feature_map_stride"]
    vx, vy = cfg["voxel_size"][:2]
    x0, y0 = cfg["pc_range"][:2]
    gx = torch.clamp((gt_boxes[:, 0] - x0) / vx / stride, 0.0, w - 1.001)
    gy = torch.clamp((gt_boxes[:, 1] - y0) / vy / stride, 0.0, h - 1.001)
    ix, iy = gx.long(), gy.long()
    fw = gt_boxes[:, 3] / vx / stride
    fh = gt_boxes[:, 4] / vy / stride
    ok = ok & (fw > 0) & (fh > 0)
    radius = torch.clamp(gaussian_radius(fh, fw, 0.1).long(), min=2)
    heat = torch.zeros(n_cls, h, w, device=gt_boxes.device)
    for i in torch.nonzero(ok)[:, 0].tolist():
        r = int(radius[i])
        sigma = (2 * r + 1) / 6.0
        cx, cy = int(ix[i]), int(iy[i])
        ys = torch.arange(max(cy - r, 0), min(cy + r, h - 1) + 1,
                          device=heat.device)
        xs = torch.arange(max(cx - r, 0), min(cx + r, w - 1) + 1,
                          device=heat.device)
        d2 = ((ys[:, None] - cy) ** 2 + (xs[None, :] - cx) ** 2).float()
        g = torch.exp(-d2 / (2 * sigma * sigma))
        g = torch.where(g >= torch.finfo(torch.float32).eps, g, 0.0)
        c = int(local_cls[i])
        win = heat[c, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
        heat[c, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = torch.maximum(win, g)
    code = torch.stack([
        gx - ix.float(), gy - iy.float(), gt_boxes[:, 2],
        torch.log(torch.clamp(gt_boxes[:, 3], min=1e-6)),
        torch.log(torch.clamp(gt_boxes[:, 4], min=1e-6)),
        torch.log(torch.clamp(gt_boxes[:, 5], min=1e-6)),
        torch.sin(gt_boxes[:, 6]), torch.cos(gt_boxes[:, 6]),
        gt_boxes[:, 7], gt_boxes[:, 8]], 1)
    anno = torch.where(ok[:, None], code, 0.0)
    inds = torch.where(ok, iy * w + ix, 0)
    return heat, anno, inds, ok


def focal(pred, gt, eps=1e-4):
    pred = torch.clamp(pred, eps, 1.0 - eps)
    pos = (gt >= 1.0).float()
    pos_loss = (torch.log(pred) * (1 - pred) ** 2 * pos).sum()
    neg_loss = (torch.log(1 - pred) * pred ** 2 * (1 - gt) ** 4
                * (1 - pos)).sum()
    n_pos = pos.sum()
    if n_pos > 0:
        return -(pos_loss + neg_loss) / n_pos
    return -neg_loss


def frame_loss(maps, gt_boxes, gt_classes, gt_valid, cfg):
    """The loss of one frame: per head focal(hm) + 2 * L1(regression at the
    GT cells) + L1(iou prediction against the 3D IoU, mapped to [-1, 1], of
    the box decoded there and its GT box)."""
    h, w = cfg["bev_hw"]
    stride = cfg["feature_map_stride"]
    vx, vy = cfg["voxel_size"][:2]
    x0, y0 = cfg["pc_range"][:2]
    total = 0.0
    for hm_maps, cls_ids in zip(maps, cfg["class_ids_each_head"]):
        ids = torch.tensor(cls_ids, device=gt_classes.device)
        hit = gt_classes[:, None] == ids
        local = hit.int().argmax(-1)
        heat, anno, inds, ok = head_targets(gt_boxes, local,
                                            gt_valid & hit.any(-1),
                                            len(cls_ids), cfg)
        loss = focal(torch.sigmoid(hm_maps["hm"]).permute(2, 0, 1), heat)
        reg = torch.cat([hm_maps[n] for n in REG_ORDER if n in hm_maps], -1)
        nc = reg.shape[-1]
        pred = reg.reshape(h * w, nc)[inds]
        m = ok.float()
        n = torch.clamp(m.sum(), min=1.0)
        loss = loss + 2.0 * ((pred - anno[:, :nc]).abs() * m[:, None]).sum() \
            / n
        if "iou" in hm_maps:
            with torch.no_grad():
                det = {k: v.detach() for k, v in hm_maps.items()}
                pb = box_ops.decode_at(det, inds, cfg)[:, :7]
                gxc = (inds % w).float()
                gyc = torch.div(inds, w, rounding_mode="floor").float()
                gb = torch.stack([
                    (gxc + anno[:, 0]) * stride * vx + x0,
                    (gyc + anno[:, 1]) * stride * vy + y0, anno[:, 2],
                    torch.exp(anno[:, 3]), torch.exp(anno[:, 4]),
                    torch.exp(anno[:, 5]),
                    torch.atan2(anno[:, 6], anno[:, 7])], -1)
                tgt = box_ops.iou3d_pairs(pb, gb).float() * 2.0 - 1.0
            ip = hm_maps["iou"].reshape(h * w)[inds]
            loss = loss + ((ip - tgt).abs() * m).sum() / n
        total = total + loss
    return total


def batch_loss(sd, batch, cfg, prec=network.F32):
    """Mean over the batch's frames of the frame loss, train mode."""
    maps, _ = network.forward(sd, batch["points"], batch["points_valid"],
                              cfg, train=True, prec=prec)
    losses = [frame_loss([{k: v[b] for k, v in m.items()} for m in maps],
                         batch["gt_boxes"][b], batch["gt_classes"][b],
                         batch["gt_valid"][b], cfg)
              for b in range(batch["points"].shape[0])]
    return torch.stack(losses).mean()


def decays(name):
    """Whether Adam's decoupled weight decay applies to a parameter: not to
    biases and batch-norm or layer-norm parameters."""
    leaf = name.rsplit(".", 1)[-1]
    return not (leaf in ("bias", "scale", "mean", "var")
                or "BatchNorm" in name or "LayerNorm" in name
                or "bn" in leaf)


def onecycle_lr(opt, total_steps, count):
    """The one-cycle cosine schedule: LR / DIV_FACTOR up to LR over the
    first PCT_START of the steps, then down to LR / (DIV_FACTOR^2 * 1e3)."""
    lr, div = opt["LR"], opt["DIV_FACTOR"]
    bounds = [0, int(opt["PCT_START"] * total_steps), int(total_steps)]
    values = [lr / div, lr, lr / (div * div * 1e3)]
    for i in range(2):
        if bounds[i] <= count < bounds[i + 1]:
            pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            start, end = values[i], values[i + 1]
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
    return values[-1]


class Adam:
    """Clip by global norm, then Adam (b1 0.9, b2 0.99, eps 1e-8) with
    decoupled weight decay, scaled by the schedule."""

    def __init__(self, params, opt, total_steps):
        self.params = params                   # {name: leaf tensor}
        self.opt, self.total = opt, total_steps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.first_grads = None

    @torch.no_grad()
    def step(self, grads):
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = self.opt["GRAD_NORM_CLIP"]
        if float(norm) >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        if self.first_grads is None:
            self.first_grads = grads
        lr = onecycle_lr(self.opt, self.total, self.count)
        self.count += 1
        b1, b2, eps = 0.9, 0.99, 1e-8
        wd = self.opt["WEIGHT_DECAY"]
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
            upd = (self.mu[k] / (1 - b1 ** self.count)) / (
                torch.sqrt(self.nu[k] / (1 - b2 ** self.count)) + eps)
            if decays(k):
                upd = upd + wd * p
            p.add_(upd, alpha=-lr)
        return norm


def train_steps(sd, batches, cfg, opt, total_steps, prec=network.F32):
    """Runs len(batches) steps from the state dict `sd` (not changed).
    Returns (losses [float], first clipped gradients {name: tensor},
    parameters after the steps {name: tensor}, the first step's batch-norm
    statistics {prefix: (mean, var)})."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in sd.items() if is_param(k)}
    buffers = {k: v for k, v in sd.items() if not is_param(k)}
    adam = Adam(params, opt, total_steps)
    losses, stats = [], {}
    for i, batch in enumerate(batches):
        weights = {**buffers, **params}
        if i == 0:
            weights["_stats"] = stats
        loss = batch_loss(weights, batch, cfg, prec)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p))
                 for (k, p), g in zip(params.items(), grads)}
        adam.step(grads)
        losses.append(float(loss.detach()))
    return losses, adam.first_grads, {k: v.detach() for k, v in
                                      params.items()}, stats


def is_param(name):
    """Running batch-norm statistics are buffers; the rest are
    parameters."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf not in ("mean", "var")
