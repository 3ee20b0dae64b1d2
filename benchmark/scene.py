"""Waymo-like LiDAR frames from a seed, on the device, in plain PyTorch.

One general generator; a traffic mix (`traffic/<mix>.json`) gives its
parameters.  A frame is a street seen by a spinning multi-beam LiDAR:

* `beams` rows from `beam_top_deg` down to `beam_bottom_deg`,
  `azimuth_steps` rays a revolution, returns up to `max_range_m`, the
  sensor `sensor_height_m` above a flat ground (z = 0);
* a wall along each side of the road (x axis) at a distance drawn from
  `wall_distance_m`, poles along the walls, and vehicles, pedestrians and
  cyclists at their class sizes jittered by `size_jitter`;
* `sweeps` sweeps `sweep_dt_s` apart while the ego drives along +x at a
  speed from `ego_speed_mps` and the objects move at their own velocities;
  every sweep is cast in the current frame from where the sensor was then
  (so earlier sweeps are already moved into it), its points shuffled;
* the columns x, y, z, intensity, elongation, time offset (0 for the
  current sweep, -dt * k for the k-th one before), the sweeps concatenated
  current first and cut to the point budget, as the loader cuts them.

GT is the current frame's objects with at least `min_points` points inside
their box, as (max_objs, 9) [x, y, z, dx, dy, dz, heading, vx, vy] with
classes 0 (Vehicle), 1 (Pedestrian), 2 (Cyclist).

Every seed makes the same set of sizes: a pool of `pool_frames` frames whose
object counts and ego speeds are spread evenly over their ranges, assigned
to the frames in an order drawn from the seed; positions, sizes, headings,
speeds, walls and the noise come from the seed.
"""

from __future__ import annotations

import math

import torch

CLASSES = ("Vehicle", "Pedestrian", "Cyclist")


def _u(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def _spread(lo, hi, n, k):
    """k of n evenly spread integers over [lo, hi]."""
    return round(lo + (hi - lo) * (k + 0.5) / n - 0.5) if hi > lo else lo


def _place(mix, gen, counts, device):
    """The scene's boxes: dict of (n, 7) boxes, (n, 2) velocities, (n,)
    classes for the objects; walls and poles as static boxes."""
    walls = _u(gen, 2, *mix["wall_distance_m"], device)
    wall_h = _u(gen, 2, *mix["wall_height_m"], device)
    boxes, vels, cls = [], [], []
    for c, name in enumerate(CLASSES):
        spec = mix["objects"][name]
        n = counts[c]
        if n == 0:
            continue
        size = torch.tensor(spec["size_m"], device=device)
        jit = _u(gen, (n, 3), 1 - mix["size_jitter"], 1 + mix["size_jitter"],
                 device)
        dims = size * jit
        x = _u(gen, n, -mix["object_extent_m"], mix["object_extent_m"],
               device)
        side = torch.rand(n, generator=gen, device=device) < 0.5
        if spec["where"] == "sidewalk":
            off = _u(gen, n, 0.6, 3.0, device)
            y = torch.where(side, walls[0] - off, -walls[1] + off)
            heading = _u(gen, n, -math.pi, math.pi, device)
        else:
            frac = torch.rand(n, generator=gen, device=device)
            y = -walls[1] + 2.0 + frac * (walls[0] + walls[1] - 4.0)
            heading = torch.where(side, 0.0, math.pi) + 0.1 * torch.randn(
                n, generator=gen, device=device)
        # keep the ego's lane clear around the sensor's path
        ego = (x.abs() < 8.0) & (y.abs() < 2.5)
        x = torch.where(ego, x + torch.where(x >= 0, 16.0, -16.0), x)
        speed = _u(gen, n, *spec["speed_mps"], device)
        vel = torch.stack([speed * torch.cos(heading),
                           speed * torch.sin(heading)], 1)
        z = dims[:, 2] / 2
        boxes.append(torch.cat([torch.stack([x, y, z], 1), dims,
                                heading[:, None]], 1))
        vels.append(vel)
        cls.append(torch.full((n,), c, device=device))
    n_poles = counts[3]
    pole_x = _u(gen, n_poles, -mix["object_extent_m"],
                mix["object_extent_m"], device)
    pole_side = torch.rand(n_poles, generator=gen, device=device) < 0.5
    pole_y = torch.where(pole_side, walls[0] - 0.5, -walls[1] + 0.5)
    pole_h = _u(gen, n_poles, 4.0, 8.0, device)
    ones = torch.ones(n_poles, device=device)
    poles = torch.stack([pole_x, pole_y, pole_h / 2, 0.3 * ones, 0.3 * ones,
                         pole_h, 0.0 * ones], 1)
    length = 2 * mix["max_range_m"] + 20.0
    wall = torch.stack([
        torch.tensor([0.0, float(walls[0] + 0.25), float(wall_h[0] / 2),
                      length, 0.5, float(wall_h[0]), 0.0], device=device),
        torch.tensor([0.0, float(-walls[1] - 0.25), float(wall_h[1] / 2),
                      length, 0.5, float(wall_h[1]), 0.0], device=device)])
    return {"boxes": torch.cat(boxes), "vels": torch.cat(vels),
            "cls": torch.cat(cls), "static": torch.cat([wall, poles])}


def _ray_box(origin, dirs, boxes):
    """Distances (R, B) along rays (R, 3) from origin (3,) to oriented boxes
    (B, 7), inf where a ray misses."""
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    rel = origin[None, :] - boxes[:, :3]                     # (B, 3)
    ox = rel[:, 0] * c + rel[:, 1] * s
    oy = -rel[:, 0] * s + rel[:, 1] * c
    oz = rel[:, 2]
    dx = dirs[:, None, 0] * c + dirs[:, None, 1] * s         # (R, B)
    dy = -dirs[:, None, 0] * s + dirs[:, None, 1] * c
    dz = dirs[:, None, 2].expand_as(dx)
    t_near = torch.full_like(dx, -math.inf)
    t_far = torch.full_like(dx, math.inf)
    for o, d, half in ((ox, dx, boxes[:, 3] / 2), (oy, dy, boxes[:, 4] / 2),
                       (oz, dz, boxes[:, 5] / 2)):
        inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        t1 = (-half - o) * inv
        t2 = (half - o) * inv
        t_near = torch.maximum(t_near, torch.minimum(t1, t2))
        t_far = torch.minimum(t_far, torch.maximum(t1, t2))
    hit = (t_near <= t_far) & (t_near > 0)
    return torch.where(hit, t_near, torch.full_like(t_near, math.inf))


def _sweep(mix, gen, scene, k, ego_speed, device):
    """One sweep's points (n, 6) in the current frame."""
    dt = -mix["sweep_dt_s"] * k
    origin = torch.tensor([ego_speed * dt, 0.0, mix["sensor_height_m"]],
                          device=device)
    nb, na = mix["beams"], mix["azimuth_steps"]
    elev = torch.linspace(math.radians(mix["beam_top_deg"]),
                          math.radians(mix["beam_bottom_deg"]), nb,
                          device=device)
    phase = float(torch.rand(1, generator=gen, device=device)) * 2 * math.pi
    az = phase + torch.arange(na, device=device) * (2 * math.pi / na)
    e, a = torch.meshgrid(elev, az, indexing="ij")
    dirs = torch.stack([torch.cos(e) * torch.cos(a),
                        torch.cos(e) * torch.sin(a), torch.sin(e)],
                       -1).reshape(-1, 3)
    t = torch.where(dirs[:, 2] < 0, -origin[2] / torch.where(
        dirs[:, 2] < 0, dirs[:, 2], -torch.ones_like(dirs[:, 2])),
        torch.full_like(dirs[:, 2], math.inf))
    moved = scene["boxes"].clone()
    moved[:, :2] += scene["vels"] * dt
    boxes = torch.cat([moved, scene["static"]])
    for chunk in torch.split(torch.arange(dirs.shape[0], device=device),
                             32768):
        t[chunk] = torch.minimum(t[chunk], _ray_box(
            origin, dirs[chunk], boxes).min(1).values)
    t = t + mix["range_noise_m"] * torch.randn(t.shape, generator=gen,
                                               device=device)
    keep = (t > 0) & (t <= mix["max_range_m"])
    keep &= torch.rand(t.shape, generator=gen,
                       device=device) >= mix["dropout"]
    n = int(keep.sum())
    xyz = origin[None, :] + dirs[keep] * t[keep, None]
    intensity = torch.rand(n, generator=gen, device=device) ** 2
    elongation = 0.3 * torch.rand(n, generator=gen, device=device)
    pts = torch.cat([xyz, intensity[:, None], elongation[:, None],
                     torch.full((n, 1), dt, device=device)], 1)
    return pts[torch.randperm(n, generator=gen, device=device)]


def _points_in_boxes(points, boxes):
    """(n_boxes,) count of points inside each (B, 7) box."""
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    counts = torch.zeros(boxes.shape[0], dtype=torch.int64,
                         device=points.device)
    for chunk in torch.split(points[:, :3], 65536):
        rel = chunk[:, None, :] - boxes[None, :, :3]
        lx = rel[..., 0] * c + rel[..., 1] * s
        ly = -rel[..., 0] * s + rel[..., 1] * c
        inside = ((lx.abs() <= boxes[:, 3] / 2) & (ly.abs() <= boxes[:, 4] / 2)
                  & (rel[..., 2].abs() <= boxes[:, 5] / 2))
        counts += inside.sum(0)
    return counts


def frame(mix, gen, counts, ego_speed, budget, max_objs, device):
    """One frame: points (budget, 6), valid (budget,), gt boxes (max_objs,
    9), gt classes (max_objs,) int32, gt valid (max_objs,)."""
    scene = _place(mix, gen, counts, device)
    pts = torch.cat([_sweep(mix, gen, scene, k, ego_speed, device)
                     for k in range(mix["sweeps"])])[:budget]
    n = pts.shape[0]
    points = torch.zeros(budget, 6, device=device)
    points[:n] = pts
    valid = torch.arange(budget, device=device) < n
    inside = _points_in_boxes(pts, scene["boxes"])
    keep = torch.nonzero(inside >= mix["min_points"])[:, 0][:max_objs]
    m = keep.shape[0]
    gt = torch.zeros(max_objs, 9, device=device)
    gt[:m, :7] = scene["boxes"][keep]
    gt[:m, 7:] = scene["vels"][keep]
    gt_cls = torch.zeros(max_objs, dtype=torch.int32, device=device)
    gt_cls[:m] = scene["cls"][keep].int()
    gt_valid = torch.arange(max_objs, device=device) < m
    return points, valid, gt, gt_cls, gt_valid


def make_pool(mix, seed, budget, max_objs, device):
    """The mix's pool of frames from `seed`: dict of stacked tensors
    points (F, budget, 6), points_valid, gt_boxes, gt_classes, gt_valid."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    nf = mix["pool_frames"]
    order = torch.randperm(nf, generator=gen, device=device).tolist()
    keys = ("points", "points_valid", "gt_boxes", "gt_classes", "gt_valid")
    out = {k: [] for k in keys}
    for i in range(nf):
        k = order[i]
        counts = [_spread(*mix["objects"][c]["count"], nf, k)
                  for c in CLASSES]
        counts.append(_spread(*mix["poles"], nf, k))
        speed = mix["ego_speed_mps"][0] + (
            mix["ego_speed_mps"][1] - mix["ego_speed_mps"][0]) * (k + 0.5) / nf
        for key, t in zip(keys, frame(mix, gen, counts, speed, budget,
                                      max_objs, device)):
            out[key].append(t)
    return {k: torch.stack(v) for k, v in out.items()}
