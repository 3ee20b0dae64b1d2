"""The two-stage CenterPoint with the PDV RoI head in plain PyTorch, float32.

The first stage is `network.py`'s, step for step: the sparse 3D backbone is
rebuilt here from its functions so that the level-2 and level-3 features
(PDV's `x_conv3`, `x_conv4`) are kept; the 2D backbone and the center head
are `network.py`'s own.  The second stage follows the JAX package's
`PDVHead` and `CenterPoint` (the semantics the port implements), on the
voxel lists of `geometry.py`:

* proposals: the center head's decode (`boxes.decode`, with its IoU
  rectification) at top 128 a head, score threshold 0, NMS pre 512, post
  128, IoU 0.7 (`ROI_BUDGET` R: top R, pre 4R, post R);
* a G^3 grid of points in each RoI, cell centres of its box;
* on each pooled level (stride 4 with 64 channels, stride 8 with 128), each
  grid point's voxel (clamped into the grid) and its 27 neighbours probed
  nearest first (L1 norm, ties in (dz, dy, dx) order) in the level's
  occupied voxels, found by key lookup; the first 16 found are kept.  The
  occupied voxels are those of every pillar the level's capacity keeps;
  the row budget zeroes the features of a pillar past it (its voxels are
  found, with zero features and their centroid);
* each level's voxel centroid: level 0's is the mean of its points, a
  level's the mean of its occupied child voxels' centroids (each child adds
  its centroid once to its principal parent, z // 2 in the parent pillar);
* per neighbour [feature, centroid - grid point] through Dense (no bias) +
  batch norm + ReLU to 32 and 32 channels, the max over the found
  neighbours (0 where none), and log1p of the found count over both
  levels;
* with attention: the grid tokens (65 wide) plus a Dense(1 -> 65) of the
  log-density as queries and keys, the tokens as values, 4 heads of 17
  (65 rounded up to 68 projections), the query scaled by 1/sqrt(17); the
  output added to the tokens, then LayerNorm (eps 1e-6, one-pass
  variance);
* BEV keypoints: the 2D backbone's 512-channel map sampled bilinearly at
  each RoI's centre and its 4 side midpoints;
* the flattened grid and the keypoints through Dense + batch norm + ReLU
  to 256 and 256, a 1-wide IoU logit and 7 residuals;
* refined boxes: the residuals decoded against the RoI (ResidualCoder),
  scored sqrt(sigmoid(logit) * proposal score), clipped to [1e-8, 1].

Departures from the published PDV (Hu, Kuai and Waslander, CVPR 2022),
all the JAX package's: the log1p neighbour count in place of the kernel
density estimate of the points; a fixed 128 proposals a frame (no score
cut); the voxel query on the two coarsest levels only, through the
occupied voxels (no point-level query); one self-attention layer over the
grid tokens with the density as a learned positional term; five BEV
keypoint features appended; a class-agnostic IoU logit.

Batch norm uses the running statistics in eval mode; in train mode the
batch's (one-pass variance), over the found neighbours of the batch in
the pooling MLPs and over the valid RoIs in the shared layers, recorded
into `sd["_stats"]` where given.  With `prec=FP8` every matrix product's
inputs are rounded as `network.FP8` rounds them: the control.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import boxes, geometry, network

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32, FP8 = network.F32, network.FP8
ROI_LEVELS = ((2, 4), (3, 8))          # (level, stride): x_conv3, x_conv4
NSAMPLE = 16
LN_EPS = 1e-6
KEYPOINTS = 5                          # a RoI's BEV keypoints


def proposal_pp(cfg):
    """The decode settings of the proposals (`CenterPoint.proposals`)."""
    r = cfg["roi_budget"]
    return {"TOP_K": r, "SCORE_THRESH": 0.0, "NMS_THRESH": 0.7,
            "NMS_PRE_MAXSIZE": 4 * r, "NMS_POST_MAXSIZE": r}


def propose(maps, cfg, quant=None):
    """One frame's maps [{name: (H, W, ch)}] -> its proposals: boxes
    (R, 9), scores, labels, mask (R,)."""
    return boxes.decode(maps, dict(cfg, post_processing=proposal_pp(cfg)),
                        quant=quant)


# ---------------------------------------------------------------- stage 1
def backbone3d(sd, frames, cfg, train, prec):
    """`network.backbone3d`, also returning each frame's features at the
    conv sites of levels 2 and 3: (BEV maps, {level: [(n_sites, C)]})."""
    p = "backbone3d."
    levels = [f[0] for f in frames]

    def idx_of(lvl_out, lvl_in, mode):
        return network._cat_idx(
            [geometry.neighbours(lv[lvl_out], lv[lvl_in], mode)
             for lv in levels],
            [lv[lvl_in].n_sites for lv in levels])

    def conv_bn(x, idx, name, residual=None):
        y = network.sparse_conv(x, idx, sd[name + ".kernel"], prec)
        y = network.batch_norm(y, sd, name + ".MaskedBatchNorm_0", 1, train)
        return torch.relu(y if residual is None else y + residual)

    def per_frame(x, lvl):
        return list(torch.split(x, [lv[lvl].n_sites for lv in levels]))

    x = torch.cat([f[2] for f in frames])
    sub = idx_of(0, 0, "subm")
    x = conv_bn(x, sub, p + "SparseConvBNReLU_0")
    block, kept = 0, {}
    for lvl in range(4):
        if lvl > 0:
            x = conv_bn(x, idx_of(lvl, lvl - 1, "down"),
                        p + f"SparseConvBNReLU_{lvl}")
            sub = idx_of(lvl, lvl, "subm")
        for _ in range(2):
            name = p + f"SparseBasicBlock_{block}"
            y = conv_bn(x, sub, name + ".SparseConvBNReLU_0")
            x = conv_bn(y, sub, name + ".SparseConvBNReLU_1", residual=x)
            block += 1
        if lvl >= 2:
            kept[lvl] = per_frame(x, lvl)

    w = sd[p + "SparseConvBNReLU_4.kernel"]
    grids = geometry.level_grids(cfg["grid"])
    nz3, c3 = grids[3][0], network.CHANNELS[3]
    onz, ony, onx = grids[4]
    dense = []
    for lv, x3 in zip(levels, kept[3]):
        l3 = lv[3]
        d = x3.new_zeros(l3.cells.shape[0], nz3, c3)
        dense.append(d.index_put((l3.site_pillar, l3.site_z), x3))
    d = torch.cat(dense)
    m = torch.cat([f[1] for f in frames])
    dp = torch.nn.functional.pad(prec.q(d), (0, 0, 1, 1))
    wq = prec.q(w)
    out = 0.0
    for t in range(3):
        out = out + dp[:, t:t + 2 * (onz - 1) + 1:2] @ wq[t]
    sel = m[..., None]
    out = torch.where(sel, out, 0.0)
    name = p + "SparseConvBNReLU_4.MaskedBatchNorm_0"
    if train:
        vals = network.batch_norm(out[m], sd, name, 1, True)
        out = out.new_zeros(out.shape).index_put(torch.nonzero(
            m, as_tuple=True), torch.relu(vals))
    else:
        out = torch.where(sel, torch.relu(network.batch_norm(
            out, sd, name, 2, False)), 0.0)
    bev, off = [], 0
    for lv in levels:
        cells = lv[3].cells
        n = cells.shape[0]
        flat = out.new_zeros(ony * onx, onz * c3)
        flat = flat.index_put((cells,), out[off:off + n].reshape(n, -1))
        off += n
        bev.append(flat.reshape(ony, onx, -1))
    return torch.stack(bev), kept


# ------------------------------------------------------ the voxel tables
class Table:
    """One level's occupied voxels (every pillar the capacity keeps):
    keys (V,) ascending, centroids (V, 3), and the level (its conv sites,
    which carry features)."""

    def __init__(self, level, keys, centroids):
        self.level, self.keys, self.centroids = level, keys, centroids


def _voxel_keys(level):
    p, z = torch.nonzero(level.zmask, as_tuple=True)
    return level.cells[p] * level.grid[0] + z


def _parent_centroids(table, parent):
    """The parent level's centroids: the mean of its occupied child
    voxels' centroids, each child added once to (y // 2, x // 2, z // 2)
    where the parent pillar is kept."""
    nz, _, nx = table.level.grid
    onz, _, onx = parent.grid
    cell = torch.div(table.keys, nz, rounding_mode="floor")
    z = table.keys % nz
    pcell = (torch.div(cell, nx, rounding_mode="floor") // 2) * onx \
        + (cell % nx) // 2
    pkey = pcell * onz + torch.div(z, 2, rounding_mode="floor")
    keys = _voxel_keys(parent)
    pos = torch.searchsorted(keys, pkey).clamp(max=len(keys) - 1)
    hit = keys[pos] == pkey
    sums = torch.zeros((len(keys), 3), dtype=torch.float64,
                       device=keys.device)
    sums.index_add_(0, pos[hit], table.centroids[hit].double())
    cnt = torch.zeros(len(keys), dtype=torch.float64, device=keys.device)
    cnt.index_add_(0, pos[hit], torch.ones_like(cnt[pos[hit]]))
    return Table(parent, keys, (sums / cnt.clamp(min=1.0)[:, None]).float())


def tables(points, valid, levels, cfg):
    """One frame's Tables of levels 2 and 3 from its points and its
    `geometry.build_levels` levels."""
    grids = geometry.level_grids(cfg["grid"])
    _, _, vkeys, means = geometry.voxelize(
        points, valid, grids[0], cfg["voxel_size"], cfg["pc_range"],
        cfg["capacities"][0])
    t, out = Table(levels[0], vkeys, means[:, :3]), {}
    for lvl in range(1, 4):
        t = out[lvl] = _parent_centroids(t, levels[lvl])
    return {lvl: out[lvl] for lvl, _ in ROI_LEVELS}


def near_first_offsets(device):
    """The 27 (dz, dy, dx) offsets by L1 norm, ties in meshgrid order."""
    d = torch.arange(-1, 2, device=device)
    offs = torch.stack(torch.meshgrid(d, d, d, indexing="ij"),
                       -1).reshape(-1, 3)
    return offs[torch.argsort(offs.abs().sum(1), stable=True)]


def grid_points(rois, g):
    """(R, 7) -> (R, g^3, 3): the centres of a g^3 split of each box, x
    index slowest, in the world frame."""
    ar = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                      -1).reshape(-1, 3).float()
    local = ((idx + 0.5) / g - 0.5)[None] * rois[:, None, 3:6]
    c = torch.cos(rois[:, 6])[:, None]
    s = torch.sin(rois[:, 6])[:, None]
    x, y = local[..., 0], local[..., 1]
    return torch.stack([x * c - y * s, x * s + y * c, local[..., 2]],
                       -1) + rois[:, None, :3]


def query(table, pts, stride, cfg):
    """pts (M, 3) -> (keys (M, NSAMPLE) of the found voxels, -1 where
    none; found (M, NSAMPLE); positions in `table.keys`)."""
    nz, ny, nx = table.level.grid
    dev = pts.device
    lo = torch.tensor(cfg["pc_range"][:3], dtype=torch.float32, device=dev)
    vs = torch.tensor(cfg["voxel_size"], dtype=torch.float32, device=dev)
    xyz = torch.floor((pts - lo) / (vs * stride)).long()
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], device=dev)
    xyz = torch.minimum(xyz.clamp(min=0), hi)
    offs = near_first_offsets(dev)
    tz = xyz[:, None, 2] + offs[:, 0]
    ty = xyz[:, None, 1] + offs[:, 1]
    tx = xyz[:, None, 0] + offs[:, 2]
    inb = ((tz >= 0) & (tz < nz) & (ty >= 0) & (ty < ny) & (tx >= 0)
           & (tx < nx))
    key = (ty * nx + tx) * nz + tz
    pos = torch.searchsorted(table.keys, key).clamp(
        max=table.keys.shape[0] - 1)
    found = inb & (table.keys[pos] == key)
    # the first NSAMPLE found, nearest first
    first = torch.argsort((~found).to(torch.uint8), dim=1,
                          stable=True)[:, :NSAMPLE]
    found = found.gather(1, first)
    keys = torch.where(found, key.gather(1, first), -1)
    return keys, found, pos.gather(1, first)


# ------------------------------------------------------------- RoI head
def _dense(x, w, prec, bias=None):
    """x (..., in) @ w (out, in)^T."""
    y = prec.q(x) @ prec.q(w).T
    return y if bias is None else y + bias


def mlp(x, sd, prefix, train, prec, n=2):
    """Dense (no bias) + batch norm + ReLU, n times; train mode takes the
    statistics of every row of x."""
    for i in range(n):
        x = _dense(x, sd[f"{prefix}.dense{i}.weight"], prec)
        x = torch.relu(network.batch_norm(x, sd, f"{prefix}.bn{i}", 1,
                                          train))
    return x


def pool(sd, li, lvl, stride, frame_tables, frame_feats, pts, cfg, train,
         prec):
    """One level's pooling over the batch (the MLP's train-mode statistics
    span every frame's found neighbours): per frame the pooled features
    (M, 32), the found counts (M,) and the query's keys (M, NSAMPLE) of
    its grid points pts (M, 3)."""
    parts, rows = [], []
    for t, f, p in zip(frame_tables, frame_feats, pts):
        table, lv = t[lvl], t[lvl].level
        keys, found, pos = query(table, p, stride, cfg)
        site = torch.searchsorted(lv.keys, keys).clamp(max=lv.n_sites - 1)
        on_site = found & (lv.keys[site] == keys)
        feats = torch.where(on_site[..., None], f[lvl][site], 0.0)
        rel = table.centroids[pos] - p[:, None, :]
        rows.append(torch.cat([feats, rel], -1)[found])
        parts.append((keys, found))
    h = mlp(torch.cat(rows), sd, f"roi_head.pool_mlp{li}", train, prec)
    out = []
    for (keys, found), part in zip(parts, torch.split(
            h, [x.shape[0] for x in rows])):
        full = h.new_full((*found.shape, h.shape[-1]), float("-inf"))
        full[found] = part
        pooled = full.amax(1)
        out.append((torch.where(torch.isfinite(pooled), pooled, 0.0),
                    found.sum(1), keys))
    return out


def attention(x, q_in, sd, prec):
    """Self-attention of the grid tokens x (B, L, C), queries and keys
    from q_in: LayerNorm(x + attention)."""
    p = "roi_head.grid_attn."

    def proj(t, name):
        return torch.einsum("blc,chd->blhd", prec.q(t),
                            prec.q(sd[p + name + ".kernel"])) \
            + sd[p + name + ".bias"]

    q = proj(q_in, "query") / math.sqrt(sd[p + "query.kernel"].shape[2])
    k, v = proj(q_in, "key"), proj(x, "value")
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", prec.q(q), prec.q(k)),
                      -1)
    o = torch.einsum("bhqk,bkhd->bqhd", prec.q(w), prec.q(v))
    y = x + torch.einsum("bqhd,hdc->bqc", prec.q(o),
                         prec.q(sd[p + "out.kernel"])) + sd[p + "out.bias"]
    mean = y.mean(-1, keepdim=True)
    var = torch.clamp((y * y).mean(-1, keepdim=True) - mean * mean, min=0.0)
    ln = "roi_head.LayerNorm_0."
    return ((y - mean) * torch.rsqrt(var + LN_EPS) * sd[ln + "scale"]
            + sd[ln + "bias"])


def keypoints_bev(rois):
    """(R, 7) -> (R, 5, 2): the BEV centre and the 4 side midpoints."""
    c, s = torch.cos(rois[:, 6]), torch.sin(rois[:, 6])
    hx, hy = rois[:, 3] / 2, rois[:, 4] / 2
    zero = torch.zeros_like(hx)
    ox = torch.stack([zero, hx, -hx, zero, zero], 1)
    oy = torch.stack([zero, zero, zero, hy, -hy], 1)
    return torch.stack([ox * c[:, None] - oy * s[:, None] + rois[:, None, 0],
                        ox * s[:, None] + oy * c[:, None] + rois[:, None, 1]],
                       -1)


def bev_corners(xy, cfg, h, w):
    """The bilinear sample's lower corner (x0, y0) in an (h, w) map and its
    weights (tx, ty) of metric points xy (K, 2): the map's cell centres at
    (i + 0.5) * stride * voxel size, clamped to the map."""
    step = cfg["feature_map_stride"]
    fx = (xy[:, 0] - cfg["pc_range"][0]) / (cfg["voxel_size"][0] * step) \
        - 0.5
    fy = (xy[:, 1] - cfg["pc_range"][1]) / (cfg["voxel_size"][1] * step) \
        - 0.5
    x0 = torch.clamp(torch.floor(fx).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(fy).long(), 0, h - 2)
    return (x0, y0, torch.clamp(fx - x0, 0.0, 1.0)[:, None],
            torch.clamp(fy - y0, 0.0, 1.0)[:, None])


def sample_bev(bev, xy, cfg):
    """Bilinear samples of bev (H, W, C) at metric xy (K, 2)."""
    x0, y0, tx, ty = bev_corners(xy, cfg, bev.shape[0], bev.shape[1])
    return ((1 - ty) * ((1 - tx) * bev[y0, x0] + tx * bev[y0, x0 + 1])
            + ty * ((1 - tx) * bev[y0 + 1, x0] + tx * bev[y0 + 1, x0 + 1]))


def refine_boxes(cls_logit, reg_deltas, rois, roi_scores):
    """ResidualCoder's decode of the residuals against the RoIs, scored
    sqrt(sigmoid(logit) * proposal score) in [1e-8, 1]."""
    xa, ya, za = rois[..., 0], rois[..., 1], rois[..., 2]
    dxa, dya, dza = (rois[..., i].clamp(min=1e-5) for i in (3, 4, 5))
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    d = reg_deltas
    out = torch.stack([d[..., 0] * diag + xa, d[..., 1] * diag + ya,
                       d[..., 2] * dza + za,
                       torch.exp(d[..., 3].clamp(-4, 4)) * dxa,
                       torch.exp(d[..., 4].clamp(-4, 4)) * dya,
                       torch.exp(d[..., 5].clamp(-4, 4)) * dza,
                       d[..., 6] + rois[..., 6]], -1)
    scores = torch.sqrt(torch.clamp(torch.sigmoid(cls_logit) * roi_scores,
                                    1e-8, 1.0))
    return out, scores


def roi_head(sd, rois, mask, frame_tables, frame_feats, bev, cfg, train,
             prec):
    """rois (N, R, 7), mask (N, R), per frame {level: Table} and {level:
    features}, bev (N, H, W, 512) -> cls_logit (N, R), reg_deltas (N, R, 7),
    per level the neighbour keys (N, R * G^3, NSAMPLE) and the found
    counts (N, R * G^3)."""
    n, r = mask.shape
    g = cfg["roi_grid_size"]
    g3 = g ** 3
    pts = grid_points(rois.reshape(n * r, 7), g).reshape(n, r * g3, 3)
    pooled, counts, keys = [], [], []
    for li, (lvl, stride) in enumerate(ROI_LEVELS):
        got = pool(sd, li, lvl, stride, frame_tables, frame_feats, pts, cfg,
                   train, prec)
        pooled.append(torch.cat([x[0] for x in got]))
        counts.append(torch.stack([x[1] for x in got]))
        keys.append(torch.stack([x[2] for x in got]))
    log_density = torch.log1p(sum(counts).reshape(n * r * g3, 1).float())
    tokens = torch.cat(pooled + [log_density], -1).reshape(n * r, g3, -1)
    if cfg["roi_attention"]:
        dpos = _dense(log_density.reshape(n * r, g3, 1),
                      sd["roi_head.density_pos.weight"], prec,
                      sd["roi_head.density_pos.bias"])
        tokens = attention(tokens, tokens + dpos, sd, prec)
    extra = torch.stack([
        sample_bev(b, keypoints_bev(ro).reshape(-1, 2), cfg).reshape(r, -1)
        for b, ro in zip(bev, rois)])
    h = torch.cat([tokens.reshape(n * r, -1), extra.reshape(n * r, -1)], -1)
    flat_mask = mask.reshape(-1)
    if train:
        h = h[flat_mask]
    h = mlp(h, sd, "roi_head.shared_fc", train, prec)
    cls = _dense(h, sd["roi_head.cls.weight"], prec, sd["roi_head.cls.bias"])
    reg = _dense(h, sd["roi_head.reg.weight"], prec, sd["roi_head.reg.bias"])
    if train:
        cls = h.new_zeros(n * r, 1).index_put((flat_mask,), cls)
        reg = h.new_zeros(n * r, reg.shape[-1]).index_put((flat_mask,), reg)
    return (cls[:, 0].reshape(n, r), reg.reshape(n, r, -1), keys, counts)



@torch.no_grad()
def forward(sd, points, valid, cfg, proposals=None, train=False, prec=F32):
    """points (N, P, F), valid (N, P) -> (the center head's maps [{name:
    (N, H, W, ch)}], the second stage: rois (N, R, 7), roi_mask,
    roi_scores, roi_labels (N, R), cls_logit (N, R), reg_deltas (N, R, 7),
    the refined boxes (N, R, 7) and scores (N, R), and per pooled level the
    neighbour keys (N, R * G^3, NSAMPLE; -1 where none) and found counts
    (N, R * G^3)).  `proposals` ({boxes (N, R, 7+), mask, scores, labels})
    are the RoIs; where None, the decode of this forward's maps (rounded by
    `prec`) at `proposal_pp`."""
    frames = [geometry.build_levels(pt, v, cfg)
              for pt, v in zip(points, valid)]
    bev3d, kept = backbone3d(sd, frames, cfg, train, prec)
    bev = network.backbone2d(sd, bev3d, cfg, train, prec)
    maps = network.center_head(sd, bev, cfg, train, prec)
    if proposals is None:
        decs = [propose([{k: prec.q(v[b]) for k, v in m.items()}
                         for m in maps], cfg, quant=prec.q)
                for b in range(len(frames))]
        proposals = {k: torch.stack([d[k] for d in decs]) for k in decs[0]}
    frame_tables = [tables(pt, v, f[0], cfg)
                    for pt, v, f in zip(points, valid, frames)]
    frame_feats = [{lvl: kept[lvl][b] for lvl, _ in ROI_LEVELS}
                   for b in range(len(frames))]
    rois = proposals["boxes"][..., :7].float()
    cls, reg, keys, counts = roi_head(
        sd, rois, proposals["mask"], frame_tables, frame_feats,
        bev.permute(0, 2, 3, 1), cfg, train, prec)
    out = {"rois": rois, "roi_mask": proposals["mask"],
           "roi_scores": proposals["scores"].float(),
           "roi_labels": proposals["labels"], "cls_logit": cls,
           "reg_deltas": reg, "neighbours": keys, "counts": counts}
    out["boxes"], out["scores"] = refine_boxes(cls, reg, rois,
                                               out["roi_scores"])
    return maps, out
