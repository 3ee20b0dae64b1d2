"""Each CUDA kernel of detzero_tpu_torch against its plain PyTorch version on
the card, at small shapes, plus the tiny model (predict and one training
loss with its gradients, one-stage and two-stage, and one loss with the
sliding conv K9) on the card against the CPU.
Marked `cuda`: skipped where torch finds no CUDA device.  On a machine with
a card:  python -m pytest tests/test_torch_cuda.py -q
chip_smoke.py makes the same checks at the flagship path's shapes."""

import numpy as np
import pytest
import torch

from torch_iou_cases import FAMILIES, pair_set

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def tiny(dev):
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint

    cfg = {"CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
           "VOXEL_CAPACITIES": (512, 256, 128, 64), "BEV_LAYER_NUMS": (2, 2)}
    kw = dict(pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 2.0),
              voxel_size=(0.2, 0.2, 0.5))
    cpu = CenterPoint(cfg, 3, dtype=torch.float32, device="cpu", **kw)
    cpu.init_parameters(torch.Generator().manual_seed(0))
    gpu = CenterPoint(cfg, 3, dtype=torch.bfloat16, device=dev, **kw)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    pts = rng.uniform(-6, 6, (2048, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.8, 1.8, 2048)
    p = torch.from_numpy(pts).to(dev)
    v = torch.ones(2048, dtype=torch.bool, device=dev)
    table = gpu.build_table(p, v)
    return cpu, gpu, p, v, table, gpu.build_plan(table)


def test_stream_vfe_kernel(tiny):
    from detzero_tpu_torch.ops import stream_vfe

    *_, table, _ = tiny
    s = table["stream"]
    args = (s["payload"], s["lane"], s["z"], s["wstart"])
    kw = dict(nz=8, ny=64, row_budget=128, out_dtype=torch.float32)
    ref = stream_vfe.stream_rowpad_feats_plain(*args, **kw)
    got = stream_vfe.stream_rowpad_feats(*args, **kw)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


# the conv kernels' widths: every cin of the model's convs and input
# gradients (5 is the stem's, padded to the MMA depth 16) and every cout
WIDTHS = [(5, 16), (16, 32), (32, 64), (64, 128), (128, 128), (128, 16)]
# the tiny plan as built; with row 1 of every level emptied and row 2
# filled (every site occupied); rebuilt at row budget 8 (rows overflow)
EDGES = ["plan", "rows", "budget8"]


@pytest.fixture(scope="module")
def plans(tiny):
    from detzero_tpu_torch.models.detection.backbone3d_pallas import (
        augment_plan_rowpad)
    from detzero_tpu_torch.models.detection.backbone3d_pillar import (
        build_pillar_plan)

    _, gpu, *_, table, plan = tiny
    rows = []
    for e in plan[:4]:
        zm = e["rp_zmask"].clone()
        zm[1], zm[2] = False, True
        rows.append(dict(e, rp_zmask=zm))
    b8 = augment_plan_rowpad(build_pillar_plan(
        table, gpu.grid_zyx, gpu.pillar_capacities), gpu.grid_zyx,
        row_budget=8)
    assert b8[0]["rp_zmask"].shape[2] == 8
    assert int(b8[0]["rp_keep"].sum()) < int(plan[0]["rp_keep"].sum())
    return {"plan": plan, "rows": rows, "budget8": b8}


def _weight(cin, cout, g):
    return torch.randn((27, cin, cout), generator=g, device=g.device) \
        * (27 * cin) ** -0.5


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("cin,cout", WIDTHS)
@pytest.mark.parametrize("mode,lvl_out,residual", [
    ("subm", 0, True), ("subm", 0, False), ("down", 1, False)])
def test_rowpad_conv_kernel(plans, dev, mode, lvl_out, residual, cin, cout,
                            edge):
    """K2 against its plain version: 2e-2 * max|ref| (the same bf16 inputs,
    f32 sums in another order, one bf16 rounding)."""
    from detzero_tpu_torch.ops import rowpad_conv

    plan = plans[edge]
    g = torch.Generator(device=dev).manual_seed(1)
    zi, zo = plan[0]["rp_zmask"], plan[lvl_out]["rp_zmask"]
    table = _masked_table(zi, cin, g)
    res = _masked_table(zo, cout, g) if residual else None
    w = _weight(cin, cout, g)
    sc = torch.rand(cout, generator=g, device=dev) + 0.5
    bi = torch.randn(cout, generator=g, device=dev) * 0.1
    nbr = plan[0]["rp_down_nbr" if mode == "down" else "rp_nbr"]
    kw = dict(nz=8, cin=cin, cout=cout, out_nz=zo.shape[1], mode=mode,
              z_stride=2 if mode == "down" else 1)
    a = (table, nbr, w, sc, bi, zo, res)
    ref = rowpad_conv.rowpad_conv_fused_plain(*a, **kw)
    n0 = rowpad_conv.LAUNCHES
    got = rowpad_conv.rowpad_conv_fused(*a, **kw)
    torch.cuda.synchronize()
    assert rowpad_conv.LAUNCHES == n0 + 1
    assert float(ref.float().abs().max()) > 0
    assert (got.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()


def _masked_table(zm, c, g):
    t = torch.randn((*zm.shape[:2], c, zm.shape[2]), generator=g,
                    device=zm.device) * zm[:, :, None]
    return t.reshape(zm.shape[0], -1, zm.shape[2]).bfloat16()


def _train_case(plan, mode, g, cin=16, cout=32):
    """One conv of the tiny plan: L0 subm cin->cout, down L0->L1 cin->cout,
    or an 'up' input gradient of a down conv (L1 cin -> L0 cout)."""
    zm0, zm1 = plan[0]["rp_zmask"], plan[1]["rp_zmask"]
    w = _weight(cin, cout, g)
    if mode == "up":
        return (_masked_table(zm1, cin, g), plan[0]["rp_up_nbr"], w, zm0,
                dict(nz=8, cin=cin, cout=cout, out_nz=8, mode="up"))
    if mode == "down":
        return (_masked_table(zm0, cin, g), plan[0]["rp_down_nbr"], w, zm1,
                dict(nz=8, cin=cin, cout=cout, z_stride=2,
                     out_nz=zm1.shape[1], mode="down"))
    return (_masked_table(zm0, cin, g), plan[0]["rp_nbr"], w, zm0,
            dict(nz=8, cin=cin, cout=cout, mode="subm"))


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("cin,cout", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["subm", "down", "up"])
def test_rowpad_conv_train_kernel(plans, dev, mode, dtype, cin, cout, edge):
    """K4 against its plain version on the same inputs and weights: bf16
    tables (the tensor-core kernel) within 2e-2 * max|ref| (f32 sums in
    another order, one bf16 rounding), float32 tables (the CUDA-core
    kernel) within 1e-5 * max|ref|."""
    from detzero_tpu_torch.ops import rowpad_conv

    g = torch.Generator(device=dev).manual_seed(3)
    table, nbr, w, zm, kw = _train_case(plans[edge], mode, g, cin, cout)
    if dtype == torch.bfloat16:
        w = w.bfloat16().float()
    else:
        table = table.float() + 1e-3 * (table != 0) * torch.randn(
            table.shape, generator=g, device=dev)
    ref = rowpad_conv.rowpad_conv_plain(table, nbr, w, zm, **kw)
    n0 = rowpad_conv.CONV_LAUNCHES
    got = rowpad_conv.rowpad_conv(table, nbr, w, zm, **kw)
    torch.cuda.synchronize()
    assert rowpad_conv.CONV_LAUNCHES == n0 + 1
    assert got.dtype == dtype and got.shape == ref.shape
    assert float(ref.abs().max()) > 0
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("cin,cout", WIDTHS)
@pytest.mark.parametrize("mode", ["subm", "down"])
def test_rowpad_conv_dw_kernel(plans, dev, mode, cin, cout, edge):
    """K5 against its plain version: the same bf16 products summed in f32 in
    another order, 1e-3 * max|ref|; the same result twice (no atomics)."""
    from detzero_tpu_torch.ops import rowpad_conv

    g = torch.Generator(device=dev).manual_seed(4)
    table, nbr, _, zm, kw = _train_case(plans[edge], mode, g, cin, cout)
    d_out = _masked_table(zm, kw["cout"], g)
    ref = rowpad_conv.rowpad_conv_dw_plain(table, nbr, d_out, zm, **kw)
    n0 = rowpad_conv.DW_LAUNCHES
    got = rowpad_conv.rowpad_conv_dw(table, nbr, d_out, zm, **kw)
    again = rowpad_conv.rowpad_conv_dw(table, nbr, d_out, zm, **kw)
    torch.cuda.synchronize()
    assert rowpad_conv.DW_LAUNCHES == n0 + 2
    assert got.shape == ref.shape == (27, kw["cin"], kw["cout"])
    assert float(ref.abs().max()) > 0
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()
    assert torch.equal(got, again)


@pytest.mark.parametrize("kind", ["overlap", "iou"])
def test_pairwise_iou_kernel(dev, kind):
    """K6 against its plain version: every operation rounded alike, so
    1e-5 absolute covers sin/cos differing in the last ulp."""
    from detzero_tpu_torch.ops import iou_bev

    g = torch.Generator().manual_seed(5)
    a = torch.rand((500, 5), generator=g) * torch.tensor(
        [16.0, 16.0, 4.0, 4.0, 6.28]) + torch.tensor([-8, -8, 0.5, 0.5, -3.14])
    b = a + torch.randn((500, 5), generator=g) * torch.tensor(
        [0.5, 0.5, 0.3, 0.3, 0.3])
    b[:, 2:4] = b[:, 2:4].abs() + 0.1
    fn, plain = ((iou_bev.boxes_iou_bev_pairwise,
                  iou_bev.boxes_iou_bev_pairwise_plain) if kind == "iou" else
                 (iou_bev.boxes_overlap_bev_pairwise,
                  iou_bev.boxes_overlap_bev_pairwise_plain))
    ref = plain(a.to(dev), b.to(dev))
    got = fn(a.to(dev), b.to(dev))
    torch.cuda.synchronize()
    assert int((ref > 0).sum()) > 250
    assert (got - ref).abs().max() <= 1e-5


@pytest.mark.parametrize("n,m", [(128, 500), (37, 61)])
def test_overlap_matrix_kernel(dev, n, m):
    """K7 (the N x M intersection areas) against its plain version, at the
    RoI-target shape and a ragged one: every operation rounded alike, so
    1e-5 * the largest area covers sin/cos differing in the last ulp.  It
    counts its own launches, not K3's."""
    from detzero_tpu_torch.ops import iou_bev

    g = torch.Generator().manual_seed(6)
    a = torch.rand((n, 5), generator=g) * torch.tensor(
        [16.0, 16.0, 4.0, 4.0, 6.28]) + torch.tensor([-8, -8, 0.5, 0.5, -3.14])
    b = torch.cat([a[torch.randint(0, n, (m // 2,), generator=g)]
                   + torch.randn((m // 2, 5), generator=g) * 0.3,
                   torch.rand((m - m // 2, 5), generator=g) * 16 - 8])
    b[:, 2:4] = b[:, 2:4].abs() + 0.2
    a, b = a.to(dev), b.to(dev)
    ref = iou_bev.boxes_overlap_bev_plain(a, b)
    n3, n7 = iou_bev.LAUNCHES, iou_bev.OVERLAP_LAUNCHES
    got = iou_bev.boxes_overlap_bev(a, b)
    torch.cuda.synchronize()
    assert (iou_bev.LAUNCHES, iou_bev.OVERLAP_LAUNCHES) == (n3, n7 + 1)
    assert got.shape == (n, m) and int((ref > 0).sum()) > m // 4
    assert (got - ref).abs().max() <= 1e-5 * float(ref.max())


@pytest.mark.parametrize("row_budget", [8, 128])
def test_rowpad_nbr_kernel(tiny, dev, row_budget):
    """K8 against its plain version on the card, all 10 maps of the tiny
    plan in one launch: equal on every element.  Row budget 8 drops the
    pillars past the 8th of a row.  `augment_plan_rowpad` builds the same
    maps in one launch a sample."""
    from detzero_tpu_torch.models.detection.backbone3d_pallas import (
        augment_plan_rowpad)
    from detzero_tpu_torch.models.detection.backbone3d_pillar import (
        build_pillar_plan, plan_grids)
    from detzero_tpu_torch.ops import pillars, rowpad_nbr

    _, gpu, *_, table, _ = tiny
    plan = build_pillar_plan(table, gpu.grid_zyx, gpu.pillar_capacities)
    xq = []
    for lvl, (_, ny, nx) in enumerate(plan_grids(gpu.grid_zyx)[:4]):
        lay = pillars.rowpad_layout(plan[lvl]["cells"], plan[lvl]["mask"],
                                    (ny, nx), row_budget)
        xq.append(pillars.rowpad_xcoords(plan[lvl]["coords2d"][:, 1],
                                         lay["gidx"], lay["gvalid"]))
    cases = [(lvl, "rp_nbr", (xq[lvl], xq[lvl], "subm")) for lvl in range(4)]
    for lvl in range(3):
        cases += [(lvl, "rp_down_nbr", (xq[lvl + 1], xq[lvl], "down")),
                  (lvl, "rp_up_nbr", (xq[lvl], xq[lvl + 1], "up"))]
    n0 = rowpad_nbr.LAUNCHES
    maps = rowpad_nbr.rowpad_nbr_maps([c for *_, c in cases])
    torch.cuda.synchronize()
    assert rowpad_nbr.LAUNCHES == n0 + 1
    for (_, key, (q, x_in, mode)), got in zip(cases, maps):
        ref = pillars.rowpad_nbr_rank(q, x_in, mode)
        assert got.dtype == torch.int32 and torch.equal(got, ref), key
        assert int((ref[:, :9] < row_budget).sum()) > 0
    aug = augment_plan_rowpad(plan, gpu.grid_zyx, row_budget)
    torch.cuda.synchronize()
    assert rowpad_nbr.LAUNCHES == n0 + 2
    for (lvl, key, _), got in zip(cases, maps):
        assert torch.equal(aug[lvl][key], got), (lvl, key)
    # one map alone is one launch too
    q, x_in, mode = cases[5][2]
    assert torch.equal(rowpad_nbr.rowpad_nbr(q, x_in, mode), maps[5])
    assert rowpad_nbr.LAUNCHES == n0 + 3


@pytest.mark.parametrize("cin,cout", [(5, 16), (128, 32)])
def test_rowpad_conv_sliding_kernel(tiny, dev, cin, cout):
    """K9 against the plain version within 2e-2 * max|ref|, K4's bound, and
    against K4 on the same bf16 inputs within that bound too (K9 sums one
    fmaf at a time, K4 on the tensor cores); cin 128 fills K9's shared
    memory as at the flagship's L3."""
    from detzero_tpu_torch.ops import rowpad_conv

    *_, plan = tiny
    g = torch.Generator(device=dev).manual_seed(7)
    zm = plan[0]["rp_zmask"]
    table = _masked_table(zm, cin, g)
    w = (torch.randn((27, cin, cout), generator=g, device=dev)
         * (27 * cin) ** -0.5).bfloat16()
    kw = dict(nz=zm.shape[1], cin=cin, cout=cout)
    a = (table, plan[0]["rp_nbr"], w, zm)
    n0 = rowpad_conv.SLIDING_LAUNCHES
    got = rowpad_conv.rowpad_conv_sliding(*a, **kw)
    k4 = rowpad_conv.rowpad_conv(*a, **kw)
    ref = rowpad_conv.rowpad_conv_plain(*a, **kw)
    torch.cuda.synchronize()
    assert rowpad_conv.SLIDING_LAUNCHES == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert float(ref.abs().max()) > 0
    tol = 2e-2 * ref.abs().max()
    assert (got.float() - ref).abs().max() <= tol
    assert (got.float() - k4.float()).abs().max() <= tol
    with pytest.raises(ValueError, match="bf16"):
        rowpad_conv.rowpad_conv_sliding(table.float(), *a[1:], **kw)
    assert rowpad_conv.SLIDING_LAUNCHES == n0 + 1


def _clustered_boxes(n, per, seed):
    """n clusters of `per` jittered BEV boxes (real overlaps), as
    chip_smoke.py draws them."""
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((n, 1, 5), generator=g)
    base = base * torch.tensor([80.0, 80.0, 4.0, 2.0, 6.283]) \
        + torch.tensor([-40.0, -40.0, 1.0, 1.0, -3.1416])
    jit = torch.randn((n, per, 5), generator=g) \
        * torch.tensor([0.3, 0.3, 0.2, 0.1, 0.2])
    boxes = (base + jit).reshape(n * per, 5)
    boxes[:, 2:4] = boxes[:, 2:4].abs() + 0.2
    return boxes


def _matrix_kernels(a, b):
    """K3 and K7 on (a, b) against their plain versions on the card, one
    launch each: K3 within 1e-5 absolute, K7 within 1e-5 of the largest
    area (sin/cos may differ in the last ulp; the rest is rounded alike)."""
    from detzero_tpu_torch.ops import iou_bev

    n3, n7 = iou_bev.LAUNCHES, iou_bev.OVERLAP_LAUNCHES
    iou = iou_bev.boxes_iou_bev(a, b)
    ov = iou_bev.boxes_overlap_bev(a, b)
    ref_iou = iou_bev.boxes_iou_bev_plain(a, b)
    ref_ov = iou_bev.boxes_overlap_bev_plain(a, b)
    torch.cuda.synchronize()
    assert (iou_bev.LAUNCHES, iou_bev.OVERLAP_LAUNCHES) == (n3 + 1, n7 + 1)
    assert iou.shape == ov.shape == (a.shape[0], b.shape[0])
    assert float((iou - ref_iou).abs().max()) <= 1e-5
    assert float((ov - ref_ov).abs().max()) \
        <= 1e-5 * max(float(ref_ov.max()), 1.0)
    return iou, ref_iou


@pytest.mark.parametrize("name", FAMILIES)
def test_iou_matrix_kernels_adversarial(dev, name):
    """K3 and K7 on the box families that sit on the clip's on-edge rule
    and the kernel's cull (tests/torch_iou_cases.py): identical and
    touching boxes, A at the edge band of B, tiny edges, zero-size boxes on
    either side, 0 and pi/2 headings, far pairs whose plain overlap is
    nonzero; and K6, which shares the clip, bit for bit on their matched
    pairs."""
    from detzero_tpu_torch.ops import iou_bev

    a, b = (torch.from_numpy(x).to(dev) for x in pair_set(name))
    _matrix_kernels(a, b)
    for fn, plain in ((iou_bev.boxes_overlap_bev_pairwise,
                       iou_bev.boxes_overlap_bev_pairwise_plain),
                      (iou_bev.boxes_iou_bev_pairwise,
                       iou_bev.boxes_iou_bev_pairwise_plain)):
        got, ref = fn(a, b), plain(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), name


@pytest.mark.parametrize("n,m", [(1, 1), (33, 65), (1000, 1024)])
def test_iou_matrix_kernels_ragged(dev, n, m):
    """K3 and K7 at shapes off the 64 x 64 tile: one pair, a ragged pair of
    edges, and the NMS budget's 1000 x 1024."""
    a = _clustered_boxes((n + 4) // 5, 5, seed=n)[:n].to(dev)
    b = _clustered_boxes((m + 3) // 4, 4, seed=m)[:m].to(dev)
    b[: min(n, m) // 2] = a[: min(n, m) // 2]
    _matrix_kernels(a, b)


def test_iou_matrix_kernel_clustered(dev):
    """K3 on chip_smoke.py's 1000 x 1000 clustered boxes, and the walk's
    keep masks on it equal to the plain walk's on the plain matrix."""
    from detzero_tpu_torch.ops import nms

    boxes = _clustered_boxes(200, 5, seed=2).to(dev)
    iou, ref = _matrix_kernels(boxes, boxes)
    assert int((iou > 0.7).sum()) > 1000
    valid = torch.ones(1000, dtype=torch.bool, device=dev)
    valid[::17] = False
    for t in (0.1, 0.5, 0.7):
        assert torch.equal(nms.nms_walk(iou, valid, t),
                           nms.nms_walk_plain(ref, valid, t))


def test_iou_and_walk_kernels(dev):
    from detzero_tpu_torch.ops import iou_bev, nms

    g = torch.Generator().manual_seed(2)
    b = torch.rand((300, 5), generator=g) * torch.tensor(
        [16.0, 16.0, 4.0, 4.0, 6.28]) + torch.tensor([-8, -8, 0.5, 0.5, -3.14])
    b = b.to(dev)
    ref = iou_bev.boxes_iou_bev_plain(b, b)
    got = iou_bev.boxes_iou_bev(b, b)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-5
    valid = torch.rand(300, generator=g).to(dev) > 0.1
    for t in (0.1, 0.5):
        assert torch.equal(nms.nms_walk(got, valid, t),
                           nms.nms_walk_plain(got, valid, t))


def test_tiny_model_card_vs_cpu(tiny):
    """bf16 on the card against f32 on the CPU: 5e-2 * max(|ref|, 1)."""
    cpu, gpu, p, v, *_ = tiny
    ref = cpu.forward_one(p.cpu(), v.cpu())
    got = gpu.forward_one(p, v)
    for r, h in zip(ref, got):
        for k in r:
            err = (h[k].cpu() - r[k]).abs().max()
            assert err <= 5e-2 * max(float(r[k].abs().max()), 1.0), k


def _grad_agreement(ref, got, rel=5e-2):
    """(share of all elements beyond rel * max(|ref leaf|, 1), lowest share
    of one leaf's elements within it, global norm ratio got / ref)."""
    out = n_all = 0
    min_share, r2, g2 = 1.0, 0.0, 0.0
    for k, r in ref.items():
        r, g = r.double(), got[k].double().cpu()
        n_out = int(((g - r).abs() > rel * max(float(r.abs().max()), 1.0))
                    .sum())
        out, n_all = out + n_out, n_all + r.numel()
        min_share = min(min_share, 1.0 - n_out / r.numel())
        r2, g2 = r2 + float((r * r).sum()), g2 + float((g * g).sum())
    return out / n_all, min_share, (g2 / r2) ** 0.5


@pytest.mark.parametrize("seed", [0, 2])
def test_tiny_train_loss_card_vs_cpu(dev, seed):
    """One training loss and its gradients at batch 2 on the tiny geometry,
    from the same weights, the card (K1, K4, K5, K6) against the CPU (plain
    versions), on two draws (points from RandomState(seed), GT from
    RandomState(seed + 1); draw 0 is tests/test_torch_train_step.py's):
      * the float32 and the bf16 model's loss within 5e-2 * max(|ref|, 1);
      * the float32 model's gradient (K4 on float32 tables): at most 1e-4 of
        all elements and 10% of any leaf's beyond 5e-2 * max(|ref leaf|, 1),
        the global norm within 1e-2.  On draw 2 a ReLU region of the 2D
        backbone flips between the card and the CPU and moves ~50 elements
        of a conv weight's gradient past that bound; the CPU's own step moves
        the same leaf as far under a 1e-7 relative weight change (PERF.md
        section 7), so elements are counted instead of the worst one taken;
      * the bf16 model's gradient norm within 25%: bf16 rounding alone
        leaves its direction uncorrelated with the float32 gradient's."""
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
    from detzero_tpu_torch.ops import iou_bev, rowpad_conv

    cfg = {"CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
           "VOXEL_CAPACITIES": (2048, 1024, 512, 256)}
    kw = dict(pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 2.0),
              voxel_size=(0.2, 0.2, 0.5), max_objs=8)
    cpu = CenterPoint(cfg, 3, dtype=torch.float32, device="cpu", **kw)
    cpu.init_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-6, 6, (2, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (2, 2048))
    rng = np.random.RandomState(seed + 1)
    cls = np.arange(8) % 3
    sizes = np.array([[4.5, 2.0, 1.6], [0.9, 0.9, 1.7], [1.8, 0.8, 1.7]])
    gb = np.zeros((2, 8, 9), np.float32)
    gb[..., :2] = rng.uniform(-5.5, 5.5, (2, 8, 2))
    gb[..., 2] = rng.uniform(-1, 1, (2, 8))
    gb[..., 3:6] = sizes[cls] * rng.uniform(0.8, 1.2, (2, 8, 3))
    gb[..., 6] = rng.uniform(-np.pi, np.pi, (2, 8))
    gb[..., 7:9] = rng.uniform(-5, 5, (2, 8, 2))
    gc = np.tile(cls, (2, 1)).astype(np.int32)
    gv = np.zeros((2, 8), bool)
    gv[:, :5] = True
    batch = [torch.from_numpy(a) for a in
             (pts, np.ones((2, 2048), bool), gb, gc, gv)]
    loss_c, _ = cpu.loss(*batch)
    loss_c.backward()
    ref = float(loss_c.detach())
    ref_g = {k: p.grad for k, p in cpu.named_parameters()}
    for dtype in (torch.float32, torch.bfloat16):
        m = CenterPoint(cfg, 3, dtype=dtype, device=dev, **kw)
        m.load_state_dict(cpu.state_dict())
        n0 = (rowpad_conv.CONV_LAUNCHES, rowpad_conv.DW_LAUNCHES,
              iou_bev.PAIRWISE_LAUNCHES)
        loss_g, _ = m.loss(*[t.to(dev) for t in batch])
        loss_g.backward()
        torch.cuda.synchronize()
        assert (rowpad_conv.CONV_LAUNCHES - n0[0], rowpad_conv.DW_LAUNCHES
                - n0[1], iou_bev.PAIRWISE_LAUNCHES - n0[2]) == (39, 20, 2)
        assert abs(float(loss_g.detach()) - ref) <= 5e-2 * max(abs(ref), 1.0)
        out_share, min_share, norm_ratio = _grad_agreement(
            ref_g, {k: p.grad for k, p in m.named_parameters()})
        if dtype == torch.float32:
            assert out_share <= 1e-4 and min_share >= 0.9
            assert abs(norm_ratio - 1.0) <= 1e-2
        else:
            assert abs(norm_ratio - 1.0) <= 0.25


def test_tiny_sliding_train_loss(dev, monkeypatch):
    """One bf16 training loss and its gradient at batch 2 on the tiny
    geometry with `rowpad_conv.USE_SLIDING`: its 17 'subm' forward convs
    launch K9 and the other 22 convs K4; the loss and gradient norm are
    finite, and the loss is within 1e-3 relative of the same model's loss
    through K4 alone (K9 and K4 agree within K4's own bound)."""
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
    from detzero_tpu_torch.ops import rowpad_conv, rowpad_nbr

    cfg = {"CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
           "VOXEL_CAPACITIES": (2048, 1024, 512, 256)}
    m = CenterPoint(cfg, 3, pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 2.0),
                    voxel_size=(0.2, 0.2, 0.5), max_objs=8,
                    dtype=torch.bfloat16, device="cpu")
    m.init_parameters(torch.Generator().manual_seed(0))
    m = m.to(dev)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-6, 6, (2, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (2, 2048))
    gb = np.zeros((2, 8, 9), np.float32)
    gb[:, 0, :7] = [1.0, 1.0, 0.0, 4.4, 2.0, 1.6, 0.3]
    gv = np.zeros((2, 8), bool)
    gv[:, 0] = True
    batch = [torch.from_numpy(a).to(dev) for a in
             (pts, np.ones((2, 2048), bool), gb, np.zeros((2, 8), np.int32),
              gv)]
    losses = []
    for sliding in (False, True):
        monkeypatch.setattr(rowpad_conv, "USE_SLIDING", sliding)
        m.zero_grad(set_to_none=True)
        n0 = (rowpad_conv.SLIDING_LAUNCHES, rowpad_conv.CONV_LAUNCHES,
              rowpad_conv.DW_LAUNCHES, rowpad_nbr.LAUNCHES)
        loss, _ = m.loss(*batch)
        loss.backward()
        torch.cuda.synchronize()
        n = (rowpad_conv.SLIDING_LAUNCHES, rowpad_conv.CONV_LAUNCHES,
             rowpad_conv.DW_LAUNCHES, rowpad_nbr.LAUNCHES)
        assert tuple(a - b for a, b in zip(n, n0)) == (
            (17, 22, 20, 2) if sliding else (0, 39, 20, 2))
        gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                               for p in m.parameters() if p.grad is not None))
        assert bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm))
        losses.append(float(loss.detach()))
    assert abs(losses[1] - losses[0]) <= 1e-3 * abs(losses[0])


TWO_STAGE = {"SECOND_STAGE": True, "ROI_BUDGET": 16, "ROI_GRID_SIZE": 3,
             "ROI_ATTENTION": True}


def test_tiny_two_stage_card_vs_cpu(dev):
    """The two-stage model on the tiny geometry, the card against the CPU
    from the same weights:
      * predict (bf16 on the card, K2 in bf16): the first-stage head outputs
        and the multi-scale tables within 5e-2 * max(|ref|, 1), and the RoI
        head on the CPU's proposals and tables within the same bound (its
        proposals come from a top-k of the heatmaps, which bf16 rounding
        reorders, so the end-to-end boxes are held only to be finite);
        launches K2 20, K3 1, walk 1, no K1 (the dense table is gathered);
      * the training loss at batch 2 in float32 on the card (K4 on float32
        tables), float32 on both sides: the loss and each RoI term within
        1e-3 relative, and launches K4 39, K5 20, K6 2, K3 2, walk 2, K7 2;
      * the RoI head, its targets (K7) and loss alone in train mode on the
        CPU's proposals, BEV map and tables (the first stage's rounding,
        which its batch norms amplify, left out): every RoI head gradient
        leaf with at most 1e-3 of its elements beyond 1e-3 * max|CPU leaf|
        + 1e-6, as tests/test_torch_two_stage_train.py bounds the port
        against the reference (a max-pool or ReLU decision flipped by
        rounding)."""
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
    from detzero_tpu_torch.ops import iou_bev, nms, rowpad_conv, stream_vfe

    cfg = {"CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
           "VOXEL_CAPACITIES": (2048, 1024, 512, 256), **TWO_STAGE}
    kw = dict(pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 2.0),
              voxel_size=(0.2, 0.2, 0.5), max_objs=8)
    cpu = CenterPoint(cfg, 3, dtype=torch.float32, device="cpu", **kw)
    cpu.init_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    pts = rng.uniform(-6, 6, (2, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (2, 2048))
    p = torch.from_numpy(pts)
    v = torch.ones(2, 2048, dtype=torch.bool)

    def counts():
        return (stream_vfe.LAUNCHES, rowpad_conv.LAUNCHES, iou_bev.LAUNCHES,
                nms.LAUNCHES, rowpad_conv.CONV_LAUNCHES,
                rowpad_conv.DW_LAUNCHES, iou_bev.PAIRWISE_LAUNCHES,
                iou_bev.OVERLAP_LAUNCHES)

    gpu = CenterPoint(cfg, 3, dtype=torch.bfloat16, device=dev, **kw)
    gpu.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        ref_in = cpu.prepare(p[:1], v[:1])
        ref_3d = cpu.backbone3d(*ref_in)
        ref_bev = cpu.backbone2d(ref_3d["spatial_features"])
        ref_heads = cpu.center_head(ref_bev)
        ref_prop = cpu.proposals(ref_heads)
        ref_roi = cpu.refine(ref_prop, ref_bev,
                             ref_3d["multi_scale_3d_features"])
        n0 = counts()
        got_in = gpu.prepare(p[:1].to(dev), v[:1].to(dev))
        got_3d = gpu.backbone3d(*got_in)
        got_bev = gpu.backbone2d(got_3d["spatial_features"].bfloat16())
        got_heads = gpu.center_head(got_bev)
        gpu.refine(gpu.proposals(got_heads), got_bev,
                   got_3d["multi_scale_3d_features"])
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), n0)) == (
            0, 20, 1, 1, 0, 0, 0, 0)
        to_dev = {k: x.to(dev) if torch.is_tensor(x) else x
                  for k, x in ref_prop.items()}
        ms = {name: {k: x.to(dev) for k, x in lvl.items()}
              for name, lvl in ref_3d["multi_scale_3d_features"].items()}
        roi_on_ref = gpu.refine(to_dev, ref_bev.to(dev).bfloat16(), ms)
        out = gpu.predict(p[:1].to(dev), v[:1].to(dev))

    def close(ref, got, what):
        err = float((got.float().cpu() - ref.float()).abs().max())
        assert err <= 5e-2 * max(float(ref.abs().max()), 1.0), what

    for r, g in zip(ref_heads, got_heads):
        for k in r:
            close(r[k], g[k], k)
    for name, r in ref_3d["multi_scale_3d_features"].items():
        close(r["features"], got_3d["multi_scale_3d_features"][name][
            "features"], name)
    for k in ("cls_logit", "reg_deltas"):
        close(ref_roi[k], roi_on_ref[k], k)
    assert all(bool(torch.isfinite(x.float()).all()) for x in out.values())

    gb = np.zeros((2, 8, 9), np.float32)
    gb[:, :4, :7] = ref_roi["rois"][0, :4].numpy() + 0.05
    gv = np.zeros((2, 8), bool)
    gv[:, :4] = True
    batch = [torch.from_numpy(a) for a in
             (pts, np.ones((2, 2048), bool), gb,
              np.zeros((2, 8), np.int32), gv)]
    draws = cpu.roi_draws(2, torch.Generator().manual_seed(1))
    loss_c, aux_c = cpu.loss(*batch, roi_draws=draws)
    loss_c.backward()
    f32 = CenterPoint(cfg, 3, dtype=torch.float32, device=dev, **kw)
    f32.load_state_dict(cpu.state_dict())
    n0 = counts()
    loss_g, aux_g = f32.loss(*[t.to(dev) for t in batch],
                             roi_draws=tuple(d.to(dev) for d in draws))
    loss_g.backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), n0)) == (
        0, 0, 2, 2, 39, 20, 2, 2)
    ref = float(loss_c.detach())
    assert abs(float(loss_g.detach()) - ref) <= 1e-3 * abs(ref)
    for k in ("roi_cls", "roi_reg", "roi_corner"):
        r, g = aux_c[k].detach(), aux_g[k].detach().cpu()
        assert float((g - r).abs().max()) \
            <= 1e-3 * max(float(r.abs().max()), 1e-3), k

    grads = []
    for m, d in ((cpu, "cpu"), (f32, dev)):
        m.zero_grad(set_to_none=True)
        m.train()
        roi = m.refine({k: x.to(d) for k, x in ref_prop.items()},
                       ref_bev.to(d), {n: {k: x.to(d) for k, x in lvl.items()}
                                       for n, lvl in ref_3d[
                                           "multi_scale_3d_features"].items()})
        roi_loss, _ = m.roi_loss(roi, batch[2][:1].to(d), batch[4][:1].to(d),
                                 tuple(x[:1].to(d) for x in draws))
        roi_loss.mean().backward()
        m.eval()
        grads.append({k: q.grad.cpu() for k, q in m.named_parameters()
                      if k.startswith("roi_head.")})
    assert len(grads[0]) > 30
    for k, r in grads[0].items():
        bound = 1e-3 * float(r.abs().max()) + 1e-6
        n_out = int(((grads[1][k] - r).abs() > bound).sum())
        assert n_out <= 1e-3 * r.numel(), (k, n_out)
