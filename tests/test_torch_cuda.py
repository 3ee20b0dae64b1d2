"""Each CUDA kernel of detzero_tpu_torch against its plain PyTorch version on
the card, at small shapes, plus the tiny model (predict and one training
loss with its gradients) on the card against the CPU.
Marked `cuda`: skipped where torch finds no CUDA device.  On a machine with
a card:  python -m pytest tests/test_torch_cuda.py -q
chip_smoke.py makes the same checks at the flagship path's shapes."""

import numpy as np
import pytest
import torch

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
    cpu = CenterPoint(cfg, 3, dtype=torch.float32, **kw)
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


@pytest.mark.parametrize("mode,lvl_out,residual", [
    ("subm", 0, True), ("subm", 0, False), ("down", 1, False)])
def test_rowpad_conv_kernel(tiny, dev, mode, lvl_out, residual):
    from detzero_tpu_torch.ops import rowpad_conv

    *_, plan = tiny
    g = torch.Generator(device=dev).manual_seed(1)
    zi, zo = plan[0]["rp_zmask"], plan[lvl_out]["rp_zmask"]
    table = (torch.randn((*zi.shape[:2], 16, zi.shape[2]), generator=g,
                         device=dev) * zi[:, :, None]).reshape(
        zi.shape[0], -1, zi.shape[2]).bfloat16()
    res = None
    if residual:
        res = (torch.randn((*zo.shape[:2], 32, zo.shape[2]), generator=g,
                           device=dev) * zo[:, :, None]).reshape(
            zo.shape[0], -1, zo.shape[2]).bfloat16()
    w = torch.randn((27, 16, 32), generator=g, device=dev) * 0.05
    sc = torch.rand(32, generator=g, device=dev) + 0.5
    bi = torch.randn(32, generator=g, device=dev) * 0.1
    nbr = plan[0]["rp_down_nbr" if mode == "down" else "rp_nbr"]
    kw = dict(nz=8, cin=16, cout=32, out_nz=zo.shape[1], mode=mode,
              z_stride=2 if mode == "down" else 1)
    a = (table, nbr, w, sc, bi, zo, res)
    ref = rowpad_conv.rowpad_conv_fused_plain(*a, **kw)
    got = rowpad_conv.rowpad_conv_fused(*a, **kw)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max() \
        <= 2e-2 * ref.float().abs().max()


def _masked_table(zm, c, g):
    t = torch.randn((*zm.shape[:2], c, zm.shape[2]), generator=g,
                    device=zm.device) * zm[:, :, None]
    return t.reshape(zm.shape[0], -1, zm.shape[2]).bfloat16()


def _train_case(plan, mode, g):
    """One conv of the tiny plan: L0 subm 16->32, down L0->L1 16->32, or the
    'up' input gradient of that down conv (L1 32 -> L0 16)."""
    zm0, zm1 = plan[0]["rp_zmask"], plan[1]["rp_zmask"]
    if mode == "up":
        w = torch.randn((27, 32, 16), generator=g, device=zm0.device) * 0.05
        return (_masked_table(zm1, 32, g), plan[0]["rp_up_nbr"], w, zm0,
                dict(nz=8, cin=32, cout=16, out_nz=8, mode="up"))
    w = torch.randn((27, 16, 32), generator=g, device=zm0.device) * 0.05
    if mode == "down":
        return (_masked_table(zm0, 16, g), plan[0]["rp_down_nbr"], w, zm1,
                dict(nz=8, cin=16, cout=32, z_stride=2, out_nz=zm1.shape[1],
                     mode="down"))
    return (_masked_table(zm0, 16, g), plan[0]["rp_nbr"], w, zm0,
            dict(nz=8, cin=16, cout=32, mode="subm"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["subm", "down", "up"])
def test_rowpad_conv_train_kernel(tiny, dev, mode, dtype):
    """K4 against its plain version on the same inputs and weights: bf16
    tables within 2e-2 * max|ref| (f32 sums in another order, one bf16
    rounding), float32 tables within 1e-5 * max|ref|."""
    from detzero_tpu_torch.ops import rowpad_conv

    *_, plan = tiny
    g = torch.Generator(device=dev).manual_seed(3)
    table, nbr, w, zm, kw = _train_case(plan, mode, g)
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


@pytest.mark.parametrize("mode", ["subm", "down"])
def test_rowpad_conv_dw_kernel(tiny, dev, mode):
    """K5 against its plain version: the same bf16 products summed in f32 in
    another order, 1e-3 * max|ref|; the same result twice (no atomics)."""
    from detzero_tpu_torch.ops import rowpad_conv

    *_, plan = tiny
    g = torch.Generator(device=dev).manual_seed(4)
    table, nbr, _, zm, kw = _train_case(plan, mode, g)
    d_out = _masked_table(zm, kw["cout"], g)
    ref = rowpad_conv.rowpad_conv_dw_plain(table, nbr, d_out, zm, **kw)
    got = rowpad_conv.rowpad_conv_dw(table, nbr, d_out, zm, **kw)
    again = rowpad_conv.rowpad_conv_dw(table, nbr, d_out, zm, **kw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (27, kw["cin"], kw["cout"])
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
    cpu = CenterPoint(cfg, 3, dtype=torch.float32, **kw)
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
