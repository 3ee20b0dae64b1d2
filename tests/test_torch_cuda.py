"""Each CUDA kernel of detzero_tpu_torch against its plain PyTorch version on
the card, at small shapes, plus the tiny model on the card against the CPU.
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
