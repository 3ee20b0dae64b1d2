"""K11's plain version (`ops/rowpad_bn.py`) against the torch composition it
replaced, bit for bit on the CPU: the masked batch-statistics BN as
`_MaskedBNTrain` computed it before its steps moved into shared helpers
(kept verbatim below), `torch.relu`, `torch.where` and the residual add,
with autograd's backwards.  Forward output, the gradients of y, scale, bias
and the residual, and the running statistics, in float32 and bf16, at C of
16 to 128, for the flags the backbone uses, on tables with empty lines, an
all-empty table (cnt clamped to 1) and a 'down' conv's table (onz < the
zmask's nz).  Then the engagement counters: 20 forwards and 20 backwards of
`RowpadBN` a one-stage training step, none a predict batch."""

import numpy as np
import pytest
import torch

from detzero_tpu_torch.models.layers import MaskedBatchNorm
from detzero_tpu_torch.ops import rowpad_bn as rb
from detzero_tpu_torch.ops.masked_bn import BN_EPS, _stat_dims

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (act, residual): the block's first conv, its second (the skip), and a
# conv with neither
FLAGS = {"act": (True, False), "residual": (False, True),
         "neither": (False, False)}


class _ParentBNTrain(torch.autograd.Function):
    """`_MaskedBNTrain` as it was before its steps became helpers."""

    @staticmethod
    def forward(ctx, x, scale, bias, mask, ch):
        dims = _stat_dims(x, ch)
        shape = [1] * x.ndim
        shape[ch] = -1
        xf = x.float()
        xm = xf * mask
        cnt = mask.sum(dtype=torch.float32)
        s, ss = xm.sum(dims), (xm * xf).sum(dims)
        del xm
        cnt = torch.clamp(cnt, min=1.0)
        mean = s / cnt
        var = torch.clamp(ss / cnt - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + BN_EPS)
        y = (xf - mean.reshape(shape)) * rstd.reshape(shape)
        y = y * scale.reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(x, mask, scale, mean, rstd, cnt)
        ctx.ch = ch
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mask, scale, mean, rstd, cnt = ctx.saved_tensors
        ch = ctx.ch
        dims = _stat_dims(x, ch)
        shape = [1] * x.ndim
        shape[ch] = -1
        g = gy.float()
        xf = x.float()
        sum_g = g.sum(dims)
        sum_gx = (g * xf).sum(dims)
        sum_gxhat = rstd * (sum_gx - mean * sum_g)
        a = scale * rstd
        d_var = -0.5 * scale * rstd * rstd * sum_gxhat
        d_mean = -a * sum_g - 2.0 * mean * d_var
        per = (d_mean.reshape(shape) + 2.0 * xf * d_var.reshape(shape)) / cnt
        per = per * mask
        dx = a.reshape(shape) * g + per
        return dx.to(x.dtype), sum_gxhat, sum_g, None, None


def composition(bn, y, zmask, residual, act, cout):
    """The train-mode epilogue of `SparseConvBNReLU` as torch ops."""
    ny_o, w, b = y.shape
    onz = w // cout
    m4 = zmask[:, :onz, None, :]
    y, mean, var = _ParentBNTrain.apply(y.reshape(ny_o, onz, cout, b),
                                        bn.scale, bn.bias,
                                        m4.to(torch.float32), 2)
    bn.update_running(mean, var)
    if act:
        y = torch.relu(y)
    y = torch.where(m4, y, 0.0).reshape(ny_o, onz * cout, b)
    if residual is not None:
        y = torch.relu(y + residual.to(y.dtype))
    return y


def fused(bn, y, zmask, residual, act, cout):
    out, mean, var = rb.rowpad_bn(y, zmask, bn.scale, bn.bias, residual,
                                  act=act, cout=cout)
    bn.update_running(mean, var)
    return out


def case(geometry, c, dtype, seed):
    """(y, zmask, residual, g_out, scale, bias): a row budget of 16, rows
    whose first slots are occupied on some planes, the rest empty."""
    rng = np.random.RandomState(seed)
    ny, nz, b = 6, 4, 16
    onz = 2 if geometry == "down" else nz
    n = rng.randint(0, b + 1, (ny, 1, 1))
    zm = (np.arange(b) < n) & (rng.rand(ny, nz, b) < 0.6)
    zm[1] = False                       # a row with no site
    zm[:, 1] = False                    # a plane with no site
    if geometry == "empty":
        zm[:] = False
    shape = (ny, onz * c, b)

    def table(scale):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dtype)

    y = table(2.0) + 0.5
    residual, g_out = table(1.0), table(1.0)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-0.3, 0.3, c).astype(np.float32))
    return y, torch.from_numpy(zm), residual, g_out, scale, bias


def run(fn, inputs, act, with_residual, c):
    y, zmask, residual, g_out, scale, bias = inputs
    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
        bn.mean.uniform_(-0.1, 0.1,
                         generator=torch.Generator().manual_seed(1))
    y = y.clone().requires_grad_()
    res = residual.clone().requires_grad_() if with_residual else None
    out = fn(bn, y, zmask, res, act, c)
    leaves = [y, bn.scale, bn.bias] + ([res] if with_residual else [])
    grads = torch.autograd.grad(out, leaves, g_out)
    return [out.detach(), bn.mean, bn.var, *grads]


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("c", [16, 32, 64, 128])
@pytest.mark.parametrize("geometry", ["lines", "down", "empty"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_equals_composition(dtype, geometry, c, flags):
    act, with_residual = FLAGS[flags]
    inputs = case(geometry, c, DTYPES[dtype], seed=c)
    want = run(composition, inputs, act, with_residual, c)
    got = run(fused, inputs, act, with_residual, c)
    names = ["out", "running mean", "running var", "d_y", "d_scale",
             "d_bias", "d_residual"]
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(bits(a), bits(b)), name
    if geometry == "empty":
        # no site: cnt clamps to 1, and the batch statistics are 0
        y, zmask, _, _, scale, bias = inputs
        _, mean, var = rb.rowpad_bn(y, zmask, scale, bias, act=act, cout=c)
        assert not mean.any() and not var.any()


def test_act_with_residual_is_refused():
    y, zmask, residual, _, scale, bias = case("lines", 16, torch.float32, 0)
    with pytest.raises(ValueError, match="act conv with a residual"):
        rb.rowpad_bn(y, zmask, scale, bias, residual, act=True, cout=16)


def test_engagement_counts_train_step_and_predict():
    """RowpadBN runs once forward and once backward for each of the 20
    row-pad convs of a one-stage training step, and not in predict."""
    from detzero_tpu_torch.core.optim import build_optimizer
    from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
    from detzero_tpu_torch.parallel.trainer import Trainer

    model = CenterPoint({"CLASS_IDS_EACH_HEAD": [[0], [1, 2]],
                         "VOXEL_CAPACITIES": (256, 128, 64, 32),
                         "BEV_LAYER_NUMS": (1, 1), "PILLAR_ROW_BUDGET": 16},
                        3, pc_range=(-3.2, -3.2, -2.0, 3.2, 3.2, 2.0),
                        voxel_size=(0.2, 0.2, 0.5), dtype=torch.float32,
                        device="cpu")
    model.init_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.uniform(-3, 3, (2, 512, 5)).astype(
        np.float32))
    valid = torch.ones(2, 512, dtype=torch.bool)
    gb = torch.zeros(2, 4, 9)
    gb[:, 0, :7] = torch.tensor([1.0, 1.0, 0.0, 4.4, 2.0, 1.6, 0.3])
    gv = torch.zeros(2, 4, dtype=torch.bool)
    gv[:, 0] = True
    batch = dict(points=pts, points_valid=valid, gt_boxes=gb,
                 gt_classes=torch.zeros(2, 4, dtype=torch.int32),
                 gt_valid=gv)
    trainer = Trainer(model, build_optimizer(
        {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01,
         "GRAD_NORM_CLIP": 10.0}, 5, model))
    before = (rb.FORWARDS, rb.BACKWARDS, rb.LAUNCHES)
    trainer.step(batch)
    assert (rb.FORWARDS, rb.BACKWARDS, rb.LAUNCHES) == (
        before[0] + 20, before[1] + 20, before[2])
    model.eval()
    before = (rb.FORWARDS, rb.BACKWARDS)
    with torch.no_grad():
        model.predict(pts, valid)
    assert (rb.FORWARDS, rb.BACKWARDS) == before
