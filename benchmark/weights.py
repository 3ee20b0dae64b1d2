"""Seeded weights for a state dict's names and shapes, made on the device
in one draw: kernels normal / sqrt(fan in), biases zero (the heatmap's
-2.19, CenterPoint's prior), batch-norm scales one.  The running
statistics are set from the data (`calibrate`), as training leaves them: at
identity statistics the random network's activations shrink layer by layer
to nothing (the heads read their biases alone), which no trained detector
does.  The benchmark hands the same tensors to the program and to the
reference."""

from __future__ import annotations

import math

import torch

HM_BIAS = -2.19


def fan_in(name, shape):
    """Inputs a unit of this leaf sums over."""
    if name.endswith((".query.kernel", ".key.kernel", ".value.kernel")):
        return shape[0]                          # attention (in, heads, dim)
    if name.endswith(".kernel"):                 # sparse (taps, cin, cout)
        return shape[0] * shape[1]
    if len(shape) == 4:
        if "ConvTranspose" in name:              # (cin, cout, kh, kw)
            return shape[0] * shape[2] * shape[3]
        return shape[1] * shape[2] * shape[3]    # (cout, cin, kh, kw)
    if len(shape) == 2 and name.endswith(".weight"):
        return shape[1]                          # linear (out, in)
    raise ValueError(f"no fan-in rule for {name} {tuple(shape)}")


def make(shapes, seed, device):
    """shapes {name: shape} -> {name: float32 tensor} from `seed`, each
    drawn leaf scaled by 1 / sqrt(fan_in(name, shape))."""
    drawn = [k for k, s in shapes.items()
             if k.endswith((".kernel", ".weight"))]
    total = sum(math.prod(shapes[k]) for k in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 7) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, shape in shapes.items():
        if k in drawn:
            n = math.prod(shape)
            out[k] = flat[off:off + n].reshape(shape) / math.sqrt(
                fan_in(k, shape))
            off += n
        elif k.endswith((".scale", ".var")):
            out[k] = torch.ones(shape, device=device)
        elif k.endswith("hm_out.bias"):
            out[k] = torch.full(shape, HM_BIAS, device=device)
        elif k.endswith((".bias", ".mean")):
            out[k] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"no rule for {k}")
    return out


@torch.no_grad()
def calibrate(sd, points, valid, cfg):
    """Sets every batch norm's running mean and variance to the batch
    statistics of one train-mode forward of the reference over (points,
    valid), in place."""
    from benchmark.reference import network

    stats = {}
    network.forward(dict(sd, _stats=stats), points, valid, cfg, train=True)
    for prefix, (mean, var) in stats.items():
        sd[prefix + ".mean"] = mean.float()
        sd[prefix + ".var"] = var.float()
    return sd
