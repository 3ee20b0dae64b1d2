"""Dense 2D BEV backbone (port of the reference's backbone2d.py): conv
blocks at strides (1, 2), each upsampled back (1x1 conv or transposed
conv) and channel-concatenated.  Runs on cuDNN.

The public boundary keeps the reference's (H, W, C) layout, with an
optional leading batch axis; inside, the map is an NCHW view in
channels-last memory, so no copy enters or leaves.  In train mode every BN's
statistics span N*H*W.
flax's ConvTranspose does not flip its kernel and torch's does: the
converter flips it spatially (convert.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detzero_tpu_torch.models.layers import (
    AutoNames, Conv2dSame, ConvBNReLU, ConvTranspose2d, MaskedBatchNorm,
)


class BaseBEVBackbone(nn.Module):
    def __init__(self, in_channels: int, layer_nums: Sequence[int] = (5, 5),
                 layer_strides: Sequence[int] = (1, 2),
                 num_filters: Sequence[int] = (128, 256),
                 upsample_strides: Sequence[int] = (1, 2),
                 num_upsample_filters: Sequence[int] = (256, 256),
                 device=None):
        super().__init__()
        name = AutoNames()
        self.levels = []
        cin = in_channels
        for i, n_layers in enumerate(layer_nums):
            convs = []
            for k in range(n_layers + 1):
                convs.append(name("ConvBNReLU"))
                self.add_module(convs[-1], ConvBNReLU(
                    cin, num_filters[i], 3,
                    layer_strides[i] if k == 0 else 1, device=device))
                cin = num_filters[i]
            s = upsample_strides[i]
            if s > 1:
                up = name("ConvTranspose")
                self.add_module(up, ConvTranspose2d(
                    cin, num_upsample_filters[i], s, stride=s, bias=False,
                    device=device))
            else:
                up = name("Conv")
                self.add_module(up, Conv2dSame(
                    cin, num_upsample_filters[i], s, s, device=device))
            bn = name("MaskedBatchNorm")
            self.add_module(bn, MaskedBatchNorm(num_upsample_filters[i],
                                                device=device))
            self.levels.append((convs, up, bn))

    def forward(self, x_hwc):
        """([N,] H, W, C) -> ([N,] H', W', sum(num_upsample_filters))."""
        if x_hwc.ndim == 3:
            return self.forward(x_hwc[None])[0]
        x = x_hwc.movedim(-1, 1)
        ups = []
        for convs, up, bn in self.levels:
            for name in convs:
                x = getattr(self, name)(x)
            u = getattr(self, up)(x)
            ups.append(F.relu(getattr(self, bn)(u, channel_dim=1)))
        out = torch.cat(ups, 1) if len(ups) > 1 else ups[0]
        return out.movedim(1, -1)
