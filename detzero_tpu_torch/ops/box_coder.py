"""Anchor-residual box coder (port of `detzero_tpu/ops/box_coder.py`'s
ResidualCoder): center offsets over the anchor diagonal, log size ratios,
heading residual (optionally split into sin/cos)."""

from __future__ import annotations

import torch


class ResidualCoder:
    def __init__(self, code_size: int = 7, encode_angle_by_sincos=False):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.sincos = encode_angle_by_sincos

    @staticmethod
    def _anchor(anchors):
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa = torch.clamp(anchors[..., 3], min=1e-5)
        dya = torch.clamp(anchors[..., 4], min=1e-5)
        dza = torch.clamp(anchors[..., 5], min=1e-5)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return xa, ya, za, dxa, dya, dza, anchors[..., 6], diag

    def encode(self, boxes, anchors):
        """boxes/anchors (..., 7+) -> (..., code_size) residuals."""
        xa, ya, za, dxa, dya, dza, ra, diag = self._anchor(anchors)
        rg = boxes[..., 6]
        cols = [(boxes[..., 0] - xa) / diag, (boxes[..., 1] - ya) / diag,
                (boxes[..., 2] - za) / dza,
                torch.log(torch.clamp(boxes[..., 3], min=1e-5) / dxa),
                torch.log(torch.clamp(boxes[..., 4], min=1e-5) / dya),
                torch.log(torch.clamp(boxes[..., 5], min=1e-5) / dza)]
        if self.sincos:
            sg, cg, sa, ca = (torch.sin(rg), torch.cos(rg), torch.sin(ra),
                              torch.cos(ra))
            cols += [sg * ca - cg * sa, cg * ca + sg * sa]
        else:
            cols.append(rg - ra)
        cols += [boxes[..., i] - anchors[..., i]
                 for i in range(7, boxes.shape[-1])]
        return torch.stack(cols, -1)

    def decode(self, deltas, anchors):
        xa, ya, za, dxa, dya, dza, ra, diag = self._anchor(anchors)
        cols = [deltas[..., 0] * diag + xa, deltas[..., 1] * diag + ya,
                deltas[..., 2] * dza + za,
                torch.exp(torch.clamp(deltas[..., 3], -4, 4)) * dxa,
                torch.exp(torch.clamp(deltas[..., 4], -4, 4)) * dya,
                torch.exp(torch.clamp(deltas[..., 5], -4, 4)) * dza]
        if self.sincos:
            cols.append(torch.atan2(deltas[..., 6], deltas[..., 7]) + ra)
            rest = 8
        else:
            cols.append(deltas[..., 6] + ra)
            rest = 7
        cols += [deltas[..., i] + anchors[..., 7 + i - rest]
                 for i in range(rest, deltas.shape[-1])]
        return torch.stack(cols, -1)
