"""Box residual coders (port of `detzero_tpu/ops/box_coder.py`):
ResidualCoder, anchor-relative (center offsets over the anchor diagonal,
log size ratios, heading residual, optionally split into sin/cos); the
decode-only PreviousResidualDecoder; and PointResidualCoder, boxes against
bare points with the class-mean sizes as the size prior.  Log sizes are
clipped at +-4 on decode."""

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


class PreviousResidualDecoder:
    """Decode-only legacy coder: ResidualCoder's decode, kept for
    detections of older pipelines."""

    code_size = 7

    @staticmethod
    def decode(deltas, anchors):
        return ResidualCoder().decode(deltas, anchors)


class PointResidualCoder:
    """Boxes encoded against points, the class-mean sizes (num_cls, 3) the
    size prior (ones without classes or with use_mean_size off); codes are
    [xt, yt, zt, dxt, dyt, dzt, sin, cos]."""

    def __init__(self, mean_sizes, use_mean_size: bool = True):
        self.mean_sizes = torch.as_tensor(mean_sizes)
        self.use_mean_size = use_mean_size
        self.code_size = 8

    def _prior(self, like, classes):
        if self.use_mean_size and classes is not None:
            return self.mean_sizes.to(like.device)[classes]
        return torch.ones((*like.shape[:-1], 3), dtype=like.dtype,
                          device=like.device)

    def encode(self, boxes, points, classes=None):
        prior = self._prior(boxes, classes)
        diag = torch.sqrt(prior[..., 0] ** 2 + prior[..., 1] ** 2)
        return torch.cat([
            ((boxes[..., 0] - points[..., 0]) / diag)[..., None],
            ((boxes[..., 1] - points[..., 1]) / diag)[..., None],
            ((boxes[..., 2] - points[..., 2]) / prior[..., 2])[..., None],
            torch.log(torch.clamp(boxes[..., 3:6], min=1e-5) / prior),
            torch.sin(boxes[..., 6:7]), torch.cos(boxes[..., 6:7])], -1)

    def decode(self, deltas, points, classes=None):
        prior = self._prior(deltas, classes)
        diag = torch.sqrt(prior[..., 0] ** 2 + prior[..., 1] ** 2)
        return torch.cat([
            (deltas[..., 0] * diag + points[..., 0])[..., None],
            (deltas[..., 1] * diag + points[..., 1])[..., None],
            (deltas[..., 2] * prior[..., 2] + points[..., 2])[..., None],
            torch.exp(torch.clamp(deltas[..., 3:6], -4, 4)) * prior,
            torch.atan2(deltas[..., 6], deltas[..., 7])[..., None]], -1)
