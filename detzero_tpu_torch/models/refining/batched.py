"""Batched refining inference (port of
detzero_tpu/models/refining/batched.py).  Every refining sampler emits
static shapes (queries padded to QUERY_NUM, the memory with its mask), so
objects stack along a batch axis: one forward and decode a chunk of
`batch_size` objects on the model's device, the last chunk padded by
repeating its last sample, and only the small decoded arrays come back to
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from detzero_tpu_torch.models.refining.crm import crm_decode
from detzero_tpu_torch.models.refining.grm import grm_decode
from detzero_tpu_torch.models.refining.prm import prm_decode

_SAMPLE_KEYS = {
    # GRM carries its anchors (K, 3) a sample, so one model serves every
    # class
    "grm": ("query_pts", "query_sizes", "memory_pts", "memory_mask",
            "anchors"),
    "prm": ("query_pts", "query_boxes", "memory_pts", "pad_mask"),
    "crm": ("query_pts", "pad_mask"),
}


def forward_decode(model, kind, *arrs):
    """The model's forward and decode on stacked tensors in _SAMPLE_KEYS'
    order: GRM (B, 3) sizes; PRM ((B, T, 3) centers, (B, T) headings) in
    init-box coords, the query boxes' centers added back; CRM (B, T)
    confidences."""
    if kind == "grm":
        *inputs, anchors = arrs
        return grm_decode(model(*inputs), anchors)
    if kind == "prm":
        return prm_decode(model(*arrs), query_boxes=arrs[1])
    return crm_decode(model(*arrs))


class BatchedRefiner:
    """Forward and decode of a GRM, PRM or CRM model over chunks of
    `batch_size` objects.  `run(samples)` returns a list of per-object
    numpy results in the samples' order: GRM (3,) sizes, PRM ((T, 3)
    centers, (T,) headings), CRM (T,) confidences."""

    def __init__(self, model, kind: str, batch_size: int = 8):
        if kind not in _SAMPLE_KEYS:
            raise ValueError(f"unknown refiner kind {kind!r}")
        self.model = model
        self.kind = kind
        self.batch_size = int(batch_size)
        self.keys = _SAMPLE_KEYS[kind]

    @torch.no_grad()
    def run(self, samples):
        device = next(self.model.parameters()).device
        outs = []
        b = self.batch_size
        for i0 in range(0, len(samples), b):
            chunk = samples[i0:i0 + b]
            pad = b - len(chunk)
            arrs = [torch.from_numpy(np.stack(
                [np.asarray(s[k]) for s in chunk]
                + [np.asarray(chunk[-1][k])] * pad)).to(device)
                for k in self.keys]
            res = forward_decode(self.model, self.kind, *arrs)
            if isinstance(res, tuple):
                res = tuple(r.cpu().numpy() for r in res)
                outs.extend(tuple(r[j] for r in res)
                            for j in range(len(chunk)))
            else:
                res = res.cpu().numpy()
                outs.extend(res[j] for j in range(len(chunk)))
        return outs
