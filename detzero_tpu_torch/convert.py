"""Reference weights -> the port's state_dict, and back.

`convert_centerpoint` takes the flax variables of a reference CenterPoint
(`{"params": ..., "batch_stats": ...}` as nested dicts of numpy arrays;
neither jax nor flax is imported) and returns a state_dict for
`models.detection.centerpoint.CenterPoint`.  A tree with `params` only (the
reference's gradients, say) converts to the port's parameter names.
`to_flax` maps a state_dict (or a dict of gradients by parameter name) back
to the nested numpy tree.  The port's module names are flax's auto-names,
so each leaf maps one to one, by its name and its parent's:

  SparseConvBNReLU_* kernels            kept (spconv order), `.kernel`
    (27|3, Cin, Cout)
  attention query/key/value/out         kept (flax's DenseGeneral layout),
    kernels (C, H, D) / (H, D, C)       `.kernel`
  nn.Conv kernels HWIO                  OIHW, `.weight`
  nn.ConvTranspose kernels HWIO         IOHW flipped in space, `.weight`
                                        (flax does not flip, torch does)
  nn.Dense kernels (in, out)            (out, in), `.weight`
  biases, BN and LayerNorm scale/bias   kept
  BN batch_stats mean/var               kept (buffers)
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


_ATTENTION = ("query", "key", "value", "out")


def _kept_3d(parent):
    """The 3-D kernels kept as they are: sparse convs and attention."""
    return parent.startswith("SparseConvBNReLU") or parent in _ATTENTION


def convert_centerpoint(variables, model=None):
    """Returns the converted state_dict.  Raises on a leaf no rule consumes,
    and, when `model` is given, on any key or shape that does not match its
    state_dict (a leftover leaf or an unfilled parameter).  Without
    `batch_stats` the result (and the check) covers the parameters only."""
    return _convert(variables, model, with_conv=True)


def convert_refiner(variables, model=None):
    """`convert_centerpoint` for a GeometryTransformer, PositionTransformer
    or ConfidencePointNet tree: Dense kernels (in, out) become (out, in),
    attention's query/key/value/out kernels keep their 3-D layout, biases
    and LayerNorm scales are kept; a conv kernel or a BN statistic is a
    leaf no rule consumes.  Raises as `convert_centerpoint` does."""
    return _convert(variables, model, with_conv=False)


def _convert(variables, model, with_conv):
    state = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            name, parent = path[-1], (path[-2] if len(path) > 1 else "")
            key = ".".join(path)
            if with_conv and collection == "batch_stats" \
                    and name in ("mean", "var"):
                val = arr
            elif with_conv and collection == "params" and name == "kernel" \
                    and arr.ndim == 4:
                if parent.startswith("ConvTranspose"):
                    val = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    val = arr.transpose(3, 2, 0, 1)
                key = ".".join(path[:-1] + ("weight",))
            elif collection == "params" and name == "kernel" \
                    and arr.ndim == 2:
                val = arr.T
                key = ".".join(path[:-1] + ("weight",))
            elif collection == "params" and (
                    (name == "kernel" and arr.ndim == 3 and _kept_3d(parent))
                    or name in ("scale", "bias")):
                val = arr
            else:
                raise ValueError(f"no conversion rule for "
                                 f"{collection}/{'/'.join(path)} "
                                 f"{arr.shape}")
            state[key] = torch.from_numpy(
                np.array(val, dtype=np.float32, order="C"))
    if model is not None:
        want = model.state_dict() if "batch_stats" in variables \
            else dict(model.named_parameters())
        missing = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        shapes = [k for k in set(want) & set(state)
                  if tuple(want[k].shape) != tuple(state[k].shape)]
        if missing or extra or shapes:
            raise ValueError(f"state_dict mismatch: unfilled {missing}, "
                             f"unconsumed {extra}, shape {sorted(shapes)}")
    return state


def flax_path(key, ndim):
    """(collection, path list) of the flax leaf that the port's state_dict
    entry `key` of `ndim` dimensions maps to (`to_flax`'s name rule)."""
    path = key.split(".")
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name in ("mean", "var"):
        return "batch_stats", path
    if name == "weight" and ndim in (2, 4):
        return "params", path[:-1] + ["kernel"]
    if (name == "kernel" and ndim == 3 and _kept_3d(parent)) \
            or name in ("scale", "bias"):
        return "params", path
    raise ValueError(f"no conversion rule for {key} ({ndim} dimensions)")


def to_flax(state):
    """The inverse of `convert_centerpoint` and `convert_refiner`: {name: tensor or array} ->
    {"params": nested numpy tree[, "batch_stats": ...]} of float32 copies
    (never views of the tensors, which may change in place)."""
    out = {}
    for key, val in state.items():
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        collection, path = flax_path(key, arr.ndim)
        if arr.ndim == 4 and collection == "params":
            if path[-2].startswith("ConvTranspose"):
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                arr = arr.transpose(2, 3, 1, 0)
        elif arr.ndim == 2 and path[-1] == "kernel":
            arr = arr.T
        node = out.setdefault(collection, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(arr, dtype=np.float32, order="C",
                                  copy=True)
    return out
