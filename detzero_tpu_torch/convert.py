"""Reference weights -> the port's state_dict, and back.

`convert_centerpoint` takes the flax variables of a reference CenterPoint
(`{"params": ..., "batch_stats": ...}` as nested dicts of numpy arrays;
neither jax nor flax is imported) and returns a state_dict for
`models.detection.centerpoint.CenterPoint`.  A tree with `params` only (the
reference's gradients, say) converts to the port's parameter names.
`to_flax` maps a state_dict (or a dict of gradients by parameter name) back
to the nested numpy tree.  The port's module names are flax's auto-names,
so each leaf maps one to one:

  sparse kernels (27|3, Cin, Cout)      kept (spconv order), `.kernel`
  nn.Conv kernels HWIO                  OIHW, `.weight`
  nn.ConvTranspose kernels HWIO         IOHW flipped in space, `.weight`
                                        (flax does not flip, torch does)
  conv biases, BN scale/bias            kept
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


def convert_centerpoint(variables, model=None):
    """Returns the converted state_dict.  Raises on a leaf no rule consumes,
    and, when `model` is given, on any key or shape that does not match its
    state_dict (a leftover leaf or an unfilled parameter).  Without
    `batch_stats` the result (and the check) covers the parameters only."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            name, parent = path[-1], (path[-2] if len(path) > 1 else "")
            key = ".".join(path)
            if collection == "batch_stats" and name in ("mean", "var"):
                val = arr
            elif collection == "params" and name == "kernel" \
                    and arr.ndim == 4:
                if parent.startswith("ConvTranspose"):
                    val = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    val = arr.transpose(3, 2, 0, 1)
                key = ".".join(path[:-1] + ("weight",))
            elif collection == "params" and (
                    (name == "kernel" and arr.ndim == 3)
                    or name in ("scale", "bias")):
                val = arr
            else:
                raise ValueError(f"no conversion rule for "
                                 f"{collection}/{'/'.join(path)} "
                                 f"{arr.shape}")
            state[key] = torch.from_numpy(
                np.ascontiguousarray(val, dtype=np.float32))
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


def to_flax(state):
    """The inverse of `convert_centerpoint`: {name: tensor or array} ->
    {"params": nested numpy tree[, "batch_stats": ...]} of float32 copies
    (never views of the tensors, which may change in place)."""
    out = {}
    for key, val in state.items():
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        path = key.split(".")
        name, parent = path[-1], (path[-2] if len(path) > 1 else "")
        collection = "params"
        if name in ("mean", "var"):
            collection = "batch_stats"
        elif name == "weight" and arr.ndim == 4:
            if parent.startswith("ConvTranspose"):
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                arr = arr.transpose(2, 3, 1, 0)
            path = path[:-1] + ["kernel"]
        elif not ((name == "kernel" and arr.ndim == 3)
                  or name in ("scale", "bias")):
            raise ValueError(f"no conversion rule for {key} {arr.shape}")
        node = out.setdefault(collection, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(arr, dtype=np.float32, order="C",
                                  copy=True)
    return out
