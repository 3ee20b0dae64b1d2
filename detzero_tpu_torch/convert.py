"""Reference weights -> the port's state_dict.

`convert_centerpoint` takes the flax variables of a reference CenterPoint
(`{"params": ..., "batch_stats": ...}` as nested dicts of numpy arrays;
neither jax nor flax is imported) and returns a state_dict for
`models.detection.centerpoint.CenterPoint`.  The port's module names are
flax's auto-names, so each leaf maps one to one:

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
    state_dict (a leftover leaf or an unfilled parameter)."""
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
        want = model.state_dict()
        missing = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        shapes = [k for k in set(want) & set(state)
                  if tuple(want[k].shape) != tuple(state[k].shape)]
        if missing or extra or shapes:
            raise ValueError(f"state_dict mismatch: unfilled {missing}, "
                             f"unconsumed {extra}, shape {sorted(shapes)}")
    return state
