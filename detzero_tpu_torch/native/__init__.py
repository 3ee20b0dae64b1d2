"""Native (C++) host runtime: threaded point-cloud loading and per-box
point cropping (port of detzero_tpu/native/__init__.py).

The hot host loop of the sweep loader (npy decode -> NLZ filter -> tanh
intensity -> pose transform -> time channel -> fixed-budget padding), the
offboard cropper's points-in-boxes scan and TFRecord's masked CRC-32C are
`loader.cpp`, a small C++ library driven through ctypes.  It is built
with g++ at first use (about 1 s) into
`build/detzero_tpu_torch_native/<content hash>/` at the root of the
checkout, never next to the source: the build writes a temporary name and
renames it into place, so processes that build at once never load half a
library.  `available()` says whether it builds and loads, as the
reference's does; callers that must take the native path call the loaders
directly, which raise when it does not.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" \
    / "detzero_tpu_torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libdetzero_loader.so"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile loader.cpp unless the library for this source exists;
    returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stderr[-8000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.load_merged_sample.restype = ctypes.c_int64
    lib.load_batch.restype = ctypes.c_int32
    lib.crop_points_multi.restype = ctypes.c_int64
    lib.masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.masked_crc32c.restype = ctypes.c_uint32
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def load_merged_sample(paths, rels, dts, out_stride: int, budget: int,
                       nlz_col: int = 5, intensity_col: int = 3):
    """paths: list of .npy files (current frame first); rels: (S, 4, 4)
    transforms into the current frame; dts: (S,) time offsets.
    Returns (points (budget, out_stride) float32, n_valid int)."""
    lib = _load()
    s = len(paths)
    arr = (ctypes.c_char_p * s)(*[str(p).encode() for p in paths])
    rels = np.ascontiguousarray(rels, np.float32).reshape(s * 16)
    dts = np.ascontiguousarray(dts, np.float32)
    out = np.zeros((budget, out_stride), np.float32)
    n = lib.load_merged_sample(
        arr, ctypes.c_int64(s),
        rels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(nlz_col), ctypes.c_int(intensity_col),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(out_stride), ctypes.c_int64(budget))
    if n < 0:
        raise IOError(f"native loader failed reading {paths}")
    return out, int(n)


def load_batch(batch_paths, batch_rels, batch_dts, out_stride: int,
               budget: int, nlz_col: int = 5, intensity_col: int = 3,
               n_threads: int = 8):
    """batch_paths: list (per sample) of lists of .npy paths. Returns
    (points (B, budget, stride), valid_mask (B, budget))."""
    lib = _load()
    b = len(batch_paths)
    max_s = max(len(p) for p in batch_paths)
    flat = []
    sweeps = np.zeros(b, np.int64)
    rels = np.zeros((b, max_s, 16), np.float32)
    dts = np.zeros((b, max_s), np.float32)
    for i, ps in enumerate(batch_paths):
        sweeps[i] = len(ps)
        for j, p in enumerate(ps):
            flat.append(str(p).encode())
            rels[i, j] = np.asarray(batch_rels[i][j], np.float32).reshape(16)
            dts[i, j] = batch_dts[i][j]
        flat.extend([b""] * (max_s - len(ps)))
    arr = (ctypes.c_char_p * len(flat))(*flat)
    out = np.zeros((b, budget, out_stride), np.float32)
    n_valid = np.zeros(b, np.int64)
    rc = lib.load_batch(
        arr, sweeps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(b), ctypes.c_int64(max_s),
        rels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(nlz_col), ctypes.c_int(intensity_col),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(out_stride), ctypes.c_int64(budget),
        n_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_threads))
    if rc != 0:
        raise IOError("native batch loader failed")
    mask = np.arange(budget)[None, :] < n_valid[:, None]
    return out, mask


def masked_crc32c(data) -> int:
    """TFRecord's masked CRC-32C of `data` (bytes-like).  Raises where the
    library cannot be built: there is no Python fallback."""
    data = bytes(data)
    return int(_load().masked_crc32c(data, len(data)))


def crop_points_multi(points, boxes, enlarge: float = 1.1,
                      n_threads: int = 8):
    """Per-box rotated crop of one frame's points (global coords).

    points (N, F>=3) float32; boxes (M, 7). Returns a list of M arrays:
    the points inside each `enlarge`-times box, with the semantics of
    ops/box_np.points_in_rotated_box (same epsilon, z from the box
    centre).  Threaded C++ over boxes.
    """
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    bxs = np.ascontiguousarray(np.asarray(boxes, np.float32)[:, :7])
    n, stride = pts.shape if pts.ndim == 2 else (0, 3)
    m = len(bxs)
    if m == 0:
        return []
    counts = np.zeros(m, np.int64)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int64)
    total = lib.crop_points_multi(
        pts.ctypes.data_as(fp), ctypes.c_int64(n), ctypes.c_int64(stride),
        bxs.ctypes.data_as(fp), ctypes.c_int64(m), ctypes.c_double(enlarge),
        None, None, counts.ctypes.data_as(ip), ctypes.c_int64(n_threads))
    offsets = np.zeros(m, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    out = np.zeros((max(int(total), 1), stride), np.float32)
    lib.crop_points_multi(
        pts.ctypes.data_as(fp), ctypes.c_int64(n), ctypes.c_int64(stride),
        bxs.ctypes.data_as(fp), ctypes.c_int64(m), ctypes.c_double(enlarge),
        offsets.ctypes.data_as(ip), out.ctypes.data_as(fp),
        counts.ctypes.data_as(ip), ctypes.c_int64(n_threads))
    return [out[offsets[j]: offsets[j] + counts[j]].copy()
            for j in range(m)]
