"""Build the port's CUDA kernels and bind them with ctypes.

Each `csrc/*.cu` compiles in its own `nvcc` process, all started together,
and one more `nvcc` links the objects into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds).  The library
lands in `build/detzero_tpu_torch_kernels/<content hash>/` at the
root of the checkout, is built at first use and reused while the sources and
flags are unchanged.  Nothing here runs at import time.

Every C entry point launches on the stream it is given, allocates nothing,
and returns `cudaGetLastError()`; `check` turns a non-zero code into an
exception, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" \
    / "detzero_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libdetzero_tpu_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # payload, lane, z, wstart, out, ny, nz, f, b, out_bf16, stream
    "dz_stream_vfe": [_P] * 5 + [_I] * 5 + [_P],
    # table, nbr, w, scale, bias, zmask, residual, out,
    # ny_in, nz, cin, b_in, ny_out, out_nz, cout, b_out, down, z_stride,
    # relu, stream
    "dz_rowpad_conv_fused": [_P] * 8 + [_I] * 11 + [_P],
    # table, nbr, w, zmask, out,
    # ny_in, nz, cin, b_in, ny_out, out_nz, cout, b_out, mode, z_stride,
    # f32, stream
    "dz_rowpad_conv": [_P] * 5 + [_I] * 11 + [_P],
    # table, nbr, d_out, zmask, partial, out,
    # ny_in, nz, cin, b_in, ny_out, out_nz, cout, b_out, down, z_stride,
    # rows_per_chunk, stream
    "dz_rowpad_conv_dw": [_P] * 6 + [_I] * 11 + [_P],
    # table, nbr, w, zmask, out, ny, nz, cin, b_in, cout, b_out,
    # rows_per_strip, stream
    "dz_rowpad_conv_sliding": [_P] * 5 + [_I] * 7 + [_P],
    # ptrs (3 a map: xq, x_in, out), dims (5 a map: ny_out, b_out, ny_in,
    # b_in, mode), n_maps, stream
    "dz_rowpad_nbr_maps": [_P, _P, _I, _P],
    # boxes_a, boxes_b, out, scratch, n, m, iou, stream
    "dz_iou_bev": [_P] * 4 + [_I] * 3 + [_P],
    # boxes_a, boxes_b, out, n, iou, stream
    "dz_iou_bev_pairwise": [_P] * 3 + [_I] * 2 + [_P],
    # iou, valid, keep, k, thresh, stream
    "dz_nms_walk": [_P] * 3 + [_I, ctypes.c_float, _P],
}


def nvcc_path() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns its path; the compiler's resource report (-Xptxas -v) is kept
    beside it as ptxas.log."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in cu]
    cmds = [[nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    (out.parent / "ptxas.log").write_text("".join(logs))
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log[-8000:]}")
    tmp = out.with_name(f"{out.name}.{tag}")
    link = [nvcc_path(), "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(link)}\n{proc.stderr[-8000:]}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    so = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = _I
    so.dz_error_string.argtypes = [_I]
    so.dz_error_string.restype = ctypes.c_char_p
    return so


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().dz_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} after launch: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
