// Shared helpers for the port's kernels: plain C entry points, no PyTorch
// headers.  Each entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DZ_EXPORT extern "C" __attribute__((visibility("default")))

static inline int dz_launch_status() { return (int)cudaGetLastError(); }
