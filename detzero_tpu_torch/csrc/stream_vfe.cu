// Stream VFE: the (cell, z)-sorted point stream -> per-voxel means in the
// row-padded transposed table (ny, nz*F, B).
//
// Replaces detzero_tpu/ops/pallas_pillar.py::stream_rowpad_feats
// (_stream_feats_kernel).  The TPU kernel reduces each BEV row's window with
// one-hot matmuls on the MXU; here the stream's order does the work: the
// points of one voxel are contiguous, so the thread that owns a run's first
// point sums the run in stream order and writes the mean.  No atomics, no
// shared-memory accumulator, and the result is deterministic.
//
// Bound on the H100: bytes.  Each point is read once (F+1 floats plus lane
// and z) and each output element written once; the output row (mostly empty
// slots) is zero-filled by the same block before the means land.  The sums
// stay in f32; only the stored mean is rounded to bf16.
#include "common.cuh"

namespace {

constexpr int kMaxF = 16;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// one block per BEV row y; payload (P, f+1) f32, lane/z (P,) i32,
// wstart (ny+1,) i32, out (ny, nz*f, b)
template <typename T>
__global__ void stream_vfe_kernel(const float* __restrict__ payload,
                                  const int* __restrict__ lane,
                                  const int* __restrict__ zz,
                                  const int* __restrict__ wstart,
                                  T* __restrict__ out, int nz, int f, int b) {
  const int y = blockIdx.x;
  const int row_elems = nz * f * b;
  T* orow = out + (size_t)y * row_elems;
  for (int i = threadIdx.x; i < row_elems; i += blockDim.x) store(orow + i, 0.f);
  __syncthreads();

  const int s0 = wstart[y], s1 = wstart[y + 1];
  const int c = f + 1;
  for (int i = s0 + threadIdx.x; i < s1; i += blockDim.x) {
    const int l = lane[i], z = zz[i];
    if (l < 0 || l >= b || z < 0 || z >= nz) continue;  // lane >= B: dropped
    if (i > s0 && lane[i - 1] == l && zz[i - 1] == z) continue;  // not a head
    float acc[kMaxF];
#pragma unroll
    for (int k = 0; k < kMaxF; ++k) acc[k] = 0.f;
    float cnt = 0.f;
    for (int k = i; k < s1 && lane[k] == l && zz[k] == z; ++k) {
      const float* p = payload + (size_t)k * c;
#pragma unroll
      for (int q = 0; q < kMaxF; ++q)
        if (q < f) acc[q] += p[q];
      cnt += p[f];
    }
    const float den = fmaxf(cnt, 1.f);
#pragma unroll
    for (int q = 0; q < kMaxF; ++q)
      if (q < f) store(orow + (size_t)(z * f + q) * b + l, acc[q] / den);
  }
}

}  // namespace

DZ_EXPORT int dz_stream_vfe(const void* payload, const void* lane,
                            const void* z, const void* wstart, void* out,
                            int ny, int nz, int f, int b, int out_bf16,
                            void* stream) {
  if (f < 1 || f > kMaxF) return (int)cudaErrorInvalidValue;
  if (ny == 0) return dz_launch_status();
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  if (out_bf16) {
    stream_vfe_kernel<__nv_bfloat16><<<ny, threads, 0, s>>>(
        (const float*)payload, (const int*)lane, (const int*)z,
        (const int*)wstart, (__nv_bfloat16*)out, nz, f, b);
  } else {
    stream_vfe_kernel<float><<<ny, threads, 0, s>>>(
        (const float*)payload, (const int*)lane, (const int*)z,
        (const int*)wstart, (float*)out, nz, f, b);
  }
  return dz_launch_status();
}

DZ_EXPORT const char* dz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
