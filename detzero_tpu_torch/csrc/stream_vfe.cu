// Stream VFE: the (cell, z)-sorted point stream -> per-voxel means in the
// row-padded transposed table (ny, nz*F, B).
//
// Replaces detzero_tpu/ops/pallas_pillar.py::stream_rowpad_feats
// (_stream_feats_kernel).  The TPU kernel reduces each BEV row's window with
// one-hot matmuls on the MXU; here the stream's order does the work: the
// points of one voxel are contiguous, so the thread that owns a run's first
// point sums the run in stream order and stores the mean.  No atomics, and
// the result is deterministic.
//
// Bound on the H100: bytes, nearly all of them the output: the flagship
// table is (1504, 200, 128) bf16, 77 MB, of which a row's ~106 points fill
// about a hundred values.  So a block owns a BEV row and builds its
// (nz*F, B) tile in shared memory (51 KB in bf16, 102 KB in float32 at the
// flagship size; a tile past kTileBudget is built in z-slabs, the window
// scanned once a slab): it zeroes the tile, walks the row's window of the
// stream (wstart[y]..wstart[y+1], contiguous) in chunks of kChunk points
// loaded with coalesced loads, and lets each run's head thread sum the run
// in float32 from the staged chunk and put the mean into the tile.  A run
// that reaches the end of a chunk hands its partial sums to the next
// chunk's first thread, which goes on adding in stream order, so a voxel of
// any size sums exactly as one serial loop would.  The hand-over buffer is
// double, by chunk parity: within one chunk thread 0 may read the sums
// carried in while another run's head writes the sums it carries out.
// Then the block writes the tile to device memory once, 16 bytes a store,
// coalesced.
#include "common.cuh"

namespace {

constexpr int kMaxF = 16;
constexpr int kThreads = 256;
constexpr int kChunk = kThreads;            // stream points a chunk
constexpr int kTileBudget = 104 * 1024;     // tile bytes a block keeps
constexpr int kNoKey = -2;                  // before the window

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A point's slot key in its row: lane * nz + z, or -1 where it selects
// nothing (lane outside [0, b), z outside [0, nz)).
__device__ __forceinline__ int slot_key(int l, int z, int b, int nz) {
  return (l >= 0 && l < b && z >= 0 && z < nz) ? l * nz + z : -1;
}

// One block per BEV row y; payload (P, f+1) f32, lane/z (P,) i32,
// wstart (ny+1,) i32, out (ny, nz*f, b).  Dynamic shared memory: the slab
// tile (slab_z * f * b T, rounded up to 16 bytes), the chunk's payload
// (kChunk * (f+1) f32) and keys (kChunk + 1 i32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stream_vfe_tile_kernel(const float* __restrict__ payload,
                           const int* __restrict__ lane,
                           const int* __restrict__ zz,
                           const int* __restrict__ wstart,
                           T* __restrict__ out, int nz, int f, int b,
                           int slab_z) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float carry[2][kMaxF + 1];  // a run's sums across chunks
  __shared__ int prev_key;               // the key before the chunk
  const int y = blockIdx.x, t = threadIdx.x, c = f + 1;
  const int tile_cap = slab_z * f * b;
  T* tile = (T*)smem;
  float* spay = (float*)(smem + ((tile_cap * (int)sizeof(T) + 15) & ~15));
  int* skey = (int*)(spay + kChunk * c);
  const int s0 = wstart[y], s1 = wstart[y + 1];
  const size_t row_elems = (size_t)nz * f * b;

  for (int z0 = 0; z0 < nz; z0 += slab_z) {
    const int z1 = min(nz, z0 + slab_z);
    const int slab_elems = (z1 - z0) * f * b;
    const int slab_bytes = slab_elems * (int)sizeof(T);
    // zero the slab tile, 16 bytes a store where the size allows
    if ((slab_bytes & 15) == 0) {
      for (int i = t; i < slab_bytes / 16; i += kThreads)
        ((uint4*)tile)[i] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int i = t; i < slab_elems; i += kThreads) put(tile + i, 0.f);
    }
    if (t == 0) prev_key = kNoKey;

    for (int c0 = s0; c0 < s1; c0 += kChunk) {
      const int n = min(kChunk, s1 - c0);
      // the sums carried into this chunk, and those it carries out
      const float* carry_in = carry[((c0 - s0) / kChunk) & 1];
      float* carry_out = carry[((c0 - s0) / kChunk + 1) & 1];
      __syncthreads();  // the previous chunk (and the zeroing) is done
      const float* src = payload + (size_t)c0 * c;
      for (int i = t; i < n * c; i += kThreads) spay[i] = src[i];
      // keys of the chunk and of the point after it (kNoKey past the end)
      for (int i = t; i <= n; i += kThreads)
        skey[i] = c0 + i < s1 ? slot_key(lane[c0 + i], zz[c0 + i], b, nz)
                              : kNoKey;
      __syncthreads();
      if (t < n) {
        const int key = skey[t];
        const int before = t == 0 ? prev_key : skey[t - 1];
        const int z = key >= 0 ? key % nz : -1;
        // a run's head, or the chunk's first point continuing the last
        // chunk's run (its sums are in carry_in)
        const bool cont = t == 0 && key == before;
        if (key >= 0 && z >= z0 && z < z1 && (cont || key != before)) {
          float acc[kMaxF];
#pragma unroll
          for (int q = 0; q < kMaxF; ++q)
            acc[q] = q < f && cont ? carry_in[q] : 0.f;
          float cnt = cont ? carry_in[f] : 0.f;
          int i = t;
          for (; i < n && skey[i] == key; ++i) {
            const float* p = spay + i * c;
#pragma unroll
            for (int q = 0; q < kMaxF; ++q)
              if (q < f) acc[q] += p[q];
            cnt += p[f];
          }
          if (i == n && skey[n] == key) {
            // the run goes on in the next chunk
#pragma unroll
            for (int q = 0; q < kMaxF; ++q)
              if (q < f) carry_out[q] = acc[q];
            carry_out[f] = cnt;
          } else {
            const float den = fmaxf(cnt, 1.f);
            const int l = key / nz;
#pragma unroll
            for (int q = 0; q < kMaxF; ++q)
              if (q < f) put(tile + ((size_t)(z - z0) * f + q) * b + l,
                             acc[q] / den);
          }
        }
      }
      if (t == 0) prev_key = skey[n - 1];
    }
    __syncthreads();  // the slab tile is complete

    // the slab to device memory, once: (z1 - z0) * f rows of b, contiguous
    T* dst = out + (size_t)y * row_elems + (size_t)z0 * f * b;
    if ((slab_bytes & 15) == 0 && ((uintptr_t)dst & 15) == 0) {
      for (int i = t; i < slab_bytes / 16; i += kThreads)
        ((uint4*)dst)[i] = ((const uint4*)tile)[i];
    } else {
      for (int i = t; i < slab_elems; i += kThreads) dst[i] = tile[i];
    }
    __syncthreads();  // before the next slab zeroes the tile
  }
}

template <typename T>
int launch(const float* payload, const int* lane, const int* z,
           const int* wstart, T* out, int ny, int nz, int f, int b,
           cudaStream_t st) {
  const int z_bytes = f * b * (int)sizeof(T);
  if (z_bytes > kTileBudget) return (int)cudaErrorInvalidValue;
  const int slab_z = min(nz, kTileBudget / z_bytes);
  const int smem = ((slab_z * z_bytes + 15) & ~15)
                   + kChunk * (f + 1) * 4 + (kChunk + 1) * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      stream_vfe_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  stream_vfe_tile_kernel<T><<<ny, kThreads, smem, st>>>(
      payload, lane, z, wstart, out, nz, f, b, slab_z);
  return dz_launch_status();
}

}  // namespace

DZ_EXPORT int dz_stream_vfe(const void* payload, const void* lane,
                            const void* z, const void* wstart, void* out,
                            int ny, int nz, int f, int b, int out_bf16,
                            void* stream) {
  if (f < 1 || f > kMaxF || nz < 1 || b < 1) return (int)cudaErrorInvalidValue;
  if (ny == 0) return dz_launch_status();
  const cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    return launch((const float*)payload, (const int*)lane, (const int*)z,
                  (const int*)wstart, (__nv_bfloat16*)out, ny, nz, f, b, s);
  return launch((const float*)payload, (const int*)lane, (const int*)z,
                (const int*)wstart, (float*)out, ny, nz, f, b, s);
}

DZ_EXPORT const char* dz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
