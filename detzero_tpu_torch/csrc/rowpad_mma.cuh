// Helpers shared by the tensor-core row-pad conv kernels (K2/K4 in
// rowpad_conv.cu, K5 in rowpad_conv_dw.cu): the compaction of a row's
// occupied sites and the bf16 m16n8k16 MMA.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNbrRows = 16;  // rows of a neighbour map; 0..8 are the taps
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper

// Appends the indices i < n of one row's occupied sites (zrow[i] != 0, or
// every site when zrow is null) to `list` in increasing order and returns
// their count.  Every thread of the block calls it; it ends on a barrier
// whenever n > 0.  A thread reads 16 zmask bytes a pass (one 16-byte load
// where the address allows it); `warp_cnt` holds one int per warp.
__device__ int compact_row(const uint8_t* __restrict__ zrow, int n,
                           uint16_t* list, int* warp_cnt) {
  constexpr int kPer = 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  int total = 0;
  for (int base = 0; base < n; base += kPer * blockDim.x) {
    const int i0 = base + kPer * tid;
    unsigned bits = 0;
    if (zrow == nullptr) {
      bits = i0 >= n ? 0u : i0 + kPer <= n ? 0xffffu : (1u << (n - i0)) - 1u;
    } else if (i0 + kPer <= n &&
               (reinterpret_cast<uintptr_t>(zrow + i0) & 15) == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(zrow + i0);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int e = 0; e < kPer; ++e) bits |= (b[e] != 0 ? 1u : 0u) << e;
    } else {
      for (int e = 0; e < kPer && i0 + e < n; ++e)
        bits |= (zrow[i0 + e] != 0 ? 1u : 0u) << e;
    }
    const int c = __popc(bits);
    int incl = c;  // inclusive prefix count over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_cnt[warp] = incl;
    __syncthreads();
    int off = total + incl - c, sum = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int v = warp_cnt[w];
      if (w < warp) off += v;
      sum += v;
    }
    for (unsigned b = bits; b != 0u; b &= b - 1u)
      list[off++] = (uint16_t)(i0 + __ffs(b) - 1);
    total += sum;
    __syncthreads();  // warp_cnt is rewritten by the next pass
  }
  return total;
}

// d += a * b for one m16n8k16 tile: bf16 inputs, f32 accumulators.
// Fragments (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4, q = lane % 4:
// a[0] (row g, cols 2q, 2q+1), a[1] row g+8, a[2] cols +8, a[3] both;
// b0 (rows 2q, 2q+1 of col g), b1 rows +8; d[0..1] (row g, cols 2q, 2q+1),
// d[2..3] row g+8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two consecutive bf16 of shared memory (an even element offset)
__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the position of the set bit of `mask` that has q set bits below it
__device__ __forceinline__ int nth_bit(unsigned mask, int q) {
  for (int i = 0; i < q; ++i) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

// eight consecutive bf16 of device memory: one 16-byte load where the
// address allows it
__device__ __forceinline__ uint4 load8(const bf16* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const uint4*>(p);
  uint4 v;
  unsigned short* d = reinterpret_cast<unsigned short*>(&v);
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = s[i];
  return v;
}

// the dynamic shared memory a kernel may take: raised to the card's maximum
// when the launch needs more than the default 48 KB
template <typename F>
int allow_smem(F* kernel, size_t bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
