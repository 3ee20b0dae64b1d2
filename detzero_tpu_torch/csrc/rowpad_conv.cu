// Fused sparse 3x3x3 conv on the row-padded pillar tables, eval mode:
//   out = relu(conv(table) * scale + bias [+ residual]) * zmask   (bf16 out)
//
// Replaces detzero_tpu/ops/pallas_pillar.py::rowpad_conv_fused (_conv_kernel
// with the fused epilogue, _select, _epilogue_val).  It holds the tensor
// contract, not the TPU mechanism:
//   table    (ny_in, nz*cin, b_in)  bf16, pillars in the last dim
//   nbr      (ny_out, 16, b_out)    i32, rows 0..8 = rank of tap j's
//            neighbour inside its source BEV row; >= b_in means absent
//   w        (27, cin, cout)        bf16, spconv order k = t*9 + j
//   zmask    (ny_out, out_nz, b_out) u8
//   residual (ny_out, out_nz*cout, b_out) bf16 or null
// Source row of tap j (dy = j/3 - 1): y+dy ('subm') or 2y+dy ('down', with
// z stride 2).  Input z of tap t: z*z_stride + t - 1, zero outside [0, nz).
//
// Bound on the H100: the TPU kernel computes every slot of every row with
// dense one-hot selections and matmuls.  On the flagship scene only about
// one voxel in fifty is occupied, so the useful work is small and the
// output write (one full table per conv) dominates.  Design: one thread
// per output site (pillar lane, z) and a chunk of 16 output channels; a
// site that zmask marks empty computes nothing and stores zeros (the TPU
// kernel multiplies it by 0, which differs only for non-finite sums).  An
// occupied site gathers its 27 taps by rank straight from device memory
// (lanes of a warp read neighbouring ranks, so the loads coalesce) and
// accumulates in f32 registers; weight loads are uniform across the warp.
// No shared memory, no tensor cores yet.
#include "common.cuh"

namespace {

constexpr int kNbrRows = 16;
constexpr int kLanes = 32;  // block x: pillar lanes
constexpr int kZ = 8;       // block y: output z
constexpr int kCoT = 16;    // output channels per thread; cout % kCoT == 0

__global__ void __launch_bounds__(kLanes* kZ)
    rowpad_conv_fused_kernel(const __nv_bfloat16* __restrict__ table,
                             const int* __restrict__ nbr,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             const uint8_t* __restrict__ zmask,
                             const __nv_bfloat16* __restrict__ res,
                             __nv_bfloat16* __restrict__ out, int ny_in,
                             int nz, int cin, int b_in, int out_nz, int cout,
                             int b_out, int down, int z_stride, int relu,
                             int z_tiles) {
  const int r = blockIdx.x * kLanes + threadIdx.x;
  const int y = blockIdx.y;
  const int z = (blockIdx.z % z_tiles) * kZ + threadIdx.y;
  const int co0 = (blockIdx.z / z_tiles) * kCoT;
  if (r >= b_out || z >= out_nz) return;

  const size_t site = ((size_t)y * out_nz + z) * b_out + r;
  const bool on = zmask[site] != 0;
  float acc[kCoT];
#pragma unroll
  for (int c = 0; c < kCoT; ++c) acc[c] = 0.f;

  if (on) {
    for (int j = 0; j < 9; ++j) {
      const int rank = nbr[((size_t)y * kNbrRows + j) * b_out + r];
      if (rank < 0 || rank >= b_in) continue;
      const int dy = j / 3 - 1;
      int src = down ? 2 * y + dy : y + dy;
      src = min(max(src, 0), ny_in - 1);
      for (int t = 0; t < 3; ++t) {
        const int zi = z * z_stride + t - 1;
        if (zi < 0 || zi >= nz) continue;
        const __nv_bfloat16* xp =
            table + ((size_t)src * nz + zi) * cin * b_in + rank;
        const __nv_bfloat16* wp = w + (size_t)(t * 9 + j) * cin * cout + co0;
        for (int ci = 0; ci < cin; ++ci) {
          const float xv = __bfloat162float(xp[(size_t)ci * b_in]);
          const __nv_bfloat16* wr = wp + (size_t)ci * cout;
#pragma unroll
          for (int c = 0; c < kCoT; ++c)
            acc[c] = fmaf(xv, __bfloat162float(wr[c]), acc[c]);
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCoT; ++c) {
    const int co = co0 + c;
    const size_t o = (((size_t)y * out_nz + z) * cout + co) * b_out + r;
    float v = 0.f;
    if (on) {
      v = acc[c] * scale[co] + bias[co];
      if (res) v += __bfloat162float(res[o]);
      if (relu) v = fmaxf(v, 0.f);
    }
    out[o] = __float2bfloat16_rn(v);
  }
}

}  // namespace

DZ_EXPORT int dz_rowpad_conv_fused(const void* table, const void* nbr,
                                   const void* w, const void* scale,
                                   const void* bias, const void* zmask,
                                   const void* res, void* out, int ny_in,
                                   int nz, int cin, int b_in, int ny_out,
                                   int out_nz, int cout, int b_out, int down,
                                   int z_stride, int relu, void* stream) {
  if (ny_out > 65535 || cout % kCoT != 0) return (int)cudaErrorInvalidValue;
  if (ny_out == 0 || out_nz == 0 || b_out == 0) return dz_launch_status();
  const int z_tiles = (out_nz + kZ - 1) / kZ;
  dim3 grid((b_out + kLanes - 1) / kLanes, ny_out, z_tiles * (cout / kCoT));
  dim3 block(kLanes, kZ);
  rowpad_conv_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)table, (const int*)nbr, (const __nv_bfloat16*)w,
      (const float*)scale, (const float*)bias, (const uint8_t*)zmask,
      (const __nv_bfloat16*)res, (__nv_bfloat16*)out, ny_in, nz, cin, b_in,
      out_nz, cout, b_out, down, z_stride, relu, z_tiles);
  return dz_launch_status();
}
