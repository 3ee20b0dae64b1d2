// Sparse 3x3x3 conv on the row-padded pillar tables, one kernel for two
// entry points:
//   * K2, eval mode (dz_rowpad_conv_fused):
//       out = relu(conv(table) * scale + bias [+ residual]) * zmask
//     replaces detzero_tpu/ops/pallas_pillar.py::rowpad_conv_fused
//     (_conv_kernel with the fused epilogue, _select, _epilogue_val);
//   * K4, training (dz_rowpad_conv): the conv alone, modes 'subm', 'down'
//     and 'up'; replaces pallas_pillar.py::rowpad_conv (_conv_kernel with
//     n_epi = 0).
// Like the reference's one _conv_kernel, the mode and the epilogue are
// template parameters of one kernel.  It holds the tensor contract, not the
// TPU mechanism:
//   table    (ny_in, planes*cin, b_in) bf16 (K4 also f32, see below),
//            pillars in the last dim
//   nbr      (ny_out, 16, b_out)    i32, rows 0..8 = rank of tap j's
//            neighbour inside its source BEV row; >= b_in means absent
//   w        (27, cin, cout)        the table's type, spconv order
//            k = t*9 + j
//   zmask    (ny_out, out_nz, b_out) u8, or null for K4 (every site)
//   scale, bias (cout,) f32, residual (ny_out, out_nz*cout, b_out) bf16 or
//            null: K2 only
// Source row of tap j (dy = j/3 - 1): y+dy ('subm'), 2y+dy ('down', with z
// stride 2) or floor((y+dy)/2) ('up').  Input z of tap t: z*z_stride+t-1,
// zero outside [0, nz).  'up' is the input gradient of a strided conv:
// `table` is the forward output level with nz/2 planes, `nz` the forward
// input nz, and the input is zero-stuffed in z, so only an even z+t-1 reads
// a plane, plane (z+t-1)/2, with z stride 1.  The TPU kernel computes in
// bf16 whatever the model's dtype, and so do K2 and the bf16 K4 that the
// flagship trains with.  K4 also reads and writes float32 tables: at random
// init the training gradient of this model is so sensitive that bf16
// rounding alone leaves nothing to compare leaf by leaf, so only a float32
// model on the card can be held to the CPU reference gradient.  That
// variant departs from the TPU kernel's bf16 compute and exists for that
// check; the accumulation order is the same.
//
// Bound on the H100: the TPU kernel computes every slot of every row with
// dense one-hot selections and matmuls.  On the flagship scene only about
// one voxel in fifty is occupied, so the useful work is small and the
// output write (one full table per conv) dominates.  Design: one thread
// per output site (pillar lane, z) and a chunk of 16 output channels; a
// site that zmask marks empty computes nothing and stores zeros (the TPU
// kernel multiplies it by 0, which differs only for non-finite sums; in
// training the model masks every such site right after the conv, so K4's
// skipped sites are never read).  An occupied site gathers its 27 taps by
// rank straight from device memory (lanes of a warp read neighbouring
// ranks, so the loads coalesce) and accumulates in f32 registers; weight
// loads are uniform across the warp.  No shared memory, no tensor cores yet.
#include "common.cuh"

namespace {

constexpr int kNbrRows = 16;
constexpr int kLanes = 32;  // block x: pillar lanes
constexpr int kZ = 8;       // block y: output z
constexpr int kCoT = 16;    // output channels per thread; cout % kCoT == 0

enum Mode { kSubm = 0, kDown = 1, kUp = 2 };

template <int kMode>
__device__ __forceinline__ int source_row(int y, int dy) {
  if (kMode == kSubm) return y + dy;
  if (kMode == kDown) return 2 * y + dy;
  const int s = y + dy;  // floor((y + dy) / 2); -1 is clamped, nbr absent
  return s >= 0 ? s / 2 : -1;
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename T, int kMode, bool kEpilogue>
__global__ void __launch_bounds__(kLanes* kZ)
    rowpad_conv_kernel(const T* __restrict__ table,
                       const int* __restrict__ nbr,
                       const T* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const uint8_t* __restrict__ zmask,
                       const T* __restrict__ res,
                       T* __restrict__ out, int ny_in, int nz,
                       int cin, int b_in, int out_nz, int cout, int b_out,
                       int z_stride, int relu, int z_tiles) {
  const int r = blockIdx.x * kLanes + threadIdx.x;
  const int y = blockIdx.y;
  const int z = (blockIdx.z % z_tiles) * kZ + threadIdx.y;
  const int co0 = (blockIdx.z / z_tiles) * kCoT;
  if (r >= b_out || z >= out_nz) return;

  const size_t site = ((size_t)y * out_nz + z) * b_out + r;
  const bool on = zmask == nullptr || zmask[site] != 0;
  const int planes = kMode == kUp ? nz / 2 : nz;
  float acc[kCoT];
#pragma unroll
  for (int c = 0; c < kCoT; ++c) acc[c] = 0.f;

  if (on) {
    for (int j = 0; j < 9; ++j) {
      const int rank = nbr[((size_t)y * kNbrRows + j) * b_out + r];
      if (rank < 0 || rank >= b_in) continue;
      int src = source_row<kMode>(y, j / 3 - 1);
      src = min(max(src, 0), ny_in - 1);
      for (int t = 0; t < 3; ++t) {
        int zi = z * z_stride + t - 1;
        if (zi < 0 || zi >= nz) continue;
        if (kMode == kUp) {
          if (zi & 1) continue;  // a zero-stuffed plane
          zi >>= 1;
        }
        const T* xp = table + ((size_t)src * planes + zi) * cin * b_in + rank;
        const T* wp = w + (size_t)(t * 9 + j) * cin * cout + co0;
        for (int ci = 0; ci < cin; ++ci) {
          const float xv = to_f(xp[(size_t)ci * b_in]);
          const T* wr = wp + (size_t)ci * cout;
#pragma unroll
          for (int c = 0; c < kCoT; ++c)
            acc[c] = fmaf(xv, to_f(wr[c]), acc[c]);
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCoT; ++c) {
    const int co = co0 + c;
    const size_t o = (((size_t)y * out_nz + z) * cout + co) * b_out + r;
    float v = acc[c];  // 0 at an empty site
    if (kEpilogue && on) {
      v = v * scale[co] + bias[co];
      if (res) v += to_f(res[o]);
      if (relu) v = fmaxf(v, 0.f);
    }
    store(out + o, v);
  }
}

template <typename T, int kMode, bool kEpilogue>
int launch(const void* table, const void* nbr, const void* w,
           const void* scale, const void* bias, const void* zmask,
           const void* res, void* out, int ny_in, int nz, int cin, int b_in,
           int ny_out, int out_nz, int cout, int b_out, int z_stride,
           int relu, void* stream) {
  if (ny_out > 65535 || cout % kCoT != 0) return (int)cudaErrorInvalidValue;
  if (ny_out == 0 || out_nz == 0 || b_out == 0) return dz_launch_status();
  const int z_tiles = (out_nz + kZ - 1) / kZ;
  dim3 grid((b_out + kLanes - 1) / kLanes, ny_out, z_tiles * (cout / kCoT));
  dim3 block(kLanes, kZ);
  rowpad_conv_kernel<T, kMode, kEpilogue>
      <<<grid, block, 0, (cudaStream_t)stream>>>(
          (const T*)table, (const int*)nbr, (const T*)w, (const float*)scale,
          (const float*)bias, (const uint8_t*)zmask, (const T*)res, (T*)out,
          ny_in, nz, cin, b_in, out_nz, cout, b_out, z_stride, relu,
          z_tiles);
  return dz_launch_status();
}

// K4's launcher for a mode
template <typename T>
decltype(&launch<T, kSubm, false>) conv_launcher(int mode) {
  return mode == kSubm   ? launch<T, kSubm, false>
         : mode == kDown ? launch<T, kDown, false>
                         : launch<T, kUp, false>;
}

}  // namespace

// K2: down selects 'down' (else 'subm'); zmask is required
DZ_EXPORT int dz_rowpad_conv_fused(const void* table, const void* nbr,
                                   const void* w, const void* scale,
                                   const void* bias, const void* zmask,
                                   const void* res, void* out, int ny_in,
                                   int nz, int cin, int b_in, int ny_out,
                                   int out_nz, int cout, int b_out, int down,
                                   int z_stride, int relu, void* stream) {
  if (zmask == nullptr) return (int)cudaErrorInvalidValue;
  using B = __nv_bfloat16;
  auto fn = down ? launch<B, kDown, true> : launch<B, kSubm, true>;
  return fn(table, nbr, w, scale, bias, zmask, res, out, ny_in, nz, cin,
            b_in, ny_out, out_nz, cout, b_out, z_stride, relu, stream);
}

// K4: mode 0 'subm', 1 'down', 2 'up' (nz even); f32: table, w and out are
// float32 (else bf16)
DZ_EXPORT int dz_rowpad_conv(const void* table, const void* nbr,
                             const void* w, const void* zmask, void* out,
                             int ny_in, int nz, int cin, int b_in, int ny_out,
                             int out_nz, int cout, int b_out, int mode,
                             int z_stride, int f32, void* stream) {
  if (mode < kSubm || mode > kUp || (mode == kUp && nz % 2 != 0))
    return (int)cudaErrorInvalidValue;
  auto fn = f32 ? conv_launcher<float>(mode)
                : conv_launcher<__nv_bfloat16>(mode);
  return fn(table, nbr, w, nullptr, nullptr, zmask, nullptr, out, ny_in, nz,
            cin, b_in, ny_out, out_nz, cout, b_out, z_stride, 0, stream);
}
