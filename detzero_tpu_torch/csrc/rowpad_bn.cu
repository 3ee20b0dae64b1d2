// K11: the train-mode epilogue of the row-pad 3x3x3 convs (masked batch
// statistics BN, affine, ReLU, zmask and residual), forward and backward.
//
// Replaces no TPU kernel: the JAX package leaves this glue to XLA, which
// fuses it on the TPU.  In PyTorch it was some 15 float32 ops forward and 25
// backward over the whole dense (ny, nz, C, B) table, each reading and
// writing it (about 88 and 110 bytes an element): 0.72 s of card time in 4
// steps of the batch-2 flagship step.  It moves a few bytes an element and
// does a few operations each, so it is bound by device memory; the design
// moves as few bytes as it can:
//   * each pass reads the table once, in 16-byte loads (8 slots of a
//     channel a thread), and reads the conv output (and the gradient) only
//     on the 8-slot groups whose zmask has a site set: a row's pillars sit
//     in its first slots, so most groups are empty and are skipped, or
//     written as zeros without a read;
//   * statistics: a block walks a fixed run of (row, z) lines and sums in
//     float32 per thread, then per channel over its threads, into its row
//     of a partial-sum workspace; a second small kernel adds the rows in a
//     fixed order.  No float atomics, so two launches give the same bits;
//   * apply: each thread derives mean and rstd (backward: the gradient's
//     coefficients) of its channels from the summed statistics, so an
//     all-reduce of the packed sums between the two kernels (data
//     parallelism) needs no third kernel; block 0 writes them out;
//   * the rounding points are those of the torch ops it replaces (the BN
//     in float32, rounded to the table's dtype, then ReLU, zmask and the
//     residual add rounded again), with the float32 operations in their
//     order and unfused (__f*_rn), so that fed the same statistics the
//     apply kernels give the plain version's values.
// The backward needs only the conv output y, the output `out` and the zmask:
// every ReLU of the train path masks by out > 0 (the act ReLU, out being 0
// at empty sites, and the residual ReLU), so g_bn = g_out [out > 0] m.
//
// Tensor contract:
//   y, out, residual, g_out, dx, d_res  (ny, onz*C, B), bf16 or f32
//   zmask  (ny, zm_nz, B) bool, its first onz planes read; B % 8 == 0
//   scale, bias  (C,) f32
//   packed  forward (cnt, s[C], ss[C]); backward (sum_g[C], sum_gx[C])
//   stats  (4, C): mean, var, rstd, cnt (clamped to 1)
//   grads  (2, C): the scale and bias gradients (this rank's sums)
#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // a block's threads where K fits
constexpr int kMaxThreads = 512;  // where K would not fit at 256
constexpr int kMaxK = 8;          // channels a thread holds
constexpr float kEps = 1e-3f;

// A thread owns 8 slots (`sg`) of K channels c0, c0 + cpp, ...: vpc = B / 8
// threads cover a channel's slots, cpp channels a pass over a line.
struct Geo {
  int lines, onz, c, b, zm_nz, vpc, cpp, k;
};

__host__ __device__ inline Geo make_geo(int ny, int onz, int c, int b,
                                        int zm_nz) {
  Geo g;
  g.lines = ny * onz;
  g.onz = onz;
  g.c = c;
  g.b = b;
  g.zm_nz = zm_nz;
  g.vpc = b / 8;
  g.cpp = g.vpc >= kThreads ? 1 : kThreads / g.vpc;
  const int need = (c + kMaxK - 1) / kMaxK;  // channels a pass for K <= 8
  if (g.cpp < need && g.vpc > 0) {
    const int most = kMaxThreads / g.vpc;
    g.cpp = need < most ? need : most;
  }
  g.k = (c + g.cpp - 1) / g.cpp;
  return g;
}

// the sums kernel's shared memory: two kMaxK x threads float arrays and a
// count a thread
inline size_t sums_smem(const Geo& g) {
  return (size_t)g.vpc * g.cpp * (2 * kMaxK * sizeof(float) + sizeof(int));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void zero8(float v[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
}

// the value as the table's dtype holds it
__device__ __forceinline__ float rounded(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rounded(float x, const float*) { return x; }

// torch.relu: NaN stays NaN
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// the 8 zmask bytes (0 or 1) of a thread's slots on line l
__device__ __forceinline__ uint64_t mask_word(const uint8_t* zm, const Geo& g,
                                             int l, int sg) {
  const int row = l / g.onz, z = l - row * g.onz;
  return *reinterpret_cast<const uint64_t*>(
      zm + ((size_t)row * g.zm_nz + z) * g.b + sg * 8);
}

__device__ __forceinline__ bool site(uint64_t bits, int i) {
  return (bits >> (8 * i)) & 0xff;
}

// Per-channel sums over the occupied sites of a run of lines, one row of
// `partial` a block.  Forward (kGrad false): cnt, sum m y, sum m y^2.
// Backward: sum g_bn, sum g_bn y with g_bn = g [out > 0 if relu_mask] m.
template <typename T, bool kGrad>
__global__ void __launch_bounds__(kMaxThreads)
    rowpad_bn_sums_kernel(const T* __restrict__ y, const T* __restrict__ g,
                          const T* __restrict__ o,
                          const uint8_t* __restrict__ zm,
                          float* __restrict__ partial, const Geo geo,
                          int lines_per_block, int relu_mask) {
  extern __shared__ float sh[];  // [2][kMaxK][threads] floats, then counts
  const int nt = blockDim.x;
  float* sh1 = sh;
  float* sh2 = sh + kMaxK * nt;
  int* shn = reinterpret_cast<int*>(sh + 2 * kMaxK * nt);
  const int t = threadIdx.x, sg = t % geo.vpc, c0 = t / geo.vpc;
  const int l0 = blockIdx.x * lines_per_block;
  const int l1 = min(l0 + lines_per_block, geo.lines);
  const size_t line = (size_t)geo.c * geo.b;
  float a1[kMaxK], a2[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) a1[k] = a2[k] = 0.f;
  int n = 0;
  for (int l = l0; l < l1; ++l) {
    const uint64_t bits = mask_word(zm, geo, l, sg);
    if (!bits) continue;
    n += __popcll(bits);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const int c = c0 + k * geo.cpp;
      if (k >= geo.k || c >= geo.c) continue;
      const size_t off = l * line + (size_t)c * geo.b + sg * 8;
      float x[8];
      load8(y + off, x);
      if (kGrad) {
        float gv[8], ov[8];
        load8(g + off, gv);
        if (relu_mask) load8(o + off, ov);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool live = site(bits, i) && !(relu_mask && ov[i] <= 0.f);
          const float gb = live ? gv[i] : 0.f;
          a1[k] += gb;
          a2[k] += gb * x[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xm = site(bits, i) ? x[i] : 0.f;
          a1[k] += xm;
          a2[k] += xm * x[i];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    sh1[k * nt + t] = a1[k];
    sh2[k * nt + t] = a2[k];
  }
  shn[t] = c0 == 0 ? n : 0;  // each slot group counted once
  __syncthreads();
  const int ncol = kGrad ? 2 * geo.c : 2 * geo.c + 1;
  float* row = partial + (size_t)blockIdx.x * ncol + (kGrad ? 0 : 1);
  for (int c = t; c < geo.c; c += blockDim.x) {
    const int k = c / geo.cpp, first = (c % geo.cpp) * geo.vpc;
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < geo.vpc; ++j) {
      s1 += sh1[k * nt + first + j];
      s2 += sh2[k * nt + first + j];
    }
    row[c] = s1;
    row[geo.c + c] = s2;
  }
  if (!kGrad && t == 0) {
    int cnt = 0;
    for (int j = 0; j < geo.vpc; ++j) cnt += shn[j];
    row[-1] = (float)cnt;
  }
}

// packed[j] = sum over the rows of partial[:, j], 32 columns a block: 32
// threads a column each add every 32nd row, then one adds their 32 sums,
// all in a fixed order.
__global__ void __launch_bounds__(1024)
    rowpad_bn_reduce_kernel(const float* __restrict__ partial,
                            float* __restrict__ packed, int rows, int ncol) {
  __shared__ float sh[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (j < ncol)
    for (int r = ty; r < rows; r += 32) acc += partial[(size_t)r * ncol + j];
  sh[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < ncol) {
    float s = 0.f;
    for (int q = 0; q < 32; ++q) s += sh[q][tx];
    packed[j] = s;
  }
}

// out = relu?(bn(y)) at occupied sites, 0 elsewhere; with a residual
// relu(out + residual), each rounded to T where the torch ops round.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rowpad_bn_apply_kernel(const T* __restrict__ y,
                           const uint8_t* __restrict__ zm,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ packed,
                           const T* __restrict__ res, T* __restrict__ out,
                           float* __restrict__ stats, const Geo geo,
                           int act) {
  const int t = threadIdx.x, sg = t % geo.vpc, c0 = t / geo.vpc;
  const size_t line = (size_t)geo.c * geo.b;
  float mean[kMaxK], rstd[kMaxK], sc[kMaxK], bi[kMaxK];
  const float cnt = fmaxf(packed[0], 1.f);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    const int c = c0 + k * geo.cpp;
    mean[k] = rstd[k] = sc[k] = bi[k] = 0.f;
    if (k >= geo.k || c >= geo.c) continue;
    mean[k] = __fdiv_rn(packed[1 + c], cnt);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(packed[1 + geo.c + c], cnt),
                                      __fmul_rn(mean[k], mean[k])),
                            0.f);
    rstd[k] = __frcp_rn(__fsqrt_rn(__fadd_rn(var, kEps)));
    sc[k] = scale[c];
    bi[k] = bias[c];
    if (blockIdx.x == 0 && sg == 0) {
      stats[c] = mean[k];
      stats[geo.c + c] = var;
      stats[2 * geo.c + c] = rstd[k];
      stats[3 * geo.c + c] = cnt;
    }
  }
  for (int l = blockIdx.x; l < geo.lines; l += gridDim.x) {
    const uint64_t bits = mask_word(zm, geo, l, sg);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const int c = c0 + k * geo.cpp;
      if (k >= geo.k || c >= geo.c) continue;
      const size_t off = l * line + (size_t)c * geo.b + sg * 8;
      float v[8], r[8];
      if (res) load8(res + off, r);
      if (bits) {
        load8(y + off, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float b = __fmul_rn(__fsub_rn(v[i], mean[k]), rstd[k]);
          b = rounded(__fadd_rn(__fmul_rn(b, sc[k]), bi[k]), y);
          if (act) b = relu(b);
          v[i] = site(bits, i) ? b : 0.f;
        }
      } else {
        zero8(v);
      }
      if (res) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = relu(rounded(__fadd_rn(v[i], r[i]), y));
      }
      store8(out + off, v);
    }
  }
}

// dx = a g_bn + ((d_mean + 2 y d_var) / cnt) m, d_res = g [out > 0], with
// the coefficients from the summed (tot) statistics; block 0 also writes
// the scale and bias gradients from this rank's (local) sums.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rowpad_bn_grad_apply_kernel(
        const T* __restrict__ g, const T* __restrict__ o,
        const T* __restrict__ y, const uint8_t* __restrict__ zm,
        const float* __restrict__ scale, const float* __restrict__ stats,
        const float* __restrict__ local, const float* __restrict__ tot,
        T* __restrict__ dx, T* __restrict__ dres, float* __restrict__ grads,
        const Geo geo, int relu_mask) {
  const int t = threadIdx.x, sg = t % geo.vpc, c0 = t / geo.vpc;
  const size_t line = (size_t)geo.c * geo.b;
  const int C = geo.c;
  float a[kMaxK], dvar[kMaxK], dmean[kMaxK];
  const float cnt = stats[3 * C];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    const int c = c0 + k * geo.cpp;
    a[k] = dvar[k] = dmean[k] = 0.f;
    if (k >= geo.k || c >= C) continue;
    const float mean = stats[c], rstd = stats[2 * C + c], sc = scale[c];
    const float tot_g = tot[c];
    const float tot_gxhat =
        __fmul_rn(rstd, __fsub_rn(tot[C + c], __fmul_rn(mean, tot_g)));
    a[k] = __fmul_rn(sc, rstd);
    dvar[k] = __fmul_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, sc), rstd), rstd), tot_gxhat);
    dmean[k] = __fsub_rn(__fmul_rn(-a[k], tot_g),
                         __fmul_rn(__fmul_rn(2.f, mean), dvar[k]));
    if (blockIdx.x == 0 && sg == 0) {
      grads[c] = __fmul_rn(
          rstd, __fsub_rn(local[C + c], __fmul_rn(mean, local[c])));
      grads[C + c] = local[c];
    }
  }
  for (int l = blockIdx.x; l < geo.lines; l += gridDim.x) {
    const uint64_t bits = mask_word(zm, geo, l, sg);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const int c = c0 + k * geo.cpp;
      if (k >= geo.k || c >= C) continue;
      const size_t off = l * line + (size_t)c * geo.b + sg * 8;
      float gv[8], ov[8], d[8];
      if (bits) {
        load8(g + off, gv);
        load8(y + off, d);
        if (relu_mask || dres) load8(o + off, ov);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool m = site(bits, i);
          const float gb =
              m && !(relu_mask && ov[i] <= 0.f) ? gv[i] : 0.f;
          float per = __fadd_rn(dmean[k], __fmul_rn(__fmul_rn(2.f, d[i]),
                                                    dvar[k]));
          per = __fmul_rn(__fdiv_rn(per, cnt), m ? 1.f : 0.f);
          d[i] = __fadd_rn(__fmul_rn(a[k], gb), per);
        }
        store8(dx + off, d);
      } else {
        zero8(d);
        store8(dx + off, d);
        if (!dres) continue;
        // an empty group's out is relu(residual): read the gradient only
        // where that is positive
        load8(o + off, ov);
        bool any = false;
#pragma unroll
        for (int i = 0; i < 8; ++i) any |= !(ov[i] <= 0.f);
        if (any) load8(g + off, gv);
        else zero8(gv);
      }
      if (dres) {
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = ov[i] <= 0.f ? 0.f : gv[i];
        store8(dres + off, d);
      }
    }
  }
}

constexpr int kApplyBlocks = 2048;

int sums_grid(const Geo& geo, int max_blocks, int* lines_per_block) {
  *lines_per_block = (geo.lines + max_blocks - 1) / max_blocks;
  return (geo.lines + *lines_per_block - 1) / *lines_per_block;
}

template <typename T, bool kGrad>
int launch_sums(const void* y, const void* g, const void* o, const void* zm,
                float* partial, float* packed, const Geo& geo,
                int max_blocks, int relu_mask, cudaStream_t st) {
  int lpb;
  const int grid = sums_grid(geo, max_blocks, &lpb);
  rowpad_bn_sums_kernel<T, kGrad>
      <<<grid, geo.vpc * geo.cpp, sums_smem(geo), st>>>(
      (const T*)y, (const T*)g, (const T*)o, (const uint8_t*)zm, partial, geo,
      lpb, relu_mask);
  int rc = dz_launch_status();
  if (rc != 0) return rc;
  const int ncol = kGrad ? 2 * geo.c : 2 * geo.c + 1;
  rowpad_bn_reduce_kernel<<<(ncol + 31) / 32, dim3(32, 32), 0, st>>>(
      partial, packed, grid, ncol);
  return dz_launch_status();
}

bool valid(int ny, int onz, int c, int b, int zm_nz) {
  if (ny < 1 || onz < 1 || c < 1 || b < 8 || b % 8 || zm_nz < onz)
    return false;
  const Geo geo = make_geo(ny, onz, c, b, zm_nz);
  return geo.k <= kMaxK && geo.vpc * geo.cpp <= kMaxThreads;
}

}  // namespace

// Statistics pass (two launches): packed = (cnt, sum m y, sum m y^2);
// partial holds max_blocks rows of 2C + 1.
DZ_EXPORT int dz_rowpad_bn_stats(const void* y, const void* zmask,
                                 void* partial, void* packed, int ny, int onz,
                                 int c, int b, int zm_nz, int max_blocks,
                                 int f32, void* stream) {
  if (!valid(ny, onz, c, b, zm_nz) || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Geo geo = make_geo(ny, onz, c, b, zm_nz);
  auto st = (cudaStream_t)stream;
  return f32 ? launch_sums<float, false>(y, y, y, zmask, (float*)partial,
                                         (float*)packed, geo, max_blocks, 0,
                                         st)
             : launch_sums<__nv_bfloat16, false>(
                   y, y, y, zmask, (float*)partial, (float*)packed, geo,
                   max_blocks, 0, st);
}

// Apply pass (one launch): out, and stats (4, C) from packed.
DZ_EXPORT int dz_rowpad_bn_apply(const void* y, const void* zmask,
                                 const void* scale, const void* bias,
                                 const void* packed, const void* residual,
                                 void* out, void* stats, int ny, int onz,
                                 int c, int b, int zm_nz, int act, int f32,
                                 void* stream) {
  if (!valid(ny, onz, c, b, zm_nz)) return (int)cudaErrorInvalidValue;
  const Geo geo = make_geo(ny, onz, c, b, zm_nz);
  const int grid = min(geo.lines, kApplyBlocks);
  auto st = (cudaStream_t)stream;
  if (f32)
    rowpad_bn_apply_kernel<float><<<grid, geo.vpc * geo.cpp, 0, st>>>(
        (const float*)y, (const uint8_t*)zmask, (const float*)scale,
        (const float*)bias, (const float*)packed, (const float*)residual,
        (float*)out, (float*)stats, geo, act);
  else
    rowpad_bn_apply_kernel<__nv_bfloat16>
        <<<grid, geo.vpc * geo.cpp, 0, st>>>(
            (const __nv_bfloat16*)y, (const uint8_t*)zmask,
            (const float*)scale, (const float*)bias, (const float*)packed,
            (const __nv_bfloat16*)residual, (__nv_bfloat16*)out,
            (float*)stats, geo, act);
  return dz_launch_status();
}

// Backward reduce pass (two launches): packed = (sum g_bn, sum g_bn y);
// partial holds max_blocks rows of 2C.
DZ_EXPORT int dz_rowpad_bn_grad_sums(const void* g_out, const void* out,
                                     const void* y, const void* zmask,
                                     void* partial, void* packed, int ny,
                                     int onz, int c, int b, int zm_nz,
                                     int max_blocks, int relu_mask, int f32,
                                     void* stream) {
  if (!valid(ny, onz, c, b, zm_nz) || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Geo geo = make_geo(ny, onz, c, b, zm_nz);
  auto st = (cudaStream_t)stream;
  return f32 ? launch_sums<float, true>(y, g_out, out, zmask,
                                        (float*)partial, (float*)packed, geo,
                                        max_blocks, relu_mask, st)
             : launch_sums<__nv_bfloat16, true>(
                   y, g_out, out, zmask, (float*)partial, (float*)packed,
                   geo, max_blocks, relu_mask, st);
}

// Backward apply pass (one launch): dx, d_res (null: no residual), grads
// from `local`, the input gradient's coefficients from `tot` (the same
// buffer without a process group).
DZ_EXPORT int dz_rowpad_bn_grad_apply(
    const void* g_out, const void* out, const void* y, const void* zmask,
    const void* scale, const void* stats, const void* local,
    const void* tot, void* dx, void* d_res, void* grads, int ny, int onz,
    int c, int b, int zm_nz, int relu_mask, int f32, void* stream) {
  if (!valid(ny, onz, c, b, zm_nz)) return (int)cudaErrorInvalidValue;
  const Geo geo = make_geo(ny, onz, c, b, zm_nz);
  const int grid = min(geo.lines, kApplyBlocks);
  auto st = (cudaStream_t)stream;
  if (f32)
    rowpad_bn_grad_apply_kernel<float><<<grid, geo.vpc * geo.cpp, 0, st>>>(
        (const float*)g_out, (const float*)out, (const float*)y,
        (const uint8_t*)zmask, (const float*)scale, (const float*)stats,
        (const float*)local, (const float*)tot, (float*)dx, (float*)d_res,
        (float*)grads, geo, relu_mask);
  else
    rowpad_bn_grad_apply_kernel<__nv_bfloat16>
        <<<grid, geo.vpc * geo.cpp, 0, st>>>(
            (const __nv_bfloat16*)g_out, (const __nv_bfloat16*)out,
            (const __nv_bfloat16*)y, (const uint8_t*)zmask,
            (const float*)scale, (const float*)stats, (const float*)local,
            (const float*)tot, (__nv_bfloat16*)dx, (__nv_bfloat16*)d_res,
            (float*)grads, geo, relu_mask);
  return dz_launch_status();
}
