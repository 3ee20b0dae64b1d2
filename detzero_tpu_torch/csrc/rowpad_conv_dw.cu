// Weight gradient of the row-padded sparse 3x3x3 conv (K5).
//
// Replaces detzero_tpu/ops/pallas_pillar.py::rowpad_conv_dw (_dw_kernel),
// returning the spconv-order (27, cin, cout) layout of its dw_to_spconv.
// Tensor contract (that of the conv in rowpad_conv.cu, modes 'subm' and
// 'down'):
//   table (ny_in, nz*cin, b_in) bf16, pillars in the last dim
//   nbr   (ny_out, 16, b_out) i32, rows 0..8 = rank of tap j's neighbour
//         inside its source BEV row; >= b_in means absent
//   dout  (ny_out, out_nz*cout, b_out) bf16, the conv output's gradient
//   zmask (ny_out, out_nz, b_out) u8 or null (null: every site counted)
//
// dW[k, ci, co] = sum over output sites of x_k[ci] * d_out[co], with x_k
// the site's tap-k input.  What bounds it on the H100 is the number of
// (site, tap) pairs that exist: at L0 about one site in fifty is occupied.
// Design: a block owns one tap k, a 16x16 tile of (ci, co) and a chunk of
// output rows.  Its eight warps walk the chunk 32 lanes at a time; the
// lanes whose site is occupied and whose tap exists append their inputs and
// output gradients to a queue in shared memory (ballot + prefix count), and
// whenever 32 are queued every thread adds its (ci, co) products in f32.
// Each block writes its partial sum to a workspace the wrapper allocates;
// a second kernel adds the chunks in a fixed order.  No float atomics, so
// the result is the same from run to run.
#include "common.cuh"

namespace {

constexpr int kNbrRows = 16;
constexpr int kTile = 16;   // ci and co per block
constexpr int kPad = kTile + 1;
constexpr int kQueue = 64;  // staged sites: < 32 waiting + 32 appended
constexpr int kDwThreads = kTile * kTile;

__global__ void __launch_bounds__(kDwThreads)
    rowpad_conv_dw_kernel(const __nv_bfloat16* __restrict__ table,
                          const int* __restrict__ nbr,
                          const __nv_bfloat16* __restrict__ dout,
                          const uint8_t* __restrict__ zmask,
                          float* __restrict__ partial, int ny_in, int nz,
                          int cin, int b_in, int ny_out, int out_nz,
                          int cout, int b_out, int down, int z_stride,
                          int rows_per_chunk, int co_tiles) {
  __shared__ float xs[kQueue * kPad];
  __shared__ float ds[kQueue * kPad];
  const int chunk = blockIdx.x;
  const int k = blockIdx.y;
  const int ci0 = (blockIdx.z / co_tiles) * kTile;
  const int co0 = (blockIdx.z % co_tiles) * kTile;
  const int t = k / 9, j = k % 9;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int my_ci = tid / kTile, my_co = tid % kTile;
  float acc = 0.f;
  int cnt = 0;  // queued sites; the same in every thread of the block

  const int y_end = min(ny_out, (chunk + 1) * rows_per_chunk);
  for (int y = chunk * rows_per_chunk; y < y_end; ++y) {
    int src = down ? 2 * y + j / 3 - 1 : y + j / 3 - 1;
    src = min(max(src, 0), ny_in - 1);
    for (int r0 = 0; r0 < b_out; r0 += 32) {
      const int r = r0 + lane;
      const int rank =
          r < b_out ? nbr[((size_t)y * kNbrRows + j) * b_out + r] : b_in;
      const bool tap = rank >= 0 && rank < b_in;
      for (int z = 0; z < out_nz; ++z) {
        const int zi = z * z_stride + t - 1;
        if (zi < 0 || zi >= nz) continue;
        bool act = tap;
        if (act && zmask != nullptr)
          act = zmask[((size_t)y * out_nz + z) * b_out + r] != 0;
        // every warp covers the same 32 lanes, so every warp (and thread)
        // sees the same ballot and keeps the same count
        const unsigned ball = __ballot_sync(0xffffffffu, act);
        if (ball == 0u) continue;
        if (act) {
          const int pos = cnt + __popc(ball & ((1u << lane) - 1u));
          for (int c = warp; c < kTile; c += kDwThreads / 32) {
            const int ci = ci0 + c, co = co0 + c;
            xs[pos * kPad + c] =
                ci < cin ? __bfloat162float(
                               table[(((size_t)src * nz + zi) * cin + ci) *
                                         b_in +
                                     rank])
                         : 0.f;
            ds[pos * kPad + c] =
                co < cout ? __bfloat162float(
                                dout[(((size_t)y * out_nz + z) * cout + co) *
                                         b_out +
                                     r])
                          : 0.f;
          }
        }
        cnt += __popc(ball);
        if (cnt >= 32) {
          __syncthreads();
          for (int s = 0; s < cnt; ++s)
            acc = fmaf(xs[s * kPad + my_ci], ds[s * kPad + my_co], acc);
          __syncthreads();
          cnt = 0;
        }
      }
    }
  }
  if (cnt > 0) {
    __syncthreads();
    for (int s = 0; s < cnt; ++s)
      acc = fmaf(xs[s * kPad + my_ci], ds[s * kPad + my_co], acc);
  }
  const int ci = ci0 + my_ci, co = co0 + my_co;
  if (ci < cin && co < cout)
    partial[(((size_t)chunk * 27 + k) * cin + ci) * cout + co] = acc;
}

// out[e] = sum over chunks c, in order, of partial[c][e]
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n_chunks,
                                  int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[(size_t)c * n + e];
  out[e] = s;
}

}  // namespace

DZ_EXPORT int dz_rowpad_conv_dw(const void* table, const void* nbr,
                                const void* dout, const void* zmask,
                                void* partial, void* out, int ny_in, int nz,
                                int cin, int b_in, int ny_out, int out_nz,
                                int cout, int b_out, int down, int z_stride,
                                int rows_per_chunk, void* stream) {
  if (rows_per_chunk <= 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (ny_out + rows_per_chunk - 1) / rows_per_chunk;
  const int ci_tiles = (cin + kTile - 1) / kTile;
  const int co_tiles = (cout + kTile - 1) / kTile;
  if (ci_tiles * co_tiles > 65535) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0 && out_nz > 0 && b_out > 0) {
    dim3 grid(n_chunks, 27, ci_tiles * co_tiles);
    rowpad_conv_dw_kernel<<<grid, kDwThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)table, (const int*)nbr,
        (const __nv_bfloat16*)dout, (const uint8_t*)zmask, (float*)partial,
        ny_in, nz, cin, b_in, ny_out, out_nz, cout, b_out, down, z_stride,
        rows_per_chunk, co_tiles);
    const int rc = dz_launch_status();
    if (rc != 0) return rc;
  }
  const int n = 27 * cin * cout;
  const int threads = 256;
  sum_chunks_kernel<<<(n + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)partial, (float*)out,
      (n_chunks > 0 && out_nz > 0 && b_out > 0) ? n_chunks : 0, n);
  return dz_launch_status();
}
