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
// dW[k] = X_k^T . D: for each tap k, the sum over the occupied output sites
// that have tap k of x_k (cin) times d_out (cout), x_k the site's tap-k
// input.  The first version gave every block one tap and a 16x16 (ci, co)
// tile, so each block walked every site of its rows: 27 * ci_tiles *
// co_tiles visits a site, ~415 M at L0 and at L3, bound by the scan and not
// by the products.  Now it is a gathered GEMM on the tensor cores with the
// sites as the reduction dimension:
//   * a block owns a chunk of output rows, a group of G taps and a (ci, co)
//     tile of at most 128 x 128; G is as many taps as the block's 8 warps
//     hold accumulators for (at most 16 m16n8 tiles a warp): all 27 at
//     cin x cout = 16 x 16, one at 128 x 128;
//   * row by row, it compacts the row's occupied sites into a shared-memory
//     list once (as K2/K4 do), and for each tile of 64 listed sites looks up
//     their 9 BEV ranks and 3 input planes, stages D (cout x 64, the sites'
//     output gradients, once for all G taps) and, for each of its taps that
//     some site has, X_k^T (cin x 64, gathered by rank, zero where absent);
//   * each warp runs mma.sync.m16n8k16 bf16 -> f32 over the 64 sites, 16 at
//     a time, for its (tap, ci tile, co tile) accumulators.
// So a site is visited 27 / G times (once at L0, 27 times at L3, where each
// visit gathers its X_k row anyway), not 27 * ci_tiles * co_tiles times.
// Each block writes its f32 partial sums to the workspace the wrapper
// allocates, (chunk, 27, cin, cout), a chunk being a few rows
// (`DW_ROWS_PER_CHUNK` in ops/rowpad_conv.py), so that the launch has
// thousands of blocks (a chunk's tap groups launched next to each other,
// so that they share its rows in L2); a second kernel adds the chunks in a
// fixed order, 8 rows of threads a block over the chunks.  No float
// atomics and a fixed MMA order, so two launches give the same bits.  What bounds it now (PERF.md): the gathers
// (2-byte loads at a stride of b_in; at L3 each input row is read once for
// each of its 27 taps, and the D tile is staged once per tap) and the
// barriers between staging and MMA, which nothing overlaps yet.
#include "rowpad_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileS = 64;         // sites per tile: the MMA reduction depth
constexpr int kLd = kTileS + 8;    // a shared-memory row, padded by 8 bf16
constexpr int kMaxC = 128;         // ci and co per block
constexpr int kWarpTiles = 16;     // m16n8 accumulator tiles per warp
constexpr int kMaxXRows = 512;     // G * padded ci rows of the X tile

// shared memory of one block, in bytes
size_t dw_smem(int g, int kcp, int nco, int n_sites) {
  const size_t ints = 12 * kTileS + 16;  // ranks, planes, counts, tap mask
  return ints * 4 + ((size_t)g * kcp + nco) * kLd * 2 +
         ((size_t)n_sites * 2 + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kThreads)
    rowpad_conv_dw_kernel(const bf16* __restrict__ table,
                          const int* __restrict__ nbr,
                          const bf16* __restrict__ dout,
                          const uint8_t* __restrict__ zmask,
                          float* __restrict__ partial, int ny_in, int nz,
                          int cin, int b_in, int ny_out, int out_nz,
                          int cout, int b_out, int down, int z_stride,
                          int rows_per_chunk, int taps_per_block,
                          int n_groups, int co_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* rk = reinterpret_cast<int*>(smem);  // [9][kTileS] rank or -1
  int* pl = rk + 9 * kTileS;               // [3][kTileS] plane or -1
  int* warp_cnt = pl + 3 * kTileS;         // [kWarps]
  int* tap_mask = warp_cnt + kWarps;       // [1]
  // the tap groups and (ci, co) tiles of a chunk are launched together, so
  // that they find its rows in L2
  const int chunk = blockIdx.y;
  const int k0 = (blockIdx.x % n_groups) * taps_per_block;
  const int ng = min(taps_per_block, 27 - k0);
  const int tile = blockIdx.x / n_groups;
  const int ci0 = (tile / co_chunks) * kMaxC;
  const int co0 = (tile % co_chunks) * kMaxC;
  const int kc = min(kMaxC, cin - ci0);
  const int kcp = (kc + 15) / 16 * 16;
  const int nco = min(kMaxC, cout - co0);  // a multiple of 16
  // [nco][kLd] the sites' output gradients, [ng][kcp][kLd] their inputs,
  // then the row's list
  bf16* ds = reinterpret_cast<bf16*>(rk + 12 * kTileS + 16);
  bf16* xs = ds + nco * kLd;
  uint16_t* list = reinterpret_cast<uint16_t*>(xs + ng * kcp * kLd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int n_sites = out_nz * b_out;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // this warp's accumulator tiles: tile id = warp + kWarps * i over
  // (tap, ci tile, co tile), co tile fastest
  const int ct_n = kcp / 16, nt_n = nco / 8;
  const int n_tiles = ng * ct_n * nt_n;
  float acc[kWarpTiles][4];
#pragma unroll
  for (int i = 0; i < kWarpTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int s_me = tid % kTileS, part = tid / kTileS;  // part: 0..3
  const int y_end = min(ny_out, (chunk + 1) * rows_per_chunk);
  for (int y = chunk * rows_per_chunk; y < y_end; ++y) {
    __syncthreads();  // the previous row is done with the list
    const int n_occ = compact_row(
        zmask != nullptr ? zmask + (size_t)y * n_sites : nullptr, n_sites,
        list, warp_cnt);
    for (int s0 = 0; s0 < n_occ; s0 += kTileS) {
      const int ns = min(kTileS, n_occ - s0);
      __syncthreads();  // the previous tile is done with the shared memory
      if (tid == 0) *tap_mask = 0;
      __syncthreads();
      // ranks and planes of the tile's sites; the taps some site has
      unsigned mask = 0;
      for (int e = tid; e < 9 * kTileS; e += kThreads) {
        const int j = e / kTileS, s = e % kTileS;
        int rank = -1;
        if (s < ns) {
          const int site = list[s0 + s];
          const int v =
              nbr[((size_t)y * kNbrRows + j) * b_out + site % b_out];
          if (v >= 0 && v < b_in) {
            rank = v;
            for (int t = 0; t < 3; ++t) {
              const int zi = (site / b_out) * z_stride + t - 1;
              if (zi >= 0 && zi < nz) mask |= 1u << (t * 9 + j);
            }
          }
        }
        rk[e] = rank;
      }
      for (int e = tid; e < 3 * kTileS; e += kThreads) {
        const int t = e / kTileS, s = e % kTileS;
        int plane = -1;
        if (s < ns) {
          const int zi = (list[s0 + s] / b_out) * z_stride + t - 1;
          if (zi >= 0 && zi < nz) plane = zi;
        }
        pl[e] = plane;
      }
      mask = __reduce_or_sync(0xffffffffu, mask);
      if (lane == 0 && mask != 0u) atomicOr(tap_mask, (int)mask);
      // D: ds[co][s] = d_out at site s, zero past the tile's sites
      {
        int site = 0;
        if (s_me < ns) site = list[s0 + s_me];
        const bf16* dp = dout +
                         (((size_t)y * out_nz + site / b_out) * cout + co0) *
                             b_out +
                         site % b_out;
#pragma unroll 8
        for (int c = part; c < nco; c += kThreads / kTileS)
          ds[c * kLd + s_me] = s_me < ns ? dp[(size_t)c * b_out] : zero;
      }
      __syncthreads();
      const unsigned taps = (unsigned)*tap_mask;
      // X: xs[g][ci][s] = tap (k0 + g) input of site s, channel ci0 + ci,
      // for the taps some site has
      for (int g = 0; g < ng; ++g) {
        const int k = k0 + g;
        if (!((taps >> k) & 1u)) continue;
        const int t = k / 9, j = k % 9;
        const int dy = j / 3 - 1;
        const int src = min(max(down ? 2 * y + dy : y + dy, 0), ny_in - 1);
        const int rank = rk[j * kTileS + s_me], plane = pl[t * kTileS + s_me];
        const bool ok = rank >= 0 && plane >= 0;
        const bf16* xp =
            table + (((size_t)src * nz + (ok ? plane : 0)) * cin + ci0) *
                        b_in +
            (ok ? rank : 0);
        bf16* xg = xs + g * kcp * kLd + s_me;
#pragma unroll 8
        for (int c = part; c < kcp; c += kThreads / kTileS)
          xg[c * kLd] = ok && c < kc ? xp[(size_t)c * b_in] : zero;
      }
      __syncthreads();
      // MMA over the tile's sites, 16 at a time
      const int k_steps = (ns + 15) / 16;
#pragma unroll
      for (int i = 0; i < kWarpTiles; ++i) {
        const int id = warp + kWarps * i;
        if (id >= n_tiles) continue;
        const int g = id / (ct_n * nt_n);
        if (!((taps >> (k0 + g)) & 1u)) continue;
        const int ct = (id / nt_n) % ct_n, nt = id % nt_n;
        const bf16* ar = xs + (g * kcp + ct * 16 + grp) * kLd + 2 * tig;
        const bf16* br = ds + (nt * 8 + grp) * kLd + 2 * tig;
        for (int ks = 0; ks < k_steps; ++ks) {
          const int kk = ks * 16;
          const uint32_t a[4] = {lds32(ar + kk), lds32(ar + 8 * kLd + kk),
                                 lds32(ar + kk + 8),
                                 lds32(ar + 8 * kLd + kk + 8)};
          mma_bf16(acc[i], a, lds32(br + kk), lds32(br + kk + 8));
        }
      }
    }
  }

  // this block's partial sums: rows ci, columns co of each tile
#pragma unroll
  for (int i = 0; i < kWarpTiles; ++i) {
    const int id = warp + kWarps * i;
    if (id >= n_tiles) continue;
    const int g = id / (ct_n * nt_n);
    const int ct = (id / nt_n) % ct_n, nt = id % nt_n;
    float* dst = partial + ((size_t)chunk * 27 + k0 + g) * cin * cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ct * 16 + grp + 8 * h;
      if (ci >= kc) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = nt * 8 + 2 * tig + e;
        dst[(size_t)(ci0 + ci) * cout + co0 + co] = acc[i][2 * h + e];
      }
    }
  }
}

// out[e] = the sum over chunks c of partial[c][e], in a fixed order: each
// of a block's 8 thread rows adds every 8th chunk in turn, then one thread
// adds the 8 rows in turn; 32 elements a block, read 128 bytes at a time
constexpr int kSumCols = 32;
constexpr int kSumRows = kThreads / kSumCols;

__global__ void __launch_bounds__(kThreads)
    sum_chunks_kernel(const float* __restrict__ partial,
                      float* __restrict__ out, int n_chunks, int n) {
  __shared__ float rows[kThreads];
  const int col = threadIdx.x % kSumCols, row = threadIdx.x / kSumCols;
  const int e = blockIdx.x * kSumCols + col;
  float s = 0.f;
  if (e < n) {
#pragma unroll 4
    for (int c = row; c < n_chunks; c += kSumRows)
      s += partial[(size_t)c * n + e];
  }
  rows[threadIdx.x] = s;
  __syncthreads();
  if (row == 0 && e < n) {
    float t = 0.f;
    for (int r = 0; r < kSumRows; ++r) t += rows[r * kSumCols + col];
    out[e] = t;
  }
}

}  // namespace

DZ_EXPORT int dz_rowpad_conv_dw(const void* table, const void* nbr,
                                const void* dout, const void* zmask,
                                void* partial, void* out, int ny_in, int nz,
                                int cin, int b_in, int ny_out, int out_nz,
                                int cout, int b_out, int down, int z_stride,
                                int rows_per_chunk, void* stream) {
  if (rows_per_chunk <= 0 || cin < 1 || cout % 16 != 0 ||
      (size_t)out_nz * b_out > 65536)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (ny_out + rows_per_chunk - 1) / rows_per_chunk;
  const bool work = n_chunks > 0 && out_nz > 0 && b_out > 0;
  if (work) {
    // taps a block holds: at most kWarpTiles m16n8 tiles a warp and
    // kMaxXRows staged input rows; then spread evenly over the groups
    const int kcp = (min(cin, kMaxC) + 15) / 16 * 16;
    const int nco = min(cout, kMaxC);
    const int per_tap = kcp / 16 * (nco / 8);
    int g = min(27, min(kWarps * kWarpTiles / per_tap, kMaxXRows / kcp));
    const int groups = (27 + g - 1) / g;
    g = (27 + groups - 1) / groups;
    const int co_chunks = (cout + kMaxC - 1) / kMaxC;
    const int ci_chunks = (cin + kMaxC - 1) / kMaxC;
    const size_t smem = dw_smem(g, kcp, nco, out_nz * b_out);
    int rc = allow_smem(rowpad_conv_dw_kernel, smem);
    if (rc != 0) return rc;
    if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(groups * ci_chunks * co_chunks, n_chunks);
    rowpad_conv_dw_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const bf16*)table, (const int*)nbr, (const bf16*)dout,
        (const uint8_t*)zmask, (float*)partial, ny_in, nz, cin, b_in, ny_out,
        out_nz, cout, b_out, down, z_stride, rows_per_chunk, g, groups,
        co_chunks);
    rc = dz_launch_status();
    if (rc != 0) return rc;
  }
  const int n = 27 * cin * cout;
  sum_chunks_kernel<<<(n + kSumCols - 1) / kSumCols, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)partial, (float*)out, work ? n_chunks : 0, n);
  return dz_launch_status();
}
