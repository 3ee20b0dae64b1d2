// K9 (dz_rowpad_conv_sliding): the 'subm' 3x3x3 conv with z stride 1 that
// streams its source rows through shared memory; replaces
// detzero_tpu/ops/pallas_pillar.py::rowpad_conv_sliding
// (_conv_kernel_sliding).  It computes what K4 (csrc/rowpad_conv.cu)
// computes in 'subm', on the same tensor contract:
//   table (ny, nz*cin, b_in)  bf16, pillars in the last dim
//   nbr   (ny, 16, b_out)     i32, rows 0..8 = rank of tap j's neighbour in
//         source row y + j/3 - 1; >= b_in (or < 0) means absent
//   wt    (27, cout, cinp)    bf16: the spconv-order weight (27, cin, cout)
//         transposed per tap and zero-padded to cinp, a multiple of 16
//         (the wrapper makes it)
//   zmask (ny, nz, b_out)     u8 or null (every site)
//   out   (ny, nz*cout, b_out) bf16; zeros at the sites zmask marks empty
// The batch's samples are stacked along the rows; taps that would cross
// into another sample are absent in the maps.
//
// The TPU kernel walks the rows in order, DMAs each input row once and
// selects the taps from a VMEM ring of three rows (160 KB a row at every
// flagship level).  Three such rows do not fit in a block's shared memory,
// and at cin 128 not even one source row's planes with a second buffer
// beside them, so the GPU form stages smaller pieces and streams them:
//   * a block owns a strip of output rows (one by default), a tile of
//     output planes [z0, z0 + zt) and up to 128 output channels (all of
//     them at every flagship level, so each staged input value feeds every
//     channel);
//   * for each output row it zeroes its part of the row with 16-byte stores
//     and compacts the occupied sites of the z tile (compact_row), then
//     per tile of 128 sites (16 a warp) looks up the 9 ranks and 3 planes of
//     every site once, and the largest rank each source row is read at;
//   * a stage is one chunk of 16 input channels of one source row y + dy:
//     the slab of the planes the z tile reads ([z0 - 1, z0 + zt]), those
//     channels and only the slot prefix [0, largest rank + 1), copied with
//     cp.async 16 bytes a thread in the table's own [plane][channel][slot]
//     order, and the weight of that row's 9 taps for those channels,
//     [cout][9 * 16], likewise.  Stages are double-buffered (the copy of
//     stage s + 1 is in flight while the warps run stage s), or, where
//     that leaves too little room for the z tile, single-buffered beside a
//     second block whose work the copy overlaps (see the launcher);
//   * each warp runs mma.sync.m16n8k16 bf16 -> f32 on its 16 sites and all
//     the block's output channels, one k-step a tap; A is gathered from the
//     slab in shared memory by (plane, rank) offsets, two channels a 32-bit
//     fragment register; k-steps whose tap no site of the warp has are
//     skipped (they would add exact zeros);
//   * each occupied site's 16..128 sums are stored over the zeros.
// The sums run channel chunk first, then source row, then z tap, then x;
// K4 sums in that order too (16 channels of a tap a k-step), so K9 equals
// K4 bit for bit.  Absent taps and the padded channels read exact zeros
// (never stale shared memory), so no NaN can enter a sum.
//
// Bound on the H100: the output table written once (2 bytes a site and
// channel, almost all of them zeros at L0) against the input values the
// occupied sites read; the products are few (about one site in fifty is
// occupied at L0, one in five at L3).  What the design spends beyond that:
// each source row is copied into shared memory once per output row that
// reads it (three times, from L2 after the first) and once per z tile,
// plane halo included, and the weight once per tile of sites.  The z tile
// is the largest that fits the launcher's choice of buffers and blocks
// an SM.  A ring of four
// source-row slabs shared by a strip's output rows (each row copied once
// a strip) was tried at cin <= 16 and was slower on the H100: the slabs of
// four rows left room for z tiles of three planes, and the per-row work
// of many small tiles outweighed the copies it saved (PERF.md).
#include "rowpad_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 16 * kWarps;  // output sites a tile, 16 a warp
constexpr int kMaxN = 128;           // output channels a block
constexpr int kTaps = 9;             // taps of one source row: 3 in z, 3 in x
constexpr int kChunk = 16;           // input channels a stage: one k-step
constexpr int kLdw = kTaps * kChunk + 8;  // a weight row, padded (banks)
constexpr int kInts = 12 * kTileM + 16;
// the shared memory of a block when two blocks share an SM (228 KB an SM,
// 1 KB of it reserved for each block)
constexpr size_t kTwoBlockSmem = 113 * 1024;
// the most z tiles a row is cut into to keep two double-buffered blocks
// an SM (see the launcher)
constexpr int kMaxTwoBlockTiles = 3;

struct Geom {
  int ny, nz, cin, cinp, b_in, cout, b_out;
  int rows;    // output rows a block walks
  int zt;      // output planes a z tile
  int ldp;     // slots a slab row holds: b_in rounded up to 8, plus 8
  int planes;  // slab planes: min(zt + 2, nz)
  int nbuf;    // stage buffers: 2 (the next stage's copy overlaps) or 1
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int NT>
__global__ void __launch_bounds__(kThreads, NT >= 16 ? 1 : 2)
    rowpad_conv_sliding_kernel(const bf16* __restrict__ table,
                               const int* __restrict__ nbr,
                               const bf16* __restrict__ wt,
                               const uint8_t* __restrict__ zmask,
                               bf16* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncoa = min(g.cout, kMaxN);  // the weight buffers' rows
  const int slab_el = g.planes * kChunk * g.ldp;
  bf16* slab0 = reinterpret_cast<bf16*>(smem);  // [nbuf][planes][16][ldp]
  bf16* w0 = slab0 + g.nbuf * slab_el;          // [nbuf][ncoa][kLdw]
  int* rk = reinterpret_cast<int*>(w0 + g.nbuf * ncoa * kLdw);  // [9][kTileM]
  int* pl = rk + 9 * kTileM;        // [3][kTileM] plane - zlo, or -1
  int* warp_cnt = pl + 3 * kTileM;  // [kWarps]
  int* pmax = warp_cnt + kWarps;    // [3] largest rank read in row y + dy
  uint16_t* list = reinterpret_cast<uint16_t*>(rk + kInts);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int co0 = blockIdx.z * kMaxN;
  const int nco = min(kMaxN, g.cout - co0);  // a multiple of 16
  const int z0 = blockIdx.y * g.zt, z1 = min(z0 + g.zt, g.nz);
  const int zlo = max(z0 - 1, 0), zhi = min(z1, g.nz - 1);
  const int np = zhi - zlo + 1;
  const int n_sites = (z1 - z0) * g.b_out;
  const int nchunks = (g.cin + kChunk - 1) / kChunk;
  const int n_stages = 3 * nchunks;  // stage s: chunk s / 3, row y + s % 3 - 1
  const bool vec = (g.b_in & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // With one chunk of fewer than 16 channels (the stem), the slabs' rows
  // past cin are never copied: zero the slabs once.  A short last chunk of
  // several zeroes its own (see copy_stage).
  if (nchunks == 1 && g.cin < kChunk) {
    uint4* s4 = reinterpret_cast<uint4*>(slab0);
    for (int e = tid; e < g.nbuf * slab_el / 8; e += kThreads)
      s4[e] = make_uint4(0, 0, 0, 0);
  }

  // copies stage s into buffer buf and commits it as one group
  auto copy_stage = [&](int y, int s, int buf) {
    const int d = s % 3, c0 = (s / 3) * kChunk;
    const int kcv = min(kChunk, g.cin - c0);
    const int src_row = min(max(y + d - 1, 0), g.ny - 1);
    const bf16* src =
        table + (((size_t)src_row * g.nz + zlo) * g.cin + c0) * g.b_in;
    bf16* dst = slab0 + buf * slab_el;
    int P = pmax[d] + 1;  // slots [0, P) are read
    if (vec) {
      P = (P + 7) / 8 * 8;
      const int cpr = P / 8;  // 16-byte chunks of a slab row
      for (int e = tid; e < np * kcv * cpr; e += kThreads) {
        const int row = e / cpr, q = e % cpr;
        const int p = row / kcv, c = row % kcv;
        cp_async16(dst + (p * kChunk + c) * g.ldp + 8 * q,
                   src + ((size_t)p * g.cin + c) * g.b_in + 8 * q);
      }
    } else {
      for (int e = tid; e < np * kcv * P; e += kThreads) {
        const int row = e / P, q = e % P;
        const int p = row / kcv, c = row % kcv;
        dst[(p * kChunk + c) * g.ldp + q] =
            src[((size_t)p * g.cin + c) * g.b_in + q];
      }
    }
    if (nchunks > 1 && kcv < kChunk) {  // a short last chunk
      const int rest = kChunk - kcv;
      for (int e = tid; e < np * rest * P; e += kThreads) {
        const int row = e / P, q = e % P;
        dst[(row / rest * kChunk + kcv + row % rest) * g.ldp + q] = zero;
      }
    }
    // the weight of the row's 9 taps (tap k = t * 9 + 3 * d + x for stage
    // column block q = t * 3 + x), channels [c0, c0 + 16), zero past cin
    bf16* wd = w0 + buf * ncoa * kLdw;
    for (int e = tid; e < nco * kTaps * 2; e += kThreads) {
      const int n = e / (kTaps * 2), q = e / 2 % kTaps, h = e % 2;
      const int k = (q / 3) * 9 + 3 * d + q % 3;
      cp_async16(wd + n * kLdw + q * kChunk + 8 * h,
                 wt + ((size_t)k * g.cout + co0 + n) * g.cinp + c0 + 8 * h);
    }
    cp_async_commit();
  };

  // the zeros over this block's part of output row y
  auto zero_row = [&](int y) {
    for (int z = z0; z < z1; ++z) {
      bf16* o = out + (((size_t)y * g.nz + z) * g.cout + co0) * g.b_out;
      const int n = nco * g.b_out;
      if ((g.b_out & 7) == 0) {
        uint4* o4 = reinterpret_cast<uint4*>(o);
        for (int e = tid; e < n / 8; e += kThreads)
          o4[e] = make_uint4(0, 0, 0, 0);
      } else {
        for (int e = tid; e < n; e += kThreads) o[e] = zero;
      }
    }
  };

  const int y0 = blockIdx.x * g.rows, y1 = min(y0 + g.rows, g.ny);
  for (int y = y0; y < y1; ++y) {
    // the z tile's occupied sites, local index (z - z0) * b_out + r
    const int n_occ = compact_row(
        zmask != nullptr ? zmask + ((size_t)y * g.nz + z0) * g.b_out
                         : nullptr,
        n_sites, list, warp_cnt);
    if (n_occ == 0) zero_row(y);
    for (int m0 = 0; m0 < n_occ; m0 += kTileM) {
      const int ns = min(kTileM, n_occ - m0);
      __syncthreads();  // the previous tile is done with rk, pl, pmax
      if (tid < 3) pmax[tid] = -1;
      __syncthreads();
      // ranks (warps 0-3) and planes (warps 4-7) of the tile's sites
      if (tid < kTileM) {
        const int m = tid;
        const int r = m < ns ? list[m0 + m] % g.b_out : 0;
        int pm[3] = {-1, -1, -1};
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          int rank = -1;
          if (m < ns) {
            const int v = nbr[((size_t)y * kNbrRows + j) * g.b_out + r];
            if (v >= 0 && v < g.b_in) rank = v;
          }
          rk[j * kTileM + m] = rank;
          pm[j / 3] = max(pm[j / 3], rank);
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int v = __reduce_max_sync(0xffffffffu, pm[d]);
          if (lane == 0 && v >= 0) atomicMax(&pmax[d], v);
        }
      } else {
        const int m = tid - kTileM;
        const int z = m < ns ? z0 + list[m0 + m] / g.b_out : -2;
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const int zi = z + t - 1;
          pl[t * kTileM + m] =
              m < ns && zi >= 0 && zi < g.nz ? zi - zlo : -1;
        }
      }
      __syncthreads();

      float acc[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      const bool busy = warp * 16 < ns;
      const int ma = warp * 16 + grp;
      // the warp's products of source row y + d - 1's 9 taps (z tap t, x
      // tap x: stage column block t * 3 + x) from slab sl and weight wb
      auto taps = [&](const bf16* sl, const bf16* wb, int d) {
        wb += grp * kLdw + 2 * tig;
        // two channels of a site at slab offset o (-1: the tap is absent)
        auto pair = [&](int o, int c) -> uint32_t {
          if (o < 0) return 0u;
          const bf16* v = sl + o + c * g.ldp;
          return pack2(v[0], v[g.ldp]);
        };
#pragma unroll
        for (int q = 0; q < kTaps; ++q) {  // z tap q / 3, x tap q % 3
          const int j = 3 * d + q % 3, t = q / 3;
          int o[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = ma + 8 * h;
            const int r = rk[j * kTileM + m], p = pl[t * kTileM + m];
            o[h] = r >= 0 && p >= 0 ? p * kChunk * g.ldp + r : -1;
          }
          if (!__any_sync(0xffffffffu, o[0] >= 0 || o[1] >= 0)) continue;
          const uint32_t a[4] = {pair(o[0], 2 * tig), pair(o[1], 2 * tig),
                                 pair(o[0], 2 * tig + 8),
                                 pair(o[1], 2 * tig + 8)};
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            if (i * 8 < nco) {
              const bf16* br = wb + i * 8 * kLdw + q * kChunk;
              mma_bf16(acc[i], a, lds32(br), lds32(br + 8));
            }
          }
        }
      };

      // the stages that some site reads: source rows with a found tap
      auto next_stage = [&](int s) {
        while (s < n_stages && pmax[s % 3] < 0) ++s;
        return s;
      };
      int s = next_stage(0), buf = 0;
      if (s < n_stages) copy_stage(y, s, 0);
      if (m0 == 0) zero_row(y);  // while the first stage is in flight
      while (s < n_stages) {
        const int sn = next_stage(s + 1);
        if (g.nbuf == 2 && sn < n_stages) {
          copy_stage(y, sn, buf ^ 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // stage s has landed for every thread
        if (busy) taps(slab0 + buf * slab_el, w0 + buf * ncoa * kLdw, s % 3);
        __syncthreads();  // buffer buf is free again
        if (g.nbuf == 1 && sn < n_stages) copy_stage(y, sn, 0);
        s = sn;
        buf ^= g.nbuf - 1;
      }

      // each occupied site's sums, stored over the zeros
      if (busy) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = ma + 8 * h;
          if (m >= ns) continue;
          const int site = list[m0 + m];
          const int z = z0 + site / g.b_out, r = site % g.b_out;
          const size_t o0 =
              (((size_t)y * g.nz + z) * g.cout + co0) * g.b_out + r;
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            if (i * 8 >= nco) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              out[o0 + (size_t)(i * 8 + 2 * tig + e) * g.b_out] =
                  __float2bfloat16_rn(acc[i][2 * h + e]);
          }
        }
      }
    }
    __syncthreads();  // list is rewritten by the next row's compaction
  }
  cp_async_wait<0>();  // no copy outlives the block
}

size_t smem_bytes(const Geom& g) {
  const size_t ncoa = g.cout < kMaxN ? g.cout : kMaxN;
  const size_t slab = (size_t)g.planes * kChunk * g.ldp;
  return g.nbuf * (slab + ncoa * kLdw) * 2 + (size_t)kInts * 4 +
         ((size_t)g.zt * g.b_out * 2 + 15) / 16 * 16;
}

// The largest z tile whose stages fit `budget` bytes, evened out over the
// tiles it makes (g.zt, g.planes set), or false
bool fit_z_tile(Geom& g, size_t budget) {
  int zt = g.nz;
  for (; zt >= 1; --zt) {
    g.zt = zt;
    g.planes = zt + 2 < g.nz ? zt + 2 : g.nz;
    if ((size_t)zt * g.b_out <= 65536 && smem_bytes(g) <= budget) break;
  }
  if (zt < 1) return false;
  const int tiles = (g.nz + zt - 1) / zt;
  g.zt = (g.nz + tiles - 1) / tiles;
  g.planes = g.zt + 2 < g.nz ? g.zt + 2 : g.nz;
  return true;
}

}  // namespace

// wt: (27, cout, cinp) bf16, the weight transposed per tap and zero-padded
// to cinp (a multiple of 16); rows_per_strip: consecutive output rows one
// block walks
DZ_EXPORT int dz_rowpad_conv_sliding(const void* table, const void* nbr,
                                     const void* wt, const void* zmask,
                                     void* out, int ny, int nz, int cin,
                                     int cinp, int b_in, int cout, int b_out,
                                     int rows_per_strip, void* stream) {
  if (cout % 16 != 0 || rows_per_strip < 1 || cin < 1 || b_in < 1 ||
      cinp < cin || cinp % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  if (ny == 0 || nz == 0 || b_out == 0) return dz_launch_status();
  Geom g{ny, nz, cin, cinp, b_in, cout, b_out, rows_per_strip, 0,
         (b_in + 7) / 8 * 8 + 8, 0, 2};
  // Two blocks an SM, with both stage buffers, where the row takes at most
  // kMaxTwoBlockTiles z tiles (the flagship's L1 and L2); else, at cin <=
  // 32 (a stage or two a source row, little work to overlap a copy with),
  // two blocks with one buffer each, so that the z tiles stay large (the
  // stem and L0: 20 planes); else one block with both buffers (L3).
  // Measured on the H100 against the other choices (PERF.md).
  if (!fit_z_tile(g, kTwoBlockSmem) ||
      (nz + g.zt - 1) / g.zt > kMaxTwoBlockTiles) {
    g.nbuf = cin <= 2 * kChunk ? 1 : 2;
    if ((g.nbuf == 2 || !fit_z_tile(g, kTwoBlockSmem)) &&
        !fit_z_tile(g, kMaxSmem))
      return (int)cudaErrorInvalidValue;
  }
  const int z_tiles = (nz + g.zt - 1) / g.zt;
  const int co_chunks = (cout + kMaxN - 1) / kMaxN;
  if (z_tiles > 65535 || co_chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((ny + g.rows - 1) / g.rows, z_tiles, co_chunks);
  const size_t smem = smem_bytes(g);
  const int nco = cout < kMaxN ? cout : kMaxN;
  auto kernel = nco <= 16   ? rowpad_conv_sliding_kernel<2>
                : nco <= 32 ? rowpad_conv_sliding_kernel<4>
                : nco <= 64 ? rowpad_conv_sliding_kernel<8>
                            : rowpad_conv_sliding_kernel<16>;
  int rc = allow_smem(kernel, smem);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (rc != 0) return rc;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)table, (const int*)nbr, (const bf16*)wt,
      (const uint8_t*)zmask, (bf16*)out, g);
  return dz_launch_status();
}
