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
// flagship trains with.
//
// The bf16 kernel (rowpad_conv_mma_kernel) is an implicit GEMM on the
// tensor cores over the occupied sites only.  On the flagship scene about
// one site in fifty is occupied at L0 (one in five at L3), so a thread per
// site, as the first version had, left ~98% of the lanes idle while the
// occupied ones ran 27*cin*16 serial fmafs.  Here a block of 8 warps owns
// one output row y and a chunk of up to 128 output channels:
//   1. it zeroes its part of the output row with 16-byte stores (every
//      empty site's value; the dense write is most of the bound);
//   2. it compacts the row's occupied (z, r) sites into a shared-memory list
//      (16 zmask bytes a thread, warp prefix sums), in increasing order;
//   3. for each tile of 128 listed sites (16 per warp) it looks up the 9 BEV
//      ranks and 3 input planes of every site once and ORs the taps some
//      site has into a mask; then, in rounds of as many of those taps as
//      fill 128 staged columns (K2: all of each tap's channels, 8 taps at
//      cin <= 16, one at cin 128; K4: 16 channels of 8 taps, channel chunks
//      outermost and the taps by source row, then z tap, then x, the order
//      in which K9 sums, so that the two agree bit for bit), it
//      stages A = the sites' inputs at the round's taps (taps*cin columns,
//      gathered by rank tap by tap with the tap's address worked out once,
//      zero where absent, cin padded to 16; only the rows a busy warp
//      reads) and the taps' W[k] transposed (cout x taps*cin, 16 bytes a
//      load) in shared memory; each warp runs mma.sync.m16n8k16 bf16 -> f32
//      on its 16 sites and all the block's output channels, so the inputs
//      are gathered once for all of cout;
//   4. the epilogue (K2: scale, bias, residual, ReLU) runs on the f32
//      accumulators and stores each occupied site's value over the zero.
// Shared-memory rows are padded by 8 bf16, so the 8 rows a fragment load
// touches fall in distinct banks.  The accumulators are sized to cout
// (template kNT), so narrow convs keep few registers and more blocks per
// SM hide the gathers' latency.  What bounds it now (PERF.md): the gathers
// (a site's cin values lie b_in apart, so at L0's sparsity every 2-byte
// value costs a 32-byte sector and a load of its own) and the staging's
// instructions and barriers, which nothing overlaps with the MMA yet; the
// dense output write is about a quarter of the time at L0.  Empty sites
// get 0 (the TPU kernel multiplies them by 0, which differs only for
// non-finite sums; in training the model masks every such site right after
// the conv).
//
// K4 also reads and writes float32 tables: at random init the training
// gradient of this model is so sensitive that bf16 rounding alone leaves
// nothing to compare leaf by leaf, so only a float32 model on the card can
// be held to the CPU reference gradient, at 1e-5 * max|ref|, which TF32
// products would miss.  That variant (rowpad_conv_f32_kernel) keeps the
// first version's body on the CUDA cores: one thread per output site
// (pillar lane, z) and 16 output channels, the 27 taps gathered by rank and
// summed one fmaf at a time in f32.  It exists for that check only.
#include "rowpad_mma.cuh"

namespace {

enum Mode { kSubm = 0, kDown = 1, kUp = 2 };

template <int kMode>
__device__ __forceinline__ int source_row(int y, int dy) {
  if (kMode == kSubm) return y + dy;
  if (kMode == kDown) return 2 * y + dy;
  const int s = y + dy;  // floor((y + dy) / 2); -1 is clamped, nbr absent
  return s >= 0 ? s / 2 : -1;
}

// the input plane that output z reads through z tap t, or -1 (outside the
// table, or a zero-stuffed plane in 'up')
template <int kMode>
__device__ __forceinline__ int input_plane(int z, int t, int z_stride,
                                           int nz) {
  const int zi = z * z_stride + t - 1;
  if (zi < 0 || zi >= nz) return -1;
  if (kMode == kUp) return (zi & 1) ? -1 : zi >> 1;
  return zi;
}

// ---------------------------------------------------------------------------
// float32 K4: the first version's CUDA-core kernel, kept for the gradient
// check (see the head note)
// ---------------------------------------------------------------------------

constexpr int kLanes = 32;  // block x: pillar lanes
constexpr int kZ = 8;       // block y: output z
constexpr int kCoT = 16;    // output channels per thread; cout % kCoT == 0

template <int kMode>
__global__ void __launch_bounds__(kLanes* kZ)
    rowpad_conv_f32_kernel(const float* __restrict__ table,
                           const int* __restrict__ nbr,
                           const float* __restrict__ w,
                           const uint8_t* __restrict__ zmask,
                           float* __restrict__ out, int ny_in, int nz,
                           int cin, int b_in, int out_nz, int cout,
                           int b_out, int z_stride, int z_tiles) {
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
        const int zi = input_plane<kMode>(z, t, z_stride, nz);
        if (zi < 0) continue;
        const float* xp =
            table + ((size_t)src * planes + zi) * cin * b_in + rank;
        const float* wp = w + (size_t)(t * 9 + j) * cin * cout + co0;
        for (int ci = 0; ci < cin; ++ci) {
          const float xv = xp[(size_t)ci * b_in];
          const float* wr = wp + (size_t)ci * cout;
#pragma unroll
          for (int c = 0; c < kCoT; ++c) acc[c] = fmaf(xv, wr[c], acc[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCoT; ++c)
    out[(((size_t)y * out_nz + z) * cout + co0 + c) * b_out + r] = acc[c];
}

template <int kMode>
int launch_f32(const void* table, const void* nbr, const void* w,
               const void* zmask, void* out, int ny_in, int nz, int cin,
               int b_in, int ny_out, int out_nz, int cout, int b_out,
               int z_stride, void* stream) {
  if (ny_out > 65535 || cout % kCoT != 0) return (int)cudaErrorInvalidValue;
  if (ny_out == 0 || out_nz == 0 || b_out == 0) return dz_launch_status();
  const int z_tiles = (out_nz + kZ - 1) / kZ;
  dim3 grid((b_out + kLanes - 1) / kLanes, ny_out, z_tiles * (cout / kCoT));
  dim3 block(kLanes, kZ);
  rowpad_conv_f32_kernel<kMode><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)nbr, (const float*)w,
      (const uint8_t*)zmask, (float*)out, ny_in, nz, cin, b_in, out_nz, cout,
      b_out, z_stride, z_tiles);
  return dz_launch_status();
}

// ---------------------------------------------------------------------------
// bf16 K4 and K2: occupied sites only, products on the tensor cores
// ---------------------------------------------------------------------------

// The bit of tap k = t * 9 + j in a tile's tap mask, whose ascending order
// is the order the taps are summed in: K2 takes k itself; K4 takes the
// source row first, r = (j / 3) * 9 + t * 3 + j % 3, which is K9's order
// (csrc/rowpad_conv_sliding.cu), so that K4 and K9 sum alike.
template <bool kRowsFirst>
__device__ __forceinline__ int tap_bit(int t, int j) {
  return kRowsFirst ? (j / 3) * 9 + t * 3 + j % 3 : t * 9 + j;
}
// the tap k of a mask bit
template <bool kRowsFirst>
__device__ __forceinline__ int bit_tap(int b) {
  return kRowsFirst ? (b % 9 / 3) * 9 + (b / 9) * 3 + b % 3 : b;
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 16 * kWarps;  // sites per tile, 16 per warp
constexpr int kMaxN = 128;           // output channels per block
constexpr int kMaxK = 128;           // input channels staged at once
constexpr int kPad = 8;              // bf16 padding of a shared-memory row
constexpr int kMaxNT = kMaxN / 8;    // n8 tiles per warp

// shared memory of one block, in bytes, for rounds of `kk` staged columns
// (taps x padded input channels, a multiple of 16), `nco` output channels
// and a row of n_sites sites
size_t mma_smem(int kk, int nco, int n_sites) {
  const size_t ints = 12 * kTileM + 16;  // ranks, planes, counts, tap mask
  const size_t ld = kk + kPad;
  return ints * 4 + (kTileM + nco) * ld * 2 +
         ((size_t)n_sites * 2 + 15) / 16 * 16;
}

// kNT: m16n8 accumulator tiles a warp keeps, nco / 8 rounded up to a power
// of two, so that narrow convs take few registers and more blocks fit
template <int kMode, bool kEpilogue, int kNT>
__global__ void __launch_bounds__(kThreads, kNT >= 16 ? 1
                                                   : kNT >= 8  ? 2
                                                               : 3)
    rowpad_conv_mma_kernel(const bf16* __restrict__ table,
                           const int* __restrict__ nbr,
                           const bf16* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const uint8_t* __restrict__ zmask,
                           const bf16* __restrict__ res,
                           bf16* __restrict__ out, int ny_in, int nz,
                           int cin, int b_in, int out_nz, int cout, int b_out,
                           int z_stride, int relu, int kcp, int round_taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* rk = reinterpret_cast<int*>(smem);   // [9][kTileM] rank or -1
  int* pl = rk + 9 * kTileM;                // [3][kTileM] plane or -1
  int* warp_cnt = pl + 3 * kTileM;          // [kWarps]
  int* tap_mask = warp_cnt + kWarps;        // [1]
  // [kTileM][ld] the sites' inputs, [nco][ld] the weight, then the list
  const int ld = round_taps * kcp + kPad;
  bf16* as = reinterpret_cast<bf16*>(rk + 12 * kTileM + 16);
  const int y = blockIdx.x;
  const int co0 = blockIdx.y * kMaxN;
  const int nco = min(kMaxN, cout - co0);  // a multiple of 16
  bf16* ws = as + kTileM * ld;
  uint16_t* list = reinterpret_cast<uint16_t*>(ws + nco * ld);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int n_sites = out_nz * b_out;
  const int planes = kMode == kUp ? nz / 2 : nz;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // 1. zeros over this block's part of the output row
  for (int z = 0; z < out_nz; ++z) {
    bf16* o = out + (((size_t)y * out_nz + z) * cout + co0) * b_out;
    const int n = nco * b_out;
    if ((b_out & 7) == 0) {
      uint4* o4 = reinterpret_cast<uint4*>(o);
      for (int e = tid; e < n / 8; e += kThreads)
        o4[e] = make_uint4(0, 0, 0, 0);
    } else {
      for (int e = tid; e < n; e += kThreads) o[e] = zero;
    }
  }
  // 2. the row's occupied sites (the barriers inside also order the zeros
  // before the values stored over them)
  const int n_occ = compact_row(
      zmask != nullptr ? zmask + (size_t)y * n_sites : nullptr, n_sites,
      list, warp_cnt);

  // the site and the channel pair a thread stages
  const int sm = tid % kTileM, sc = tid / kTileM;  // sc: 0 or 1
  for (int m0 = 0; m0 < n_occ; m0 += kTileM) {
    const int ns = min(kTileM, n_occ - m0);
    const bool staged = sm < (ns + 15) / 16 * 16;  // a busy warp reads it
    __syncthreads();  // the previous tile is done with the shared memory
    if (tid == 0) *tap_mask = 0;
    __syncthreads();
    // 3a. ranks and planes of the tile's sites; the taps some site has
    unsigned mask = 0;
    for (int e = tid; e < 9 * kTileM; e += kThreads) {
      const int j = e / kTileM, m = e % kTileM;
      int rank = -1;
      if (m < ns) {
        const int site = list[m0 + m];
        const int v = nbr[((size_t)y * kNbrRows + j) * b_out + site % b_out];
        if (v >= 0 && v < b_in) {
          rank = v;
          for (int t = 0; t < 3; ++t)
            if (input_plane<kMode>(site / b_out, t, z_stride, nz) >= 0)
              mask |= 1u << tap_bit<!kEpilogue>(t, j);
        }
      }
      rk[e] = rank;
    }
    for (int e = tid; e < 3 * kTileM; e += kThreads) {
      const int t = e / kTileM, m = e % kTileM;
      pl[e] = m < ns ? input_plane<kMode>(list[m0 + m] / b_out, t, z_stride,
                                          nz)
                     : -1;
    }
    mask = __reduce_or_sync(0xffffffffu, mask);
    if (lane == 0 && mask != 0u) atomicOr(tap_mask, (int)mask);
    __syncthreads();
    const unsigned taps = (unsigned)*tap_mask;

    float acc[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const bool busy = warp * 16 < ns;  // this warp has sites

    // channel chunks of kcp: K2 one pass unless cin > 128, K4 16 channels
    // a pass, as K9 stages them
    for (int c0 = 0; c0 < cin; c0 += kcp) {
      const int kc = min(kcp, cin - c0);
      // rounds of up to round_taps of the taps some site has, in order;
      // a round's q-th tap is bit nth_bit(round, q)
      for (unsigned rest = taps; rest != 0u;) {
        const unsigned round = rest;
        int nq = 0;
        for (; nq < round_taps && rest != 0u; ++nq) rest &= rest - 1u;
        // 3b. A: as[m][q * kcp + c] = the input of site m at the round's
        // q-th tap, channel c0 + c, two channels a store; only the rows
        // that a busy warp reads
        if (staged) {
          unsigned left = round;
          for (int q = 0; q < nq; ++q, left &= left - 1u) {
            const int k = bit_tap<!kEpilogue>(__ffs(left) - 1);
            const int t = k / 9, j = k % 9;
            const int rank = rk[j * kTileM + sm], plane = pl[t * kTileM + sm];
            const bool ok = rank >= 0 && plane >= 0;
            const int src =
                min(max(source_row<kMode>(y, j / 3 - 1), 0), ny_in - 1);
            const bf16* xp =
                table +
                (((size_t)src * planes + (ok ? plane : 0)) * cin + c0) *
                    b_in +
                (ok ? rank : 0);
            bf16* ad = as + sm * ld + q * kcp;
#pragma unroll 4
            for (int c = 2 * sc; c < kcp; c += 4) {
              bf16 lo = zero, hi = zero;
              if (ok && c < kc) lo = xp[(size_t)c * b_in];
              if (ok && c + 1 < kc) hi = xp[(size_t)(c + 1) * b_in];
              *reinterpret_cast<uint32_t*>(ad + c) = pack2(lo, hi);
            }
          }
        }
        // W: ws[n][q * kcp + c] = w[k_q][c0 + c][co0 + n], 8 n a thread
        // from two 16-byte loads, neighbouring threads on neighbouring c
        const int pairs = nq * kcp / 2;
#pragma unroll 4
        for (int e = tid; e < pairs * (nco / 8); e += kThreads) {
          const int qc = e % pairs, n0 = 8 * (e / pairs);
          const int q = qc / (kcp / 2), c = 2 * (qc % (kcp / 2));
          const int k = bit_tap<!kEpilogue>(nth_bit(round, q));
          const bf16* wk = w + ((size_t)k * cin + c0 + c) * cout + co0 + n0;
          uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
          if (c < kc) lo = load8(wk);
          if (c + 1 < kc) hi = load8(wk + cout);
          const bf16* l = reinterpret_cast<const bf16*>(&lo);
          const bf16* h = reinterpret_cast<const bf16*>(&hi);
          bf16* wd = ws + n0 * ld + q * kcp + c;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            *reinterpret_cast<uint32_t*>(wd + i * ld) = pack2(l[i], h[i]);
        }
        __syncthreads();
        // 3c. each warp: its 16 sites x all nco channels
        if (busy) {
          const bf16* ar = as + (warp * 16 + grp) * ld + 2 * tig;
          const bf16* br = ws + grp * ld + 2 * tig;
          for (int kk = 0; kk < nq * kcp; kk += 16) {
            const uint32_t a[4] = {lds32(ar + kk), lds32(ar + 8 * ld + kk),
                                   lds32(ar + kk + 8),
                                   lds32(ar + 8 * ld + kk + 8)};
#pragma unroll
            for (int i = 0; i < kNT; ++i) {
              if (i * 8 < nco)
                mma_bf16(acc[i], a, lds32(br + i * 8 * ld + kk),
                         lds32(br + i * 8 * ld + kk + 8));
            }
          }
        }
        __syncthreads();
      }
    }

    // 4. epilogue on the accumulators; store each occupied site's value
    if (busy) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = warp * 16 + grp + 8 * h;
        if (m >= ns) continue;
        const int site = list[m0 + m];
        const int z = site / b_out, r = site % b_out;
        const size_t o0 =
            (((size_t)y * out_nz + z) * cout + co0) * b_out + r;
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          if (i * 8 >= nco) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = i * 8 + 2 * tig + e;
            const size_t o = o0 + (size_t)n * b_out;
            float v = acc[i][2 * h + e];
            if (kEpilogue) {
              v = v * scale[co0 + n] + bias[co0 + n];
              if (res) v += __bfloat162float(res[o]);
              if (relu) v = fmaxf(v, 0.f);
            }
            out[o] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

template <int kMode, bool kEpilogue, int kNT>
int launch_nt(const void* table, const void* nbr, const void* w,
              const void* scale, const void* bias, const void* zmask,
              const void* res, void* out, int ny_in, int nz, int cin,
              int b_in, int ny_out, int out_nz, int cout, int b_out,
              int z_stride, int relu, void* stream) {
  // a round stages as many whole taps as fit in kMaxK columns: K2 all the
  // channels of each (up to 128), K4 16 channels of each
  const int kcp = kEpilogue ? (min(cin, kMaxK) + 15) / 16 * 16 : 16;
  const int round_taps = max(1, kMaxK / kcp);
  const size_t smem =
      mma_smem(round_taps * kcp, min(cout, kMaxN), out_nz * b_out);
  const int rc =
      allow_smem(rowpad_conv_mma_kernel<kMode, kEpilogue, kNT>, smem);
  if (rc != 0) return rc;
  dim3 grid(ny_out, (cout + kMaxN - 1) / kMaxN);
  rowpad_conv_mma_kernel<kMode, kEpilogue, kNT>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const bf16*)table, (const int*)nbr, (const bf16*)w,
          (const float*)scale, (const float*)bias, (const uint8_t*)zmask,
          (const bf16*)res, (bf16*)out, ny_in, nz, cin, b_in, out_nz, cout,
          b_out, z_stride, relu, kcp, round_taps);
  return dz_launch_status();
}

template <int kMode, bool kEpilogue>
int launch_mma(const void* table, const void* nbr, const void* w,
               const void* scale, const void* bias, const void* zmask,
               const void* res, void* out, int ny_in, int nz, int cin,
               int b_in, int ny_out, int out_nz, int cout, int b_out,
               int z_stride, int relu, void* stream) {
  // the site list holds uint16 indices of one row
  if (cout % 16 != 0 || cin < 1 || (size_t)out_nz * b_out > 65536)
    return (int)cudaErrorInvalidValue;
  if (ny_out == 0 || out_nz == 0 || b_out == 0) return dz_launch_status();
  const int nco = min(cout, kMaxN);
  auto fn = nco <= 16   ? launch_nt<kMode, kEpilogue, 2>
            : nco <= 32 ? launch_nt<kMode, kEpilogue, 4>
            : nco <= 64 ? launch_nt<kMode, kEpilogue, 8>
                        : launch_nt<kMode, kEpilogue, kMaxNT>;
  return fn(table, nbr, w, scale, bias, zmask, res, out, ny_in, nz, cin,
            b_in, ny_out, out_nz, cout, b_out, z_stride, relu, stream);
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
  auto fn = down ? launch_mma<kDown, true> : launch_mma<kSubm, true>;
  return fn(table, nbr, w, scale, bias, zmask, res, out, ny_in, nz, cin,
            b_in, ny_out, out_nz, cout, b_out, z_stride, relu, stream);
}

// K4: mode 0 'subm', 1 'down', 2 'up' (nz even); f32: table, w and out are
// float32 (the CUDA-core kernel), else bf16 (the tensor-core kernel)
DZ_EXPORT int dz_rowpad_conv(const void* table, const void* nbr,
                             const void* w, const void* zmask, void* out,
                             int ny_in, int nz, int cin, int b_in, int ny_out,
                             int out_nz, int cout, int b_out, int mode,
                             int z_stride, int f32, void* stream) {
  if (mode < kSubm || mode > kUp || (mode == kUp && nz % 2 != 0))
    return (int)cudaErrorInvalidValue;
  if (f32) {
    auto fn = mode == kSubm   ? launch_f32<kSubm>
              : mode == kDown ? launch_f32<kDown>
                              : launch_f32<kUp>;
    return fn(table, nbr, w, zmask, out, ny_in, nz, cin, b_in, ny_out,
              out_nz, cout, b_out, z_stride, stream);
  }
  auto fn = mode == kSubm   ? launch_mma<kSubm, false>
            : mode == kDown ? launch_mma<kDown, false>
                            : launch_mma<kUp, false>;
  return fn(table, nbr, w, nullptr, nullptr, zmask, nullptr, out, ny_in, nz,
            cin, b_in, ny_out, out_nz, cout, b_out, z_stride, 0, stream);
}
