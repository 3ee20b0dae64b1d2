// Greedy NMS walk over a suppression bitmask -> keep mask (k,) uint8.
//
// Together with the mask epilogue of iou_bev.cu's matrix kernel this
// replaces detzero_tpu/ops/pallas_iou.py::_launch_nms (the fused IoU tiles
// and fori_loop walk of _nms_kernel_factory), with the semantics of
// detzero_tpu/ops/nms.py::_greedy_suppress over all k boxes:
//   keep_i = valid[i] & !suppressed[i];  suppress j > i with iou[i, j] > t.
// The mask: words (k, ceil(k / 64)) uint64, bit j % 64 of word (i, j / 64)
// set where iou[i, j] > t and j > i (so columns >= k and the lower
// triangle are zero), as OpenPCDet's iou3d_nms_kernel.cu builds it.
//
// Bound on the H100: latency.  The walk is sequential in i, so one warp
// does all of it, with no block barrier.  Lane w keeps the removal words
// w, w + 32, ... in registers.  The walk takes 64 boxes at a time: the
// block's 64 rows (64 x words, contiguous in the mask) are staged into
// shared memory with cp.async while the previous block is resolved.  The
// block's 64 diagonal words are loaded at once, two a lane; a box whose
// word is zero removes nothing, so the serial part visits only the
// candidates whose word is nonzero, lowest first, a shuffle each.  Then
// each lane ORs the kept rows' words of its own columns into its removal
// words (predicated loads, independent of each other, unrolled by 8:
// fully unrolled beside the register words of kLaneWords > 1, ptxas
// hoists them all and spills).  The valid flags are loaded a block ahead.
// The staging pays on the path's k <= 1,024: at k = 1,000 on an H100 at
// 700 W the walk took 0.046 ms staged, 0.059 ms with its rows read from
// L2.  Past 2,048 boxes, on no path, the rows are read from device memory,
// with 8 or 32 removal words a lane; past 65,536 boxes the removal words
// outgrow the registers and the entry point refuses.
#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kBlk = 64;           // boxes a block of the walk
constexpr int kMaxLaneWords = 32;  // removal words a lane: k <= 65,536

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The walk: one warp, kLaneWords removal words a lane (words <= 32 *
// kLaneWords).  kStaged: the rows come through two shared-memory buffers
// of one block's rows (64 x words u64 each, at most 32 KB together at one
// word a lane); otherwise straight from the mask in device memory.
template <int kLaneWords, bool kStaged>
__global__ void __launch_bounds__(32)
    nms_walk_bits_kernel(const u64* __restrict__ mask,
                         const uint8_t* __restrict__ valid,
                         uint8_t* __restrict__ keep, int k, int words) {
  extern __shared__ __align__(16) u64 buf[];
  const int lane = threadIdx.x;
  const size_t panel = (size_t)kBlk * words;

  // stage block `blk`'s rows into buffer blk % 2: they are contiguous
  auto stage = [&](int blk) {
    const int rows = min(kBlk, k - blk * kBlk);
    const char* src = (const char*)(mask + blk * panel);
    char* dst = (char*)(buf + (blk & 1) * panel);
    const int bytes = rows * words * 8;
    for (int off = lane * 16; off + 16 <= bytes; off += 32 * 16)
      cp_async16(dst + off, src + off);
    if ((bytes & 15) && lane == 0) cp_async8(dst + bytes - 8, src + bytes - 8);
    cp_async_commit();
  };
  if (kStaged) stage(0);

  // the valid flags of boxes lane and lane + 32 of the block, loaded one
  // block ahead
  bool v0 = lane < k && valid[lane];
  bool v1 = lane + 32 < k && valid[lane + 32];
  u64 remv[kLaneWords];
#pragma unroll
  for (int q = 0; q < kLaneWords; ++q) remv[q] = 0ull;

  for (int blk = 0; blk < words; ++blk) {
    const int base = blk * kBlk, nrows = min(kBlk, k - base);
    const unsigned vlo = __ballot_sync(0xffffffffu, v0);
    const unsigned vhi = __ballot_sync(0xffffffffu, v1);
    {
      const int i0 = base + kBlk + lane, i1 = i0 + 32;
      v0 = i0 < k && valid[i0];
      v1 = i1 < k && valid[i1];
    }
    const u64* rows;
    if (kStaged) {
      if (blk + 1 < words) {
        stage(blk + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      rows = buf + (blk & 1) * panel;
    } else {
      rows = mask + blk * panel;
    }
    // this block's removal word, from the lane that owns column blk (a
    // shuffle a register word, so that no word is indexed at run time)
    u64 rem = 0ull;
#pragma unroll
    for (int q = 0; q < kLaneWords; ++q) {
      const u64 x = __shfl_sync(0xffffffffu, remv[q], blk % 32);
      if (q == blk / 32) rem = x;
    }
    // the block's boxes in order, the same in every lane: a box is kept
    // where it is valid and no kept box before it removed it, and its
    // diagonal word (rows lane and lane + 32 a lane, zero past k) removes
    // the later ones.  A box whose word is zero removes nothing, so only
    // the candidates with a nonzero word are visited, lowest first, each
    // with one shuffle of its word.
    const u64 dlo =
        lane < nrows ? rows[(size_t)lane * words + blk] : 0ull;
    const u64 dhi =
        lane + 32 < nrows ? rows[(size_t)(lane + 32) * words + blk] : 0ull;
    const u64 busy = (u64)__ballot_sync(0xffffffffu, dlo != 0ull)
                     | ((u64)__ballot_sync(0xffffffffu, dhi != 0ull) << 32);
    u64 cand = (((u64)vhi << 32) | vlo) & ~rem;
    for (u64 todo = cand & busy; todo;) {
      const int r = __ffsll((long long)todo) - 1;
      cand &= ~__shfl_sync(0xffffffffu, r < 32 ? dlo : dhi, r & 31);
      todo = cand & busy & (~1ull << r);
    }
    const unsigned klo = (unsigned)cand, khi = (unsigned)(cand >> 32);
    const int i0 = base + lane, i1 = i0 + 32;
    if (i0 < k) keep[i0] = (uint8_t)((klo >> lane) & 1u);
    if (i1 < k) keep[i1] = (uint8_t)((khi >> lane) & 1u);
    // the kept rows remove later columns: each lane its own words, the
    // rows' loads independent of each other, 8 in flight
#pragma unroll
    for (int q = 0; q < kLaneWords; ++q) {
      const int w = lane + 32 * q;
      if (w > blk && w < words) {
        u64 acc = 0ull;
#pragma unroll 8
        for (int r = 0; r < 32; ++r)
          if ((klo >> r) & 1u) acc |= rows[(size_t)r * words + w];
#pragma unroll 8
        for (int r = 0; r < 32; ++r)
          if ((khi >> r) & 1u) acc |= rows[(size_t)(r + 32) * words + w];
        remv[q] |= acc;
      }
    }
    __syncwarp();  // the buffer read here is restaged two blocks on
  }
}

template <int kLaneWords, bool kStaged>
int launch_walk(const u64* mask, const uint8_t* valid, uint8_t* keep, int k,
                int words, cudaStream_t st) {
  const size_t smem = kStaged ? 2 * (size_t)kBlk * words * 8 : 0;
  nms_walk_bits_kernel<kLaneWords, kStaged>
      <<<1, 32, smem, st>>>(mask, valid, keep, k, words);
  return dz_launch_status();
}

}  // namespace

// mask (k, ceil(k / 64)) uint64 words, valid (k,) bytes 0/1 -> keep (k,)
// bytes 0/1 (a torch.bool tensor's storage, read and written as such)
DZ_EXPORT int dz_nms_walk_bits(const void* mask, const void* valid,
                               void* keep, int k, void* stream) {
  if (k == 0) return dz_launch_status();
  const int words = (k + kBlk - 1) / kBlk;
  const u64* m = (const u64*)mask;
  const uint8_t* v = (const uint8_t*)valid;
  uint8_t* o = (uint8_t*)keep;
  const cudaStream_t st = (cudaStream_t)stream;
  // k <= 2,048 staged (the path's); k <= 16,384 and <= 65,536 unstaged
  // (ptxas spills the unstaged walk at 16 words a lane, not at 8 or 32)
  if (words <= 32) return launch_walk<1, true>(m, v, o, k, words, st);
  if (words <= 256) return launch_walk<8, false>(m, v, o, k, words, st);
  if (words <= 32 * kMaxLaneWords)
    return launch_walk<kMaxLaneWords, false>(m, v, o, k, words, st);
  return (int)cudaErrorInvalidValue;
}
