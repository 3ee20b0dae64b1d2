// K8 (dz_rowpad_nbr_maps): the neighbour-rank maps of the row-pad plan,
// all of a sample's maps in one launch; replaces
// detzero_tpu/ops/pallas_pillar.py::rowpad_nbr (_nbr_kernel).  Each map:
//   xq   (ny_out, b_out) i32  x-coord of each output slot, kNbrBig if empty
//   x_in (ny_in, b_in)   i32  the target level's x-coords, same fill
//   out  (ny_out, 16, b_out) i32
// Row j < 9 of out holds, for tap (dy, dx) = (j/3 - 1, j%3 - 1), the rank of
// the neighbour inside its target row, b_in where the tap is absent; rows
// 9..15 hold b_in.  Target (row, x): (y+dy, x+dx) in 'subm', (2y+dy, 2x+dx)
// in 'down', ((y+dy)/2, (x+dx)/2) in 'up' when both are even.
//
// The reference ranks by counting: the rank of x' is the number of strictly
// smaller x-coords over all b_in slots of the target row, and the tap is
// present when one equals x'.  Here a lower-bound binary search finds the
// same number in ceil(log2 b_in) + 1 steps, and one equality test at the
// found rank replaces the "equal" count.  The two agree because each row's
// live cells are unique and x-sorted (the pillar table is sorted by cell,
// and a row that held more than b_in pillars kept its first b_in, which are
// still sorted), and the kNbrBig fill of the empty slots sorts last and is
// never smaller than a live query's x' (at most 2 * nx + 1).  Queries of
// empty slots, absent rows and odd 'up' taps are written b_in whatever the
// search gives.  tests/test_torch_nbr_iou_redesign.py pins the order on the
// plans and the search against the count.
//
// Bound on the H100: the maps are written once, (ny_out * 16 * b_out) int32
// each, 12 MB for L0 and 55 MB for the flagship plan's 10; the searches are
// a few thousand shared-memory reads a block.  Design: one launch for a
// list of maps whose descriptors go by value in the kernel's parameters
// (no copy to the device); the grid is the sum of the maps' output rows and
// a block finds its map from the descriptors' first rows.  A block takes
// one output row: the three target rows in shared memory, padded with
// INT_MAX to a power of two, one thread per query lane, stores coalesced
// along the lanes.  Every index into the descriptors is a compile-time
// constant, so they stay in the parameter space.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kNbrRows = 16;
constexpr int kNbrBig = 1 << 28;  // 2 * kNbrBig + 1 stays in int32 ('down')
constexpr int kThreads = 128;
constexpr int kMaxMaps = 16;

enum Mode { kSubm = 0, kDown = 1, kUp = 2 };

struct NbrMap {
  const int* xq;
  const int* x_in;
  int* out;
  int ny_out, b_out, ny_in, b_in, mode;
  int row0;  // the map's first block
  int pad;   // b_in rounded up to a power of two
};

struct NbrMaps {
  NbrMap map[kMaxMaps];
  int n;
};

// the count of entries of the sorted row[0..pad) that are smaller than x
__device__ __forceinline__ int lower_bound(const int* row, int pad, int x) {
  int base = 0;
  for (int half = pad >> 1; half > 0; half >>= 1)
    base += row[base + half - 1] < x ? half : 0;
  return base + (row[base] < x);
}

__global__ void __launch_bounds__(kThreads)
    rowpad_nbr_maps_kernel(const NbrMaps maps) {
  extern __shared__ int xt[];  // 3 * pad: the target rows of dy = -1, 0, 1
  // this block's map: the last whose first block is at or below it
  NbrMap mp = maps.map[0];
#pragma unroll
  for (int k = 1; k < kMaxMaps; ++k)
    if (k < maps.n && (int)blockIdx.x >= maps.map[k].row0) mp = maps.map[k];
  const int i = blockIdx.x - mp.row0;
  const int mode = mp.mode, b_in = mp.b_in, b_out = mp.b_out, pad = mp.pad;

  bool rv[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // target row of dy = d - 1; an absent row is loaded clamped (and unused)
    int s = mode == kDown ? 2 * i + d - 1 : i + d - 1;
    if (mode == kUp) {
      // C++ division truncates: test s >= 0 and its parity before halving
      rv[d] = s >= 0 && s % 2 == 0 && s / 2 < mp.ny_in;
      s = s >= 0 ? s / 2 : 0;
    } else {
      rv[d] = s >= 0 && s < mp.ny_in;
    }
    s = min(max(s, 0), mp.ny_in - 1);
    for (int e = threadIdx.x; e < pad; e += blockDim.x)
      xt[d * pad + e] = e < b_in ? mp.x_in[(size_t)s * b_in + e] : INT_MAX;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < b_out; r += blockDim.x) {
    const int q = mp.xq[(size_t)i * b_out + r];
    const bool qvalid = q < kNbrBig;
    int* o = mp.out + (size_t)i * kNbrRows * b_out + r;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int d = j / 3, dx = j % 3 - 1;
      bool ok = qvalid && rv[d];
      int xp;
      if (mode == kSubm) {
        xp = q + dx;
      } else if (mode == kDown) {
        xp = 2 * q + dx;
      } else {
        const int num = q + dx + 2;  // >= 1: truncation is the floor
        xp = num / 2 - 1;
        ok = ok && num % 2 == 0;
      }
      const int* row = xt + d * pad;
      const int rank = lower_bound(row, pad, xp);
      const bool found = ok && rank < b_in && row[min(rank, pad - 1)] == xp;
      o[(size_t)j * b_out] = found ? rank : b_in;
    }
    for (int j = 9; j < kNbrRows; ++j) o[(size_t)j * b_out] = b_in;
  }
}

}  // namespace

// n_maps maps; map k reads ptrs[3k..3k+2] = xq, x_in, out and
// dims[5k..5k+4] = ny_out, b_out, ny_in, b_in, mode (0 'subm', 1 'down',
// 2 'up').
DZ_EXPORT int dz_rowpad_nbr_maps(const void* const* ptrs, const int* dims,
                                 int n_maps, void* stream) {
  if (n_maps < 1 || n_maps > kMaxMaps) return (int)cudaErrorInvalidValue;
  NbrMaps maps = {};
  maps.n = n_maps;
  int rows = 0, pad_max = 1;
  for (int k = 0; k < n_maps; ++k) {
    NbrMap& mp = maps.map[k];
    mp.xq = (const int*)ptrs[3 * k];
    mp.x_in = (const int*)ptrs[3 * k + 1];
    mp.out = (int*)ptrs[3 * k + 2];
    mp.ny_out = dims[5 * k];
    mp.b_out = dims[5 * k + 1];
    mp.ny_in = dims[5 * k + 2];
    mp.b_in = dims[5 * k + 3];
    mp.mode = dims[5 * k + 4];
    if (mp.mode < kSubm || mp.mode > kUp || mp.ny_in < 1 || mp.b_in < 1 ||
        mp.ny_out < 0 || mp.b_out < 0)
      return (int)cudaErrorInvalidValue;
    mp.pad = 1;
    while (mp.pad < mp.b_in) mp.pad *= 2;
    if (mp.pad > pad_max) pad_max = mp.pad;
    // a map with no output rows or lanes takes no block
    const bool work = mp.ny_out > 0 && mp.b_out > 0;
    mp.row0 = work ? rows : INT_MAX;
    rows += work ? mp.ny_out : 0;
  }
  const size_t smem = (size_t)3 * pad_max * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (rows == 0) return dz_launch_status();
  rowpad_nbr_maps_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      maps);
  return dz_launch_status();
}
