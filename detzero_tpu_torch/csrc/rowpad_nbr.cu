// K8 (dz_rowpad_nbr): the neighbour-rank maps of the row-pad plan; replaces
// detzero_tpu/ops/pallas_pillar.py::rowpad_nbr (_nbr_kernel).
//   xq   (ny_out, b_out) i32  x-coord of each output slot, kNbrBig if empty
//   x_in (ny_in, b_in)   i32  the target level's x-coords, same fill
//   out  (ny_out, 16, b_out) i32
// Row j < 9 of out holds, for tap (dy, dx) = (j/3 - 1, j%3 - 1), the rank of
// the neighbour inside its target row, b_in where the tap is absent; rows
// 9..15 hold b_in.  Target (row, x): (y+dy, x+dx) in 'subm', (2y+dy, 2x+dx)
// in 'down', ((y+dy)/2, (x+dx)/2) in 'up' when both are even.  Within a row
// the cells are unique and x-sorted, so the rank of x' is the count of
// strictly smaller x-coords and the tap is present when one equals x'.  The
// count runs over all b_in slots: the kNbrBig fill is never smaller than a
// query of a live slot.  A row that held more pillars than b_in kept its
// first b_in, which the count sees as they are.
//
// Bound on the H100: a map is (ny_out * 16 * b_out) int32 written once, 12
// MB at L0; the compares (9 * b_in per query) are CUDA-core work of a few
// microseconds.  Design: one block per output row, the three target rows in
// shared memory, one thread per query lane; every thread of a block reads
// the same target element at once (a broadcast), so shared memory never
// conflicts, and the map's rows are written by neighbouring lanes.
#include "common.cuh"

namespace {

constexpr int kNbrRows = 16;
constexpr int kNbrBig = 1 << 28;  // 2 * kNbrBig + 1 stays in int32 ('down')
constexpr int kThreads = 128;

enum Mode { kSubm = 0, kDown = 1, kUp = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    rowpad_nbr_kernel(const int* __restrict__ xq, const int* __restrict__ x_in,
                      int* __restrict__ out, int b_out, int ny_in, int b_in) {
  extern __shared__ int xt[];  // 3 * b_in: the target rows of dy = -1, 0, 1
  const int i = blockIdx.x;
  bool rv[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // target row of dy = d - 1; an absent row is loaded clamped (and unused)
    int s = kMode == kDown ? 2 * i + d - 1 : i + d - 1;
    if (kMode == kUp) {
      // C++ division truncates: test s >= 0 and its parity before halving
      rv[d] = s >= 0 && s % 2 == 0 && s / 2 < ny_in;
      s = s >= 0 ? s / 2 : 0;
    } else {
      rv[d] = s >= 0 && s < ny_in;
    }
    s = min(max(s, 0), ny_in - 1);
    for (int e = threadIdx.x; e < b_in; e += blockDim.x)
      xt[d * b_in + e] = x_in[(size_t)s * b_in + e];
  }
  __syncthreads();

  for (int r = threadIdx.x; r < b_out; r += blockDim.x) {
    const int q = xq[(size_t)i * b_out + r];
    const bool qvalid = q < kNbrBig;
    int* o = out + (size_t)i * kNbrRows * b_out + r;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int d = j / 3, dx = j % 3 - 1;
      bool ok = qvalid && rv[d];
      int xp;
      if (kMode == kSubm) {
        xp = q + dx;
      } else if (kMode == kDown) {
        xp = 2 * q + dx;
      } else {
        const int num = q + dx + 2;  // >= 1: truncation is the floor
        xp = num / 2 - 1;
        ok = ok && num % 2 == 0;
      }
      const int* row = xt + d * b_in;
      int lt = 0;
      bool eq = false;
      for (int e = 0; e < b_in; ++e) {
        const int v = row[e];
        lt += v < xp;
        eq |= v == xp;
      }
      o[(size_t)j * b_out] = ok && eq ? lt : b_in;
    }
    for (int j = 9; j < kNbrRows; ++j) o[(size_t)j * b_out] = b_in;
  }
}

}  // namespace

// mode 0 'subm', 1 'down', 2 'up'
DZ_EXPORT int dz_rowpad_nbr(const void* xq, const void* x_in, void* out,
                            int ny_out, int b_out, int ny_in, int b_in,
                            int mode, void* stream) {
  const size_t smem = (size_t)3 * b_in * sizeof(int);
  if (mode < kSubm || mode > kUp || ny_in < 1 || b_in < 1 ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (ny_out == 0 || b_out == 0) return dz_launch_status();
  auto kern = mode == kSubm   ? rowpad_nbr_kernel<kSubm>
              : mode == kDown ? rowpad_nbr_kernel<kDown>
                              : rowpad_nbr_kernel<kUp>;
  kern<<<ny_out, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)xq, (const int*)x_in, (int*)out, b_out, ny_in, b_in);
  return dz_launch_status();
}
