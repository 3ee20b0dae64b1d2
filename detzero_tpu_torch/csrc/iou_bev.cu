// Rotated BEV boxes as [x, y, dx, dy, heading]: the N x M matrix
// boxes_a (n, 5) x boxes_b (m, 5) -> (n, m) f32 of IoU (kernel K3) or of
// intersection areas (kernel K7), NMS's suppression bitmask of k boxes
// against themselves (k, ceil(k / 64)) uint64 (the mask half of kernel
// K10, walked by nms_walk.cu), and the matched-pair overlap / IoU
// (n, 5) x (n, 5) -> (n,) f32 (kernel K6).
//
// Replaces detzero_tpu/ops/pallas_iou.py::_launch with both of its
// epilogues, boxes_iou_bev (_iou_kernel) and boxes_overlap_bev
// (_overlap_kernel; the N x M overlap that iou3d.boxes_iou3d takes, as the
// RoI targets of the two-stage training loss do), over _overlap_tile and
// _clip_area; and the pairwise kernels of _launch_pairwise
// (_overlap_tile_pairwise, _pairwise_iou_kernel).  The TPU kernel runs the
// Sutherland-Hodgman clip over a (128, 128) tile of pairs as vector ops with
// eight polygon slots per pair.  The arithmetic here follows _clip_area
// step for step: the same corner order, the on-edge rule d >= -1e-3, the
// |denom| > 1e-8 guard, order-keeping ring compaction, the shoelace area and
// the 1e-6 union clamp.  Every product and sum is rounded on its own (no
// fused multiply-add), as the plain PyTorch version rounds it, because
// near-threshold NMS keep sets depend on the last bit.
//
// Work.  The clip of one pair costs 778 float32 operations (a compare, abs,
// sin or cos counting one): the corners of both boxes (2 x 44), four edges
// of eight vertex slots each (4 x (2 + 8 x 20): the side test 5, its
// compare, the crossing test 4, denom, guard 2, t and the point 6) and the
// shoelace over eight slots (8 x 5 + 2); the IoU epilogue adds 6.  What the
// data need is less: the corners once per box, and for most pairs of a
// scene (far apart, or a padded box) only the side tests that show the
// clip's result without running it.  chip_smoke.py's clip_ops counts that
// work on the inputs it times.  The bound at every shape the paths run is
// the bytes: 20 read per box, 4 written per pair (the mask: 1 bit).
//
// Design of the matrix (K3, K7): two kernels on one stream.  The first,
// one thread a box, computes for each of the n + m boxes its four corners,
// its area dx * dy, the shoelace area of its quad and its four edge
// vectors, with the arithmetic of corners() and clip_area() as the per-pair
// code would, into a scratch array, one row of n + m a field (the same
// bits, read back).  It holds sinf/cosf, whose slow path for |heading| >
// 105615 (Payne-Hanek reduction) keeps a 28-byte array in local memory:
// ptxas's stack frame of that kernel, never touched at real headings, and
// kept out of the matrix kernel this way.  In the matrix kernel a block
// owns a 64 x 64 tile of pairs; its prologue copies the tile's A and B
// records into shared memory.  Each warp then owns 8 rows of the tile and classifies its 512
// pairs, a lane on neighbouring columns, with classify():
//
//   The clip starts from A's four corners.  At B's edge e, if every corner
//   is inside (d >= -1e-3), the edge emits them unchanged (no crossing, the
//   same slots, n = 4); if none is, the polygon is emptied and the result
//   is exactly 0.  So walking B's edges in the clip's own order, the first
//   edge that does not keep all four corners decides: none kept -> 0, some
//   kept -> the pair needs the clip.  If all four edges keep all corners
//   (A inside B up to the tolerance, or B of zero size, whose edges are
//   null vectors with d = 0), the clip leaves A's quad as it was and the
//   result is its shoelace area, a constant of A computed in the prologue.
//   The side tests are the clip's own, rounded alike on the same corners,
//   so the cull gives the very bits the clip would: there is no margin.
//
// A distance test (circumcircles apart by some margin) cannot be made
// exact: where a vertex of A lies within the on-edge band outside one of
// B's edge lines (d in [-1e-3, 0)) and its neighbour beyond it, the
// crossing point t = d_k / (d_k - d_next) is extrapolated along A's edge
// onto B's edge line, as far as 1e-3 / |d_k - d_next| edge lengths.  A box
// 50 m from B whose edge lies along the extension of B's edge line at
// 0.25 mm and tilts by 1e-5 rad gets a nonzero overlap from the plain clip
// and the reference (tests/test_torch_nbr_iou_redesign.py holds such pairs).
//
// The pairs that need the clip are compacted with __ballot_sync into the
// warp's queue in shared memory, and the warp clips them 32 at a time,
// every lane busy.  Culled pairs are written at once, coalesced along the
// row.  The clip keeps its ring in registers: every array index is a
// compile-time constant, the emit at rank `run` is a select over the slots
// it can reach, and the successor of slot k is a select between k + 1 and
// slot 0.  The pairwise kernel (K6) clips every pair with the same
// arithmetic, a group of 8 lanes a pair (see there).
#include "common.cuh"

namespace {

constexpr int kCap = 8;
constexpr float kTol = 1e-3f;
constexpr float kEps = 1e-8f;
constexpr int kTile = 64;                      // a block's 64 x 64 pairs
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kTile / kWarps;   // 8 rows of the tile a warp

// rows of a box's record: corners x[4], y[4], area dx * dy, the shoelace
// area of its quad, edge vectors ex[4], ey[4].  A tile's A boxes take the
// first kRowsA rows into shared memory, its B boxes all but the quad area.
constexpr int kArea = 8, kQuadArea = 9, kEx = 10, kEy = 14, kRecRows = 18;
constexpr int kRowsA = 10;

enum Class { kEmpty = 0, kInside = 1, kClip = 2 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// corner (tx, ty) of _corners' template, for cos c and sin s of the heading
__device__ __forceinline__ void corner(const float* box, float c, float s,
                                       float tx, float ty, float& x,
                                       float& y) {
  const float lx = mul(tx, mul(box[2], 0.5f)), ly = mul(ty, mul(box[3], 0.5f));
  x = sub(add(box[0], mul(lx, c)), mul(ly, s));
  y = add(add(box[1], mul(lx, s)), mul(ly, c));
}

// the 4 ccw corners of _corners: template (1,1), (-1,1), (-1,-1), (1,-1)
__device__ __forceinline__ void corners(const float* box, float* cx,
                                        float* cy) {
  const float c = cosf(box[4]), s = sinf(box[4]);
  const float tx[4] = {1.f, -1.f, -1.f, 1.f};
  const float ty[4] = {1.f, 1.f, -1.f, -1.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) corner(box, c, s, tx[k], ty[k], cx[k], cy[k]);
}

// B's edge vectors, as _clip_area takes them: (x2 - x1, y2 - y1)
__device__ __forceinline__ void edges(const float* bx, const float* by,
                                      float* ex, float* ey) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ex[e] = sub(bx[(e + 1) % 4], bx[e]);
    ey[e] = sub(by[(e + 1) % 4], by[e]);
  }
}

// the side test of _clip_area: ex * (py - y1) - ey * (px - x1)
__device__ __forceinline__ float side(float ex, float ey, float x1, float y1,
                                      float px, float py) {
  return sub(mul(ex, sub(py, y1)), mul(ey, sub(px, x1)));
}

// Slot k's successor in the compacted ring of n: k + 1, n - 1 wraps to 0.
// k is a constant once the callers' loops are unrolled.
__device__ __forceinline__ float nxt(const float* v, int k, int n) {
  return n == k + 1 ? v[0] : v[(k + 1) % kCap];
}

// 0.5 |shoelace| of the ring (px, py, pv) of n, zero below 3 vertices
__device__ __forceinline__ float shoelace(const float* px, const float* py,
                                          const float* pv, int n) {
  float area2 = 0.f;
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    const float cross =
        sub(mul(px[k], nxt(py, k, n)), mul(nxt(px, k, n), py[k]));
    area2 = add(area2, mul(pv[k], cross));
  }
  return n >= 3 ? mul(fabsf(area2), 0.5f) : 0.f;
}

// The shoelace area of A's own quad: the clip's result where every edge of
// B keeps all four corners (the ring then stays as it started).
__device__ __forceinline__ float quad_area(const float* ax, const float* ay) {
  float px[kCap], py[kCap], pv[kCap];
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    px[k] = k < 4 ? ax[k] : 0.f;
    py[k] = k < 4 ? ay[k] : 0.f;
    pv[k] = k < 4 ? 1.f : 0.f;
  }
  return shoelace(px, py, pv, 4);
}

// What the clip of A's quad by B's half-planes comes to, from its own side
// tests on A's corners in its own edge order (see the header).
__device__ __forceinline__ int classify(const float* ax, const float* ay,
                                        const float* bx, const float* by,
                                        const float* ex, const float* ey) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int kept = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      kept += side(ex[e], ey[e], bx[e], by[e], ax[k], ay[k]) >= -kTol;
    if (kept == 0) return kEmpty;
    if (kept < 4) return kClip;
  }
  return kInside;
}

// Write (x, y) to slot `run` of the ring q when `emit`.  The rank of an
// emit from position p of the emit list is at most p, so only slots up to
// max_rank = p are tested; p, and so every index, is a constant once the
// caller's loop is unrolled.
__device__ __forceinline__ void emit_at(float* qx, float* qy, int run,
                                        bool emit, float x, float y,
                                        int max_rank) {
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    if (j <= max_rank) {
      const bool here = emit && run == j;
      qx[j] = here ? x : qx[j];
      qy[j] = here ? y : qy[j];
    }
  }
}

// _clip_area: A's quad clipped by B's four half-planes (B's corners and
// edge vectors), the area of what is left.  Inlined, so that the callers'
// corner arrays stay in registers.
__device__ __forceinline__ float clip_area(const float* ax, const float* ay,
                                           const float* bx, const float* by,
                                           const float* ex,
                                           const float* ey) {
  float px[kCap], py[kCap], pv[kCap];
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    px[k] = k < 4 ? ax[k] : 0.f;
    py[k] = k < 4 ? ay[k] : 0.f;
    pv[k] = k < 4 ? 1.f : 0.f;
  }
  int n = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float d[kCap], in[kCap];
#pragma unroll
    for (int k = 0; k < kCap; ++k) {
      d[k] = side(ex[e], ey[e], bx[e], by[e], px[k], py[k]);
      in[k] = d[k] >= -kTol ? pv[k] : 0.f;
    }
    float qx[kCap], qy[kCap];
#pragma unroll
    for (int k = 0; k < kCap; ++k) qx[k] = qy[k] = 0.f;
    int run = 0;   // valid emits so far: the rank of the next one
#pragma unroll
    for (int k = 0; k < kCap; ++k) {
      const float nxk = nxt(px, k, n), nyk = nxt(py, k, n);
      const float ndk = nxt(d, k, n);
      const float nin = nxt(in, k, n) * pv[k];
      const float crossing = pv[k] * fabsf(in[k] - nin);
      const float denom = sub(d[k], ndk);
      const float safe = fabsf(denom) > kEps ? denom : 1.f;
      const float t = __fdiv_rn(d[k], safe);
      const float ix = add(px[k], mul(t, sub(nxk, px[k])));
      const float iy = add(py[k], mul(t, sub(nyk, py[k])));
      // emit (vertex if inside, crossing point if the edge crosses); the
      // rank of a valid emit is the count of valid emits before it
      const bool vin = in[k] > 0.f, vcross = crossing > 0.f;
      emit_at(qx, qy, run, vin, px[k], py[k], 2 * k);
      run += vin;
      emit_at(qx, qy, run, vcross, ix, iy, 2 * k + 1);
      run += vcross;
    }
#pragma unroll
    for (int k = 0; k < kCap; ++k) {
      px[k] = qx[k];
      py[k] = qy[k];
      pv[k] = k < run ? 1.f : 0.f;
    }
    n = run;
  }
  return shoelace(px, py, pv, n);
}

__device__ __forceinline__ float iou_of(float inter, float area_a,
                                        float area_b) {
  const float uni = fmaxf(sub(add(area_a, area_b), inter), 1e-6f);
  return __fdiv_rn(inter, uni);
}

// The boxes' records, row r of box g at rec[r * (n + m) + g]: boxes_a
// first, then boxes_b.
__global__ void iou_bev_boxes_kernel(const float* __restrict__ boxes_a,
                                     const float* __restrict__ boxes_b,
                                     float* __restrict__ rec, int n, int m) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x, total = n + m;
  if (g >= total) return;
  const float* src = g < n ? boxes_a + (size_t)g * 5
                           : boxes_b + (size_t)(g - n) * 5;
  float box[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) box[q] = src[q];
  float cx[4], cy[4], ex[4], ey[4];
  corners(box, cx, cy);
  edges(cx, cy, ex, ey);
  float* r = rec + g;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[(size_t)k * total] = cx[k];
    r[(size_t)(4 + k) * total] = cy[k];
    r[(size_t)(kEx + k) * total] = ex[k];
    r[(size_t)(kEy + k) * total] = ey[k];
  }
  r[(size_t)kArea * total] = mul(box[2], box[3]);
  r[(size_t)kQuadArea * total] = quad_area(cx, cy);
}

// What the matrix kernel's epilogue writes for a pair: the IoU (K3), the
// intersection area (K7), or NMS's suppression bit (K10's mask).
enum Epilogue { kEpIoU = 0, kEpOverlap = 1, kEpMask = 2 };

// The N x M matrix from the boxes' records: A's record of box g at column
// g, B's at column b_off + g, of a record array `total` columns wide.
//
// kEpMask (K10, replacing the IoU tiles of pallas_iou._launch_nms): one
// box set against itself (n == m, b_off 0), only the tiles on or above the
// diagonal, one block a tile in row-major order of blockIdx.x.  Row i of
// the tile gives one 64-bit word: bit jl of word (i, tile column) is
//   iou_of(inter, area_i, area_j) > thresh  &&  j > i  &&  j < n,
// the IoU epilogue's own value compared in float32, so the bits are those
// of K3's matrix, packed.  Culled pairs set theirs by ballot (columns lane
// and lane + 32), clipped pairs OR theirs into the row's shared word; a
// warp owns its 8 rows, so it writes their words once at the end.  The
// diagonal tile also writes the zero words left of it, so the whole
// (n, words) array is written and nothing else touches it.
template <int kEp>
__global__ void __launch_bounds__(kThreads)
    iou_bev_matrix_kernel(const float* __restrict__ rec,
                          void* __restrict__ out_, int n, int m, int total,
                          int b_off, float thresh, int words) {
  __shared__ float sa[kRowsA][kTile];
  __shared__ float sb[kRecRows][kTile];  // row kQuadArea unused
  __shared__ unsigned short queue[kWarps][kRowsPerWarp * kTile];
  __shared__ unsigned smask[kEp == kEpMask ? kTile : 1][2];
  float* out = (float*)out_;
  unsigned long long* words_out = (unsigned long long*)out_;
  int ty = blockIdx.y, tx = blockIdx.x;
  if (kEp == kEpMask) {
    // upper-triangle tile number -> (ty, tx), row ty holding T - ty tiles
    const int T = words;
    const long long L = blockIdx.x;
    const double c = 2.0 * T + 1.0;
    ty = (int)((c - sqrt(c * c - 8.0 * (double)L)) * 0.5);
    auto first = [T](long long r) { return r * T - r * (r - 1) / 2; };
    while (ty > 0 && first(ty) > L) --ty;
    while (first(ty + 1) <= L) ++ty;
    tx = ty + (int)(L - first(ty));
  }
  const int n0 = ty * kTile, m0 = tx * kTile;
  const int t = threadIdx.x;

  // prologue: one box a thread, A's by threads 0..63, B's by 64..127; a
  // box past the end reads as zeros and is never written out
  if (t < 2 * kTile) {
    const bool is_a = t < kTile;
    const int c = is_a ? t : t - kTile;
    const int g = (is_a ? n0 : m0) + c;
    const bool live = g < (is_a ? n : m);
    const float* r = rec + (is_a ? g : b_off + g);
    float(*dst)[kTile] = is_a ? sa : sb;
#pragma unroll
    for (int k = 0; k < kRecRows; ++k)
      if (k < kRowsA || !is_a)
        dst[k][c] = live ? r[(size_t)k * total] : 0.f;
  }
  if (kEp == kEpMask && tx == ty) {
    // the words left of the diagonal, zero
    for (int e = t; e < kTile * tx; e += kThreads) {
      const int i = n0 + e / tx;
      if (i < n) words_out[(size_t)i * words + e % tx] = 0ull;
    }
  }
  __syncthreads();

  const int warp = t / 32, lane = t % 32;
  unsigned short* q = queue[warp];
  // this lane's two B boxes, columns lane and lane + 32
  float bx[2][4], by[2][4], ex[2][4], ey[2][4], area_b[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jl = h * 32 + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bx[h][k] = sb[k][jl];
      by[h][k] = sb[4 + k][jl];
      ex[h][k] = sb[kEx + k][jl];
      ey[h][k] = sb[kEy + k][jl];
    }
    area_b[h] = sb[kArea][jl];
  }
  int qn = 0;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int il = warp * kRowsPerWarp + rr, i = n0 + il;
    if (i >= n) break;  // the same for the whole warp
    float ax[4], ay[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ax[k] = sa[k][il];
      ay[k] = sa[4 + k][il];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jl = h * 32 + lane, j = m0 + jl;
      bool clip = false, bit = false;
      if (j < m && (kEp != kEpMask || j > i)) {
        const int cls = classify(ax, ay, bx[h], by[h], ex[h], ey[h]);
        clip = cls == kClip;
        if (!clip) {
          const float inter = cls == kInside ? sa[kQuadArea][il] : 0.f;
          if (kEp == kEpMask)
            bit = iou_of(inter, sa[kArea][il], area_b[h]) > thresh;
          else
            out[(size_t)i * m + j] =
                kEp == kEpIoU ? iou_of(inter, sa[kArea][il], area_b[h])
                              : inter;
        }
      }
      if (kEp == kEpMask) {
        const unsigned bits = __ballot_sync(0xffffffffu, bit);
        if (lane == 0) smask[il][h] = bits;
      }
      const unsigned ball = __ballot_sync(0xffffffffu, clip);
      if (clip)
        q[qn + __popc(ball & ((1u << lane) - 1u))] =
            (unsigned short)(il * kTile + jl);
      qn += __popc(ball);
    }
  }
  __syncwarp();

  // the pairs that need the clip, 32 at a time
  for (int base = 0; base < qn; base += 32) {
    const int s = base + lane;
    if (s >= qn) break;
    const int il = q[s] / kTile, jl = q[s] % kTile;
    float ax[4], ay[4], cbx[4], cby[4], cex[4], cey[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ax[k] = sa[k][il];
      ay[k] = sa[4 + k][il];
      cbx[k] = sb[k][jl];
      cby[k] = sb[4 + k][jl];
      cex[k] = sb[kEx + k][jl];
      cey[k] = sb[kEy + k][jl];
    }
    const float inter = clip_area(ax, ay, cbx, cby, cex, cey);
    if (kEp == kEpMask) {
      if (iou_of(inter, sa[kArea][il], sb[kArea][jl]) > thresh)
        atomicOr(&smask[il][jl / 32], 1u << (jl % 32));
    } else {
      out[(size_t)(n0 + il) * m + m0 + jl] =
          kEp == kEpIoU ? iou_of(inter, sa[kArea][il], sb[kArea][jl])
                        : inter;
    }
  }
  if (kEp == kEpMask) {
    __syncwarp();
    const int il = warp * kRowsPerWarp + lane, i = n0 + il;
    if (lane < kRowsPerWarp && i < n)
      words_out[(size_t)i * words + tx] =
          ((unsigned long long)smask[il][1] << 32) | smask[il][0];
  }
}

// Matched pairs (kernel K6, pallas_iou._launch_pairwise): pair i is
// (boxes_a[i], boxes_b[i]); the intersection area, or with `iou` the IoU
// with the same union clamp as above.  One pair's clip is a serial chain
// (4 stages over a ring of 8 slots), so a thread a pair left a launch of
// 1,000 pairs on 8 SMs, as long as one thread's chain.  Here a group of 8
// lanes takes a pair (4 pairs a warp) and lane k owns slot k of the ring:
// lanes 0-3 compute the corners of both boxes and B's edges; in each clip
// stage every lane makes its slot's side test, in flag, crossing test and
// crossing point, reading its successor's values by shuffle within the
// group; the emit ranks are an exclusive prefix of the emit counts over the
// group, and lane k of the next ring fetches the emit of rank k from the
// lane that made it; the shoelace terms are formed a lane and summed in slot
// order.  Every float operation is clip_area's, in its order, so the result
// is the thread-a-pair kernel's to the bit.
constexpr int kGroup = 8;          // lanes a pair: one a ring slot
constexpr int kPairThreads = 64;   // 8 pairs a block

__global__ void __launch_bounds__(kPairThreads)
    iou_bev_pairwise_kernel(const float* __restrict__ boxes_a,
                            const float* __restrict__ boxes_b,
                            float* __restrict__ out, int n, int iou) {
  static_assert(kCap == kGroup, "a lane a ring slot");
  constexpr unsigned kAll = 0xffffffffu;
  const int gid = blockIdx.x * kPairThreads + threadIdx.x;
  const int i = gid / kGroup, k = gid % kGroup;
  const bool live = i < n;  // lanes past n run along for the shuffles
  float a[5], b[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    a[q] = live ? boxes_a[(size_t)i * 5 + q] : 0.f;
    b[q] = live ? boxes_b[(size_t)i * 5 + q] : 0.f;
  }
  auto lane_of = [&](float v, int src) {
    return __shfl_sync(kAll, v, src, kGroup);
  };
  // slot k starts as A's corner k (k < 4); lane k < 4 also holds B's
  // corner k and edge k
  float px = 0.f, py = 0.f, pv = 0.f, bx = 0.f, by = 0.f;
  if (k < 4) {
    const float tx = k == 0 || k == 3 ? 1.f : -1.f, ty = k < 2 ? 1.f : -1.f;
    corner(a, cosf(a[4]), sinf(a[4]), tx, ty, px, py);
    corner(b, cosf(b[4]), sinf(b[4]), tx, ty, bx, by);
    pv = 1.f;
  }
  const float ex = sub(lane_of(bx, (k + 1) % 4), bx);
  const float ey = sub(lane_of(by, (k + 1) % 4), by);
  const int next = (k + 1) % kGroup;
  int n_ring = 4;
  // the successor of slot k in the compacted ring of n_ring (nxt())
  auto succ = [&](float v) {
    const float first = lane_of(v, 0), after = lane_of(v, next);
    return n_ring == k + 1 ? first : after;
  };
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float d = side(lane_of(ex, e), lane_of(ey, e), lane_of(bx, e),
                         lane_of(by, e), px, py);
    const float in = d >= -kTol ? pv : 0.f;
    const float nxk = succ(px), nyk = succ(py), ndk = succ(d);
    const float nin = succ(in) * pv;
    const float crossing = pv * fabsf(in - nin);
    const float denom = sub(d, ndk);
    const float safe = fabsf(denom) > kEps ? denom : 1.f;
    const float t = __fdiv_rn(d, safe);
    const float ix = add(px, mul(t, sub(nxk, px)));
    const float iy = add(py, mul(t, sub(nyk, py)));
    // emits: the vertex if inside, then the crossing point if the edge
    // crosses; ranks from an exclusive prefix over the group
    const int vin = in > 0.f, cnt = vin + (crossing > 0.f);
    int incl = cnt;
#pragma unroll
    for (int dd = 1; dd < kGroup; dd <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, dd, kGroup);
      if (k >= dd) incl += v;
    }
    const int excl = incl - cnt;
    const int run = __shfl_sync(kAll, incl, kGroup - 1, kGroup);
    // the lane whose emits hold rank k: the first whose inclusive count
    // passes k (none when k >= run)
    int src = 0;
#pragma unroll
    for (int l = 0; l < kGroup; ++l)
      src += __shfl_sync(kAll, incl, l, kGroup) <= k;
    const int sl = src < kGroup ? src : 0;
    const float vx = lane_of(px, sl), vy = lane_of(py, sl);
    const float cx = lane_of(ix, sl), cy = lane_of(iy, sl);
    const int s_excl = __shfl_sync(kAll, excl, sl, kGroup);
    const int s_vin = __shfl_sync(kAll, vin, sl, kGroup);
    const bool vert = s_excl == k && s_vin != 0;
    px = k < run ? (vert ? vx : cx) : 0.f;
    py = k < run ? (vert ? vy : cy) : 0.f;
    pv = k < run ? 1.f : 0.f;
    n_ring = run;
  }
  // 0.5 |shoelace|, the terms summed in slot order
  const float term = mul(pv, sub(mul(px, succ(py)), mul(succ(px), py)));
  float area2 = 0.f;
#pragma unroll
  for (int l = 0; l < kGroup; ++l) area2 = add(area2, lane_of(term, l));
  const float inter = n_ring >= 3 ? mul(fabsf(area2), 0.5f) : 0.f;
  if (live && k == 0)
    out[i] = iou ? iou_of(inter, mul(a[2], a[3]), mul(b[2], b[3])) : inter;
}

}  // namespace

DZ_EXPORT int dz_iou_bev_pairwise(const void* boxes_a, const void* boxes_b,
                                  void* out, int n, int iou, void* stream) {
  if (n == 0) return dz_launch_status();
  const long long lanes = (long long)n * kGroup;
  if (lanes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  iou_bev_pairwise_kernel<<<(unsigned)((lanes + kPairThreads - 1) /
                                       kPairThreads),
                            kPairThreads, 0, (cudaStream_t)stream>>>(
      (const float*)boxes_a, (const float*)boxes_b, (float*)out, n, iou);
  return dz_launch_status();
}

// iou != 0: the IoU matrix (K3); iou == 0: the intersection areas (K7).
// scratch holds 18 * (n + m) floats: the boxes' records (kRecRows).
DZ_EXPORT int dz_iou_bev(const void* boxes_a, const void* boxes_b, void* out,
                         void* scratch, int n, int m, int iou, void* stream) {
  if (n == 0 || m == 0) return dz_launch_status();
  dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* rec = (float*)scratch;
  const int threads = 128;
  iou_bev_boxes_kernel<<<(n + m + threads - 1) / threads, threads, 0, st>>>(
      (const float*)boxes_a, (const float*)boxes_b, rec, n, m);
  if (iou)
    iou_bev_matrix_kernel<kEpIoU><<<grid, kThreads, 0, st>>>(
        rec, out, n, m, n + m, n, 0.f, 0);
  else
    iou_bev_matrix_kernel<kEpOverlap><<<grid, kThreads, 0, st>>>(
        rec, out, n, m, n + m, n, 0.f, 0);
  return dz_launch_status();
}

// K10's suppression mask of k score-sorted boxes (k, 5): words (k,
// ceil(k / 64)) uint64, bit j % 64 of word (i, j / 64) set where box i's
// IoU with a later box j exceeds thresh.  scratch holds 18 * k floats.
DZ_EXPORT int dz_nms_mask(const void* boxes, void* words, void* scratch,
                          int k, float thresh, void* stream) {
  if (k == 0) return dz_launch_status();
  const int T = (k + kTile - 1) / kTile;
  const long long tiles = (long long)T * (T + 1) / 2;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* rec = (float*)scratch;
  const int threads = 128;
  iou_bev_boxes_kernel<<<(k + threads - 1) / threads, threads, 0, st>>>(
      (const float*)boxes, (const float*)boxes, rec, k, 0);
  iou_bev_matrix_kernel<kEpMask><<<(unsigned)tiles, kThreads, 0, st>>>(
      rec, words, k, k, k, 0, thresh, T);
  return dz_launch_status();
}
