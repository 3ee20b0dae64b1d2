// Rotated BEV boxes as [x, y, dx, dy, heading]: the N x M matrix
// boxes_a (n, 5) x boxes_b (m, 5) -> (n, m) f32 of IoU (kernel K3) or of
// intersection areas (kernel K7), and the matched-pair overlap / IoU
// (n, 5) x (n, 5) -> (n,) f32 (kernel K6).
//
// Replaces detzero_tpu/ops/pallas_iou.py::_launch with both of its
// epilogues, boxes_iou_bev (_iou_kernel) and boxes_overlap_bev
// (_overlap_kernel; the N x M overlap that iou3d.boxes_iou3d takes, as the
// RoI targets of the two-stage training loss do), over _overlap_tile and
// _clip_area; and the pairwise kernels of _launch_pairwise
// (_overlap_tile_pairwise, _pairwise_iou_kernel).  The TPU kernel runs the
// Sutherland-Hodgman clip over a (128, 128) tile of pairs as vector ops with
// eight polygon slots per pair; here one thread owns one pair and keeps its
// polygon (at most 8 vertices) in registers.  The arithmetic follows
// _clip_area step for step: the same corner order, the on-edge rule
// d >= -1e-3, the |denom| > 1e-8 guard, order-keeping ring compaction, the
// shoelace area and the 1e-6 union clamp.  Every product and sum is rounded
// on its own (no fused multiply-add), as the plain PyTorch version rounds
// it, because near-threshold NMS keep sets depend on the last bit.
//
// Work.  As written, a thread spends 778 float32 operations on its pair
// (a compare, abs, sin or cos counting one): the corners of both boxes
// (2 x 44), four edges of eight vertex slots each (4 x (2 + 8 x 20): the
// side test 5, its compare, the crossing test 4, denom, guard 2, t and the
// point 6) and the shoelace over eight slots (8 x 5 + 2); the IoU epilogue
// adds 6.  What the data need is less: the corners once per box, and for a
// pair whose circumcircles do not meet only that test; chip_smoke.py's
// clip_ops counts it on the inputs it times.  The bound at the RoI-target
// shape of the two-stage step, 128 x 500 mostly disjoint pairs, is the
// bytes (20 read per box, 4 written per pair, 0.27 MB): under 0.1 us on
// the H100.  The launch costs more than the work, so the matrix kernel
// stays one thread per pair with no shared-memory tiling.
#include "common.cuh"

namespace {

constexpr int kCap = 8;
constexpr float kTol = 1e-3f;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the 4 ccw corners of _corners: template (1,1), (-1,1), (-1,-1), (1,-1)
__device__ void corners(const float* box, float* cx, float* cy) {
  const float c = cosf(box[4]), s = sinf(box[4]);
  const float hx = mul(box[2], 0.5f), hy = mul(box[3], 0.5f);
  const float tx[4] = {1.f, -1.f, -1.f, 1.f};
  const float ty[4] = {1.f, 1.f, -1.f, -1.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lx = mul(tx[k], hx), ly = mul(ty[k], hy);
    cx[k] = sub(add(box[0], mul(lx, c)), mul(ly, s));
    cy[k] = add(add(box[1], mul(lx, s)), mul(ly, c));
  }
}

__device__ float clip_area(const float* ax, const float* ay, const float* bx,
                           const float* by) {
  float px[kCap], py[kCap], pv[kCap];
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    px[k] = k < 4 ? ax[k] : 0.f;
    py[k] = k < 4 ? ay[k] : 0.f;
    pv[k] = k < 4 ? 1.f : 0.f;
  }
  float n = 4.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x1 = bx[e], y1 = by[e];
    const float ex = sub(bx[(e + 1) % 4], x1), ey = sub(by[(e + 1) % 4], y1);
    float d[kCap], in[kCap];
#pragma unroll
    for (int k = 0; k < kCap; ++k) {
      d[k] = sub(mul(ex, sub(py[k], y1)), mul(ey, sub(px[k], x1)));
      in[k] = d[k] >= -kTol ? pv[k] : 0.f;
    }
    float qx[kCap], qy[kCap], qv[kCap];
#pragma unroll
    for (int k = 0; k < kCap; ++k) qx[k] = qy[k] = qv[k] = 0.f;
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < kCap; ++k) {
      // next vertex in the compacted ring: k+1, wrapping n-1 -> 0
      const int nk = (n == (float)(k + 1)) ? 0 : (k + 1) % kCap;
      const float nin = in[nk] * pv[k];
      const float crossing = pv[k] * fabsf(in[k] - nin);
      const float denom = sub(d[k], d[nk]);
      const float safe = fabsf(denom) > kEps ? denom : 1.f;
      const float t = __fdiv_rn(d[k], safe);
      const float ix = add(px[k], mul(t, sub(px[nk], px[k])));
      const float iy = add(py[k], mul(t, sub(py[nk], py[k])));
      // emit (vertex if inside, crossing point if the edge crosses); the
      // rank of a valid emit is the count of valid emits before it
      if (in[k] > 0.f) {
        const int j = (int)run;
        if (j < kCap) { qx[j] = px[k]; qy[j] = py[k]; qv[j] = 1.f; }
        run += in[k];
      }
      if (crossing > 0.f) {
        const int j = (int)run;
        if (j < kCap) { qx[j] = ix; qy[j] = iy; qv[j] = 1.f; }
        run += crossing;
      }
    }
#pragma unroll
    for (int k = 0; k < kCap; ++k) { px[k] = qx[k]; py[k] = qy[k]; pv[k] = qv[k]; }
    n = run;
  }
  float area2 = 0.f;
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    const int nk = (n == (float)(k + 1)) ? 0 : (k + 1) % kCap;
    area2 = add(area2, mul(pv[k], sub(mul(px[k], py[nk]), mul(px[nk], py[k]))));
  }
  return n >= 3.f ? mul(fabsf(area2), 0.5f) : 0.f;
}

// The N x M matrix; the epilogue writes the IoU (K3) or, with !kIoU, the
// intersection area (K7), as the TPU kernel's two epilogues do.
template <bool kIoU>
__global__ void iou_bev_kernel(const float* __restrict__ boxes_a,
                               const float* __restrict__ boxes_b,
                               float* __restrict__ out, int n, int m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m) return;
  const float* a = boxes_a + (size_t)i * 5;
  const float* b = boxes_b + (size_t)j * 5;
  float ax[4], ay[4], bx[4], by[4];
  corners(a, ax, ay);
  corners(b, bx, by);
  const float inter = clip_area(ax, ay, bx, by);
  if (!kIoU) {
    out[(size_t)i * m + j] = inter;
    return;
  }
  const float area_a = mul(a[2], a[3]), area_b = mul(b[2], b[3]);
  const float uni = fmaxf(sub(add(area_a, area_b), inter), 1e-6f);
  out[(size_t)i * m + j] = __fdiv_rn(inter, uni);
}

// Matched pairs (kernel K6, pallas_iou._launch_pairwise): pair i is
// (boxes_a[i], boxes_b[i]); the intersection area, or with `iou` the IoU
// with the same union clamp as above.
__global__ void iou_bev_pairwise_kernel(const float* __restrict__ boxes_a,
                                        const float* __restrict__ boxes_b,
                                        float* __restrict__ out, int n,
                                        int iou) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* a = boxes_a + (size_t)i * 5;
  const float* b = boxes_b + (size_t)i * 5;
  float ax[4], ay[4], bx[4], by[4];
  corners(a, ax, ay);
  corners(b, bx, by);
  const float inter = clip_area(ax, ay, bx, by);
  if (!iou) {
    out[i] = inter;
    return;
  }
  const float area_a = mul(a[2], a[3]), area_b = mul(b[2], b[3]);
  const float uni = fmaxf(sub(add(area_a, area_b), inter), 1e-6f);
  out[i] = __fdiv_rn(inter, uni);
}

}  // namespace

DZ_EXPORT int dz_iou_bev_pairwise(const void* boxes_a, const void* boxes_b,
                                  void* out, int n, int iou, void* stream) {
  if (n == 0) return dz_launch_status();
  const int threads = 128;
  iou_bev_pairwise_kernel<<<(n + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)boxes_a, (const float*)boxes_b, (float*)out, n, iou);
  return dz_launch_status();
}

// iou != 0: the IoU matrix (K3); iou == 0: the intersection areas (K7).
DZ_EXPORT int dz_iou_bev(const void* boxes_a, const void* boxes_b, void* out,
                         int n, int m, int iou, void* stream) {
  if (n == 0 || m == 0) return dz_launch_status();
  dim3 block(32, 8);
  dim3 grid((m + block.x - 1) / block.x, (n + block.y - 1) / block.y);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const float* a = (const float*)boxes_a;
  const float* b = (const float*)boxes_b;
  if (iou)
    iou_bev_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        a, b, (float*)out, n, m);
  else
    iou_bev_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        a, b, (float*)out, n, m);
  return dz_launch_status();
}
