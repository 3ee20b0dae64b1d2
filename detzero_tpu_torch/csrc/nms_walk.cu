// Greedy NMS walk over a score-sorted (k, k) IoU matrix -> keep mask (k,).
//
// Replaces the walk of detzero_tpu/ops/pallas_iou.py::nms_keep_mask
// (_nms_kernel_factory, the fori_loop after the IoU tiles), with the
// semantics of detzero_tpu/ops/nms.py::_greedy_suppress over all k boxes:
//   keep_i = valid[i] & !suppressed[i];  suppress j > i with iou[i, j] > t.
// The reference runs the walk as an XLA loop; in eager PyTorch it would be
// k dependent launches per frame.
//
// Bound on the H100: latency.  The walk is sequential in i, so one block
// does all of it: the suppression flags live in shared memory, each step
// reads one IoU row (only when box i survives) with the block's threads
// striding over j, and one barrier orders the steps.
#include "common.cuh"

namespace {

__global__ void nms_walk_kernel(const float* __restrict__ iou,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int k,
                                float thresh) {
  extern __shared__ uint8_t smem[];
  uint8_t* sup = smem;      // (k,) suppressed
  uint8_t* val = smem + k;  // (k,) valid
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    sup[j] = 0;
    val[j] = valid[j] != 0;
  }
  __syncthreads();
  for (int i = 0; i < k; ++i) {
    if (val[i] && !sup[i]) {
      const float* row = iou + (size_t)i * k;
      for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x)
        if (row[j] > thresh) sup[j] = 1;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    keep[j] = val[j] && !sup[j];
}

}  // namespace

DZ_EXPORT int dz_nms_walk(const void* iou, const void* valid, void* keep,
                          int k, float thresh, void* stream) {
  if (k == 0) return dz_launch_status();
  const size_t smem = 2 * (size_t)k;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = k < 1024 ? ((k + 31) / 32) * 32 : 1024;
  nms_walk_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const float*)iou, (const uint8_t*)valid, (uint8_t*)keep, k, thresh);
  return dz_launch_status();
}
