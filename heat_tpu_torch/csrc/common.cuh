// Device helpers shared by the kernels of heat_tpu_torch.
//
// dot_f32 is the counterpart of heat_tpu/core/pallas_util.py::dot_f32, the
// f32-accumulated contraction that the TPU's cdist and Lloyd kernels share.
// There it dispatches between precision tiers of the TPU's matrix unit
// (a bf16x3 split product by default). Its tiers live on this card's tensor
// cores in the Hopper kernels: lloyd.cu's lloyd_tc and cdist.cu's cdist_tc
// compute the split product as 3xTF32 wgmma (hi = tf32(v), lo = v - hi;
// lo.hi + hi.lo + hi.hi), and cdist_tc one TF32 pass for the DEFAULT tier
// (HEAT_TPU_CDIST_PREC, spatial/cuda_cdist.py). The function here is the
// exact f32 tier (HIGHEST) of the older kernels, which run off the Hopper
// kernels' gates: one rank-1 update of a register tile by plain f32 FMAs,
// exact f32 products with f32 accumulation.
//
// Each source under csrc/ includes this header once and is built into its
// own shared library, so the extern "C" definition below exists once per
// library.
#pragma once

#include <cuda_runtime.h>

namespace heat {

// acc[i][j] += a[i] * b[j] for a TM x TN register tile, in f32 FMA.
template <int TM, int TN>
__device__ __forceinline__ void dot_f32(float (&acc)[TM][TN], const float (&a)[TM],
                                        const float (&b)[TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Chan/Welford merge of the moment carry (nb, mean_b, m2_b) into
// (cnt, mean, m2): the rule of heat_tpu/core/pallas_moments.py::chan_merge.
// An empty right side passes the carry through unchanged. Count is float
// inside a block, double where counts pass 2^24 rows.
template <typename Count>
__device__ __forceinline__ void chan_merge(Count& cnt, float& mean, float& m2, Count nb,
                                           float mean_b, float m2_b) {
  if (nb <= Count(0)) return;
  const Count tot = cnt + nb;
  const float delta = mean_b - mean;
  mean = fmaf(delta, static_cast<float>(nb / tot), mean);
  m2 = m2 + m2_b + delta * delta * static_cast<float>(cnt * nb / tot);
  cnt = tot;
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace heat

extern "C" const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
