// Column moments (mean and M2 over axis 0) of an (m, d) f32 array, reading X
// once.
//
// Replaces heat_tpu/core/pallas_moments.py::_moments_kernel. On the TPU that
// kernel walks the row blocks in order and carries a Welford accumulator from
// one grid step to the next. Blocks on the H100 run in parallel and in no
// order, so the carry is split instead:
//   pass 1 (moments_partial): block (x, y) owns 32 columns of a contiguous row
//     range. Each warp streams groups of 8 rows through registers, forms the
//     group's mean and centred square sum, and Chan-merges it into its own
//     carry. The block's 8 warp carries are merged in warp order and written
//     as the block's partial (count, mean, M2).
//   pass 2 (moments_final): one warp per column merges the partials of all
//     row ranges, each lane a contiguous run in row order and then the lanes
//     pairwise. (A first version merged them in one thread per column; that
//     serial chain of ~1000 dependent merges took longer than reading X.) The
//     order of every merge is fixed, so results are bit-reproducible.
// Rows at or past `lim` drop out; a row range with no valid row leaves a
// zero count, and the merge passes the carry through it unchanged. M2 is never
// formed as E[x^2] - E[x]^2.
//
// Bound on the H100: the bytes of X (m*d*4 read once) over 3.35 TB/s; the
// arithmetic is ~5 instructions per element. A warp reads 32 consecutive
// floats of a row (128 B) per load and keeps 8 loads in flight per thread to
// cover the memory latency; pass 2 reads only the small partials.
#include "common.cuh"

namespace {

constexpr int kCols = 32;   // columns per block: one lane per column
constexpr int kWarps = 8;   // row streams per block
constexpr int kGroup = 8;   // rows per register group

__global__ void __launch_bounds__(kCols * kWarps)
moments_partial(const float* __restrict__ x, int d, long long lim, long long rows_per_block,
                float* __restrict__ part_mean, float* __restrict__ part_m2,
                float* __restrict__ part_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + lane;
  const bool col_ok = col < d;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long r1 = min(lim, r0 + rows_per_block);

  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  for (long long g = r0 + static_cast<long long>(warp) * kGroup; g < r1;
       g += static_cast<long long>(kWarps) * kGroup) {
    const int nv = static_cast<int>(min(static_cast<long long>(kGroup), r1 - g));
    float v[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      v[i] = (col_ok && i < nv) ? __ldg(x + (g + i) * d + col) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) s += v[i];
    const float gm = s / static_cast<float>(nv);
    float gm2 = 0.f;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float dv = i < nv ? v[i] - gm : 0.f;
      gm2 = fmaf(dv, dv, gm2);
    }
    heat::chan_merge(cnt, mean, m2, static_cast<float>(nv), gm, gm2);
  }

  __shared__ float s_cnt[kWarps][kCols], s_mean[kWarps][kCols], s_m2[kWarps][kCols];
  s_cnt[warp][lane] = cnt;
  s_mean[warp][lane] = mean;
  s_m2[warp][lane] = m2;
  __syncthreads();
  if (warp == 0 && col_ok) {
    float c = s_cnt[0][lane], mu = s_mean[0][lane], q = s_m2[0][lane];
    for (int w = 1; w < kWarps; ++w)
      heat::chan_merge(c, mu, q, s_cnt[w][lane], s_mean[w][lane], s_m2[w][lane]);
    const size_t o = static_cast<size_t>(blockIdx.y) * d + col;
    part_mean[o] = mu;
    part_m2[o] = q;
    if (blockIdx.x == 0 && lane == 0) part_cnt[blockIdx.y] = c;
  }
}

// One warp per column: lane l merges its contiguous run of partials in row
// order, then the lanes merge pairwise (l with l + 1, then l with l + 2, ...),
// so the order of every merge is fixed.
__global__ void moments_final(const float* __restrict__ part_mean,
                              const float* __restrict__ part_m2,
                              const float* __restrict__ part_cnt, int parts, int d,
                              float* __restrict__ mean_out, float* __restrict__ m2_out) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (col >= d) return;  // uniform across the warp
  const int per = heat::ceil_div(parts, 32);
  const int p0 = min(parts, lane * per), p1 = min(parts, p0 + per);
  double cnt = 0.0;
  float mean = 0.f, m2 = 0.f;
  for (int p = p0; p < p1; ++p) {
    const size_t o = static_cast<size_t>(p) * d + col;
    heat::chan_merge(cnt, mean, m2, static_cast<double>(part_cnt[p]), part_mean[o], part_m2[o]);
  }
  for (int off = 1; off < 32; off <<= 1) {
    const double nb = __shfl_down_sync(0xffffffffu, cnt, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float qb = __shfl_down_sync(0xffffffffu, m2, off);
    if ((lane & (2 * off - 1)) == 0) heat::chan_merge(cnt, mean, m2, nb, mb, qb);
  }
  if (lane == 0) {
    mean_out[col] = mean;
    m2_out[col] = m2;
  }
}

}  // namespace

// x: (m, d) f32 row-major; the first `lim` rows count (lim <= m).
// The row ranges are `parts` blocks of `rows_per_block` rows each; the
// partials are (parts, d), (parts, d) and (parts,) f32 scratch.
extern "C" int heat_moments_f32(const void* x, int d, long long lim, int parts,
                                long long rows_per_block, void* part_mean, void* part_m2,
                                void* part_cnt, void* mean_out, void* m2_out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(heat::ceil_div(d, kCols), parts);
  moments_partial<<<grid, kCols * kWarps, 0, s>>>(
      static_cast<const float*>(x), d, lim, rows_per_block, static_cast<float*>(part_mean),
      static_cast<float*>(part_m2), static_cast<float*>(part_cnt));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  moments_final<<<heat::ceil_div(d, 8), 256, 0, s>>>(
      static_cast<const float*>(part_mean), static_cast<const float*>(part_m2),
      static_cast<const float*>(part_cnt), parts, d, static_cast<float*>(mean_out),
      static_cast<float*>(m2_out));
  return static_cast<int>(cudaGetLastError());
}
