// One Lloyd (K-Means) accumulation pass: for every valid row of X the nearest
// center, and per center the sum of its rows (k, d) and their count (k,).
//
// Replaces heat_tpu/cluster/pallas_lloyd.py::_lloyd_kernel. On the TPU the
// grid walks the row blocks in order and carries the (k, d) sums in scratch
// memory. Here a fixed number of blocks G each walk a fixed, strided set of
// 64-row tiles:
//   - the tile of X is staged once in shared memory (X is read once per
//     iteration);
//   - scores |c|^2 - 2 x.c against all k centers are formed 64 centers at a
//     time as a 64 x 64 register-tiled product (4 x 4 per thread), the
//     centers staged through shared memory 32 features at a time, so any
//     k*d fits; centers past k are masked out of the argmin;
//   - the argmin (lowest index on ties, as argmin) goes through warp
//     shuffles and a running best per row; the (n, k) scores never leave
//     the chip;
//   - each thread owns whole feature columns of the block's accumulator and
//     adds the tile's valid rows in row order, so no two threads touch one
//     sum and no float atomics are used. The accumulator lives in shared
//     memory when it fits, else in the block's own slice of the partials.
// A second kernel adds the G partials in block order. Every order is fixed,
// so two runs give bit-identical sums, counts and hence centers and labels.
// The partial scratch is G*k*d*4 B; the caller bounds G so that it stays
// small at the gate's corner (k = 1024, d = 512).
//
// Bound on the H100: per pass 2*n*k*d operations for the scores' product,
// n*k compares for the argmin and n*d adds for the sums (no one-hot
// product: each row is added into its center) over the 67 TFLOP/s f32
// rate, against n*d*4 B of X over 3.35 TB/s; at d = k = 64 the operations
// bound it by about 1.6x.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;   // rows per tile
constexpr int KC = 64;   // centers per chunk
constexpr int DK = 32;   // features per staged center sub-tile
constexpr int NT = 256;  // threads per block (16 x 16)
constexpr int kBlocksPerSM = 4;  // the grid's blocks per SM (cuda_lloyd.py _BLOCKS_PER_SM)
constexpr int CS = KC + 4;  // row stride of the staged centers

template <bool kSmemAcc>
__global__ void __launch_bounds__(NT, kBlocksPerSM)
lloyd_partial(const float* __restrict__ x, int d, long long lim, const float* __restrict__ c, int k,
              float* __restrict__ sums_part, int* __restrict__ cnt_part) {
  extern __shared__ __align__(16) float smem[];
  const int dp = d + 1;
  float* xs = smem;                 // [BM][d + 1]
  float* cs = xs + BM * dp;         // [DK][CS], centers transposed
  float* best_s = cs + DK * CS;     // [BM]
  int* best_i = reinterpret_cast<int*>(best_s + BM);  // [BM]
  float* my_sums = sums_part + static_cast<size_t>(blockIdx.x) * k * d;
  int* my_cnt = cnt_part + static_cast<size_t>(blockIdx.x) * k;
  float* acc_s = my_sums;
  int* cnt_s = my_cnt;
  if (kSmemAcc) {
    acc_s = reinterpret_cast<float*>(best_i + BM);
    cnt_s = reinterpret_cast<int*>(acc_s + k * d);
  }
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < k * d; i += NT) acc_s[i] = 0.f;
  for (int i = tid; i < k; i += NT) cnt_s[i] = 0;

  // rows pass 2^31, tiles do not (2^31 tiles of 64 rows outgrow any card)
  const int num_tiles = static_cast<int>((lim + BM - 1) / BM);
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long r0 = static_cast<long long>(t) * BM;
    const int nvalid = static_cast<int>(min(static_cast<long long>(BM), lim - r0));
    __syncthreads();  // the previous tile's accumulation is done with xs
    for (int idx = tid; idx < BM * d; idx += NT) {
      const int r = idx / d, cc = idx % d;
      xs[r * dp + cc] = r < nvalid ? __ldg(x + static_cast<size_t>(r0 + r) * d + cc) : 0.f;
    }
    if (tid < BM) {
      best_s[tid] = INFINITY;
      best_i[tid] = 0;
    }

    for (int j0 = 0; j0 < k; j0 += KC) {
      float acc[4][4], c2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c2[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      for (int d0 = 0; d0 < d; d0 += DK) {
        __syncthreads();  // xs is staged; the previous sub-tile is consumed
        for (int idx = tid; idx < KC * DK; idx += NT) {
          const int j = idx / DK, kk = idx % DK;
          const int gj = j0 + j, gk = d0 + kk;
          cs[kk * CS + j] = (gj < k && gk < d) ? __ldg(c + static_cast<size_t>(gj) * d + gk) : 0.f;
        }
        __syncthreads();
        const int kmax = min(DK, d - d0);
#pragma unroll 8
        for (int kk = 0; kk < kmax; ++kk) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xs[(ty * 4 + i) * dp + d0 + kk];
          const float4 bv = *reinterpret_cast<const float4*>(&cs[kk * CS + tx * 4]);
          const float b[4] = {bv.x, bv.y, bv.z, bv.w};
          heat::dot_f32<4, 4>(acc, a, b);
#pragma unroll
          for (int j = 0; j < 4; ++j) c2[j] = fmaf(b[j], b[j], c2[j]);
        }
      }
      // this chunk's best center per row: own 4 centers, then across the
      // 16 lanes that share the rows; an earlier chunk keeps a tie
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float bs = INFINITY;
        int bi = k;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gj = j0 + tx * 4 + j;
          const float s = c2[j] - 2.f * acc[i][j];
          if (gj < k && s < bs) {
            bs = s;
            bi = gj;
          }
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float os = __shfl_xor_sync(0xffffffffu, bs, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (os < bs || (os == bs && oi < bi)) {
            bs = os;
            bi = oi;
          }
        }
        if (tx == 0) {
          const int r = ty * 4 + i;
          if (bs < best_s[r]) {
            best_s[r] = bs;
            best_i[r] = bi;
          }
        }
      }
    }
    __syncthreads();
    for (int cc = tid; cc < d; cc += NT) {
      for (int r = 0; r < nvalid; ++r) acc_s[best_i[r] * d + cc] += xs[r * dp + cc];
    }
    if (tid == NT - 1) {
      for (int r = 0; r < nvalid; ++r) cnt_s[best_i[r]] += 1;
    }
  }
  if (kSmemAcc) {
    __syncthreads();
    for (int i = tid; i < k * d; i += NT) my_sums[i] = acc_s[i];
    for (int i = tid; i < k; i += NT) my_cnt[i] = cnt_s[i];
  }
}

__global__ void lloyd_final(const float* __restrict__ sums_part, const int* __restrict__ cnt_part,
                            int blocks, int k, int d, float* __restrict__ sums,
                            float* __restrict__ counts) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t kd = static_cast<size_t>(k) * d;
  if (i < kd) {
    float s = 0.f;
    for (int g = 0; g < blocks; ++g) s += sums_part[g * kd + i];
    sums[i] = s;
  }
  if (i < static_cast<size_t>(k)) {
    long long n = 0;
    for (int g = 0; g < blocks; ++g) n += cnt_part[static_cast<size_t>(g) * k + i];
    counts[i] = static_cast<float>(n);
  }
}

constexpr size_t kSmemAccMax = 100 * 1024;  // keeps two blocks per SM

}  // namespace

// x: (m, d) f32 row-major, of which the first `lim` rows count; centers:
// (k, d) f32. `blocks` blocks share the tiles; sums_part (blocks, k, d) f32
// and cnt_part (blocks, k) i32 are scratch. Writes sums (k, d) and counts
// (k,) f32.
extern "C" int heat_lloyd_f32(const void* x, int d, long long lim, const void* centers, int k,
                              int blocks, void* sums_part, void* cnt_part, void* sums,
                              void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t base = (static_cast<size_t>(BM) * (d + 1) + DK * CS + 2 * BM) * 4;
  const size_t with_acc = base + (static_cast<size_t>(k) * d + k) * 4;
  const bool smem_acc = with_acc <= kSmemAccMax;
  const size_t bytes = smem_acc ? with_acc : base;
  auto kern = smem_acc ? lloyd_partial<true> : lloyd_partial<false>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, NT, bytes, s>>>(static_cast<const float*>(x), d, lim,
                                 static_cast<const float*>(centers), k,
                                 static_cast<float*>(sums_part), static_cast<int*>(cnt_part));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t kd = static_cast<size_t>(k) * d;
  const size_t total = kd > static_cast<size_t>(k) ? kd : static_cast<size_t>(k);
  lloyd_final<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(sums_part), static_cast<const int*>(cnt_part), blocks, k, d,
      static_cast<float*>(sums), static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}
