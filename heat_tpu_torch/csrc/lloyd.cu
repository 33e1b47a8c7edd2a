// One Lloyd (K-Means) accumulation pass: for every valid row of X the nearest
// center, and per center the sum of its rows (k, d) and their count (k,).
//
// Replaces heat_tpu/cluster/pallas_lloyd.py::_lloyd_kernel. On the TPU the
// grid walks the row blocks in order and carries the (k, d) sums in scratch
// memory. Here a fixed number of blocks G each walk a fixed, strided set of
// 64-row tiles and write their own partial sums and counts; a second kernel
// (lloyd_final) adds the G partials in block order. Every order is fixed
// and no float atomics are used, so two runs give bit-identical sums,
// counts and hence centers and labels. The partial scratch is G*k*d*4 B;
// the caller bounds G so that it stays small at the gate's corner
// (k = 1024, d = 512).
//
// lloyd_tc, for d % 4 == 0 (16-byte rows for the bulk copies), 16-byte
// aligned x and centers and fewer than 2^31 - 64 rows (a copy's row
// coordinate is an int). Bound on the H100 at the main path's
// 2,000,000 x 64, k = 64: X's 512 MB over 3.35 TB/s (0.153 ms) against the
// scores' 3 x 16.4 GFLOP of 3xTF32 products over 495 TFLOP/s (0.100 ms):
// bytes. The design:
//   - a persistent grid, two blocks an SM where their shared memory allows
//     (one elsewhere), its warps specialised: a scorer warpgroup and an
//     accumulator warpgroup, each a serial chain of latencies that the
//     other block's chains cover. The block
//     keeps the centers in shared memory for its whole life, split once
//     into tf32 halves (hi = tf32(c), lo = c - hi) in the 128-byte swizzle,
//     with |c|^2 computed once in exact f32 (+inf past k, which masks the
//     pad centers out of the argmin). Where k * d does not fit, the scorer
//     stages the centers again for every tile, 64 centers by a few panels
//     of 32 features at a time;
//   - bulk tensor copies of X tiles (64 rows, a 2-D tensor map, zeros past
//     the last valid row and past d) stay in flight in a ring of slots on
//     mbarriers, each started by the accumulator's first thread as soon as
//     the slot's previous tile is done: X is read once a pass;
//   - the scorer computes x.c on the tensor cores in 3xTF32: wgmma
//     m64n64k8 with X's fragments from registers, split into hi and lo
//     there, and the centers' halves from shared memory, accumulating
//     lo.hi, hi.lo, then hi.hi (small terms first) in f32, one panel's 12
//     products a batch, none of them on a branch (ptxas serialises every
//     wgmma of a kernel that issues one on a divergent path). That keeps the
//     scores within a few f32 ulps; one TF32 product alone (~3 digits) would
//     flip labels near boundaries. The argmin runs on the accumulator fragments
//     in registers (a thread's columns in order, then its quad by shuffles;
//     ties to the lowest index); the labels go to one of two buffers that
//     mbarriers hand to the accumulator, and the counts are integer
//     shared-memory atomics, exact in any order;
//   - the accumulator: every thread owns one (row group, feature) pair of
//     the block's accumulator copies (two copies of (k, d) at d = 64) and
//     walks its group's rows in order, four rows a step with the aliases
//     among them resolved in registers, so no two threads touch one sum.
//     It works on one tile while the scorer works on the next, and frees
//     the X slot; the copies are added in a fixed order at the block's end.
// lloyd_partial, for any other shape (d % 4 != 0 among them: a row stride
// of 4 d bytes is no multiple of 16): scores |c|^2 - 2 x.c as a 64 x 64
// register-tiled product of f32 FMAs (heat::dot_f32), the centers staged
// through shared memory 32 features at a time for every tile, the argmin by
// shuffles, and each of d threads adding the tile's rows into its feature
// column of the block's accumulator. Bound by its f32 FMA operations
// (2 n k d over 67 TFLOP/s, 0.248 ms at the main path's shape), of which it
// reaches 20%: the accumulation is serial (d of 256 threads), the centers
// and |c|^2 are staged again for every tile, and the X tile is staged
// synchronously. Times are in PERF.md section 6.
#include <math.h>

#include "common.cuh"
#include "wgmma.cuh"

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

// ------------------------------------------------------- tensor cores

constexpr int TC_BM = 64;          // rows a tile: the scorer warpgroup's wgmma M
constexpr int TC_NC = 64;          // centers a chunk: the wgmma N
constexpr int TC_PANEL = 32;       // f32 features in one 128-byte swizzled row
constexpr int TC_UNIT = 64 * 128;  // bytes of 64 rows of one panel
constexpr int TC_THREADS = 256;    // scorer warpgroup, then accumulator warpgroup
constexpr int TC_MAX_STAGES = 8;
constexpr int TC_SMEM_2 = 113 * 1024;  // a block's shared memory at two blocks an SM
constexpr int TC_SMEM_1 = 227 * 1024;  // at one
constexpr int TC_MIN_BLOCKS = 2;       // blocks an SM the registers allow (launch bounds)

struct TcPlan {
  int d, k, panels, chunks;  // panels = ceil(d / 32), chunks = ceil(k / 64)
  int stages;                // X ring slots
  int units;                 // (chunk, panel) units of centers held at once
  int groups;                // accumulator copies, each owned by a group of threads
  int feat;                  // features a group covers at once: its threads
  int acc_smem;              // 1: the copies in shared memory; 0: the block's partial slice
  int smem;                  // dynamic shared memory
  int blocks_per_sm;
};

__host__ __device__ inline bool tc_resident(const TcPlan& p) {
  return p.units == p.chunks * p.panels;
}

// dynamic shared memory: X ring, centers hi and lo, |c|^2, labels (two
// tiles), barriers, counts and the accumulator copies
inline long long tc_smem_bytes(const TcPlan& p) {
  long long b = 1024 + static_cast<long long>(p.stages) * p.panels * TC_UNIT +
                2ll * p.units * TC_UNIT + 4ll * p.chunks * TC_NC + 4ll * 2 * TC_BM +
                16ll * p.stages + 32 + 4ll * p.k;
  if (p.acc_smem) b += 4ll * p.groups * p.k * p.d;
  return b;
}

// The first layout that fits, in order of preference: two blocks an SM
// (resident centers, accumulator copies in shared memory, a ring of two
// slots or more); then one block an SM: resident centers, the most
// accumulator copies in shared memory, then the deepest ring; then the copy
// in the partial slice, fewer center units.
inline bool tc_plan(int d, int k, TcPlan& p) {
  p.d = d;
  p.k = k;
  p.panels = heat::ceil_div(d, TC_PANEL);
  p.chunks = heat::ceil_div(k, TC_NC);
  const int all_units = p.panels * p.chunks;
  const int most_groups = max(1, min(TC_BM / 8, 128 / d));  // a group takes 8 rows or more
  p.blocks_per_sm = 2;
  p.units = all_units;
  p.acc_smem = 1;
  for (p.groups = TC_MIN_BLOCKS == 2 ? most_groups : 0; p.groups >= 1; --p.groups) {
    p.feat = min(d, 128 / p.groups);
    for (p.stages = TC_MAX_STAGES; p.stages >= 2; --p.stages) {
      const long long bytes = tc_smem_bytes(p);
      if (bytes <= TC_SMEM_2) {
        p.smem = static_cast<int>(bytes);
        return true;
      }
    }
  }
  p.blocks_per_sm = 1;
  for (int units = all_units; units >= 1; units = units == all_units ? min(p.panels, units - 1) : units - 1) {
    p.units = units;
    for (int groups = most_groups; groups >= 0; --groups) {
      p.groups = max(groups, 1);
      p.acc_smem = groups > 0;
      p.feat = min(d, 128 / p.groups);
      for (p.stages = TC_MAX_STAGES; p.stages >= 1; --p.stages) {
        const long long bytes = tc_smem_bytes(p);
        if (bytes <= TC_SMEM_1) {
          p.smem = static_cast<int>(bytes);
          return true;
        }
      }
    }
  }
  return false;
}

// A tile's row r and feature column c in its X slot (panels of 64 rows of
// 128 bytes, 16-byte chunks swizzled by the row)
__device__ __forceinline__ const float* x_at(const uint8_t* xt, int r, int c) {
  return reinterpret_cast<const float*>(xt + (c >> 5) * TC_UNIT + r * 128 +
                                        ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4);
}

// The centers' (chunk, panel) units first .. first + count - 1 (in
// chunk-major order) into unit slots 0 .. count - 1, split into tf32
// halves, in the 128-byte swizzle; `threads` threads share the work.
// Inside a panel the features are permuted: logical 16-byte chunk q holds
// features q, q + 8, q + 16, q + 24 (logical position 4 q + t is feature
// 8 t + q). The contraction does not care which feature sits where, as
// long as X's fragments follow the same order, and in this order each
// thread's eight values of a row and panel are two 16-byte chunks of X's
// tile as the copy wrote it (x_fragments).
__device__ __forceinline__ void stage_centers(const float* __restrict__ c, const TcPlan& p,
                                              int first, int count, uint8_t* chi, uint8_t* clo,
                                              int tid, int threads) {
  for (int idx = tid; idx < count * 512; idx += threads) {
    const int u = idx >> 9, row = (idx >> 3) & 63, q = idx & 7;
    const int unit = first + u, ch = unit / p.panels, pn = unit % p.panels;
    const int center = ch * TC_NC + row;
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int f = pn * TC_PANEL + 8 * t + q;
      v[t] = center < p.k && f < p.d ? __ldg(c + static_cast<size_t>(center) * p.d + f) : 0.f;
    }
    const float4 hi = make_float4(heat::tf32_round(v[0]), heat::tf32_round(v[1]),
                                  heat::tf32_round(v[2]), heat::tf32_round(v[3]));
    const float4 lo = make_float4(v[0] - hi.x, v[1] - hi.y, v[2] - hi.z, v[3] - hi.w);
    const int off = u * TC_UNIT + row * 128 + ((q ^ (row & 7)) << 4);
    *reinterpret_cast<float4*>(chi + off) = hi;
    *reinterpret_cast<float4*>(clo + off) = lo;
  }
}

// named barriers: 1 for the scorer's 128 threads, 2 for the accumulator's,
// 3 for both
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// X's A fragments of one panel's four k8 steps for rows r0 and r0 + 8 (at
// `row0`, the tile's panel base plus r0's row), split into tf32 halves in
// registers. In stage_centers' order, k8 step kq's columns tg and tg + 4
// are features 8 tg + 2 kq and 8 tg + 2 kq + 1: the two 16-byte chunks 2 tg
// and 2 tg + 1 of each row, at the swizzled offsets off0 and off1.
__device__ __forceinline__ void x_fragments(const uint8_t* row0, int off0, int off1,
                                            uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
  const float4 a0 = *reinterpret_cast<const float4*>(row0 + off0);
  const float4 a1 = *reinterpret_cast<const float4*>(row0 + off1);
  const float4 b0 = *reinterpret_cast<const float4*>(row0 + 8 * 128 + off0);
  const float4 b1 = *reinterpret_cast<const float4*>(row0 + 8 * 128 + off1);
  const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    const float v[4] = {ra[2 * kq], rb[2 * kq], ra[2 * kq + 1], rb[2 * kq + 1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = heat::tf32_round(v[e]);
      hi[kq][e] = __float_as_uint(h);
      lo[kq][e] = __float_as_uint(v[e] - h);
    }
  }
}

// s (+)= X C^T over one panel in 3xTF32: lo.hi, hi.lo, then hi.hi a k8 step
__device__ __forceinline__ void panel_products(float (&s)[8][4], const uint32_t (&hi)[4][4],
                                               const uint32_t (&lo)[4][4], uint32_t bh,
                                               uint32_t bl, int first) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    const uint64_t dh = heat::wgmma_desc(bh + kq * 32, 16, heat::SWIZZLE_ATOM_BYTES);
    const uint64_t dl = heat::wgmma_desc(bl + kq * 32, 16, heat::SWIZZLE_ATOM_BYTES);
    heat::wgmma_tf32_rs(s, lo[kq], dh, kq > 0 || !first);
    heat::wgmma_tf32_rs(s, hi[kq], dl, 1);
    heat::wgmma_tf32_rs(s, hi[kq], dh, 1);
  }
}

// Rows r .. r + 3 of one feature column: the labels l, the values x (at
// col_x + row offsets), added into the column `col` of the accumulator (a
// later row that repeats a label adds to the earlier one's value, as one
// row after the other would)
__device__ __forceinline__ void add_four(float* col, int d, const int4 l4, const float (&x)[4]) {
  const int l[4] = {l4.x, l4.y, l4.z, l4.w};
  float a[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = col[static_cast<size_t>(l[e]) * d];
  const float v0 = a[0] + x[0];
  const float v1 = (l[1] == l[0] ? v0 : a[1]) + x[1];
  const float v2 = (l[2] == l[1] ? v1 : l[2] == l[0] ? v0 : a[2]) + x[2];
  const float v3 = (l[3] == l[2] ? v2 : l[3] == l[1] ? v1 : l[3] == l[0] ? v0 : a[3]) + x[3];
  col[static_cast<size_t>(l[0]) * d] = v0;
  col[static_cast<size_t>(l[1]) * d] = v1;
  col[static_cast<size_t>(l[2]) * d] = v2;
  col[static_cast<size_t>(l[3]) * d] = v3;
}

// A tile's sums: this thread's features over its group's rows [rb, re)
// (rb a multiple of 8), in row order, eight rows a step; the swizzled
// offsets of a feature's chunk depend on the row only modulo 8.
__device__ __forceinline__ void accumulate(float* gacc, const uint8_t* xt, const int* lab, int d,
                                           int f0, int feat, int rb, int re) {
  for (int f = f0; f < d; f += feat) {
    float* const col = gacc + f;
    const uint8_t* const xcol = xt + (f >> 5) * TC_UNIT + (f & 3) * 4;
    const int q = (f & 31) >> 2;
    int off[8];
#pragma unroll
    for (int ph = 0; ph < 8; ++ph) off[ph] = ph * 128 + ((q ^ ph) << 4);
    int r = rb;
    for (; r + 8 <= re; r += 8) {
      const uint8_t* const rows = xcol + r * 128;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = *reinterpret_cast<const float*>(rows + off[4 * h + e]);
        add_four(col, d, *reinterpret_cast<const int4*>(lab + r + 4 * h), x);
      }
    }
    for (; r < re; ++r) col[static_cast<size_t>(lab[r]) * d] += *x_at(xt, r, f);
  }
}

// The block's set-up, by the scorer's and the accumulator's threads
// together: zero accumulator copies and counts, |c|^2, resident centers.
__device__ __forceinline__ void tc_setup(const float* __restrict__ c, const TcPlan& p, float* acc,
                                         int* cnt, float* c2, uint8_t* chi, uint8_t* clo,
                                         int tid) {
  const size_t kd = static_cast<size_t>(p.k) * p.d;
  for (size_t e = tid; e < static_cast<size_t>(p.groups) * kd; e += 256) acc[e] = 0.f;
  for (int j = tid; j < p.k; j += 256) cnt[j] = 0;
  for (int j = tid; j < p.chunks * TC_NC; j += 256) {
    float sq = INFINITY;
    if (j < p.k) {
      const float* cj = c + static_cast<size_t>(j) * p.d;
      sq = 0.f;
      for (int f = 0; f < p.d; ++f) sq = fmaf(cj[f], cj[f], sq);
    }
    c2[j] = sq;
  }
  if (tc_resident(p)) stage_centers(c, p, 0, p.units, chi, clo, tid, 256);
  heat::fence_proxy_async();
  named_sync(3, 256);
}

// The accumulator copies, added in a fixed order, into the block's partial
// slice, by the scorer's and the accumulator's threads together.
__device__ __forceinline__ void tc_merge(const TcPlan& p, const float* acc, const int* cnt,
                                         float* __restrict__ sums_part,
                                         int* __restrict__ cnt_part, int tid) {
  if (!p.acc_smem) return;  // the one copy is the slice
  named_sync(3, 256);
  const size_t kd = static_cast<size_t>(p.k) * p.d;
  float* const my_sums = sums_part + blockIdx.x * kd;
  for (size_t e = tid; e < kd; e += 256) {
    float v = acc[e];
    for (int q = 1; q < p.groups; ++q) v += acc[q * kd + e];
    my_sums[e] = v;
  }
  for (int j = tid; j < p.k; j += 256) cnt_part[static_cast<size_t>(blockIdx.x) * p.k + j] = cnt[j];
}

// Two blocks an SM where their shared memory allows, at 128 registers a
// thread: the scorer holds one panel's fragments (32 registers) beside its
// 32 accumulators, so a batch is one panel's 12 products. There is no
// producer warp, whose 32 threads would lower the cap to 112 (and spill):
// the accumulator's first thread starts each X tile's copy into the slot
// it has just freed. (setmaxnreg cannot move registers to the scorer safely
// here: the count a block starts with is ptxas's choice below the cap, and
// an increase the pool cannot meet waits forever.)
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS)
    lloyd_tc(const __grid_constant__ CUtensorMap map_x, const float* __restrict__ c, int lim,
             const TcPlan p, float* __restrict__ sums_part, int* __restrict__ cnt_part) {
  using namespace heat;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int x_tile = p.panels * TC_UNIT;
  const int k_pad = p.chunks * TC_NC;
  uint8_t* const xs = base;
  uint8_t* const chi = xs + p.stages * x_tile;
  uint8_t* const clo = chi + p.units * TC_UNIT;
  float* const c2 = reinterpret_cast<float*>(clo + p.units * TC_UNIT);
  int* const labels = reinterpret_cast<int*>(c2 + k_pad);  // [2][TC_BM]
  uint64_t* const full = reinterpret_cast<uint64_t*>(labels + 2 * TC_BM);
  uint64_t* const empty = full + p.stages;
  uint64_t* const lab_full = empty + p.stages;  // [2]
  uint64_t* const lab_empty = lab_full + 2;     // [2]
  int* cnt = reinterpret_cast<int*>(lab_empty + 2);
  float* acc = reinterpret_cast<float*>(cnt + p.k);  // [groups][k][d]
  const size_t kd = static_cast<size_t>(p.k) * p.d;
  if (!p.acc_smem) {  // one copy: the block's partial slice
    cnt = cnt_part + static_cast<size_t>(blockIdx.x) * p.k;
    acc = sums_part + blockIdx.x * kd;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int num_tiles = (lim + TC_BM - 1) / TC_BM;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // the accumulator's warps, the X slot's last readers
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(lab_full + b, 4);   // the scorer's warps
      mbar_init(lab_empty + b, 4);  // the accumulator's warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the copy of the block's i-th tile into its slot, by one thread
  auto load_tile = [&](int i) {
    const int slot = i % p.stages;
    mbar_expect_tx(full + slot, x_tile);
    for (int pn = 0; pn < p.panels; ++pn)
      tma_load_2d(xs + slot * x_tile + pn * TC_UNIT, &map_x, full + slot, pn * TC_PANEL,
                  (blockIdx.x + i * gridDim.x) * TC_BM);
  };
  const int tid = threadIdx.x;
  const bool resident = tc_resident(p);
  if (warp < 4) {
    // --------------------------------------------------------- scorer
    tc_setup(c, p, acc, cnt, c2, chi, clo, tid);
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = warp * 16 + g;  // this thread's rows of a tile: r0 and r0 + 8
    // its fragments' chunks 2 tg and 2 tg + 1, swizzled by the row (r0 and
    // r0 + 8 alike modulo 8)
    const int off0 = ((2 * tg) ^ (r0 & 7)) << 4, off1 = ((2 * tg + 1) ^ (r0 & 7)) << 4;
    int i = 0;
    for (int t = blockIdx.x; t < num_tiles; t += gridDim.x, ++i) {
      const int slot = i % p.stages;
      mbar_wait(full + slot, (i / p.stages) & 1);
      const uint8_t* const xt = xs + slot * x_tile;
      float best_s[2] = {INFINITY, INFINITY};
      int best_i[2] = {0, 0};
      for (int ch = 0; ch < p.chunks; ++ch) {
        float s[8][4];
        for (int pn0 = 0; pn0 < p.panels; pn0 += p.units) {
          const int pn_end = resident ? p.panels : min(p.panels, pn0 + p.units);
          if (!resident) {
            named_sync(1, 128);  // every warp's products on the previous units are done
            stage_centers(c, p, ch * p.panels + pn0, pn_end - pn0, chi, clo, tid, 128);
            fence_proxy_async();
            named_sync(1, 128);
          }
          // a panel's products, then the wait that frees the fragments'
          // registers
          for (int pn = pn0; pn < pn_end; ++pn) {
            uint32_t hi[4][4], lo[4][4];
            x_fragments(xt + pn * TC_UNIT + r0 * 128, off0, off1, hi, lo);
            const int u = resident ? ch * p.panels + pn : pn - pn0;
            wgmma_fence();
            panel_products(s, hi, lo, smem_u32(chi + u * TC_UNIT), smem_u32(clo + u * TC_UNIT),
                           pn == 0);
            wgmma_commit();
            wgmma_wait<0>();
          }
        }
        fence_regs(s);
        // this chunk's columns in order: a later chunk keeps an earlier tie
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = ch * TC_NC + j * 8 + tg * 2 + (e & 1);
            const float sc = fmaf(-2.f, s[j][e], c2[col]);  // c2 - 2 s, rounded once
            if (sc < best_s[e >> 1]) {
              best_s[e >> 1] = sc;
              best_i[e >> 1] = col;
            }
          }
        }
      }
      const int nvalid = min(TC_BM, lim - t * TC_BM);
      const int buf = i & 1;
      if (i >= 2) mbar_wait(lab_empty + buf, ((i >> 1) - 1) & 1);
      int* const lab = labels + buf * TC_BM;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float os = __shfl_xor_sync(0xffffffffu, best_s[r], off);
          const int oi = __shfl_xor_sync(0xffffffffu, best_i[r], off);
          if (os < best_s[r] || (os == best_s[r] && oi < best_i[r])) {
            best_s[r] = os;
            best_i[r] = oi;
          }
        }
        const int row = r0 + 8 * r;
        if (tg == 0) {
          lab[row] = best_i[r];
          if (row < nvalid) atomicAdd(cnt + best_i[r], 1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(lab_full + buf);  // the tile's labels (and X reads) are done
    }
    tc_merge(p, acc, cnt, sums_part, cnt_part, tid);
  } else {
    // ---------------------------------------------------- accumulator
    const int atid = tid - 128;
    const int my_tiles = blockIdx.x < num_tiles ? (num_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    if (atid == 0)  // the ring's first fill
      for (int i = 0; i < min(p.stages, my_tiles); ++i) load_tile(i);
    tc_setup(c, p, acc, cnt, c2, chi, clo, tid);
    // group `grp` of a tile's rows, features f0, f0 + feat, ...
    const int grp = atid / p.feat, f0 = atid % p.feat;
    const int rows_per_group = (TC_BM / 8 + p.groups - 1) / p.groups * 8;
    const bool accumulates = grp < p.groups;
    float* const gacc = acc + static_cast<size_t>(accumulates ? grp : 0) * kd;
    int i = 0;
    for (int t = blockIdx.x; t < num_tiles; t += gridDim.x, ++i) {
      const int slot = i % p.stages, buf = i & 1;
      mbar_wait(lab_full + buf, (i >> 1) & 1);
      if (accumulates) {
        const int rb = grp * rows_per_group;
        accumulate(gacc, xs + slot * x_tile, labels + buf * TC_BM, p.d, f0, p.feat, rb,
                   min(rb + rows_per_group, min(TC_BM, lim - t * TC_BM)));
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty + slot);  // the X slot and the labels are free again
        mbar_arrive(lab_empty + buf);
      }
      if (atid == 0 && i + p.stages < my_tiles) {  // the slot's next tile, once all four warps are done
        mbar_wait(empty + slot, (i / p.stages) & 1);
        load_tile(i + p.stages);
      }
    }
    tc_merge(p, acc, cnt, sums_part, cnt_part, tid);
  }
}

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

// The tensor-core variant: x (m, d) f32 row-major and centers (k, d), both
// 16-byte aligned, d % 4 == 0, 1 <= lim < 2^31 - 64, d <= 512, k <= 1024.
// Up to `blocks` blocks (as many as are resident at once) share the tiles;
// sums_part (blocks, k, d) f32 and cnt_part (blocks, k) i32 are scratch.
// Writes sums (k, d) and counts (k,) f32.
extern "C" int heat_lloyd_tc(const void* x, int d, long long lim, const void* centers, int k,
                             int blocks, void* sums_part, void* cnt_part, void* sums,
                             void* counts, void* stream) {
  TcPlan p;
  if (d < 4 || d % 4 != 0 || d > 512 || k < 1 || k > 1024 || lim < 1 ||
      lim >= (1ll << 31) - TC_BM || blocks < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(centers) % 16 != 0 || !tc_plan(d, k, p))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int used = min(blocks, p.blocks_per_sm * sms);
  CUtensorMap map_x;
  err = heat::make_tensor_map_2d(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, d, lim, 4ll * d,
                                 TC_PANEL, TC_BM);
  static bool ready[64] = {};  // the limit is raised once to the most any plan takes
  if (err == cudaSuccess) err = heat::allow_dynamic_smem(lloyd_tc, TC_SMEM_1, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lloyd_tc<<<used, TC_THREADS, p.smem, s>>>(map_x, static_cast<const float*>(centers),
                                                  static_cast<int>(lim), p,
                                                  static_cast<float*>(sums_part),
                                                  static_cast<int*>(cnt_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t kd = static_cast<size_t>(k) * d;
  const size_t total = kd > static_cast<size_t>(k) ? kd : static_cast<size_t>(k);
  lloyd_final<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(sums_part), static_cast<const int*>(cnt_part), used, k, d,
      static_cast<float*>(sums), static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core variant's layout at (d, k): its dynamic shared memory
// (the return value, -1 where the variant does not take the shape), its
// blocks an SM, X ring slots and accumulator copies (0: the one copy in the
// partial slice).
extern "C" int heat_lloyd_tc_plan(int d, int k, int* blocks_per_sm, int* stages, int* copies) {
  TcPlan p;
  if (d < 4 || d % 4 != 0 || d > 512 || k < 1 || k > 1024 || !tc_plan(d, k, p)) return -1;
  *blocks_per_sm = p.blocks_per_sm;
  *stages = p.stages;
  *copies = p.acc_smem ? p.groups : 0;
  return p.smem;
}
