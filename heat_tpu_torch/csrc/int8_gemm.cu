// W8A8 GEMM: out = f32(qa @ qb) * (sa * sb), with int8 operands and an
// int32 accumulator, cast to f32 or bf16.
//
// Replaces heat_tpu/core/linalg/quant.py::_q_kernel. qa is (M, K) int8 with
// a row scale sa (M, 1) f32, qb is (K, N) int8 with a column scale sb
// (1, N) f32, both row-major. The int32 accumulation is exact (while
// 128^2 K < 2^31, which the caller checks), and the epilogue keeps the TPU
// kernel's order (scale = sa * sb, then f32(acc) * scale, then the cast,
// each rounded to nearest even), so every variant is bit-identical to the
// plain version.
//
// Bound on the H100 at 8192^3: 2 * 8192^3 = 1.10 T int8 operations over
// 1979 TOP/s (0.556 ms) against ~400 MB over 3.35 TB/s (0.12 ms): bound by
// operations, which only wgmma reaches.
//
// int8_gemm_wgmma, for K % 16 == 0 (16-byte rows for the bulk copies) and
// a 16-byte aligned qa:
//   - int8 wgmma reads both operands K-major, and qb (K, N) is N-major, so
//     a pre-pass (transpose_s8, 64 x 64 byte tiles through shared memory)
//     writes qb^T into an (N, K) scratch buffer the caller allocates anew
//     every call: 2 K N bytes of traffic, ~7% of the bound at 8192^2. A
//     transpose inside the producer would cost the tensor cores' issue
//     slots or a second pass over each slice in shared memory instead;
//   - a block computes a 128 x 256 output tile: two consumer warpgroups of
//     64 x 256, each holding 128 int32 accumulators a thread and issuing
//     wgmma m64n256k32 (s8 x s8 -> s32) from shared memory, four k32 steps
//     a 128-byte K slice, one slice's products kept in flight while the
//     next slice's wait;
//   - a producer warpgroup keeps bulk tensor copies (2-D tensor maps over
//     qa and qb^T, 128-byte swizzle) in flight into a ring of four slots
//     of 48 KB, each completing on its own mbarrier, and gives its
//     registers to the consumers (setmaxnreg 40 / 232);
//   - ragged M, N and K arrive as zeros from the copies themselves and are
//     masked at the store; the tiles are walked in groups of 16 row tiles
//     so that the operands a wave of blocks reads stay in the L2 cache;
//   - at one block an SM the epilogue and the ring's fill overlap no main
//     loop, which a short K (few slices a tile) cannot hide: there the
//     caller takes the second layout of WgTiles, 128 x 128 tiles (m64n128k32,
//     64 accumulators a thread) with a lone producer warp, two blocks an SM,
//     so that one block's epilogue runs beside the other's products.
// int8_gemm_kernel, for any other shape (K % 16 != 0, an unaligned qa):
// each block computes a 128 x 128 output tile with 8 warps of 64 x 32,
// stepping over K in 64-byte slices through a ring of two shared slots:
// while the tensor cores work on one slice (mma.sync m16n8k32, s8 x s8 ->
// s32), cp.async brings the next A slice into the other slot and the next
// B slice waits in registers. The B operand of that instruction wants
// K-contiguous groups of 4 bytes, but qb is N-contiguous: each thread loads
// a 4 (k) x 8 (n) block of qb and transposes it in registers with byte
// permutes before storing it as B^T (n-major) in shared memory. Rows are
// padded to 80 bytes, which makes the fragment loads free of bank
// conflicts. Ragged M, N and K are masked in the kernel (zero-filled
// tiles, guarded stores); nothing is padded in device memory. It reaches
// 12.6% of the bound at 8192^3: 8 warps reload their fragments with 32-bit
// shared loads, and the same warps transpose B and wait at a barrier per
// 64-byte slice. Times are in PERF.md section 6.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, NT = 256;
constexpr int RS = BK + 16;  // shared row stride in bytes

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 4 bytes of one row from a guarded byte source
__device__ __forceinline__ uint32_t gather4(const int8_t* src, int avail) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < avail) w |= static_cast<uint32_t>(static_cast<uint8_t>(src[e])) << (8 * e);
  return w;
}

__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}

// The A slice (BM rows x BK bytes) into its shared tile: with vec_a one
// 16-byte cp.async per chunk, zero-filled by the copy where out of range,
// so it lands while the block computes; otherwise byte loads, stored at once.
__device__ __forceinline__ void load_a(int8_t* as, const int8_t* a, int m, int k, int m0, int k0,
                                       bool vec_a, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * NT;
    const int r = idx >> 2, c = (idx & 3) * 16;
    const int gm = m0 + r, gk = k0 + c;
    const bool in = gm < m && gk < k;
    const int8_t* src = a + static_cast<long long>(in ? gm : 0) * k + (in ? gk : 0);
    if (vec_a) {
      cp_async16(as + r * RS + c, src, in);
    } else {
      uint4 w = make_uint4(0, 0, 0, 0);
      if (in) {
        const int avail = k - gk;
        w.x = gather4(src, avail);
        w.y = gather4(src + 4, avail - 4);
        w.z = gather4(src + 8, avail - 8);
        w.w = gather4(src + 12, avail - 12);
      }
      *reinterpret_cast<uint4*>(as + r * RS + c) = w;
    }
  }
}

// thread -> (kq, nq) of the B slice: 16 k-quads by 16 n-octets; neighbouring
// threads take neighbouring k-quads, so the transposed stores spread over
// the banks. b[i] holds row k0 + 4 kq + i, bytes n0 + 8 nq ... + 7.
__device__ __forceinline__ void load_b(uint2 (&b)[4], const int8_t* bg, int n, int k, int n0,
                                       int k0, bool vec_b, int tid) {
  const int kq = tid & 15, nq = tid >> 4;
  const int gn = n0 + nq * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + kq * 4 + i;
    uint2 w = make_uint2(0, 0);
    if (gk < k && gn < n) {
      const int8_t* src = bg + static_cast<long long>(gk) * n + gn;
      if (vec_b) {
        w = __ldg(reinterpret_cast<const uint2*>(src));
      } else {
        w.x = gather4(src, n - gn);
        w.y = gather4(src + 4, n - gn - 4);
      }
    }
    b[i] = w;
  }
}

// 4 rows of 4 bytes (w[i] = row i) -> 4 columns of 4 bytes (t[j] = column j)
__device__ __forceinline__ void transpose4(const uint32_t w0, const uint32_t w1, const uint32_t w2,
                                           const uint32_t w3, uint32_t (&t)[4]) {
  const uint32_t x01l = __byte_perm(w0, w1, 0x5140), x23l = __byte_perm(w2, w3, 0x5140);
  const uint32_t x01h = __byte_perm(w0, w1, 0x7362), x23h = __byte_perm(w2, w3, 0x7362);
  t[0] = __byte_perm(x01l, x23l, 0x5410);
  t[1] = __byte_perm(x01l, x23l, 0x7632);
  t[2] = __byte_perm(x01h, x23h, 0x5410);
  t[3] = __byte_perm(x01h, x23h, 0x7632);
}

// The B slice, transposed, into its shared tile B^T (bs[n][k]).
__device__ __forceinline__ void store_b(const uint2 (&b)[4], int8_t* bs, int tid) {
  const int kq = tid & 15, nq = tid >> 4;
  uint32_t t[4];
  transpose4(b[0].x, b[1].x, b[2].x, b[3].x, t);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint32_t*>(bs + (nq * 8 + j) * RS + kq * 4) = t[j];
  transpose4(b[0].y, b[1].y, b[2].y, b[3].y, t);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint32_t*>(bs + (nq * 8 + 4 + j) * RS + kq * 4) = t[j];
}

// The epilogue of one accumulator pair: row `row`, columns col and col + 1
// (col + 1 only when it exists), in the plain version's order of roundings.
__device__ __forceinline__ void store_pair(void* out, int n, int row, int col, float srow,
                                           const float* __restrict__ sb, int a0, int a1,
                                           int bf16_out) {
  const bool both = col + 1 < n;
  const bool pairs = (n & 1) == 0;
  const float v0 = __fmul_rn(__int2float_rn(a0), __fmul_rn(srow, sb[col]));
  const float v1 = both ? __fmul_rn(__int2float_rn(a1), __fmul_rn(srow, sb[col + 1])) : 0.f;
  const long long off = static_cast<long long>(row) * n + col;
  if (bf16_out) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + off;
    if (both && pairs) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      o[0] = __float2bfloat16_rn(v0);
      if (both) o[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* o = static_cast<float*>(out) + off;
    if (both && pairs) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (both) o[1] = v1;
    }
  }
}

// Two blocks per SM: the 128-register cap keeps 16 warps resident to cover
// the loads' latency.
__global__ void __launch_bounds__(NT, 2) int8_gemm_kernel(const int8_t* __restrict__ a,
                                                          const int8_t* __restrict__ b,
                                                          const float* __restrict__ sa,
                                                          const float* __restrict__ sb,
                                                          void* out, int m, int n, int k,
                                                          int bf16_out, bool vec_a, bool vec_b) {
  // a ring of two slices: A tiles and B^T tiles (bs[n][k])
  __shared__ __align__(16) int8_t as[2][BM * RS];
  __shared__ __align__(16) int8_t bs[2][BN * RS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int n_slices = heat::ceil_div(k, BK);
  uint2 bn[4];
  load_a(as[0], a, m, k, m0, 0, vec_a, tid);
  asm volatile("cp.async.commit_group;\n");
  load_b(bn, b, n, k, n0, 0, vec_b, tid);
  store_b(bn, bs[0], tid);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int ks = 0; ks < n_slices; ++ks) {
    const int cur = ks & 1;
    const bool more = ks + 1 < n_slices;
    if (more) {  // the next slice: A lands by itself, B waits in registers
      load_a(as[cur ^ 1], a, m, k, m0, (ks + 1) * BK, vec_a, tid);
      load_b(bn, b, n, k, n0, (ks + 1) * BK, vec_b, tid);
    }
    asm volatile("cp.async.commit_group;\n");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = as[cur] + (wm * 64 + i * 16 + g) * RS + kk * 32 + tg * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * RS);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * RS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs[cur] + (wn * 32 + j * 8 + g) * RS + kk * 32 + tg * 4;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    if (more) store_b(bn, bs[cur ^ 1], tid);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the next slice is in place; this one is free
  }

  // epilogue: rows g and g + 8 of each 16-row fragment, column pairs
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm * 64 + i * 16 + g + 8 * r;
      if (row >= m) continue;
      const float srow = sa[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + tg * 2;
        if (col < n)
          store_pair(out, n, row, col, srow, sb, acc[i][j][2 * r], acc[i][j][2 * r + 1], bf16_out);
      }
    }
  }
}

// ------------------------------------------------------------ wgmma, TMA

constexpr int WG_BM = 128, WG_BK = 128, WG_GROUP_M = 16;
constexpr int WG_A_BYTES = WG_BM * WG_BK;

// The two tile layouts (chosen by the caller from the shape): 128 x 256
// output tiles, a four-slot ring and a producer warpgroup that gives its
// registers to the consumers, one block an SM; or 128 x 128 tiles, a
// three-slot ring and a lone producer warp, two blocks an SM, so that one
// block's epilogue and ring fill overlap the other's main loop (a short K
// leaves few slices a tile to hide them behind).
template <int BN>
struct WgTiles {
  static constexpr int STAGES = BN == 256 ? 4 : 3;
  static constexpr int MIN_BLOCKS = BN == 256 ? 1 : 2;
  static constexpr int PRODUCERS = BN == 256 ? 128 : 32;
  static constexpr int THREADS = 256 + PRODUCERS;  // two consumer warpgroups first
  static constexpr int STAGE_BYTES = WG_A_BYTES + BN * WG_BK;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

// src (k, n) int8 row-major -> dst (n, k): one 64 x 64 byte tile a block,
// read and written in 16-byte rows (k % 16 == 0 makes every written row
// whole and aligned; a ragged or unaligned source row is read bytewise)
__global__ void __launch_bounds__(256) transpose_s8(const int8_t* __restrict__ src,
                                                     int8_t* __restrict__ dst, int k, int n) {
  constexpr int RS = 68;  // shared row stride: the column reads below hit two banks at most
  __shared__ __align__(16) uint8_t tile[64 * RS];  // tile[kk * RS + nn]
  const int t = threadIdx.x, r = t >> 2, c = (t & 3) * 16;
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  {
    const int gk = k0 + r, gn = n0 + c;
    uint32_t w[4] = {0, 0, 0, 0};
    if (gk < k) {
      const int8_t* p = src + static_cast<long long>(gk) * n + gn;
      if (gn + 16 <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (gn + e < n) w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[e])) << (8 * (e & 3));
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) *reinterpret_cast<uint32_t*>(tile + r * RS + c + 4 * q) = w[q];
  }
  __syncthreads();
  const int gn = n0 + r, gk = k0 + c;
  if (gn < n && gk < k) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint8_t* col = tile + (c + 4 * q) * RS + r;
      w[q] = static_cast<uint32_t>(col[0]) | static_cast<uint32_t>(col[RS]) << 8 |
             static_cast<uint32_t>(col[2 * RS]) << 16 | static_cast<uint32_t>(col[3 * RS]) << 24;
    }
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(gn) * k + gk) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One 128 x BN output tile a block (blockIdx.x in groups of WG_GROUP_M row
// tiles). map_a covers qa (M rows of K bytes), map_b qb^T (N rows of K
// bytes); boxes of 128 bytes by 128 and BN rows.
template <int BN>
__global__ void __launch_bounds__(WgTiles<BN>::THREADS, WgTiles<BN>::MIN_BLOCKS)
    int8_gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, const float* __restrict__ sa,
                    const float* __restrict__ sb, void* out, int m, int n, int k, int bf16_out) {
  using namespace heat;
  using T = WgTiles<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + T::STAGES * T::STAGE_BYTES);
  uint64_t* const empty = full + T::STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int m_tiles = heat::ceil_div(m, WG_BM), n_tiles = heat::ceil_div(n, BN);
  const int per_group = WG_GROUP_M * n_tiles;
  const int first_m = (blockIdx.x / per_group) * WG_GROUP_M;
  const int group_rows = min(m_tiles - first_m, WG_GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_rows) * WG_BM;
  const int n0 = (in_group / group_rows) * BN;
  const int slices = heat::ceil_div(k, WG_BK);

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------- producer
    if (T::PRODUCERS == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int s = 0; s < slices; ++s) {
        const int slot = s % T::STAGES;
        if (s >= T::STAGES) mbar_wait(empty + slot, ((s / T::STAGES) - 1) & 1);
        mbar_expect_tx(full + slot, T::STAGE_BYTES);
        uint8_t* const st = base + slot * T::STAGE_BYTES;
        tma_load_2d(st, &map_a, full + slot, s * WG_BK, m0);
        tma_load_2d(st + WG_A_BYTES, &map_b, full + slot, s * WG_BK, n0);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    if (T::PRODUCERS == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    int acc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int s = 0; s < slices; ++s) {
      const int slot = s % T::STAGES;
      mbar_wait(full + slot, (s / T::STAGES) & 1);
      const uint32_t a = smem_u32(base + slot * T::STAGE_BYTES) + wg * 64 * PANEL_ROW_BYTES;
      const uint32_t b = smem_u32(base + slot * T::STAGE_BYTES + WG_A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 32; ++kk)
        wgmma_s8(acc, wgmma_desc(a + kk * 32, 16, SWIZZLE_ATOM_BYTES),
                 wgmma_desc(b + kk * 32, 16, SWIZZLE_ATOM_BYTES), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: its slot is free
      if (s > 0 && lane == 0) mbar_arrive(empty + (s - 1) % T::STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // rows g and g + 8 of this warp's 16, column pairs 8 j + 2 tg
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      if (row >= m) continue;
      const float srow = sa[row];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + tg * 2;
        if (col < n) store_pair(out, n, row, col, srow, sb, acc[j][2 * r], acc[j][2 * r + 1], bf16_out);
      }
    }
  }
}

template <int BN>
cudaError_t launch_wgmma(const void* qa, const void* qbt, const void* sa, const void* sb,
                         void* out, int m, int n, int k, int bf16_out, cudaStream_t s) {
  using T = WgTiles<BN>;
  CUtensorMap map_a, map_b;
  cudaError_t err =
      heat::make_tensor_map_2d(&map_a, qa, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, m, k, WG_BK, WG_BM);
  if (err == cudaSuccess)
    err = heat::make_tensor_map_2d(&map_b, qbt, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, n, k, WG_BK, BN);
  static bool ready[64] = {};  // of this instantiation
  if (err == cudaSuccess) err = heat::allow_dynamic_smem(int8_gemm_wgmma<BN>, T::SMEM, ready);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(heat::ceil_div(m, WG_BM)) * heat::ceil_div(n, BN);
  int8_gemm_wgmma<BN><<<static_cast<unsigned>(tiles), T::THREADS, T::SMEM, s>>>(
      map_a, map_b, static_cast<const float*>(sa), static_cast<const float*>(sb), out, m, n, k,
      bf16_out);
  return cudaGetLastError();
}

}  // namespace

// qa: (m, k) int8, qb: (k, n) int8, sa: (m,) f32, sb: (n,) f32, all
// contiguous; out: (m, n) f32 (bf16_out = 0) or bf16 (bf16_out = 1),
// contiguous. m, n, k >= 1, m <= 65535 * 128.
extern "C" int heat_int8_gemm(const void* qa, const void* qb, const void* sa, const void* sb,
                              void* out, int m, int n, int k, int bf16_out, void* stream) {
  const int m_tiles = heat::ceil_div(m, BM), n_tiles = heat::ceil_div(n, BN);
  if (m < 1 || n < 1 || k < 1 || m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_a = k % 16 == 0 && reinterpret_cast<uintptr_t>(qa) % 16 == 0;
  const bool vec_b = n % 8 == 0 && reinterpret_cast<uintptr_t>(qb) % 8 == 0;
  int8_gemm_kernel<<<dim3(n_tiles, m_tiles), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qb),
      static_cast<const float*>(sa), static_cast<const float*>(sb), out, m, n, k, bf16_out,
      vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma variant: the same operands, k % 16 == 0 and qa 16-byte aligned;
// qbt is an (n, k) int8 scratch buffer (16-byte aligned) that receives qb^T
// before the product; bn = 256 or 128, the tiles' width (WgTiles). m, n,
// k >= 1.
extern "C" int heat_int8_gemm_wgmma(const void* qa, const void* qb, void* qbt, const void* sa,
                                    const void* sb, void* out, int m, int n, int k, int bf16_out,
                                    int bn, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k % 16 != 0 || (bn != 128 && bn != 256) ||
      reinterpret_cast<uintptr_t>(qa) % 16 != 0 || reinterpret_cast<uintptr_t>(qbt) % 16 != 0 ||
      heat::ceil_div(k, 64) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  transpose_s8<<<dim3(heat::ceil_div(n, 64), heat::ceil_div(k, 64)), 256, 0, s>>>(
      static_cast<const int8_t*>(qb), static_cast<int8_t*>(qbt), k, n);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = bn == 256 ? launch_wgmma<256>(qa, qbt, sa, sb, out, m, n, k, bf16_out, s)
                    : launch_wgmma<128>(qa, qbt, sa, sb, out, m, n, k, bf16_out, s);
  return static_cast<int>(err);
}

// the dynamic shared memory of one block of the wgmma variant at tile width bn
extern "C" int heat_int8_gemm_wgmma_smem(int bn) {
  return bn == 256 ? WgTiles<256>::SMEM : bn == 128 ? WgTiles<128>::SMEM : -1;
}
