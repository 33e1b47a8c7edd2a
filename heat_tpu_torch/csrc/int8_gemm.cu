// W8A8 GEMM: out = f32(qa @ qb) * (sa * sb), with int8 operands and an
// int32 accumulator, cast to f32 or bf16.
//
// Replaces heat_tpu/core/linalg/quant.py::_q_kernel. qa is (M, K) int8 with
// a row scale sa (M, 1) f32, qb is (K, N) int8 with a column scale sb
// (1, N) f32, both row-major. The int32 accumulation is exact, and the
// epilogue keeps the TPU kernel's order (scale = sa * sb, then
// f32(acc) * scale, then the cast, each rounded to nearest even), so the
// result is bit-identical to the plain version.
//
// Each block computes a 128 x 128 output tile with 8 warps of 64 x 32,
// stepping over K in 64-byte slices through a ring of two shared slots:
// while the tensor cores work on one slice (mma.sync m16n8k32, s8 x s8 ->
// s32), cp.async brings the next A slice into the other slot and the next
// B slice waits in registers. The B operand of that instruction wants
// K-contiguous groups of 4 bytes, but qb is N-contiguous: each thread loads
// a 4 (k) x 8 (n) block of qb and transposes it in registers with byte
// permutes before storing it as B^T (n-major) in shared memory. Rows are
// padded to 80 bytes, which makes the fragment loads free of bank
// conflicts. Ragged M, N and K are masked in the kernel (zero-filled
// tiles, guarded stores); nothing is padded in device memory.
// Bound on the H100 at 8192^3: 2 * 8192^3 = 1.10 T int8 operations over
// 1979 TOP/s (0.556 ms) against ~400 MB over 3.35 TB/s (0.12 ms): bound by
// operations, which mma.sync reaches only in part (wgmma is for later).
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

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
  const bool pairs = (n & 1) == 0;
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
        if (col >= n) continue;
        const bool both = col + 1 < n;
        const float v0 = __fmul_rn(__int2float_rn(acc[i][j][2 * r]), __fmul_rn(srow, sb[col]));
        const float v1 =
            both ? __fmul_rn(__int2float_rn(acc[i][j][2 * r + 1]), __fmul_rn(srow, sb[col + 1]))
                 : 0.f;
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
    }
  }
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
