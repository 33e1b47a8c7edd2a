// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the masking constants of the JAX kernels, bf16 mma.sync
// m16n8k16 with its fragment loads (ldmatrix), cp.async, and the tile
// loader that reads a (time, dim) slice of the (B, T, H, D) layout through
// its row stride.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace heat {

constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG = -5e29f;  // NEG_INF / 2: "still fully masked"
constexpr float BIG = 1e30f;        // lse of a fully masked row
constexpr float LOG2E = 1.4426950408889634f;

// c += a b: one 16 x 8 tile, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of one 16 x 16 tile from four accumulator fragments of two
// neighbouring 16 x 8 tiles (c0 keys 0-7, c1 keys 8-15), rounded to bf16:
// a product's result re-used as the next product's A operand in registers
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x in one MUFU instruction (ex2.approx, ~2 ulp)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copies rows [0, rows) x cols [0, d) of a (time, dim) slice with row
// stride st into a ROWS x DP shared tile of row stride DP + 8, zero-filling
// the rest, with the 128 threads of a block. VEC (d % 8 == 0, every row
// start 16-byte aligned): one 16-byte cp.async per 8 values, zero-filled by
// the copy itself where out of range, so the tile lands while the block
// computes. Otherwise plain loads and stores, value by value. The row
// stride DP + 8 keeps ldmatrix free of bank conflicts.
template <int ROWS, int DP, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                          long long st, int rows, int d, int tid) {
  constexpr int NT = 128, CH = DP / 8, RS = DP + 8;
  static_assert(ROWS * CH % NT == 0, "tile does not split evenly over 128 threads");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / CH, c = (idx % CH) * 8;
    if (VEC) {
      const bool in = r < rows && c < d;
      cp_async16(tile + r * RS + c, in ? src + r * st + c : src, in);
    } else {
      uint32_t w[4];  // in registers: no local array, no stack frame
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = r < rows && c + 2 * e < d, hi = r < rows && c + 2 * e + 1 < d;
        const uint32_t a = lo ? __bfloat16_as_ushort(src[r * st + c + 2 * e]) : 0u;
        const uint32_t b = hi ? __bfloat16_as_ushort(src[r * st + c + 2 * e + 1]) : 0u;
        w[e] = a | (b << 16);
      }
      *reinterpret_cast<uint4*>(tile + r * RS + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

}  // namespace heat
