// Counter-mode threefry2x32: the JAX package's random bits, one element a
// thread.
//
// Replaces XLA's fused threefry2x32 operation (jax/_src/prng.py, reached from
// heat_tpu/core/random.py:59-65 through jax.random.{bits,uniform,normal,
// randint,permutation}); there is no Pallas kernel for it. Under
// jax_threefry_partitionable the element at flat index i of the global shape
// takes the counter (i >> 32, i & 0xffffffff) and its 32 bits are x0 ^ x1 of
// threefry2x32(key, counter). So each element is independent: a thread finds
// the global index of its local element from the rank's slice (outer, G,
// inner, start, length: the local element (o, t, j) is the global
// ((o * G) + start + t) * inner + j), runs the 20 rounds (rotations by
// __funnelshift_l), and writes one of four epilogues, each output once:
//   0 bits32       int32  x0 ^ x1
//   1 bits64       int64  x0 << 32 | x1
//   2 uniform_f32  float  max(lo, f * (hi - lo) + lo), f = [1, 2) from the
//                         23 high bits, minus 1
//   3 normal_f32   float  sqrt(2) * erfinv(u), u uniform in (-1, 1), by
//                         XLA's single-precision erf_inv polynomial
// The float epilogues round every product and sum on its own (__fmul_rn,
// __fadd_rn: no contraction into FMA), as the plain version's separate torch
// operations do (heat_tpu_torch/core/_threefry.py, draw_plain).
//
// Bound on the H100: the hash needs 41 operations an element that only the
// ALU pipe runs (64 lanes an SM a clock) and 32 adds that the FMA pipe may
// take, against 4 or 8 bytes written, so the integer pipe and not the
// memory bounds it. The design does nothing
// more than keep every lane busy: a grid-stride loop over elements, the
// rounds unrolled with immediate rotation amounts, and coalesced stores.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kThreads = 256;

// the rotation amount of round r (0-3) of group i (0-4)
__host__ __device__ constexpr int rotation(int i, int r) {
  return i % 2 == 0 ? (r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : 6)
                    : (r == 0 ? 17 : r == 1 ? 29 : r == 2 ? 16 : 24);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(i, r));
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// the coefficients as double literals converted to float, as the plain
// version's float32 tensors are made from python floats
#define F(c) static_cast<float>(c)
__device__ __forceinline__ float erfinv_f32(float x) {
  const float c_lt[9] = {F(2.81022636e-08), F(3.43273939e-07), F(-3.5233877e-06),
                         F(-4.39150654e-06), F(0.00021858087), F(-0.00125372503),
                         F(-0.00417768164), F(0.246640727), F(1.50140941)};
  const float c_ge[9] = {F(-0.000200214257), F(0.000100950558), F(0.00134934322),
                         F(-0.00367342844), F(0.00573950773), F(-0.0076224613),
                         F(0.00943887047), F(1.00167406), F(2.83297682)};
  float w = -log1pf(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? c_lt[0] : c_ge[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fadd_rn(lt ? c_lt[i] : c_ge[i], __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7f800000) : __fmul_rn(p, x);
}
#undef F

template <int kEpilogue>
__global__ void __launch_bounds__(kThreads)
threefry_draw(uint32_t k0, uint32_t k1, long long outer_len, long long g, long long inner,
              long long start, long long length, float lo, float hi, float sqrt2,
              void* __restrict__ out) {
  const long long n = outer_len * length * inner;
  const long long plane = length * inner;
  const float span = __fsub_rn(hi, lo);
  for (long long l = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; l < n;
       l += static_cast<long long>(gridDim.x) * kThreads) {
    unsigned long long idx;
    if (outer_len == 1) {
      idx = static_cast<unsigned long long>(start * inner + l);
    } else {
      const long long o = l / plane;
      const long long rest = l - o * plane;
      idx = static_cast<unsigned long long>((o * g + start) * inner + rest);
    }
    uint32_t x0 = static_cast<uint32_t>(idx >> 32);
    uint32_t x1 = static_cast<uint32_t>(idx);
    threefry2x32(k0, k1, x0, x1);
    if (kEpilogue == 1) {
      static_cast<unsigned long long*>(out)[l] =
          (static_cast<unsigned long long>(x0) << 32) | x1;
      continue;
    }
    const uint32_t bits = x0 ^ x1;
    if (kEpilogue == 0) {
      static_cast<uint32_t*>(out)[l] = bits;
      continue;
    }
    const float f = __fsub_rn(__int_as_float(static_cast<int>((bits >> 9) | 0x3F800000u)), 1.0f);
    const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, span), lo));
    static_cast<float*>(out)[l] = kEpilogue == 2 ? u : __fmul_rn(sqrt2, erfinv_f32(u));
  }
}

}  // namespace

// One draw of the slice (outer_len, g, inner, start, length) under the key
// (k0, k1) into `out` (outer_len * length * inner elements of the
// epilogue's type: int32, int64, float, float). `lo`, `hi` bound the
// uniform (epilogue 2), or the uniform that feeds erfinv (epilogue 3, with
// `sqrt2` the float32 sqrt(2)). `blocks` caps the grid of the grid-stride loop.
extern "C" int heat_threefry_draw(unsigned int k0, unsigned int k1, long long outer_len,
                                  long long g, long long inner, long long start,
                                  long long length, float lo, float hi, float sqrt2,
                                  int epilogue, int blocks, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case 0:
      threefry_draw<0><<<blocks, kThreads, 0, s>>>(k0, k1, outer_len, g, inner, start, length,
                                                   lo, hi, sqrt2, out);
      break;
    case 1:
      threefry_draw<1><<<blocks, kThreads, 0, s>>>(k0, k1, outer_len, g, inner, start, length,
                                                   lo, hi, sqrt2, out);
      break;
    case 2:
      threefry_draw<2><<<blocks, kThreads, 0, s>>>(k0, k1, outer_len, g, inner, start, length,
                                                   lo, hi, sqrt2, out);
      break;
    case 3:
      threefry_draw<3><<<blocks, kThreads, 0, s>>>(k0, k1, outer_len, g, inner, start, length,
                                                   lo, hi, sqrt2, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
