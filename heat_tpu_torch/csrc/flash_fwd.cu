// Flash-attention forward: O = softmax(scale * Q K^T + mask) V, row by row,
// with the online softmax (m, l, acc) in f32 and, on request, the
// log-sum-exp of every row.
//
// Replaces heat_tpu/parallel/pallas_attention.py::_flash_kernel. There the K
// axis is a sequential grid axis whose accumulator lives in VMEM scratch.
// Here one block owns a tile of query rows of one (batch, head) and loops
// over the K tiles itself, with m, l and acc in registers:
//   - it reads the public (B, T, H, D) layout through the strides it is
//     given, so the caller transposes nothing;
//   - it stops at the last K tile that a row of its tile can see (the causal
//     diagonal, kv_valid, T_k): tiles past it contribute exactly nothing in
//     the TPU kernel either (p = 0, alpha = 1), so skipping them is exact;
//   - it masks the ragged T_q, T_k and D edges itself (zero-filled tiles,
//     guarded stores); nothing is padded in device memory;
//   - fully masked rows give O = 0 and lse = +1e30, as on the TPU.
// The rules of the TPU kernel are kept: the scale multiplies the f32 Q K^T
// product, masked scores are the finite -1e30, m_safe and alpha guard rows
// that are still fully masked, l sums the f32 probabilities, and for bf16
// inputs p rounds to bf16 before the PV product.
//
// bf16 (flash_fwd_bf16): 4 warps, 16 query rows each, 64-key tiles. Both
// products run on the tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate). Q's fragments stay in registers for the whole loop; the
// scores' accumulator fragments are re-packed in registers as the A operand
// of the PV product, so the probabilities never touch shared memory. K and
// V tiles sit row-major in a ring of two slots: cp.async fills the next
// slot while the tensor cores work on the current one, and ldmatrix (with
// .trans for V) reads the B fragments. Rows are padded by 16 bytes, which
// keeps ldmatrix free of bank conflicts. The softmax of a tile takes about
// as many instruction slots as its 64 mma.sync, so it is kept lean: no
// mask work on tiles that are wholly live, and each exponential is one
// FMA and one ex2.approx (a few ulp of f32, far inside the bf16 rounding of
// p that follows).
// Bound on the H100 at the LM's shape (8, 1024, 16, 64) causal: 17.2 GFLOP
// over 989 TFLOP/s (17.4 us) against 67 MB of Q, K, V and O over 3.35 TB/s
// (20.0 us): bound by bytes, so each K/V tile is read once per query tile
// and the output is written once.
//
// f32 (flash_fwd_f32): exact f32 FMAs, 16 query rows by 32-key tiles, 8
// threads a row; it serves f32 inputs at any head dim, off the LM's path.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_common.cuh"

namespace {

using namespace heat;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, T_q) or null
  // element strides over (batch, time, head); the head dim is contiguous
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh;
  int h, t_q, t_k, kv_end, d, causal;
  float scale;
};

// the number of K tiles of width bk that rows [q0, q0 + bq) can see
__device__ __forceinline__ int live_tiles(const Params& p, int q0, int bq, int bk) {
  int k_end = p.kv_end;
  if (p.causal) k_end = min(k_end, q0 + bq);
  return k_end > 0 ? heat::ceil_div(k_end, bk) : 0;
}

__device__ __forceinline__ bool live(const Params& p, int row, int col) {
  return col < p.kv_end && (!p.causal || col <= row);
}

// online-softmax update of one row's (m, l) for a tile whose masked row max
// is mx; returns alpha and sets m_safe (the shift of this tile's exponents)
__device__ __forceinline__ float advance(float& m, float mx, float& m_safe) {
  const float m_new = fmaxf(m, mx);
  m_safe = m_new <= HALF_NEG ? 0.f : m_new;
  const float alpha = m <= HALF_NEG ? 0.f : expf(m - m_safe);
  m = m_new;
  return alpha;
}

__device__ __forceinline__ float row_lse(float m, float l) {
  const float m_safe = m <= HALF_NEG ? 0.f : m;
  return l == 0.f ? BIG : m_safe + logf(fmaxf(l, 1e-38f));
}

// ----------------------------------------------------------------- bf16

// One 16-row x 64-key tile of a warp: scale and mask the scores s (the
// accumulator fragments of Q K^T; this thread holds rows row[0], row[1] and
// keys k0 + 8 j + 2 tg + {0, 1}), advance the rows' (m, l) and replace s by
// the probabilities; alpha[r] is the rescale of row r's accumulator. The
// probabilities are exp(s - m_safe) as 2^(s log2 e - m_safe log2 e), one FMA
// and one MUFU op each. FULL: every pair is live, so no mask is built.
template <bool FULL>
__device__ __forceinline__ void tile_softmax(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& p,
                                             const int (&row)[2], int k0, int tg) {
  float mx[2] = {NEG_INF, NEG_INF};
  uint32_t mask = 0xffffffffu;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (FULL) {
        s[j][e] *= p.scale;
      } else {
        const bool on = live(p, row[e >> 1], k0 + j * 8 + tg * 2 + (e & 1));
        s[j][e] = on ? s[j][e] * p.scale : NEG_INF;
        if (!on) mask &= ~(1u << (j * 4 + e));
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float shift[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    float m_safe;
    alpha[r] = advance(m[r], mx[r], m_safe);
    shift[r] = m_safe * LOG2E;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = exp2_approx(fmaf(s[j][e], LOG2E, -shift[e >> 1]));
      if (!FULL && !((mask >> (j * 4 + e)) & 1u)) pe = 0.f;
      s[j][e] = pe;
      sum[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = alpha[r] * l[r] + sum[r];
  }
}

// Dynamic shared memory: K and V tiles, two of each, 64 x (DP + 8) bf16.
template <int DP>
constexpr int bf16_smem_bytes() {
  return 4 * 64 * (DP + 8) * 2;
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(128) flash_fwd_bf16(const Params p) {
  constexpr int BQ = 64, BK = 64;
  constexpr int RS = DP + 8;  // row stride of every tile (bf16): conflict-free ldmatrix
  constexpr int TILE = BK * RS;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* const kbuf = smem;            // two K tiles
  __nv_bfloat16* const vbuf = smem + 2 * TILE;  // two V tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(p.q) + bb * p.q_sb + hh * p.q_sh + q0 * p.q_st;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  const int n_tiles = live_tiles(p, q0, BQ, BK);

  // the first K/V tile and the Q tile (in the second K slot) in flight at once
  if (n_tiles > 0) {
    const int rows = min(BK, p.t_k);
    load_tile<64, DP, VEC>(kbuf, kp, p.k_st, rows, p.d, tid);
    load_tile<64, DP, VEC>(vbuf, vp, p.v_st, rows, p.d, tid);
  }
  load_tile<64, DP, VEC>(kbuf + TILE, qp, p.q_st, min(BQ, p.t_q - q0), p.d, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // Q's A fragments, held in registers for the whole loop
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* r0 = kbuf + TILE + (warp * 16 + g) * RS + kk * 16 + tg * 2;
    qf[kk][0] = ld32(r0);
    qf[kk][1] = ld32(r0 + 8 * RS);
    qf[kk][2] = ld32(r0 + 8);
    qf[kk][3] = ld32(r0 + 8 * RS + 8);
  }
  __syncthreads();

  // this thread's two rows: g and g + 8 of the warp's 16
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // ldmatrix lane roles: matrix mat = lane / 8, its row lane % 8
  const int mat = lane >> 3, mrow = lane & 7;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const __nv_bfloat16* ks = kbuf + (kt & 1) * TILE;
    const __nv_bfloat16* vs = vbuf + (kt & 1) * TILE;
    if (kt + 1 < n_tiles) {  // the next tile lands in the other slot meanwhile
      const int rows = min(BK, p.t_k - k0 - BK);
      load_tile<64, DP, VEC>(kbuf + ((kt + 1) & 1) * TILE, kp + (k0 + BK) * p.k_st, p.k_st,
                             rows, p.d, tid);
      load_tile<64, DP, VEC>(vbuf + ((kt + 1) & 1) * TILE, vp + (k0 + BK) * p.v_st, p.v_st,
                             rows, p.d, tid);
    }
    cp_async_commit();

    // S = Q K^T for 16 rows x 64 keys: 8 fragments of 16 x 8; one ldmatrix
    // gives the B fragments of two key octets
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, ks + ((j + (mat >> 1)) * 8 + mrow) * RS + kk * 16 + (mat & 1) * 8);
        mma_bf16(s[j], qf[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
      }
    }

    // the tile's probabilities in place of its scores; no mask work where
    // every (row, key) pair of the warp's 16 rows is live
    float alpha[2];
    if (k0 + BK <= p.kv_end && (!p.causal || k0 + BK - 1 <= q0 + warp * 16))
      tile_softmax<true>(s, m, l, alpha, p, row, k0, tg);
    else
      tile_softmax<false>(s, m, l, alpha, p, row, k0, tg);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P V: two score fragments (16 keys) are one A fragment, p in
    // bf16; V's B fragments come from its row-major tile by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (kk * 16 + (mat & 1) * 8 + mrow) * RS + (j + (mat >> 1)) * 8);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one is free
  }

  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + bb * p.o_sb + hh * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.t_q) continue;
    const float inv_denom = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* orow = op + row[r] * p.o_st;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + tg * 2;
      const float o0 = acc[j][2 * r] * inv_denom, o1 = acc[j][2 * r + 1] * inv_denom;
      if (c + 1 < p.d && (p.d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(o0, o1);
      } else {
        if (c < p.d) orow[c] = __float2bfloat16(o0);
        if (c + 1 < p.d) orow[c + 1] = __float2bfloat16(o1);
      }
    }
    if (p.lse != nullptr && tg == 0)
      p.lse[(static_cast<long long>(bb) * p.h + hh) * p.t_q + row[r]] = row_lse(m[r], l[r]);
  }
}

// ------------------------------------------------------------------ f32

template <int DP>
__global__ void __launch_bounds__(128) flash_fwd_f32(const Params p) {
  constexpr int BQ = 16, BK = 32, NT = 128;
  __shared__ float qs[BQ][DP + 1];
  __shared__ float ks[BK][DP + 1];
  __shared__ float vs[BK][DP];
  __shared__ float ps[BQ][BK + 1];
  const int tid = threadIdx.x;
  const int r = tid >> 3, sub = tid & 7;  // 8 threads a row, in one warp
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const float* qp = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + bb * p.v_sb + hh * p.v_sh;

  for (int i = tid; i < BQ * DP; i += NT) {
    const int rr = i / DP, c = i % DP;
    qs[rr][c] = (q0 + rr < p.t_q && c < p.d) ? qp[(q0 + rr) * p.q_st + c] : 0.f;
  }
  const int row = q0 + r;
  float m = NEG_INF, l = 0.f;
  float acc[DP / 8];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j] = 0.f;

  const int n_tiles = live_tiles(p, q0, BQ, BK);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * DP; i += NT) {
      const int rr = i / DP, c = i % DP;
      const bool in = k0 + rr < p.t_k && c < p.d;
      ks[rr][c] = in ? kp[(k0 + rr) * p.k_st + c] : 0.f;
      vs[rr][c] = in ? vp[(k0 + rr) * p.v_st + c] : 0.f;
    }
    __syncthreads();

    float s[BK / 8];
    bool on[BK / 8];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int c = sub + 8 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int x = 0; x < DP; ++x) dot = fmaf(qs[r][x], ks[c][x], dot);
      on[i] = live(p, row, k0 + c);
      s[i] = on[i] ? dot * p.scale : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float m_safe;
    const float alpha = advance(m, mx, m_safe);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float pe = on[i] ? expf(s[i] - m_safe) : 0.f;
      ps[r][sub + 8 * i] = pe;
      sum += pe;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l = alpha * l + sum;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      float pv = 0.f;
#pragma unroll 8
      for (int c = 0; c < BK; ++c) pv = fmaf(ps[r][c], vs[c][sub + 8 * j], pv);
      acc[j] = acc[j] * alpha + pv;
    }
  }

  if (row >= p.t_q) return;
  const float denom = l == 0.f ? 1.f : l;
  float* orow = static_cast<float*>(p.o) + bb * p.o_sb + hh * p.o_sh + row * p.o_st;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = sub + 8 * j;
    if (c < p.d) orow[c] = acc[j] / denom;
  }
  if (p.lse != nullptr && sub == 0)
    p.lse[(static_cast<long long>(bb) * p.h + hh) * p.t_q + row] = row_lse(m, l);
}

template <int DP>
cudaError_t launch(const Params& p, int b, int bf16, int vec, cudaStream_t stream) {
  if (bf16) {
    const dim3 grid(heat::ceil_div(p.t_q, 64), p.h, b);
    constexpr int smem = bf16_smem_bytes<DP>();
    auto kernel = vec ? flash_fwd_bf16<DP, true> : flash_fwd_bf16<DP, false>;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, 128, smem, stream>>>(p);
  } else {
    const dim3 grid(heat::ceil_div(p.t_q, 16), p.h, b);
    flash_fwd_f32<DP><<<grid, 128, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// q: (B, T_q, H, D), k and v: (B, T_k, H, D), each with unit stride over D
// and the element strides (batch, time, head) in strides[0:3], [3:6],
// [6:9]; o: (B, T_q, H, D) with strides[9:12]; lse: (B, H, T_q) f32
// contiguous, or null. bf16 = 1 for bfloat16 tensors, 0 for float32. vec = 1
// when d % 8 == 0 and every row start is 16-byte aligned (bf16 only).
// kv_valid is clamped to [0, T_k]; D <= 128. Batch and heads are grid
// dimensions (each <= 65535).
extern "C" int heat_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              const long long* strides, int b, int h, int t_q, int t_k, int d,
                              int kv_valid, int causal, float scale, int bf16, int vec,
                              void* stream) {
  if (d < 1 || d > 128 || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0 || t_q == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0], p.q_st = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_st = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_st = strides[7], p.v_sh = strides[8];
  p.o_sb = strides[9], p.o_st = strides[10], p.o_sh = strides[11];
  p.h = h;
  p.t_q = t_q;
  p.t_k = t_k;
  p.kv_end = max(0, min(kv_valid, t_k));
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32)
    err = launch<32>(p, b, bf16, vec, s);
  else if (d <= 64)
    err = launch<64>(p, b, bf16, vec, s);
  else
    err = launch<128>(p, b, bf16, vec, s);
  return static_cast<int>(err);
}
