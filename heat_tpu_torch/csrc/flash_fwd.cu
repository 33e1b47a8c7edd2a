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
// bf16, D = 64 or 128, rows 16-byte aligned (flash_fwd_wgmma), the LM's path.
// What bounds it on the H100: not bytes (20 us at the LM's shape (8, 1024,
// 16, 64) causal: 67 MB over 3.35 TB/s) nor the tensor cores (17 us: 17.2
// GFLOP over 989 TFLOP/s), but the exponentials and the instructions around
// them: the SM's special-function unit does 16 ex2 a clock, which at D = 64
// is exactly the rate at which its tensor cores consume scores (256 FLOP a
// score), so the softmax takes as long as both products, and any clock in
// which one waits for the other is lost. The design:
//   - both products are wgmma: S = Q K^T with Q and K from shared memory, O +=
//     P V with P from registers (the scores' accumulator fragments re-packed
//     to bf16, never in shared memory) and V read MN-major as it lies; a
//     warpgroup reads each K and V tile once, where the four warps of the
//     mma.sync kernel each read all of it through ldmatrix;
//   - one producer thread fills rings of three K and three V slots by bulk
//     tensor copies (a tensor map over the strided (B, T, H, D) view, 128-byte
//     swizzle, zero fill past T) that complete on mbarriers, so no thread
//     computes an address or waits for a copy it started;
//   - a warpgroup keeps two products queued while it does a tile's
//     exponentials (S of the next tile, P V of this one), and several
//     warpgroups share an SM (three 64-row blocks at D = 64; two warpgroups
//     of a 128-row block at D = 128, on registers the producer warpgroup
//     hands over with setmaxnreg);
//   - the softmax is lean and latency-tolerant: the scale folded into the
//     exponent's FMA, one FMA and one ex2.approx an exponential, four
//     independent chains for each row's max and sum, no mask work on wholly
//     live tiles, causal and kv_valid tile skip, longest causal rows first.
// Times, tile choices and what did not help are in PERF.md section 6.
//
// bf16, any other shape (flash_fwd_bf16): D <= 32, D not 64 or 128, rows not
// 16-byte aligned, or a non-positive scale. 4 warps, 16 query rows each,
// 64-key tiles. Both
// products run on the tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate). Q's fragments stay in registers for the whole loop; the
// scores' accumulator fragments are re-packed in registers as the A operand
// of the PV product, so the probabilities never touch shared memory. K and
// V tiles sit row-major in a ring of two slots: cp.async fills the next
// slot while the tensor cores work on the current one, and ldmatrix (with
// .trans for V) reads the B fragments. Rows are padded by 16 bytes, which
// keeps ldmatrix free of bank conflicts. It is bound by instruction slots:
// the softmax of a tile takes about as many slots as its 64 mma.sync, every
// warp reads the whole K and V tile from shared memory, and a load overlaps
// one tile of compute and no more.
//
// f32 (flash_fwd_f32): exact f32 FMAs, 16 query rows by 32-key tiles, 8
// threads a row; it serves f32 inputs at any head dim, off the LM's path.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_common.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------- bf16, wgmma

// The softmax of one warp's 16 rows x (8 NJ) keys of a tile, as tile_softmax
// above, for any tile width, arranged for a warpgroup that has only one
// other warp beside it on its scheduler to hide its latencies:
//   - the row max and the row sum each run as four independent chains;
//   - the scale is folded into the exponent's FMA: s holds the raw Q K^T
//     product, the row max is scaled once (the scale is positive here, so
//     max and rounding commute: m is the same float as the max of the
//     scaled scores) and p = 2^(s (scale log2 e) - m_safe log2 e), the form
//     the backward kernels rebuild p in.
// Masked scores are the finite NEG_INF, whose exponent underflows to exactly
// 0 against any shift a row can have (0 while the row is still fully masked,
// else its running max), so no mask is kept for the second pass.
template <int NJ, bool FULL>
__device__ __forceinline__ void tile_softmax_w(float (&s)[NJ][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], const Params& p,
                                               const int (&row)[2], int k0, int tg) {
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = NEG_INF, sum[r][c] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!FULL && !live(p, row[e >> 1], k0 + j * 8 + tg * 2 + (e & 1))) s[j][e] = NEG_INF;
      float& chain = mx[e >> 1][((j & 1) << 1) | (e & 1)];
      chain = fmaxf(chain, s[j][e]);
    }
  }
  const float sl2 = p.scale * LOG2E;
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float top = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
    float m_safe;
    alpha[r] = advance(m[r], top <= HALF_NEG ? NEG_INF : top * p.scale, m_safe);
    shift[r] = m_safe * LOG2E;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_approx(fmaf(s[j][e], sl2, -shift[e >> 1]));
      sum[e >> 1][((j & 1) << 1) | (e & 1)] += s[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float total = (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    l[r] = alpha[r] * l[r] + total;
  }
}

// the producer: a warp beside one consumer warpgroup; a whole warpgroup
// beside two, so that it can hand its registers over (setmaxnreg)
constexpr int producer_threads(int nwg) { return nwg == 2 ? 128 : 32; }

constexpr int FWD_STAGES = 3;  // slots of the K ring and of the V ring

constexpr int wgmma_smem_bytes(int d, int nwg, int bn) {
  return 1024 + (64 * nwg + 2 * FWD_STAGES * bn) * d * 2 + (1 + 4 * FWD_STAGES) * 8;
}

// NWG consumer warpgroups of 64 query rows each and one producer warpgroup.
// The producer's first thread starts the bulk tensor copies: Q once, then
// the K and V tiles into rings of STAGES slots, each slot completing on its
// own mbarrier; it waits on a slot's `empty` barrier before it refills it.
// With two consumer warpgroups the producer gives most of its registers to
// them (setmaxnreg): 12 warps share the SM's file three to a partition, 168
// registers a thread, and a consumer needs more.
// A consumer warpgroup keeps two products queued on the tensor cores while
// it does a tile's exponentials: per tile it starts S = Q K^T of the next
// tile (D / 16 wgmma, both operands from shared memory), then O += P V of
// this tile (P as bf16 A fragments in registers, V read MN-major from its
// row-major tile), waits for S, runs the lean softmax on it, waits for
// P V, rescales O and packs the next P. Each warp releases K's slot when
// S is done and V's when P V is done. Rows past T_q or T_k arrive as
// zeros from the copy itself.
template <int D, int NWG, int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(NWG * 128 + producer_threads(NWG), MINB)
    flash_fwd_wgmma(const Params p, const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v) {
  constexpr int BM = 64 * NWG, PANELS = D / 64;
  constexpr uint32_t Q_PANEL = BM * PANEL_ROW_BYTES, KV_PANEL = BN * PANEL_ROW_BYTES;
  constexpr uint32_t Q_BYTES = PANELS * Q_PANEL, TILE_BYTES = PANELS * KV_PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* const qs = base;
  uint8_t* const ks = qs + Q_BYTES;
  uint8_t* const vs = ks + STAGES * TILE_BYTES;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(vs + STAGES * TILE_BYTES);
  uint64_t* const q_full = bars;
  uint64_t* const k_full = bars + 1;
  uint64_t* const v_full = k_full + STAGES;
  uint64_t* const k_empty = v_full + STAGES;
  uint64_t* const v_empty = k_empty + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest causal rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int n_tiles = live_tiles(p, q0, BM, BN);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(k_empty + i, 4 * NWG);  // one arrival a consumer warp
      mbar_init(v_empty + i, 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ------------------------------------------------------- producer
    if (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < PANELS; ++pn)
        tma_load_4d(qs + pn * Q_PANEL, &map_q, q_full, pn * PANEL_COLS, q0, hh, bb);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int slot = kt % STAGES;
        if (kt >= STAGES) mbar_wait(k_empty + slot, ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(k_full + slot, TILE_BYTES);
#pragma unroll
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_4d(ks + slot * TILE_BYTES + pn * KV_PANEL, &map_k, k_full + slot,
                      pn * PANEL_COLS, kt * BN, hh, bb);
        if (kt >= STAGES) mbar_wait(v_empty + slot, ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(v_full + slot, TILE_BYTES);
#pragma unroll
        for (int pn = 0; pn < PANELS; ++pn)
          tma_load_4d(vs + slot * TILE_BYTES + pn * KV_PANEL, &map_v, v_full + slot,
                      pn * PANEL_COLS, kt * BN, hh, bb);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    if (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
    const int r0 = q0 + wg * 64 + (warp & 3) * 16;  // this warp's first row
    const int row[2] = {r0 + g, r0 + g + 8};
    // this warpgroup's rows may see fewer tiles than the block's
    const int my_tiles = live_tiles(p, q0 + wg * 64, 64, BN);
    const uint32_t q_addr = smem_u32(qs) + wg * 64 * PANEL_ROW_BYTES;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    float acc[D / 8][4], s[BN / 8][4];
    uint32_t pa[BN / 16][4];  // p in bf16 A fragments, never in shared memory
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    auto start_s = [&](int kt) {
      const int slot = kt % STAGES;
      mbar_wait(k_full + slot, (kt / STAGES) & 1);
      wgmma_fence();
      wgmma_abt<D>(s, q_addr, Q_PANEL, smem_u32(ks + slot * TILE_BYTES), KV_PANEL);
      wgmma_commit();
    };
    auto start_pv = [&](int kt) {
      const int slot = kt % STAGES;
      mbar_wait(v_full + slot, (kt / STAGES) & 1);
      wgmma_fence();
      wgmma_pb<BN / 16>(acc, pa, smem_u32(vs + slot * TILE_BYTES), KV_PANEL);
      wgmma_commit();
    };
    // S of tile kt is complete: K's slot is free; s becomes the tile's
    // probabilities, (m, l) advance and alpha is the rescale of O
    auto softmax = [&](int kt) {
      fence_regs(s);
      if (lane == 0) mbar_arrive(k_empty + kt % STAGES);
      const int k0 = kt * BN;
      if (k0 + BN <= p.kv_end && (!p.causal || k0 + BN - 1 <= r0))
        tile_softmax_w<BN / 8, true>(s, m, l, alpha, p, row, k0, tg);
      else
        tile_softmax_w<BN / 8, false>(s, m, l, alpha, p, row, k0, tg);
    };
    // no product is in flight: O takes alpha and p its bf16 fragments
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    };

    mbar_wait(q_full, 0);
    if (my_tiles > 0) {
      start_s(0);
      wgmma_wait<0>();
      softmax(0);
      rescale_and_pack();
      for (int kt = 0; kt + 1 < my_tiles; ++kt) {
        start_s(kt + 1);
        start_pv(kt);
        wgmma_wait<1>();  // S of the next tile; P V of this one may still run
        softmax(kt + 1);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(v_empty + kt % STAGES);
        rescale_and_pack();
      }
      start_pv(my_tiles - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(v_empty + (my_tiles - 1) % STAGES);
    }
    // tiles that only the block's other warpgroup sees: stay in step with
    // the ring, so that a release never runs a whole round ahead
    for (int kt = my_tiles; kt < n_tiles; ++kt) {
      const int slot = kt % STAGES;
      mbar_wait(v_full + slot, (kt / STAGES) & 1);
      if (lane == 0) {
        mbar_arrive(k_empty + slot);
        mbar_arrive(v_empty + slot);
      }
    }

    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + bb * p.o_sb + hh * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= p.t_q) continue;
      const float inv_denom = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      __nv_bfloat16* orow = op + row[r] * p.o_st;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tg * 2) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv_denom, acc[j][2 * r + 1] * inv_denom);
      if (p.lse != nullptr && tg == 0)
        p.lse[(static_cast<long long>(bb) * p.h + hh) * p.t_q + row[r]] = row_lse(m[r], l[r]);
    }
  }
}

template <int D, int NWG, int BN, int MINB>
cudaError_t launch_wgmma(const Params& p, int b, const TensorView* views, cudaStream_t stream) {
  constexpr int STAGES = FWD_STAGES;
  constexpr int smem = wgmma_smem_bytes(D, NWG, BN);
  CUtensorMap maps[3];
  const int box_rows[3] = {64 * NWG, BN, BN};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_tensor_map(&maps[i], views[i], box_rows[i]);
    if (err != cudaSuccess) return err;
  }
  auto kernel = flash_fwd_wgmma<D, NWG, BN, STAGES, MINB>;
  static bool ready[64] = {};  // of this instantiation, so of this kernel
  const cudaError_t err = allow_dynamic_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(heat::ceil_div(p.t_q, 64 * NWG), p.h, b);
  kernel<<<grid, NWG * 128 + producer_threads(NWG), smem, stream>>>(p, maps[0], maps[1], maps[2]);
  return cudaGetLastError();
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

// The wgmma variant: bf16, d = 64 or 128, every row start 16-byte aligned.
// layouts holds, for q, k and v in turn, seven values: the view's D, T, H, B
// and the byte strides of T, H and B (each a multiple of 16), from which the
// tensor maps are encoded; o_strides the element strides (batch, time,
// head) of o. bm = 128 (two consumer warpgroups) or 64 (one) rows a block,
// bn = 64 or 128 keys a tile. The caller picks this entry and its tiles;
// nothing is chosen here.
extern "C" int heat_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const long long* layouts,
                                    const long long* o_strides, int b, int h, int t_q, int t_k,
                                    int d, int kv_valid, int causal, float scale, int bm, int bn,
                                    void* stream) {
  if (!(scale > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  if ((d != 64 && d != 128) || (bm != 64 && bm != 128) || (bn != 64 && bn != 128) || b > 65535 ||
      h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0 || t_q == 0) return static_cast<int>(cudaGetLastError());
  Params p = {};
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_strides[0], p.o_st = o_strides[1], p.o_sh = o_strides[2];
  p.h = h;
  p.t_q = t_q;
  p.t_k = t_k;
  p.kv_end = max(0, min(kv_valid, t_k));
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  const TensorView views[3] = {tensor_view(q, layouts), tensor_view(k, layouts + 7),
                               tensor_view(v, layouts + 14)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define HEAT_FWD_CASE(D_, NWG_, BN_, MINB_)    \
  if (d == D_ && bm == 64 * NWG_ && bn == BN_) \
  err = launch_wgmma<D_, NWG_, BN_, MINB_>(p, b, views, s)
  HEAT_FWD_CASE(64, 2, 64, 1);
  else HEAT_FWD_CASE(64, 2, 128, 1);
  else HEAT_FWD_CASE(64, 1, 64, 3);
  else HEAT_FWD_CASE(64, 1, 128, 2);
  else HEAT_FWD_CASE(128, 2, 64, 1);
  else HEAT_FWD_CASE(128, 2, 128, 1);
  else HEAT_FWD_CASE(128, 1, 64, 2);
  else HEAT_FWD_CASE(128, 1, 128, 1);
  else err = cudaErrorInvalidValue;
#undef HEAT_FWD_CASE
  return static_cast<int>(err);
}

// the dynamic shared memory of one block of the wgmma variant, or -1
extern "C" int heat_flash_fwd_wgmma_smem(int d, int bm, int bn) {
  if ((d != 64 && d != 128) || (bm != 64 && bm != 128) || (bn != 64 && bn != 128)) return -1;
  return wgmma_smem_bytes(d, bm / 64, bn);
}
