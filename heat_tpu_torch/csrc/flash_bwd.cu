// Flash-attention backward: dQ, dK and dV from Q, K, V, dO, the forward's
// log-sum-exp (lse) and D = rowsum(dO * O), with the probabilities rebuilt
// tile by tile and never stored.
//
// Replaces three kernels of heat_tpu/parallel/pallas_attention.py:
//   - _bwd_dq_kernel (K7a): flash_bwd_dq_*, one block per query tile;
//   - _bwd_dkv_kernel (K7b): flash_bwd_dkv_*, one block per key tile;
//   - _bwd_fused_kernel (K8): flash_bwd_fused_wgmma and flash_bwd_fused_*,
//     one block per key tile that also adds its dS K product into dQ.
// Each keeps the TPU kernels' block math (_rebuild_probs, _bwd_block_terms):
//   s  = (q k^T) scale in f32; live = k_pos < kv_valid (and k_pos <= q_pos
//        when causal, no offset for T_q != T_k);
//   p  = live ? exp(s - lse) : 0;      dP = dO V^T, accumulated in f32;
//   dS = p (dP - D) scale;
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO, each accumulated in f32 and
//   written once in the input dtype. For bf16 inputs p rounds to bf16
//   before P^T dO and dS to bf16 before dS K and dS^T Q (p_mx, ds_mx).
// A fully masked row has lse = +1e30 (from the forward), so its p is 0 and
// its dQ is 0; query rows past T_q read lse = +1e30 and D = 0 for the same
// reason. Tiles wholly above the causal diagonal or at or past kv_valid are
// skipped: their p is 0. The kernels read the public (B, T, H, D) layout
// through strides and mask ragged T and D themselves (zero-filled tiles,
// guarded stores); nothing is padded in device memory. lse and D are
// (B, H, T_q) f32.
//
// The exponential. The forward (flash_fwd.cu) computes its bf16
// probabilities as 2^(s log2 e - m log2 e) with ex2.approx and writes lse
// in natural-log units; here the bf16 kernels rebuild p the same way,
// 2^(dot * (scale log2 e) - lse log2 e), one FMA and one ex2.approx (a few
// ulp of f32, far inside the bf16 rounding of p and dS that follows). The
// f32 kernels use expf(dot * scale - lse), as the f32 forward does.
//
// Sequential grid axes. On the TPU the reduction axis of each kernel is a
// sequential grid axis whose accumulator lives in VMEM scratch; here each
// block loops over that axis itself with its accumulators in registers.
// K8's dQ is the exception: its key-tile blocks run in parallel, so they
// add their f32 dQ partials into a zeroed f32 workspace (FlashAttention-2's
// way), which the caller casts to q's dtype. The order of those adds changes
// from run to run, so K8's dQ is not bit-reproducible; its dK and dV, and
// all of K7a's and K7b's outputs, are (each is summed by one block in a
// fixed order).
//
// K8 for bf16 with D = 64 or 128 and 16-byte-aligned rows
// (flash_bwd_fused_wgmma). What bound the mma.sync K8 on the H100 was not
// its products but its dQ: every (query tile, key tile) pair added 64 x D
// floats one atomicAdd at a time (71 M scalar atomics at the LM's shape,
// 285 MB of 4-byte read-modify-writes at L2 against the 136 MB the whole
// kernel has to move), twice the two-pass kernels' time from T = 1024 on.
// The design:
//   - the workspace is private to the wrapper and laid out (B, H, T_q rounded
//     up to 64, D), so a 64-row tile of a head is contiguous; the tile's
//     partial goes to shared memory as f32 and one thread adds all of it with
//     one cp.reduce.async.bulk (a bulk group, waited on only before that
//     shared tile is written again, two query tiles later);
//   - the five products are wgmma: S^T = K Q^T and dP^T = V dO^T from shared
//     memory, every operand K-major as it lies; dV += P^T dO and dK += dS^T Q
//     with P^T and dS^T as bf16 A fragments in registers and dO, Q read
//     MN-major; dQ = dS K with dS^T from its swizzled shared tile as an
//     MN-major A and K as an MN-major B;
//   - Q and dO tiles come by bulk tensor copies into a ring on mbarriers,
//     started by a producer that also stages the tiles' lse and D values;
//   - at D = 128 two warpgroups of 64 keys each share the Q and dO tiles and
//     one dQ partial (each computes half its columns over all 128 keys, which
//     halves the reduce-add traffic), on 232 registers each that the producer
//     warpgroup hands over: dK and dV alone are 128 floats a thread.
// It is bound by operations (43 us at the LM's shape, 10 D a live pair); its
// times are in PERF.md section 6.
//
// K7a and K7b for the same inputs (flash_bwd_dq_wgmma, flash_bwd_dkv_wgmma).
// What held their mma.sync forms back was what held K8's: four warps each
// re-read every streamed tile from shared memory through ldmatrix, a
// __syncthreads() per tile behind a two-slot cp.async ring, 32-key (K7a) and
// 16-query (K7b) tiles at D = 128, and the exponentials never overlapped a
// product. The designs:
//   - K7b is K8's body with its dQ compiled out (no dS^T tile, no dQ
//     product, tiles or reduce-add): one body, two kernels;
//   - K7a mirrors the forward: consumer warpgroups of 64 query rows hold Q
//     and dO (one bulk tensor copy each) and dQ as an f32 accumulator; a
//     producer streams K and V tiles into a ring on mbarriers; per tile
//     S = Q K^T and dP = dO V^T come from shared memory (K-major), dS is
//     rebuilt on the accumulator fragments and packed to bf16 A fragments
//     for dQ += dS K (K read MN-major). The next tile's S and dP are queued
//     before this tile's dQ product, so the tensor cores work while the
//     warpgroup does the exponentials;
//   - K7a also computes D = rowsum(dO O) for its own rows (O by 16-byte
//     loads into registers, dO from its shared tile) and writes it to a
//     (B, H, T_q) f32 buffer that K7b, launched after it on the same stream,
//     reads: the wrapper's plain-torch prologue is gone on this path.
// Each output is summed by one block in a fixed order, so both stay
// bit-reproducible. Every other input (f32, other D, unaligned rows) keeps
// the kernels below, atomicAdd included.
//
// bf16 (tensor cores, mma.sync m16n8k16, bf16 in, f32 accumulate): 4 warps,
// each owning 16 rows of the block's 64 (query rows in K7a, keys in K7b and
// K8). The operand the block owns sits in shared memory for the whole loop
// and its A fragments come by ldmatrix; the streamed operand's tiles sit
// row-major in a ring of two slots that cp.async fills while the tensor
// cores work on the other slot, and ldmatrix (.trans where the contraction
// runs over its rows) reads their B fragments. The scores' accumulator
// fragments re-pack in registers as the A operand of the next product, so
// p and dS never touch shared memory, except in K8, whose dQ product needs
// dS with queries as rows: it stores dS^T in shared memory and reads it back
// with ldmatrix.trans. K7b and K8 hold two f32 accumulators of 16 x D a warp
// (dK, dV: 64 floats a thread at D = 64, 128 at D = 128); at D = 128 they
// take query tiles of 16 instead of 64, and K7a key tiles of 32, so that
// the scores of a tile take fewer registers and nothing spills (the build
// log's ptxas lines say).
// Bound on the H100 at the LM's shape (8, 1024, 16, 64) bf16 causal, 67.2 M
// live (row, key) pairs: K7a does 6 D = 384 operations a pair (25.8 GFLOP,
// 26 us at 989 TFLOP/s) against 85 MB of Q, K, V, dO, lse, D and dQ (25 us
// at 3.35 TB/s); K7b 8 D (34.4 GFLOP, 35 us) against 102 MB (30 us); K8
// 10 D (43.0 GFLOP, 43 us) against 136 MB with its f32 dQ (40 us). All
// three are bound by operations, by a little, so each keeps its owned tile
// on chip for the whole loop and streams the other operand once per block.
//
// f32 (exact f32 FMAs, no TF32): 8 threads a row, 16 rows a block, tiles of
// 32 along the loop (16 at D = 128); they serve f32 inputs at any head dim,
// off the LM's path.
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
  const void* dout;
  const float* lse;  // (B, H, T_q)
  const float* dd;   // (B, H, T_q): D = rowsum(dO * O)
  const void* o;     // wgmma K7a: O, from which it computes D into dd_out
  float* dd_out;
  void* dq;          // K8: the f32 workspace
  void* dk;
  void* dv;
  // element strides over (batch, time, head); the head dim is contiguous
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh, o_sb, o_st, o_sh;
  int h, t_q, t_k, kv_end, d, causal;
  float scale;
};

__device__ __forceinline__ bool live(const Params& p, int row, int col) {
  return col < p.kv_end && (!p.causal || col <= row);
}

// the number of key tiles of width bk that query rows [q0, q0 + bq) can see
__device__ __forceinline__ int live_k_tiles(const Params& p, int q0, int bq, int bk) {
  int k_end = p.kv_end;
  if (p.causal) k_end = min(k_end, q0 + bq);
  return k_end > 0 ? ceil_div(k_end, bk) : 0;
}

// the query tiles of width bq that keys [k0, k0 + bk) are seen by: [first, end)
__device__ __forceinline__ void live_q_tiles(const Params& p, int k0, int bq, int& first,
                                             int& end) {
  end = k0 < p.kv_end ? ceil_div(p.t_q, bq) : 0;
  first = p.causal ? k0 / bq : 0;
}

// lse and D of query row `row`; rows past T_q give p = 0 and dS = 0
__device__ __forceinline__ float row_lse(const Params& p, long long bh, int row) {
  return row < p.t_q ? p.lse[bh * p.t_q + row] : BIG;
}

__device__ __forceinline__ float row_dd(const Params& p, long long bh, int row) {
  return row < p.t_q ? p.dd[bh * p.t_q + row] : 0.f;
}

// stores the f32 accumulator fragments acc[DP / 8][4] of a warp's 16 rows
// (this thread: rows row0 and row0 + 8, columns 8 j + 2 tg + {0, 1}) as
// bf16 into rows of stride st, guarding T and D
template <int DP>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* base, long long st,
                                                const float (&acc)[DP / 8][4], int row0,
                                                int rows, int d, int tg) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* out = base + row * st;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + tg * 2;
      const float o0 = acc[j][2 * r], o1 = acc[j][2 * r + 1];
      if (c + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(o0, o1);
      } else {
        if (c < d) out[c] = __float2bfloat16(o0);
        if (c + 1 < d) out[c + 1] = __float2bfloat16(o1);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// c[j] (16 rows x 8 columns, j < N) += A B^T over DP: the A fragments from
// a row-major tile `a` (the warp's 16 rows from row a_row), the B
// fragments from the rows of a row-major tile `b` (N * 8 of them), both of
// row stride RS. This is the scores' product, Q K^T or dO V^T (and their
// transposes with keys as rows).
template <int DP, int N>
__device__ __forceinline__ void product_abt(float (&c)[N][4], const __nv_bfloat16* a,
                                            int a_row, const __nv_bfloat16* b, int lane) {
  constexpr int RS = DP + 8;
  const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (a_row + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + ((j + (mat >> 1)) * 8 + mrow) * RS + kk * 16 + (mat & 1) * 8);
      mma_bf16(c[j], af, bf[0], bf[1]);
      mma_bf16(c[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[j] (16 rows x 8 of the DP columns) += P B: P is 16 rows x (2 KT * 8)
// in accumulator fragments pf[2 KT], rounded to bf16 on the way into the
// tensor cores; B is a row-major tile of 2 KT * 8 rows by DP columns, of
// row stride DP + 8, read with ldmatrix.trans.
template <int DP, int KT>
__device__ __forceinline__ void product_pb(float (&acc)[DP / 8][4], const float (&pf)[2 * KT][4],
                                           const __nv_bfloat16* b, int lane) {
  constexpr int RS = DP + 8;
  const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    pack_a(a, pf[2 * kk], pf[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < DP / 8; j += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (kk * 16 + (mat & 1) * 8 + mrow) * RS + (j + (mat >> 1)) * 8);
      mma_bf16(acc[j], a, bf[0], bf[1]);
      mma_bf16(acc[j + 1], a, bf[2], bf[3]);
    }
  }
}

// ------------------------------------------------------------- bf16 K7a

// Dynamic shared memory: Q and dO tiles of 64 x (DP + 8) bf16, and two
// slots each of K and V tiles of BK x (DP + 8).
template <int DP, int BK>
constexpr int dq_smem_bytes() {
  return (2 * 64 + 4 * BK) * (DP + 8) * 2;
}

template <int DP, int BK, bool VEC>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(const Params p) {
  constexpr int BQ = 64, RS = DP + 8, TILE = BK * RS;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* const qs = smem;
  __nv_bfloat16* const dos = smem + 64 * RS;
  __nv_bfloat16* const kbuf = smem + 2 * 64 * RS;  // two K tiles
  __nv_bfloat16* const vbuf = kbuf + 2 * TILE;      // two V tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * p.h + hh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  const int n_tiles = live_k_tiles(p, q0, BQ, BK);
  const int q_rows = min(BQ, p.t_q - q0);

  load_tile<64, DP, VEC>(qs, static_cast<const __nv_bfloat16*>(p.q) + bb * p.q_sb +
                                 hh * p.q_sh + q0 * p.q_st, p.q_st, q_rows, p.d, tid);
  load_tile<64, DP, VEC>(dos, static_cast<const __nv_bfloat16*>(p.dout) + bb * p.do_sb +
                                  hh * p.do_sh + q0 * p.do_st, p.do_st, q_rows, p.d, tid);
  if (n_tiles > 0) {
    load_tile<BK, DP, VEC>(kbuf, kp, p.k_st, min(BK, p.t_k), p.d, tid);
    load_tile<BK, DP, VEC>(vbuf, vp, p.v_st, min(BK, p.t_k), p.d, tid);
  }
  cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float sl2 = p.scale * LOG2E;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = row_lse(p, bh, row[r]) * LOG2E;
    dd[r] = row_dd(p, bh, row[r]);
  }
  float acc[DP / 8][4];
  zero(acc);
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const __nv_bfloat16* ks = kbuf + (kt & 1) * TILE;
    const __nv_bfloat16* vs = vbuf + (kt & 1) * TILE;
    if (kt + 1 < n_tiles) {  // the next tile lands in the other slot meanwhile
      const int rows = min(BK, p.t_k - k0 - BK);
      load_tile<BK, DP, VEC>(kbuf + ((kt + 1) & 1) * TILE, kp + (k0 + BK) * p.k_st, p.k_st,
                             rows, p.d, tid);
      load_tile<BK, DP, VEC>(vbuf + ((kt + 1) & 1) * TILE, vp + (k0 + BK) * p.v_st, p.v_st,
                             rows, p.d, tid);
    }
    cp_async_commit();

    // S = Q K^T and dP = dO V^T, 16 rows x BK keys a warp
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
    product_abt<DP, BK / 8>(s, qs, warp * 16, ks, lane);
    product_abt<DP, BK / 8>(dp, dos, warp * 16, vs, lane);

    // dS in place of S; no mask work where every pair of the warp's rows is live
    const bool full = k0 + BK <= p.kv_end && (!p.causal || k0 + BK - 1 <= q0 + warp * 16);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pe = exp2_approx(fmaf(s[j][e], sl2, -lse2[r]));
        if (!full && !live(p, row[r], k0 + j * 8 + tg * 2 + (e & 1))) pe = 0.f;
        s[j][e] = pe * (dp[j][e] - dd[r]) * p.scale;
      }
    }
    // dQ += dS K: dS rounds to bf16; K's B fragments by ldmatrix.trans
    product_pb<DP, BK / 16>(acc, s, ks, lane);
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one is free
  }

  store_rows_bf16<DP>(static_cast<__nv_bfloat16*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh,
                      p.dq_st, acc, q0 + warp * 16 + g, p.t_q, p.d, tg);
}

// ------------------------------------------------------ bf16 K7b and K8

// Dynamic shared memory: K and V tiles of 64 x (DP + 8); two slots each of
// Q and dO tiles of BQ x (DP + 8); two slots of BQ lse (times log2 e) and D
// values; for K8, dS^T as 64 x (BQ + 8).
template <int DP, int BQ, bool FUSED>
constexpr int dkv_smem_bytes() {
  return (2 * 64 + 4 * BQ) * (DP + 8) * 2 + 4 * BQ * 4 + (FUSED ? 64 * (BQ + 8) * 2 : 0);
}

template <int DP, int BQ, bool VEC, bool FUSED>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(const Params p) {
  constexpr int BK = 64, RS = DP + 8, QTILE = BQ * RS, DSR = BQ + 8;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* const ks = smem;
  __nv_bfloat16* const vs = smem + 64 * RS;
  __nv_bfloat16* const qbuf = smem + 2 * 64 * RS;  // two Q tiles
  __nv_bfloat16* const dobuf = qbuf + 2 * QTILE;    // two dO tiles
  float* const lse_s = reinterpret_cast<float*>(dobuf + 2 * QTILE);  // two slots
  float* const dd_s = lse_s + 2 * BQ;                               // two slots
  __nv_bfloat16* const ds_s = reinterpret_cast<__nv_bfloat16*>(dd_s + 2 * BQ);  // K8
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int k0 = blockIdx.x * BK;  // the first key tiles see the most causal rows
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * p.h + hh;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const __nv_bfloat16* dop =
      static_cast<const __nv_bfloat16*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  int first, end;
  live_q_tiles(p, k0, BQ, first, end);
  const int k_rows = min(BK, p.t_k - k0);

  // stages query tile `it` (Q, dO, lse log2 e, D) into ring slot `slot`
  auto stage = [&](int it, int slot) {
    const int q0 = it * BQ, rows = min(BQ, p.t_q - q0);
    load_tile<BQ, DP, VEC>(qbuf + slot * QTILE, qp + q0 * p.q_st, p.q_st, rows, p.d, tid);
    load_tile<BQ, DP, VEC>(dobuf + slot * QTILE, dop + q0 * p.do_st, p.do_st, rows, p.d, tid);
    for (int i = tid; i < BQ; i += 128) {
      lse_s[slot * BQ + i] = row_lse(p, bh, q0 + i) * LOG2E;
      dd_s[slot * BQ + i] = row_dd(p, bh, q0 + i);
    }
  };

  float dk[DP / 8][4], dv[DP / 8][4];
  zero(dk);
  zero(dv);
  if (first < end) {
    load_tile<64, DP, VEC>(ks, static_cast<const __nv_bfloat16*>(p.k) + bb * p.k_sb +
                                   hh * p.k_sh + k0 * p.k_st, p.k_st, k_rows, p.d, tid);
    load_tile<64, DP, VEC>(vs, static_cast<const __nv_bfloat16*>(p.v) + bb * p.v_sb +
                                   hh * p.v_sh + k0 * p.v_st, p.v_st, k_rows, p.d, tid);
    stage(first, 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this thread's two keys: g and g + 8 of the warp's 16
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float sl2 = p.scale * LOG2E;
  for (int it = first; it < end; ++it) {
    const int slot = (it - first) & 1, q0 = it * BQ;
    const __nv_bfloat16* qs = qbuf + slot * QTILE;
    const __nv_bfloat16* dos = dobuf + slot * QTILE;
    const float* lse2 = lse_s + slot * BQ;
    const float* dd = dd_s + slot * BQ;
    if (it + 1 < end) stage(it + 1, slot ^ 1);  // lands in the other slot meanwhile
    cp_async_commit();

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x BQ queries a warp
    float st[BQ / 8][4], dpt[BQ / 8][4];
    zero(st);
    zero(dpt);
    product_abt<DP, BQ / 8>(st, ks, warp * 16, qs, lane);
    product_abt<DP, BQ / 8>(dpt, vs, warp * 16, dos, lane);

    // P^T in place of S^T, dS^T in place of dP^T; no mask work where every
    // pair of the warp's keys is live
    const int kw = k0 + warp * 16;
    const bool full = kw + 15 < p.kv_end && (!p.causal || kw + 15 <= q0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tg * 2 + (e & 1);
        float pe = exp2_approx(fmaf(st[j][e], sl2, -lse2[c]));
        if (!full && !live(p, q0 + c, key[e >> 1])) pe = 0.f;
        st[j][e] = pe;
        dpt[j][e] = pe * (dpt[j][e] - dd[c]) * p.scale;
      }
    }
    // dV += P^T dO and dK += dS^T Q: p and dS round to bf16
    product_pb<DP, BQ / 16>(dv, st, dos, lane);
    product_pb<DP, BQ / 16>(dk, dpt, qs, lane);

    if (FUSED) {
      // dS^T (bf16) into shared memory, then dQ (BQ x DP) += dS K: warps
      // split the tile into BQ / 16 row groups by 4 / (BQ / 16) column
      // groups; each adds its f32 partial into the workspace
      constexpr int NRG = BQ / 16, DPW = DP / (4 / NRG);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(ds_s + (warp * 16 + g + 8 * r) * DSR + j * 8 + tg * 2) =
              pack_bf16(dpt[j][2 * r], dpt[j][2 * r + 1]);
      }
      __syncthreads();
      const int rg = warp % NRG, c0 = (warp / NRG) * DPW;
      const int mat = lane >> 3, mrow = lane & 7;
      float dq[DPW / 8][4];
      zero(dq);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];  // dS rows rg*16.., keys kk*16.., from dS^T by ldmatrix.trans
        ldsm_x4_trans(a, ds_s + (kk * 16 + (mat >> 1) * 8 + mrow) * DSR + rg * 16 +
                             (mat & 1) * 8);
#pragma unroll
        for (int j = 0; j < DPW / 8; j += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, ks + (kk * 16 + (mat & 1) * 8 + mrow) * RS + c0 + (j + (mat >> 1)) * 8);
          mma_bf16(dq[j], a, bf[0], bf[1]);
          mma_bf16(dq[j + 1], a, bf[2], bf[3]);
        }
      }
      float* dqp = static_cast<float*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rg * 16 + g + 8 * r;
        if (row >= p.t_q) continue;
#pragma unroll
        for (int j = 0; j < DPW / 8; ++j) {
          const int c = c0 + j * 8 + tg * 2;
          if (c < p.d) atomicAdd(dqp + row * p.dq_st + c, dq[j][2 * r]);
          if (c + 1 < p.d) atomicAdd(dqp + row * p.dq_st + c + 1, dq[j][2 * r + 1]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one (and dS^T) is free
  }

  const int kr = warp * 16 + g;
  store_rows_bf16<DP>(static_cast<__nv_bfloat16*>(p.dk) + bb * p.dk_sb + hh * p.dk_sh +
                          k0 * p.dk_st, p.dk_st, dk, kr, k_rows, p.d, tg);
  store_rows_bf16<DP>(static_cast<__nv_bfloat16*>(p.dv) + bb * p.dv_sb + hh * p.dv_sh +
                          k0 * p.dv_st, p.dv_st, dv, kr, k_rows, p.d, tg);
}

// ------------------------------------------- bf16 K7b and K8, wgmma

// Shared memory of flash_bwd_dkv_wgmma (K7b) and flash_bwd_fused_wgmma (K8):
// K and V tiles (64 NWG x D), a ring of STAGES Q and dO tiles (64 x D) with
// their 64 lse log2 e and D values, the barriers, and 1024 bytes to align the
// tiles to the swizzle; K8 adds dS^T (64 NWG keys x 64 queries bf16,
// swizzled) and two f32 dQ tiles of 64 x D.
constexpr int kv_wgmma_smem_bytes(int d, int nwg, int stages, bool fused) {
  return 1024 + (2 * nwg + 2 * stages) * 64 * d * 2 +
         (fused ? nwg * 64 * 64 * 2 + 2 * 64 * d * 4 : 0) + stages * 2 * 64 * 4 +
         (1 + 2 * stages) * 8;
}

// the producer: a warp beside one consumer warpgroup; a whole warpgroup
// beside two, so that it can hand its registers over (setmaxnreg)
constexpr int producer_threads(int nwg) { return nwg == 2 ? 128 : 32; }

// The body of K7b (FUSED = false) and K8 (FUSED = true): NWG consumer
// warpgroups that own 64 keys each, and a producer. The producer's first
// lane starts the bulk tensor copies (K and V once, then the Q and dO tiles
// of every query tile that sees these keys, into a ring of STAGES slots on
// mbarriers) while its first warp stages the tiles' lse log2 e and D values.
// Per query tile a warpgroup starts S^T = K Q^T and dP^T = V dO^T (wgmma,
// every operand K-major as it lies), rebuilds P^T and dS^T on the
// accumulator fragments, and packs them to bf16 A fragments in registers for
// dV += P^T dO and dK += dS^T Q (dO and Q read MN-major). dK and dV are
// summed by this block alone, in a fixed order: bit-reproducible.
// K8 also stores dS^T swizzled in shared memory. dQ = dS K then reads dS^T
// as an MN-major A operand against K as an MN-major B, over all the block's
// keys; with two warpgroups each computes one half of dQ's columns, so the
// two share one partial. The 64 x D f32 partial goes to shared memory, and
// one thread adds the whole tile to the tile-contiguous (B, H, T_q rounded
// up to 64, D) workspace with one bulk reduce-add; the two dQ tiles
// alternate, so a reduce-add is only waited on two tiles later. The order in
// which key tiles add into a dQ tile changes from run to run, so K8's dQ is
// not bit-reproducible.
template <int D, int NWG, int STAGES, bool FUSED>
__device__ __forceinline__ void kv_wgmma_body(const Params& p, const CUtensorMap* map_q,
                                              const CUtensorMap* map_k,
                                              const CUtensorMap* map_v,
                                              const CUtensorMap* map_do) {
  constexpr int BQ = 64, BK = 64 * NWG, PANELS = D / 64;
  constexpr int DN = D / NWG;  // K8: the dQ columns of one warpgroup
  static_assert(DN == 64 || DN == 128, "a warpgroup's share of dQ is 64 or 128 columns");
  constexpr uint32_t PANEL = 64 * PANEL_ROW_BYTES, TILE = PANELS * PANEL;  // Q, dO
  constexpr uint32_t KV_PANEL = BK * PANEL_ROW_BYTES, KV_TILE = PANELS * KV_PANEL;
  constexpr int CONSUMERS = 128 * NWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* const ks = base;
  uint8_t* const vs = ks + KV_TILE;
  uint8_t* const qs = vs + KV_TILE;            // STAGES Q tiles
  uint8_t* const dos = qs + STAGES * TILE;     // STAGES dO tiles
  uint8_t* const ds_s = dos + STAGES * TILE;   // K8: dS^T, BK keys x 64 queries
  float* const dq_s = reinterpret_cast<float*>(ds_s + (FUSED ? KV_PANEL : 0));  // K8: 2 x (64 x D)
  float* const lse_s = dq_s + (FUSED ? 2 * BQ * D : 0);  // STAGES x 64
  float* const dd_s = lse_s + STAGES * BQ;     // STAGES x 64
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(dd_s + STAGES * BQ);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BK;  // the first key tiles see the most causal rows
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * p.h + hh;
  int first, end;
  live_q_tiles(p, k0, BQ, first, end);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 33);       // the copies' announcement and the producer warp's 32 lanes
      mbar_init(empty + i, 4 * NWG);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ------------------------------------------------------- producer
    if (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * NWG && first < end) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * KV_TILE);
#pragma unroll
        for (int pn = 0; pn < PANELS; ++pn) {
          tma_load_4d(ks + pn * KV_PANEL, map_k, kv_full, pn * PANEL_COLS, k0, hh, bb);
          tma_load_4d(vs + pn * KV_PANEL, map_v, kv_full, pn * PANEL_COLS, k0, hh, bb);
        }
      }
      for (int it = first; it < end; ++it) {
        const int n = it - first, slot = n % STAGES, q0 = it * BQ;
        if (n >= STAGES) mbar_wait(empty + slot, ((n / STAGES) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(full + slot, 2 * TILE);
#pragma unroll
          for (int pn = 0; pn < PANELS; ++pn) {
            tma_load_4d(qs + slot * TILE + pn * PANEL, map_q, full + slot, pn * PANEL_COLS, q0,
                        hh, bb);
            tma_load_4d(dos + slot * TILE + pn * PANEL, map_do, full + slot, pn * PANEL_COLS, q0,
                        hh, bb);
          }
        }
#pragma unroll
        for (int i = lane; i < BQ; i += 32) {
          lse_s[slot * BQ + i] = row_lse(p, bh, q0 + i) * LOG2E;
          dd_s[slot * BQ + i] = row_dd(p, bh, q0 + i);
        }
        mbar_arrive(full + slot);
      }
    }
  } else {
    // -------------------------------------------------------- consumers
    if (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
    const int kr = wg * 64 + (warp & 3) * 16 + g;  // this thread's first key row of the block
    const int kw = k0 + wg * 64 + (warp & 3) * 16;  // this warp's first key
    const int key[2] = {kw + g, kw + g + 8};
    const float sl2 = p.scale * LOG2E;
    const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs), ds_addr = smem_u32(ds_s);
    const uint32_t own = wg * 64 * PANEL_ROW_BYTES;  // this warpgroup's keys inside a K or V panel
    float dk[D / 8][4], dv[D / 8][4];
    zero(dk);
    zero(dv);

    if (first < end) mbar_wait(kv_full, 0);
    for (int it = first; it < end; ++it) {
      const int n = it - first, slot = n % STAGES, q0 = it * BQ;
      const uint32_t q_addr = smem_u32(qs + slot * TILE), do_addr = smem_u32(dos + slot * TILE);
      const float* lse2 = lse_s + slot * BQ;
      const float* dd = dd_s + slot * BQ;
      mbar_wait(full + slot, (n / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 64 keys x 64 queries
      float st[8][4], dpt[8][4];
      wgmma_fence();
      wgmma_abt<D>(st, k_addr + own, KV_PANEL, q_addr, PANEL);
      wgmma_abt<D>(dpt, v_addr + own, KV_PANEL, do_addr, PANEL);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T in place of S^T, dS^T in place of dP^T; no mask work where every
      // pair of the warp's keys is live
      const bool full_tile = kw + 15 < p.kv_end && (!p.causal || kw + 15 <= q0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + j * 8 + tg * 2);
        const float2 d2 = *reinterpret_cast<const float2*>(dd + j * 8 + tg * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + tg * 2 + (e & 1);
          float pe = exp2_approx(fmaf(st[j][e], sl2, -((e & 1) ? l2.y : l2.x)));
          if (!full_tile && !live(p, q0 + c, key[e >> 1])) pe = 0.f;
          st[j][e] = pe;
          dpt[j][e] = pe * (dpt[j][e] - ((e & 1) ? d2.y : d2.x)) * p.scale;
        }
      }
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pack_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
        pack_a(dsa[kk], dpt[2 * kk], dpt[2 * kk + 1]);
      }
      // dV += P^T dO and dK += dS^T Q: p and dS in bf16, dO and Q MN-major
      wgmma_fence();
      wgmma_pb<4>(dv, pa, do_addr, PANEL);
      wgmma_pb<4>(dk, dsa, q_addr, PANEL);
      wgmma_commit();

      if constexpr (FUSED) {
        // dS^T into its swizzled tile: key row r, queries 16 kk + 2 tg + {0, 1}
        // (+ 8) of the A fragment's four words; 16-byte chunk c of row r lies
        // at chunk c ^ (r & 7)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int r = kr + 8 * (w & 1), chunk = 2 * kk + (w >> 1);
            *reinterpret_cast<uint32_t*>(ds_s + r * PANEL_ROW_BYTES + ((chunk ^ (r & 7)) << 4) +
                                         tg * 4) = dsa[kk][w];
          }
        }
        // the dQ tile written two query tiles ago has been read by its reduce-add
        if (tid == 0) bulk_wait_read<1>();
        fence_proxy_async();
        asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");  // dS^T is whole
      }

      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (lane == 0) mbar_arrive(empty + slot);  // Q and dO of this slot are consumed

      if constexpr (FUSED) {
        // dQ = dS K over the block's keys, this warpgroup's DN columns: dS
        // from dS^T (MN-major A), K MN-major B
        float dq[DN / 8][4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<1, 1>(
              dq, wgmma_desc(ds_addr + kk * 16 * PANEL_ROW_BYTES, PANEL, SWIZZLE_ATOM_BYTES),
              wgmma_desc(k_addr + (wg * DN / 64) * KV_PANEL + kk * 16 * PANEL_ROW_BYTES, KV_PANEL,
                         SWIZZLE_ATOM_BYTES),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);

        float* const tile = dq_s + (n & 1) * BQ * D;
#pragma unroll
        for (int j = 0; j < DN / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(tile + ((warp & 3) * 16 + g + 8 * r) * D + wg * DN +
                                       j * 8 + tg * 2) = make_float2(dq[j][2 * r], dq[j][2 * r + 1]);
        }
        fence_proxy_async();
        asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");  // the dQ tile is whole
        if (tid == 0) {
          float* const ws = static_cast<float*>(p.dq) + (bh * p.dq_st) * D;  // dq_st: padded T_q
          bulk_reduce_add_f32(ws + static_cast<long long>(q0) * D, tile, BQ * D * 4);
          bulk_commit();
        }
      }
    }
    if (FUSED && tid == 0) bulk_wait_read<0>();

    const int k_rows = min(BK, p.t_k - k0);
    store_rows_bf16<D>(static_cast<__nv_bfloat16*>(p.dk) + bb * p.dk_sb + hh * p.dk_sh +
                           k0 * p.dk_st, p.dk_st, dk, kr, k_rows, p.d, tg);
    store_rows_bf16<D>(static_cast<__nv_bfloat16*>(p.dv) + bb * p.dv_sb + hh * p.dv_sh +
                           k0 * p.dv_st, p.dv_st, dv, kr, k_rows, p.d, tg);
  }
}

// K8. D = 64: one warpgroup, two blocks an SM. D = 128: two warpgroups of 232
// registers (dK and dV alone are 128 a thread), one block an SM.
template <int D, int NWG, int STAGES, int MINB>
__global__ void __launch_bounds__(NWG * 128 + producer_threads(NWG), MINB)
    flash_bwd_fused_wgmma(const Params p, const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do) {
  kv_wgmma_body<D, NWG, STAGES, true>(p, &map_q, &map_k, &map_v, &map_do);
}

// K7b: K8 without dQ, so without its dS^T tile, dQ tiles and dQ product;
// the shared memory freed goes to the ring (STAGES).
template <int D, int NWG, int STAGES, int MINB>
__global__ void __launch_bounds__(NWG * 128 + producer_threads(NWG), MINB)
    flash_bwd_dkv_wgmma(const Params p, const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do) {
  kv_wgmma_body<D, NWG, STAGES, false>(p, &map_q, &map_k, &map_v, &map_do);
}

template <int D, int NWG, int STAGES, int MINB, bool FUSED>
auto kv_wgmma_kernel() {
  if constexpr (FUSED)
    return flash_bwd_fused_wgmma<D, NWG, STAGES, MINB>;
  else
    return flash_bwd_dkv_wgmma<D, NWG, STAGES, MINB>;
}

template <int D, int NWG, int STAGES, int MINB, bool FUSED>
cudaError_t launch_kv_wgmma(const Params& p, int b, const TensorView* views,
                            cudaStream_t stream) {
  constexpr int smem = kv_wgmma_smem_bytes(D, NWG, STAGES, FUSED);
  CUtensorMap maps[4];  // q, k, v, dout: K and V in boxes of the block's keys
  const int box_rows[4] = {64, 64 * NWG, 64 * NWG, 64};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = make_tensor_map(&maps[i], views[i], box_rows[i]);
    if (err != cudaSuccess) return err;
  }
  auto kernel = kv_wgmma_kernel<D, NWG, STAGES, MINB, FUSED>();
  static bool ready[64] = {};  // of this instantiation, so of this kernel
  const cudaError_t err = allow_dynamic_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(p.t_k, 64 * NWG), p.h, b);
  kernel<<<grid, NWG * 128 + producer_threads(NWG), smem, stream>>>(p, maps[0], maps[1], maps[2],
                                                                    maps[3]);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16 K7a, wgmma

// Shared memory of flash_bwd_dq_wgmma: the Q and dO tiles (64 NWG x D), a
// ring of STAGES K and V tiles (BN x D), the barriers, and 1024 bytes to
// align the tiles to the swizzle.
constexpr int dq_wgmma_smem_bytes(int d, int nwg, int bn, int stages) {
  return 1024 + (2 * 64 * nwg + 2 * stages * bn) * d * 2 + (1 + 2 * stages) * 8;
}

// The ring's slots: three of 64-key tiles, two of 128-key tiles (so that a
// one-warpgroup block of those leaves room for a second block on its SM)
constexpr int dq_wgmma_stages(int bn) { return bn == 128 ? 2 : 3; }

// acc + the f32 products of two runs of eight bf16 values, in order (each
// product of two bf16 values is exact in f32)
__device__ __forceinline__ float dot8_bf16(const uint4& a, const uint4& b, float acc) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(wa[i] << 16), __uint_as_float(wb[i] << 16), acc);
    acc = fmaf(__uint_as_float(wa[i] & 0xffff0000u), __uint_as_float(wb[i] & 0xffff0000u), acc);
  }
  return acc;
}

// NWG consumer warpgroups of 64 query rows each and a producer. The
// producer's first thread starts the bulk tensor copies: Q and dO once, then
// the K and V tiles of every key tile these rows see into a ring of STAGES
// slots, each completing on its `full` mbarrier; it waits on a slot's `empty`
// barrier (one arrival a consumer warp) before it refills it.
// A consumer warp first computes D = rowsum(dO O) of its 16 rows: two lanes a
// row, each over half the columns, O by 16-byte loads started before the
// block waits for its tiles, dO from its swizzled shared tile; it writes D to
// dd_out and keeps its rows' D and lse log2 e in registers. Then, per key
// tile, S = Q K^T and dP = dO V^T (wgmma from shared memory, K-major as the
// tiles lie), dS = p (dP - D) scale on the accumulator fragments with
// p = 2^(s scale log2 e - lse log2 e), masks only on tiles that cross the
// causal diagonal or kv_valid, dS rounded to bf16 A fragments, and
// dQ += dS K (K read MN-major). The next tile's S and dP are started before
// this tile's dQ product, and the warpgroup rebuilds their dS while that
// product runs. dQ is written once from registers in q's dtype. Rows past
// T_q or keys past T_k arrive as zeros from the copies themselves.
template <int D, int NWG, int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(NWG * 128 + producer_threads(NWG), MINB)
    flash_bwd_dq_wgmma(const Params p, const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do) {
  constexpr int BM = 64 * NWG, PANELS = D / 64;
  constexpr uint32_t Q_PANEL = BM * PANEL_ROW_BYTES, Q_BYTES = PANELS * Q_PANEL;
  constexpr uint32_t KV_PANEL = BN * PANEL_ROW_BYTES, TILE = PANELS * KV_PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* const qs = base;
  uint8_t* const dos = qs + Q_BYTES;
  uint8_t* const ks = dos + Q_BYTES;       // STAGES K tiles
  uint8_t* const vs = ks + STAGES * TILE;  // STAGES V tiles
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(vs + STAGES * TILE);
  uint64_t* const full = q_full + 1;       // K and V of a slot
  uint64_t* const empty = full + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest causal rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * p.h + hh;
  const int n_tiles = live_k_tiles(p, q0, BM, BN);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * NWG);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ------------------------------------------------------- producer
    if (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(q_full, 2 * Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < PANELS; ++pn) {
        tma_load_4d(qs + pn * Q_PANEL, &map_q, q_full, pn * PANEL_COLS, q0, hh, bb);
        tma_load_4d(dos + pn * Q_PANEL, &map_do, q_full, pn * PANEL_COLS, q0, hh, bb);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int slot = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + slot, ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(full + slot, 2 * TILE);
#pragma unroll
        for (int pn = 0; pn < PANELS; ++pn) {
          tma_load_4d(ks + slot * TILE + pn * KV_PANEL, &map_k, full + slot, pn * PANEL_COLS,
                      kt * BN, hh, bb);
          tma_load_4d(vs + slot * TILE + pn * KV_PANEL, &map_v, full + slot, pn * PANEL_COLS,
                      kt * BN, hh, bb);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    if (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
    const int r0 = q0 + wg * 64 + (warp & 3) * 16;  // this warp's first row
    const int row[2] = {r0 + g, r0 + g + 8};
    // this warpgroup's rows may see fewer tiles than the block's
    const int my_tiles = live_k_tiles(p, q0 + wg * 64, 64, BN);
    const uint32_t own = wg * 64 * PANEL_ROW_BYTES;  // this warpgroup's rows inside a panel
    const uint32_t q_addr = smem_u32(qs) + own, do_addr = smem_u32(dos) + own;

    float dd[2], lse2[2];  // this thread's rows' D and lse log2 e
    const float sl2 = p.scale * LOG2E;
    float dq[D / 8][4], s[BN / 8][4], dp[BN / 8][4];
    uint32_t dsa[BN / 16][4];  // dS in bf16 A fragments, never in shared memory
    zero(dq);

    auto start_sdp = [&](int kt) {
      const int slot = kt % STAGES;
      mbar_wait(full + slot, (kt / STAGES) & 1);
      wgmma_fence();
      wgmma_abt<D>(s, q_addr, Q_PANEL, smem_u32(ks + slot * TILE), KV_PANEL);
      wgmma_abt<D>(dp, do_addr, Q_PANEL, smem_u32(vs + slot * TILE), KV_PANEL);
      wgmma_commit();
    };
    auto start_dq = [&](int kt) {
      wgmma_fence();
      wgmma_pb<BN / 16>(dq, dsa, smem_u32(ks + (kt % STAGES) * TILE), KV_PANEL);
      wgmma_commit();
    };
    // S and dP of tile kt are complete: dS in place of dP, no mask work
    // where every pair of the warp's rows is live
    auto tile_ds = [&](int kt) {
      fence_regs(s);
      fence_regs(dp);
      const int k0 = kt * BN;
      const bool full_tile = k0 + BN <= p.kv_end && (!p.causal || k0 + BN - 1 <= r0);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pe = exp2_approx(fmaf(s[j][e], sl2, -lse2[r]));
          if (!full_tile && !live(p, row[r], k0 + j * 8 + tg * 2 + (e & 1))) pe = 0.f;
          dp[j][e] = pe * (dp[j][e] - dd[r]) * p.scale;
        }
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pack_a(dsa[kk], dp[2 * kk], dp[2 * kk + 1]);
    };
    // the dQ product of tile kt is complete: its K and V slot is free
    auto release = [&](int kt) {
      if (lane == 0) mbar_arrive(empty + kt % STAGES);
    };

    // D of this warp's 16 rows: lanes 2 r and 2 r + 1 take row r's two
    // halves. (Starting the first tile's products before this loop made
    // ptxas serialize every wgmma of the kernel: its divergent stores would
    // run while a product is in flight.)
    {
      constexpr int CH = D / 16;  // 16-byte chunks of half a row
      const int rr = lane >> 1, half = lane & 1, r_blk = r0 - q0 + rr, row_d = r0 + rr;
      const __nv_bfloat16* orow = static_cast<const __nv_bfloat16*>(p.o) + bb * p.o_sb +
                                  hh * p.o_sh + static_cast<long long>(row_d) * p.o_st +
                                  half * (D / 2);
      uint4 ov[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        ov[i] = row_d < p.t_q ? *reinterpret_cast<const uint4*>(orow + 8 * i)
                              : make_uint4(0u, 0u, 0u, 0u);
      mbar_wait(q_full, 0);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = half * (D / 2) + 8 * i, chunk = (c % 64) / 8;
        const uint4 dov = *reinterpret_cast<const uint4*>(
            dos + (c / 64) * Q_PANEL + r_blk * PANEL_ROW_BYTES + ((chunk ^ (r_blk & 7)) << 4));
        sum = dot8_bf16(dov, ov[i], sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0 && row_d < p.t_q) p.dd_out[bh * p.t_q + row_d] = sum;
      dd[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
      dd[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) lse2[r] = row_lse(p, bh, row[r]) * LOG2E;

    if (my_tiles > 0) {
      start_sdp(0);
      wgmma_wait<0>();
      tile_ds(0);
      pack();
      for (int kt = 0; kt + 1 < my_tiles; ++kt) {
        start_sdp(kt + 1);
        start_dq(kt);
        wgmma_wait<1>();  // S and dP of the next tile; dS K of this one may still run
        tile_ds(kt + 1);
        wgmma_wait<0>();
        fence_regs(dq);
        release(kt);
        pack();
      }
      start_dq(my_tiles - 1);
      wgmma_wait<0>();
      fence_regs(dq);
      release(my_tiles - 1);
    }
    // tiles that only the block's other warpgroup sees: stay in step with
    // the ring, so that a release never runs a whole round ahead
    for (int kt = my_tiles; kt < n_tiles; ++kt) {
      mbar_wait(full + kt % STAGES, (kt / STAGES) & 1);
      release(kt);
    }
    store_rows_bf16<D>(static_cast<__nv_bfloat16*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh,
                       p.dq_st, dq, r0 + g, p.t_q, p.d, tg);
  }
}

template <int D, int NWG, int BN, int STAGES, int MINB>
cudaError_t launch_dq_wgmma(const Params& p, int b, const TensorView* views,
                            cudaStream_t stream) {
  constexpr int smem = dq_wgmma_smem_bytes(D, NWG, BN, STAGES);
  CUtensorMap maps[4];  // q, k, v, dout
  const int box_rows[4] = {64 * NWG, BN, BN, 64 * NWG};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = make_tensor_map(&maps[i], views[i], box_rows[i]);
    if (err != cudaSuccess) return err;
  }
  auto kernel = flash_bwd_dq_wgmma<D, NWG, BN, STAGES, MINB>;
  static bool ready[64] = {};  // of this instantiation, so of this kernel
  const cudaError_t err = allow_dynamic_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(p.t_q, 64 * NWG), p.h, b);
  kernel<<<grid, NWG * 128 + producer_threads(NWG), smem, stream>>>(p, maps[0], maps[1], maps[2],
                                                                    maps[3]);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32

// K7a in f32: 16 query rows a block, 8 threads a row, 32-key tiles (16 at
// D = 128, to stay inside 48 KB of static shared memory)
template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32(const Params p) {
  constexpr int BQ = 16, BK = DP == 128 ? 16 : 32, NT = 128;
  __shared__ float qs[BQ][DP + 1];
  __shared__ float dos[BQ][DP + 1];
  __shared__ float ks[BK][DP + 1];
  __shared__ float vs[BK][DP + 1];
  __shared__ float ds_s[BQ][BK + 1];
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * p.h + hh;
  const float* qp = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const float* dop = static_cast<const float*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const float* kp = static_cast<const float*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  for (int i = tid; i < BQ * DP; i += NT) {
    const int rr = i / DP, c = i % DP;
    const bool in = q0 + rr < p.t_q && c < p.d;
    qs[rr][c] = in ? qp[(q0 + rr) * p.q_st + c] : 0.f;
    dos[rr][c] = in ? dop[(q0 + rr) * p.do_st + c] : 0.f;
  }
  const int row = q0 + r;
  const float lse = row_lse(p, bh, row), dd = row_dd(p, bh, row);
  float acc[DP / 8];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j] = 0.f;

  const int n_tiles = live_k_tiles(p, q0, BQ, BK);
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
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int c = sub + 8 * i;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int x = 0; x < DP; ++x) {
        s = fmaf(qs[r][x], ks[c][x], s);
        dp = fmaf(dos[r][x], vs[c][x], dp);
      }
      const float pe = live(p, row, k0 + c) ? expf(s * p.scale - lse) : 0.f;
      ds_s[r][c] = pe * (dp - dd) * p.scale;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll 8
      for (int c = 0; c < BK; ++c) acc[j] = fmaf(ds_s[r][c], ks[c][sub + 8 * j], acc[j]);
    }
  }
  if (row >= p.t_q) return;
  float* out = static_cast<float*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh + row * p.dq_st;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
    if (sub + 8 * j < p.d) out[sub + 8 * j] = acc[j];
}

// K7b (and, FUSED, K8) in f32: 16 keys a block, 8 threads a key, 32-query
// tiles (16 at D = 128); K8 adds each tile's dS K into the f32 dQ with
// atomicAdd
template <int DP, bool FUSED>
__global__ void __launch_bounds__(128) flash_bwd_dkv_f32(const Params p) {
  constexpr int BK = 16, BQ = DP == 128 ? 16 : 32, NT = 128;
  __shared__ float ks[BK][DP + 1];
  __shared__ float vs[BK][DP + 1];
  __shared__ float qs[BQ][DP + 1];
  __shared__ float dos[BQ][DP + 1];
  __shared__ float lse_s[BQ], dd_s[BQ];
  __shared__ float p_s[BK][BQ + 1];
  __shared__ float ds_s[BK][BQ + 1];
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  const int k0 = blockIdx.x * BK;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * p.h + hh;
  const float* qp = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const float* dop = static_cast<const float*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const float* kp = static_cast<const float*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  for (int i = tid; i < BK * DP; i += NT) {
    const int rr = i / DP, c = i % DP;
    const bool in = k0 + rr < p.t_k && c < p.d;
    ks[rr][c] = in ? kp[(k0 + rr) * p.k_st + c] : 0.f;
    vs[rr][c] = in ? vp[(k0 + rr) * p.v_st + c] : 0.f;
  }
  const int key = k0 + r;
  float dk[DP / 8], dv[DP / 8];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) dk[j] = dv[j] = 0.f;

  int first, end;
  live_q_tiles(p, k0, BQ, first, end);
  for (int it = first; it < end; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BQ * DP; i += NT) {
      const int rr = i / DP, c = i % DP;
      const bool in = q0 + rr < p.t_q && c < p.d;
      qs[rr][c] = in ? qp[(q0 + rr) * p.q_st + c] : 0.f;
      dos[rr][c] = in ? dop[(q0 + rr) * p.do_st + c] : 0.f;
    }
    for (int i = tid; i < BQ; i += NT) {
      lse_s[i] = row_lse(p, bh, q0 + i);
      dd_s[i] = row_dd(p, bh, q0 + i);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const int c = sub + 8 * i;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int x = 0; x < DP; ++x) {
        s = fmaf(qs[c][x], ks[r][x], s);
        dp = fmaf(dos[c][x], vs[r][x], dp);
      }
      const float pe = live(p, q0 + c, key) ? expf(s * p.scale - lse_s[c]) : 0.f;
      p_s[r][c] = pe;
      ds_s[r][c] = pe * (dp - dd_s[c]) * p.scale;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = sub + 8 * j;
#pragma unroll 8
      for (int c = 0; c < BQ; ++c) {
        dv[j] = fmaf(p_s[r][c], dos[c][col], dv[j]);
        dk[j] = fmaf(ds_s[r][c], qs[c][col], dk[j]);
      }
    }
    if (FUSED) {
      __syncthreads();  // every key's dS of the tile is in shared memory
      constexpr int PARTS = NT / BQ;  // query c of the tile, columns part + PARTS j
      const int c = tid / PARTS, part = tid % PARTS;
      if (q0 + c < p.t_q) {
        float* out = static_cast<float*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh +
                     (q0 + c) * p.dq_st;
        for (int col = part; col < p.d; col += PARTS) {
          float sum = 0.f;
#pragma unroll
          for (int rr = 0; rr < BK; ++rr) sum = fmaf(ds_s[rr][c], ks[rr][col], sum);
          atomicAdd(out + col, sum);
        }
      }
    }
  }
  if (key >= p.t_k) return;
  float* dkr = static_cast<float*>(p.dk) + bb * p.dk_sb + hh * p.dk_sh + key * p.dk_st;
  float* dvr = static_cast<float*>(p.dv) + bb * p.dv_sb + hh * p.dv_sh + key * p.dv_st;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (sub + 8 * j < p.d) {
      dkr[sub + 8 * j] = dk[j];
      dvr[sub + 8 * j] = dv[j];
    }
  }
}

// ---------------------------------------------------------------- launch

enum Kind { DQ = 0, DKV = 1, FUSED_KV = 2 };

template <typename Kernel>
cudaError_t launch_dyn(Kernel kernel, dim3 grid, int smem, const Params& p,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(Kind kind, const Params& p, int b, int bf16, int vec, cudaStream_t stream) {
  // at D = 128 the loop's tiles shrink (K7a's key tile, K7b and K8's query
  // tile) so that the scores of a tile take fewer registers and nothing
  // spills beside the D-wide f32 accumulators
  constexpr int BK = DP == 128 ? 32 : 64;  // K7a's key tile
  constexpr int BQ = DP == 128 ? 16 : 64;  // K7b and K8's query tile
  if (bf16) {
    if (kind == DQ) {
      const dim3 grid(ceil_div(p.t_q, 64), p.h, b);
      return vec ? launch_dyn(flash_bwd_dq_bf16<DP, BK, true>, grid, dq_smem_bytes<DP, BK>(), p,
                              stream)
                 : launch_dyn(flash_bwd_dq_bf16<DP, BK, false>, grid, dq_smem_bytes<DP, BK>(), p,
                              stream);
    }
    const dim3 grid(ceil_div(p.t_k, 64), p.h, b);
    if (kind == DKV)
      return vec ? launch_dyn(flash_bwd_dkv_bf16<DP, BQ, true, false>, grid,
                              dkv_smem_bytes<DP, BQ, false>(), p, stream)
                 : launch_dyn(flash_bwd_dkv_bf16<DP, BQ, false, false>, grid,
                              dkv_smem_bytes<DP, BQ, false>(), p, stream);
    return vec ? launch_dyn(flash_bwd_dkv_bf16<DP, BQ, true, true>, grid,
                            dkv_smem_bytes<DP, BQ, true>(), p, stream)
               : launch_dyn(flash_bwd_dkv_bf16<DP, BQ, false, true>, grid,
                            dkv_smem_bytes<DP, BQ, true>(), p, stream);
  }
  if (kind == DQ) {
    flash_bwd_dq_f32<DP><<<dim3(ceil_div(p.t_q, 16), p.h, b), 128, 0, stream>>>(p);
  } else {
    const dim3 grid(ceil_div(p.t_k, 16), p.h, b);
    if (kind == DKV)
      flash_bwd_dkv_f32<DP, false><<<grid, 128, 0, stream>>>(p);
    else
      flash_bwd_dkv_f32<DP, true><<<grid, 128, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

int run(Kind kind, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* dd, void* dq, void* dk, void* dv,
        const long long* strides, int b, int h, int t_q, int t_k, int d, int kv_valid,
        int causal, float scale, int bf16, int vec, void* stream) {
  if (d < 1 || d > 128 || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0 || (kind == DQ ? t_q : t_k) == 0)
    return static_cast<int>(cudaGetLastError());
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.dd = static_cast<const float*>(dd);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  long long* const s[] = {&p.q_sb,  &p.q_st,  &p.q_sh,  &p.k_sb,  &p.k_st,  &p.k_sh,
                          &p.v_sb,  &p.v_st,  &p.v_sh,  &p.do_sb, &p.do_st, &p.do_sh,
                          &p.dq_sb, &p.dq_st, &p.dq_sh, &p.dk_sb, &p.dk_st, &p.dk_sh,
                          &p.dv_sb, &p.dv_st, &p.dv_sh};
  for (int i = 0; i < 21; ++i) *s[i] = strides[i];
  p.h = h;
  p.t_q = t_q;
  p.t_k = t_k;
  p.kv_end = max(0, min(kv_valid, t_k));
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32)
    err = launch<32>(kind, p, b, bf16, vec, st);
  else if (d <= 64)
    err = launch<64>(kind, p, b, bf16, vec, st);
  else
    err = launch<128>(kind, p, b, bf16, vec, st);
  return static_cast<int>(err);
}

}  // namespace

// q, dout: (B, T_q, H, D); k, v: (B, T_k, H, D); dq: (B, T_q, H, D) in q's
// dtype (for heat_flash_bwd_fused: f32, zeroed, the workspace that the
// blocks add into); dk, dv: (B, T_k, H, D) in k's dtype. Every one has unit
// stride over D; strides holds the element strides (batch, time, head) of
// q, k, v, dout, dq, dk, dv, in that order (21 values). lse and dd: (B, H,
// T_q) f32, contiguous. bf16 = 1 for bfloat16 tensors, 0 for float32; vec =
// 1 when d % 8 == 0 and every row start of q, k, v, dout is 16-byte aligned
// (bf16 only). kv_valid is clamped to [0, T_k]; D <= 128; batch and heads
// are grid dimensions (each <= 65535). Each entry launches one kernel on
// `stream` and returns cudaGetLastError(); unused outputs may be null.
extern "C" int heat_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* dd, void* dq, void* dk, void* dv,
                                 const long long* strides, int b, int h, int t_q, int t_k, int d,
                                 int kv_valid, int causal, float scale, int bf16, int vec,
                                 void* stream) {
  return run(DQ, q, k, v, dout, lse, dd, dq, dk, dv, strides, b, h, t_q, t_k, d, kv_valid,
             causal, scale, bf16, vec, stream);
}

extern "C" int heat_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* dd, void* dq, void* dk, void* dv,
                                  const long long* strides, int b, int h, int t_q, int t_k, int d,
                                  int kv_valid, int causal, float scale, int bf16, int vec,
                                  void* stream) {
  return run(DKV, q, k, v, dout, lse, dd, dq, dk, dv, strides, b, h, t_q, t_k, d, kv_valid,
             causal, scale, bf16, vec, stream);
}

extern "C" int heat_flash_bwd_fused(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* dd, void* dq,
                                    void* dk, void* dv, const long long* strides, int b, int h,
                                    int t_q, int t_k, int d, int kv_valid, int causal,
                                    float scale, int bf16, int vec, void* stream) {
  return run(FUSED_KV, q, k, v, dout, lse, dd, dq, dk, dv, strides, b, h, t_q, t_k, d, kv_valid,
             causal, scale, bf16, vec, stream);
}

namespace {

// Params of the wgmma kernels: lse and dd as above, the scalars, and the
// element strides (batch, time, head) of dk and dv (or of o and dq)
Params wgmma_params(const void* lse, const void* dd, int h, int t_q, int t_k, int d,
                    int kv_valid, int causal, float scale) {
  Params p = {};
  p.lse = static_cast<const float*>(lse);
  p.dd = static_cast<const float*>(dd);
  p.h = h;
  p.t_q = t_q;
  p.t_k = t_k;
  p.kv_end = max(0, min(kv_valid, t_k));
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  return p;
}

// the tensor-map views of q, k, v and dout from their 28 layout values
void wgmma_views(TensorView (&views)[4], const void* q, const void* k, const void* v,
                 const void* dout, const long long* layouts) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) views[i] = tensor_view(ptrs[i], layouts + 7 * i);
}

}  // namespace

// The wgmma kernels, for bf16 with d = 64 or 128 and 16-byte-aligned rows.
// layouts holds, for q, k, v and dout in turn, seven values: the view's D,
// T, H, B and the byte strides of T, H and B (each a multiple of 16).
//
// K8 through bulk copies. dq is the zeroed f32 workspace (B, H, t_q_pad, D),
// contiguous, with t_q_pad = t_q rounded up to 64: every 64-row tile of a
// head is contiguous there, and one bulk reduce-add adds a key tile's
// partial into it. kv_strides holds the element strides (batch, time, head)
// of dk, then dv.
extern "C" int heat_flash_bwd_fused_wgmma(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* dd,
                                          void* dq, void* dk, void* dv, const long long* layouts,
                                          const long long* kv_strides, int b, int h, int t_q,
                                          int t_k, int d, int kv_valid, int causal, float scale,
                                          void* stream) {
  if ((d != 64 && d != 128) || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0 || t_k == 0) return static_cast<int>(cudaGetLastError());
  Params p = wgmma_params(lse, dd, h, t_q, t_k, d, kv_valid, causal, scale);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dq_st = static_cast<long long>(ceil_div(t_q, 64)) * 64;  // the workspace's padded T_q
  p.dk_sb = kv_strides[0], p.dk_st = kv_strides[1], p.dk_sh = kv_strides[2];
  p.dv_sb = kv_strides[3], p.dv_st = kv_strides[4], p.dv_sh = kv_strides[5];
  TensorView views[4];
  wgmma_views(views, q, k, v, dout, layouts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 64 ? launch_kv_wgmma<64, 1, 3, 2, true>(p, b, views, st)
                                  : launch_kv_wgmma<128, 2, 2, 1, true>(p, b, views, st));
}

// K7b through bulk copies: dk and dv in k's dtype, from dd = D (B, H, T_q)
// f32 as K7a wrote it; kv_strides as for K8. stages: the slots of the Q and
// dO ring, 2 or 4 (the caller's rule picks it; nothing is chosen here).
extern "C" int heat_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* dd,
                                        void* dk, void* dv, const long long* layouts,
                                        const long long* kv_strides, int b, int h, int t_q,
                                        int t_k, int d, int kv_valid, int causal, float scale,
                                        int stages, void* stream) {
  if ((d != 64 && d != 128) || (stages != 2 && stages != 4) || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0 || t_k == 0) return static_cast<int>(cudaGetLastError());
  Params p = wgmma_params(lse, dd, h, t_q, t_k, d, kv_valid, causal, scale);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = kv_strides[0], p.dk_st = kv_strides[1], p.dk_sh = kv_strides[2];
  p.dv_sb = kv_strides[3], p.dv_st = kv_strides[4], p.dv_sh = kv_strides[5];
  TensorView views[4];
  wgmma_views(views, q, k, v, dout, layouts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = stages == 2 ? launch_kv_wgmma<64, 1, 2, 2, false>(p, b, views, st)
                      : launch_kv_wgmma<64, 1, 4, 2, false>(p, b, views, st);
  else
    err = stages == 2 ? launch_kv_wgmma<128, 2, 2, 1, false>(p, b, views, st)
                      : launch_kv_wgmma<128, 2, 4, 1, false>(p, b, views, st);
  return static_cast<int>(err);
}

// K7a through bulk copies: dq (B, T_q, H, D) in q's dtype, and D =
// rowsum(dO O) of every row into dd (B, H, T_q) f32, contiguous. o has the
// same shape as q, unit stride over D and 16-byte-aligned rows; strides
// holds the element strides (batch, time, head) of o, then dq. bm = 64 or
// 128 query rows a block (one or two consumer warpgroups), bn = 64 or 128
// keys a tile; d = 128 takes 128 x 64 only (a one-warpgroup block there
// spills at two blocks an SM, and 128-key tiles spill beside its 64 dQ
// floats a thread). The caller's rule picks them.
extern "C" int heat_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                       const void* dout, const void* o, const void* lse, void* dd,
                                       void* dq, const long long* layouts,
                                       const long long* strides, int b, int h, int t_q, int t_k,
                                       int d, int kv_valid, int causal, float scale, int bm,
                                       int bn, void* stream) {
  if ((d != 64 && d != 128) || (bm != 64 && bm != 128) || (bn != 64 && bn != 128) ||
      (d == 128 && (bm != 128 || bn != 64)) || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0 || t_q == 0) return static_cast<int>(cudaGetLastError());
  Params p = wgmma_params(lse, nullptr, h, t_q, t_k, d, kv_valid, causal, scale);
  p.o = o;
  p.dd_out = static_cast<float*>(dd);
  p.dq = dq;
  p.o_sb = strides[0], p.o_st = strides[1], p.o_sh = strides[2];
  p.dq_sb = strides[3], p.dq_st = strides[4], p.dq_sh = strides[5];
  TensorView views[4];
  wgmma_views(views, q, k, v, dout, layouts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define HEAT_DQ_CASE(D_, NWG_, BN_, MINB_)       \
  if (d == D_ && bm == 64 * NWG_ && bn == BN_) \
  err = launch_dq_wgmma<D_, NWG_, BN_, dq_wgmma_stages(BN_), MINB_>(p, b, views, st)
  HEAT_DQ_CASE(64, 1, 64, 2);
  else HEAT_DQ_CASE(64, 1, 128, 1);
  else HEAT_DQ_CASE(64, 2, 64, 1);
  else HEAT_DQ_CASE(64, 2, 128, 1);
  else HEAT_DQ_CASE(128, 2, 64, 1);
  else err = cudaErrorInvalidValue;
#undef HEAT_DQ_CASE
  return static_cast<int>(err);
}

// the dynamic shared memory of one block of a wgmma kernel, or -1: K8 by d;
// K7b by d and stages; K7a by d, bm and bn
extern "C" int heat_flash_bwd_fused_wgmma_smem(int d) {
  if (d == 64) return kv_wgmma_smem_bytes(64, 1, 3, true);
  if (d == 128) return kv_wgmma_smem_bytes(128, 2, 2, true);
  return -1;
}

extern "C" int heat_flash_bwd_dkv_wgmma_smem(int d, int stages) {
  if ((d != 64 && d != 128) || (stages != 2 && stages != 4)) return -1;
  return kv_wgmma_smem_bytes(d, d / 64, stages, false);
}

extern "C" int heat_flash_bwd_dq_wgmma_smem(int d, int bm, int bn) {
  if ((d != 64 && d != 128) || (bm != 64 && bm != 128) || (bn != 64 && bn != 128) ||
      (d == 128 && (bm != 128 || bn != 64)))
    return -1;
  return dq_wgmma_smem_bytes(d, bm / 64, bn, dq_wgmma_stages(bn));
}
