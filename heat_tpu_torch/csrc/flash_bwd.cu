// Flash-attention backward: dQ, dK and dV from Q, K, V, dO, the forward's
// log-sum-exp (lse) and D = rowsum(dO * O), with the probabilities rebuilt
// tile by tile and never stored.
//
// Replaces three kernels of heat_tpu/parallel/pallas_attention.py:
//   - _bwd_dq_kernel (K7a): flash_bwd_dq_*, one block per query tile;
//   - _bwd_dkv_kernel (K7b): flash_bwd_dkv_*, one block per key tile;
//   - _bwd_fused_kernel (K8): flash_bwd_fused_*, one block per key tile
//     that also adds its dS K product into dQ.
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
// add their f32 dQ partials into a zeroed (B, T_q, H, D) f32 workspace with
// atomicAdd (FlashAttention-2's way), which the caller casts to q's dtype.
// The order of those adds changes from run to run, so K8's dQ is not
// bit-reproducible; its dK and dV, and all of K7a's and K7b's outputs, are
// (each is summed by one block in a fixed order).
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

namespace {

using namespace heat;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B, H, T_q)
  const float* dd;   // (B, H, T_q): D = rowsum(dO * O)
  void* dq;          // K8: the f32 workspace
  void* dk;
  void* dv;
  // element strides over (batch, time, head); the head dim is contiguous
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh;
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
