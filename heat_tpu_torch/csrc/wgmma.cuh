// Hopper building blocks shared by the redesigned kernels (flash_fwd.cu,
// flash_bwd.cu, int8_gemm.cu, lloyd.cu, cdist.cu): mbarriers, bulk tensor
// copies (TMA) through a tensor map over the strided (B, T, H, D) view or
// over a 2-D row-major matrix, in both directions, the bulk reduce-add from
// shared to device memory, and
// warpgroup matrix products (wgmma) with their shared-memory descriptors:
// bf16 (f32 accumulator), s8 (exact s32 accumulator) and tf32.
//
// One layout serves every tile: rows of 64 bf16 (128 bytes) in the 128-byte
// swizzle (the 16-byte chunk index of an address XORed with its row index
// modulo 8), tiles aligned to 1024 bytes. A (rows x D) tile is D / 64 such
// panels, one after the other. The tensor map's copy writes that layout
// (CU_TENSOR_MAP_SWIZZLE_128B, a box of 64 columns) and zero-fills rows past
// the tensor's end; the descriptors below read it, either with the 64
// columns as the contraction (K-major, as Q and K lie for Q K^T) or with the
// rows as the contraction (MN-major, as V lies for P V: the trans flag).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time, so no -lcuda
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <mutex>

namespace heat {

constexpr int PANEL_COLS = 64;    // bf16 values in a 128-byte swizzled row
constexpr int PANEL_ROW_BYTES = 128;
constexpr int SWIZZLE_ATOM_BYTES = 1024;  // 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the inits, before any thread or copy uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`. A wait that lasts
// past ~2^32 clocks (seconds) is a lost arrival: it traps, so that a fault
// in a pipeline surfaces as a CUDA error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 32))
      __trap();
  }
}

// ------------------------------------------------------------ bulk copies

// One box of the tensor map `map` at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at `dst`; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of the 2-D tensor map `map` at (column c0, row c1) into `dst`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// generic-proxy writes to shared memory (st.shared) become visible to the
// asynchronous proxy (bulk copies, wgmma); every writing thread executes it
// before the barrier that hands the data over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// device memory [dst, dst + bytes) += shared memory [src, src + bytes), f32,
// element-wise and atomic per element, in one instruction of one thread;
// both addresses and `bytes` are multiples of 16
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// shared memory at `src`, one box of the 2-D tensor map `map`, into device
// memory at (column c0, row c1); the map clips the box at the tensor's
// edges. Completes in this thread's current bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// An L2 cache policy for output that is written once and not read again:
// the lines a store under it writes are the first the L2 evicts.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// tma_store_2d under an L2 cache policy (l2_evict_first)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%2, %3}], [%1], "
      "%4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most PENDING of this thread's bulk groups still read their source
template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING) : "memory");
}

// until at most PENDING of this thread's bulk groups are still in flight
// (their writes to device memory done, not only their reads of the source)
template <int PENDING>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// After a wgmma_wait, before the first read of an accumulator that an
// asynchronous product wrote: the compiler does not know that the wait
// orders those registers, so this pins every read after it.
template <int NJ>
__device__ __forceinline__ void fence_regs(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

template <int NJ>
__device__ __forceinline__ void fence_regs(int (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
  }
}

// The descriptor of an operand in the 128-byte swizzle at shared address
// `addr`. K-major (contraction along the 64 columns of a panel): sbo = 1024,
// the stride between groups of 8 rows; lbo is not used; the 16 values of one
// k16 step start 32 bytes after the last, inside the swizzled row.
// MN-major (contraction along the rows): sbo = 1024, the stride between
// groups of 8 rows of the contraction; lbo = the stride from one panel of
// 64 columns to the next; a k16 step is 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

#define HEAT_ACC4(d, j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define HEAT_ACC32(d)                                                                   \
  HEAT_ACC4(d, 0), HEAT_ACC4(d, 1), HEAT_ACC4(d, 2), HEAT_ACC4(d, 3), HEAT_ACC4(d, 4), \
      HEAT_ACC4(d, 5), HEAT_ACC4(d, 6), HEAT_ACC4(d, 7)
#define HEAT_ACC64(d)                                                                      \
  HEAT_ACC32(d), HEAT_ACC4(d, 8), HEAT_ACC4(d, 9), HEAT_ACC4(d, 10), HEAT_ACC4(d, 11),    \
      HEAT_ACC4(d, 12), HEAT_ACC4(d, 13), HEAT_ACC4(d, 14), HEAT_ACC4(d, 15)
#define HEAT_REGS32                                                                      \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22," \
  "%23,%24,%25,%26,%27,%28,%29,%30,%31}"
#define HEAT_REGS64                                                                      \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22," \
  "%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43," \
  "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"

// d (64 x 8 NJ, f32; this thread's fragments d[j][0..3] are rows g and g + 8
// of its warp's 16, columns 8 j + 2 tg + {0, 1}, as mma.sync's) = A B (+ d
// when acc != 0), one k16 step, bf16 in. A and B from shared memory through
// descriptors; TA / TB = 1 marks an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HEAT_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HEAT_ACC32(d)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HEAT_REGS64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : HEAT_ACC64(d)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// the same with A from registers: the bf16 A fragment of mma.sync m16n8k16
// for this warp's 16 rows (pack_a of two accumulator fragments)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HEAT_REGS32
      ", {%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : HEAT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HEAT_REGS64
      ", {%64,%65,%66,%67}, %68, p, 1, 1, %70;\n}\n"
      : HEAT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// d (64 x 64, f32) = A B (+ d when acc != 0), one k8 step in tf32 (each
// operand's low 13 mantissa bits are ignored): A from registers, the tf32
// A fragment of mma.sync m16n8k8 for this warp's 16 rows (a[0] row g, a[1]
// row g + 8, both column tg; a[2], a[3] the same rows, column tg + 4); B
// (64 rows x 8, K-major: the contraction along its rows of 32 values in
// the 128-byte swizzle) from shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HEAT_REGS32
      ", {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : HEAT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// the same for a B of 128 rows: d (64 x 128, f32) = A B (+ d), one k8 step
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HEAT_REGS64
      ", {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : HEAT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef HEAT_ACC4
#undef HEAT_ACC32
#undef HEAT_ACC64
#undef HEAT_REGS32
#undef HEAT_REGS64

#define HEAT_IACC4(d, j) "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])
#define HEAT_IACC32(d, j)                                                          \
  HEAT_IACC4(d, j), HEAT_IACC4(d, j + 1), HEAT_IACC4(d, j + 2), HEAT_IACC4(d, j + 3), \
      HEAT_IACC4(d, j + 4), HEAT_IACC4(d, j + 5), HEAT_IACC4(d, j + 6), HEAT_IACC4(d, j + 7)
#define HEAT_REGS128 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
  "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47," \
  "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71," \
  "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95," \
  "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119," \
  "%120,%121,%122,%123,%124,%125,%126,%127}"

// d (64 x 256, s32, exact; fragments as wgmma_ss's) = A B (+ d when acc !=
// 0), one k32 step of int8: A (64 x 32) and B (256 rows x 32) both K-major
// in shared memory (int8 operands cannot be read MN-major).
__device__ __forceinline__ void wgmma_s8(int (&d)[32][4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " HEAT_REGS128 ", %128, %129, p;\n}\n"
      : HEAT_IACC32(d, 0), HEAT_IACC32(d, 8), HEAT_IACC32(d, 16), HEAT_IACC32(d, 24)
      : "l"(da), "l"(db), "r"(acc));
}

#define HEAT_IREGS64 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
  "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47," \
  "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"

// the same for a 64 x 128 tile of B's 128 rows
__device__ __forceinline__ void wgmma_s8(int (&d)[16][4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HEAT_IREGS64 ", %64, %65, p;\n}\n"
      : HEAT_IACC32(d, 0), HEAT_IACC32(d, 8)
      : "l"(da), "l"(db), "r"(acc));
}

#undef HEAT_IACC4
#undef HEAT_IACC32
#undef HEAT_REGS128
#undef HEAT_IREGS64

// v rounded to tf32 (10 mantissa bits, to nearest, ties away), as an f32
__device__ __forceinline__ float tf32_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// d = A B^T over D for operands that both lie K-major (rows x D, D / 64
// panels of `a_panel` and `b_panel` bytes): the scores' product, Q K^T or
// K Q^T. a and b are the shared addresses of the operands' first rows.
template <int D, int NJ>
__device__ __forceinline__ void wgmma_abt(float (&d)[NJ][4], uint32_t a, uint32_t a_panel,
                                          uint32_t b, uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss<0, 0>(d, wgmma_desc(a + (kk >> 2) * a_panel + off, 16, SWIZZLE_ATOM_BYTES),
                   wgmma_desc(b + (kk >> 2) * b_panel + off, 16, SWIZZLE_ATOM_BYTES), kk > 0);
  }
}

// d (64 x D) += P B for P in A fragments a[KT] (64 x 16 KT, bf16) and B a
// (16 KT rows x D) tile read MN-major (the contraction runs over its rows)
template <int KT, int NJ>
__device__ __forceinline__ void wgmma_pb(float (&d)[NJ][4], const uint32_t (&a)[KT][4],
                                         uint32_t b, uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    wgmma_rs<1>(d, a[kk], wgmma_desc(b + kk * 16 * PANEL_ROW_BYTES, b_panel, SWIZZLE_ATOM_BYTES),
                1);
}

// ------------------------------------------------------------ tensor maps

struct TensorView {  // a (B, T, H, D) bf16 view, innermost dimension first
  const void* ptr;
  long long dims[4];     // D, T, H, B
  long long strides[3];  // bytes between rows (T), heads (H) and batches (B)
};

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

// A tensor map over `view` whose box is 64 columns by `box_rows` rows of one
// head of one batch, written in the 128-byte swizzle; rows past T read as
// zeros. The encoder (cuTensorMapEncodeTiled) is looked up once per library. Encoding takes
// the host a few microseconds a map, on paths that are led by the host, and
// a map is a pure function of (pointer, shape, strides, box), which torch's
// caching allocator repeats from step to step: the last maps are kept in a
// small direct-mapped table.
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled encode = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);  // torch has loaded it
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return reinterpret_cast<TensorMapEncodeTiled>(
        lib == nullptr ? nullptr : dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return encode;
}

// The encoder needs a current CUDA context, which a thread that has not
// launched anything yet may lack (autograd's device threads run the
// backward so): cudaSetDevice makes the device's primary context current
// on this thread.
inline cudaError_t bind_current_device() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  return err;
}

inline cudaError_t make_tensor_map(CUtensorMap* map, const TensorView& view, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;

  struct Entry {
    TensorView view;
    int box_rows;  // 0: empty
    CUtensorMap map;
  };
  constexpr int SLOTS = 256;
  static Entry table[SLOTS] = {};
  static std::mutex guard;
  unsigned long long hash = reinterpret_cast<unsigned long long>(view.ptr) >> 4;
  for (int i = 0; i < 4; ++i)
    hash = hash * 1000003ull + static_cast<unsigned long long>(view.dims[i]);
  for (int i = 0; i < 3; ++i)
    hash = hash * 1000003ull + static_cast<unsigned long long>(view.strides[i]);
  Entry& entry = table[(hash * 1000003ull + box_rows) % SLOTS];
  std::lock_guard<std::mutex> lock(guard);
  bool hit = entry.box_rows == box_rows && entry.view.ptr == view.ptr;
  for (int i = 0; i < 4; ++i) hit = hit && entry.view.dims[i] == view.dims[i];
  for (int i = 0; i < 3; ++i) hit = hit && entry.view.strides[i] == view.strides[i];
  if (hit) {
    *map = entry.map;
    return cudaSuccess;
  }
  const cudaError_t err = bind_current_device();
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(view.dims[0]), static_cast<cuuint64_t>(view.dims[1]),
      static_cast<cuuint64_t>(view.dims[2]), static_cast<cuuint64_t>(view.dims[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(view.strides[0]),
                                 static_cast<cuuint64_t>(view.strides[1]),
                                 static_cast<cuuint64_t>(view.strides[2])};
  const cuuint32_t box[4] = {PANEL_COLS, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(view.ptr),
                             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return cudaErrorInvalidValue;
  entry.view = view;
  entry.box_rows = box_rows;
  entry.map = *map;
  return cudaSuccess;
}

// A tensor map over a (rows x cols) row-major matrix of `type` (elements of
// `elem_bytes`; rows `row_bytes` apart, a multiple of 16, and a 16-byte
// aligned base), whose box is `box_cols` x `box_rows` (box_cols *
// elem_bytes = 128) written in the 128-byte swizzle, or, with
// CU_TENSOR_MAP_SWIZZLE_NONE, box_cols * elem_bytes a multiple of 16 (at
// most 256 columns) laid out row after row; the box reads zeros past either
// edge. Not cached: its kernels run long against the few microseconds an
// encoding takes. The device context is bound only when an encoding fails
// without it, so that the call also runs inside a stream capture.
inline cudaError_t make_tensor_map_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                                      long long cols, long long rows, long long row_bytes,
                                      int box_cols, int box_rows,
                                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  auto encode_once = [&] {
    return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult rc = encode_once();
  if (rc != CUDA_SUCCESS) {  // a thread without a current context: bind one, once more
    const cudaError_t err = bind_current_device();
    if (err != cudaSuccess) return err;
    rc = encode_once();
  }
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Raises a kernel's dynamic shared-memory limit on the current device the
// first time it is asked for there. `ready` is the caller's table of 64
// flags, one table per kernel (a static of the function that launches it).
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, bool (&ready)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && ready[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < 64) ready[device] = true;
  return err;
}

// views[i] from seven values each: D, T, H, B, then the byte strides of T, H, B
inline TensorView tensor_view(const void* ptr, const long long* layout) {
  TensorView v;
  v.ptr = ptr;
  for (int i = 0; i < 4; ++i) v.dims[i] = layout[i];
  for (int i = 0; i < 3; ++i) v.strides[i] = layout[4 + i];
  return v;
}

}  // namespace heat
