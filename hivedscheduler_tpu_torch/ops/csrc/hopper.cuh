// Hopper (sm_90a) building blocks of the flash-attention kernels K1
// (flash_fwd.cu), K2 and K3 (flash_bwd.cu), as raw PTX:
// TMA tensor maps and bulk tensor loads that complete on mbarriers, wgmma
// shared-memory descriptors for the 128-byte swizzled layout, and
// wgmma.mma_async (bf16 in, f32 accumulate) with its fences.
//
// Shared tiles. A tile of R rows by D bf16 columns (D a multiple of 64) is
// kept as D / 64 column blocks of [R][64], one after the other, each row 128
// bytes and each block 1024-byte aligned. TMA writes it with the 128-byte
// swizzle: the 16-byte chunk c of row r lands at chunk c ^ (r % 8) of that
// row. wgmma reads the same layout through a descriptor (layout type
// SWIZZLE_128B), as either operand form:
// - K-major (the contraction runs along a row: Q, K in q k^T and k q^T,
//   dO, V in do v^T and v do^T): 8-row groups 1024 bytes apart (SBO); a
//   16-column k-step is +32 bytes inside the row, and +R * 128 bytes moves
//   to the next column block;
// - MN-major (the contraction runs down the rows: V in p v, K in ds k, dO
//   in p^T do, Q in ds^T q): 8-row groups 1024 bytes apart (SBO), column
//   blocks R * 128 bytes apart (LBO); a 16-row k-step is +2048 bytes, two
//   whole swizzle atoms.
//
// Accumulator layout of wgmma m64nNk16 for thread t of the warpgroup, warp
// w = t / 32, lane l, g = l / 4, t4 = l % 4: d[4j + e] holds row 16w + g
// (e = 0, 1) or 16w + g + 8 (e = 2, 3), column 8j + 2 t4 + (e & 1): per
// 8 columns, the C layout of mma.sync m16n8k16. A row's values live in one
// quad of lanes, and the accumulators of columns [16k, 16k + 16) are the A
// registers of k-step k of an RS product (A from registers).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hived {

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; null if the driver has none
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a bf16 [B, T, heads, D] tensor with element strides (sb, st,
// sh) and D contiguous, over the 4-D box space (D, heads, T, B): a box is 64
// columns of one head and `rows` rows of one batch, 128-byte swizzled, so
// rows at or past T read as zeros and never come from the next batch, and
// columns at or past D (the padding of a kernel run at a wider template)
// read as zeros and never come from the next head. Either way the box's
// full bytes complete on its barrier.
// Returns 0 or the CUresult of the encoder.
inline int make_tile_map(CUtensorMap* map, const void* base, int B, int T, int heads, int D,
                         int64_t sb, int64_t st, int64_t sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                                 dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// -------------------------------------------------------------- device side

// Warp specialisation of K1, K2 and K3: a block of three warpgroups, warpgroup
// 0 the producer (TMA), 1 and 2 the consumers (wgmma). setmaxnreg moves
// registers from the one to the others within the SM's 65536:
// 128 x 24 + 256 x 240 = 64512.
constexpr int kWsThreads = 384;
constexpr int kWsConsumerThreads = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// a barrier wait longer than this traps (a launch error) instead of hanging
constexpr uint64_t kWaitLimitNs = 4000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// first 1024-byte boundary at or after p (the 128-byte swizzle repeats every
// 1024 bytes; descriptors assume atoms start there)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and add `bytes` to the transactions the current phase awaits
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// TMA: the box at (c0, c1, c2, c3) of `map` into shared memory at dst,
// completing as transactions on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// rows [row0, row0 + kRows) of one head of a [B, T, heads, D] map, as the
// D / 64 column blocks of a shared tile; kRows * D * 2 bytes on `bar`
template <int D, int kRows>
__device__ __forceinline__ void tma_load_tile(__nv_bfloat16* dst, const CUtensorMap* map,
                                              uint64_t* bar, int head, int row0, int b) {
#pragma unroll
  for (int blk = 0; blk < D / 64; ++blk) {
    tma_load_4d(dst + blk * kRows * 64, map, bar, blk * 64, head, row0, b);
  }
}

// wgmma descriptor of a 128-byte swizzled shared operand starting at p:
// SBO 1024 bytes between 8-row groups, `lbo` bytes between the 64-column
// blocks of an MN-major operand (a K-major one ignores it: pass 16)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// the descriptor moved `bytes` on (bytes a multiple of 16)
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of r across this point
// (after wgmma_wait: the accumulators are only final there)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// makes this thread's plain shared-memory stores visible to wgmma (the async
// proxy); a barrier over the threads that stored must follow
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

#define HIVED_D8(i)                                                                     \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define HIVED_R32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HIVED_R64                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N, f32) = a b + (accumulate ? d : 0), one k-step of 16: a (64 x 16)
// and b (16 x N) K-major in shared memory, through their descriptors
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HIVED_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HIVED_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24), HIVED_D8(32), HIVED_D8(40),
        HIVED_D8(48), HIVED_D8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) = a b + (accumulate ? d : 0), one k-step of 16: a (64 x 16)
// K-major and b (16 x N) MN-major, both in shared memory through their
// descriptors
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t a, uint64_t b,
                                            int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss_mn<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HIVED_R32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss_mn<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HIVED_R64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24), HIVED_D8(32), HIVED_D8(40),
        HIVED_D8(48), HIVED_D8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) = a b + (accumulate ? d : 0), one k-step of 16: a (64 x 16)
// in registers (four bf16 pairs, the layout above), b (16 x N) MN-major in
// shared memory through its descriptor
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HIVED_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HIVED_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24), HIVED_D8(32), HIVED_D8(40),
        HIVED_D8(48), HIVED_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef HIVED_D8
#undef HIVED_R32
#undef HIVED_R64

}  // namespace hived
