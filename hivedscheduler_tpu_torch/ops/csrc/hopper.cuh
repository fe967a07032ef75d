// Hopper (sm_90a) building blocks of the flash-attention kernels K1
// (flash_fwd.cu), K2 and K3 (flash_bwd.cu), as raw PTX:
// TMA tensor maps and bulk tensor loads that complete on mbarriers, wgmma
// shared-memory descriptors for the 128- and 64-byte swizzled layouts, and
// wgmma.mma_async (bf16 or fp16 in, f32 accumulate) with its fences. The
// element type In (bf16 or fp16) is a template parameter throughout: both
// take the same instruction shapes, k-steps of 16 and swizzles, and differ
// only in the tensor map's data type and the wgmma type suffix.
//
// Shared tiles. A tile of R rows by D 16-bit columns (D a multiple of 64) is
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
// At the padded width 96 (K2 and K3 at 64 < D <= 96, flash_bwd.cu) a tile is
// three 32-column panels of [R][32], rows 64 bytes, each panel 512-byte
// aligned, which TMA writes with the 64-byte swizzle: chunk c (of 4) of row r
// lands at chunk c ^ ((r / 2) % 4), and the pattern repeats every 8 rows (512
// bytes). wgmma reads it through a SWIZZLE_64B descriptor: K-major with 8-row
// groups 512 bytes apart (SBO), a k-step +32 bytes inside the row and +R * 64
// bytes to the next panel; MN-major with SBO 512, the panels R * 64 bytes
// apart (LBO) and a 16-row k-step +1024 bytes. So no product reads a column
// past 96: the 128-byte layout would take 128 (the PTX ISA's canonical
// layouts of wgmma; CUTLASS picks the same swizzle for a 96-wide tile).
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
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Tensor map of a bf16 or fp16 (In) [B, T, heads, D] tensor with element
// strides (sb, st, sh) and D contiguous, over the 4-D box space (D, heads,
// T, B): a box is `cols` columns of one head and `rows` rows of one batch,
// 64 columns 128-byte swizzled or 32 columns 64-byte swizzled (the panels of
// the padded width 96), so rows at or past T read as zeros and never come from
// the next batch, and columns at or past D (the padding of a kernel run at a
// wider template) read as zeros and never come from the next head. Either
// way the box's full bytes complete on its barrier.
// Returns 0 or the CUresult of the encoder.
template <typename In>
inline int make_tile_map(CUtensorMap* map, const void* base, int B, int T, int heads, int D,
                         int64_t sb, int64_t st, int64_t sh, int rows, int cols = 64) {
  constexpr CUtensorMapDataType kType = std::is_same<In, __half>::value
                                            ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(map, kType, 4, const_cast<void*>(base),
                                 dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// -------------------------------------------------------------- device side

// Warp specialisation of K1, K2 and K3: a block of three warpgroups, warpgroup
// 0 the producer (TMA), 1 and 2 the consumers (wgmma). setmaxnreg moves
// registers from the one to the others within the SM's 65536 at run time
// (128 x 24 + 256 x 240 = 64512). ptxas reports the block's launch count,
// 168 for 384 threads. It did not let a consumer of K1 at Dp = 256 hold more
// at setmaxnreg 240 (nvcc 12.9, each placement tried, ops/regs_probe.py),
// so that kernel, and K2 and K3 at Dp = 256, run the two consumer warpgroups
// alone (flash_fwd.cu, flash_bwd.cu).
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

// the columns of a panel of a shared tile of padded width D: 64 (128-byte
// swizzle), or 32 at D = 96 (64-byte swizzle)
__host__ __device__ constexpr int panel_cols(int D) { return D == 96 ? 32 : 64; }

// rows [row0, row0 + kRows) of one head of a [B, T, heads, D] map, as the
// D / panel_cols(D) panels of a shared tile; kRows * D * 2 bytes on `bar`
template <int D, int kRows, typename In>
__device__ __forceinline__ void tma_load_tile(In* dst, const CUtensorMap* map,
                                              uint64_t* bar, int head, int row0, int b) {
  constexpr int kCols = panel_cols(D);
#pragma unroll
  for (int blk = 0; blk < D / kCols; ++blk) {
    tma_load_4d(dst + blk * kRows * kCols, map, bar, blk * kCols, head, row0, b);
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

// wgmma descriptor of a 64-byte swizzled shared operand (layout type 2)
// starting at p: SBO 512 bytes between 8-row groups, `lbo` bytes between the
// 32-column panels of an MN-major operand (a K-major one ignores it: pass 16)
__device__ __forceinline__ uint64_t desc_sw64(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// the descriptor of a tile of padded width D (its panels' swizzle)
template <int D>
__device__ __forceinline__ uint64_t desc_tile(const void* p, uint32_t lbo) {
  if constexpr (panel_cols(D) == 32) {
    return desc_sw64(p, lbo);
  } else {
    return desc_sw128(p, lbo);
  }
}

// bytes from a tile of `rows` rows at padded width D to K-major k-step kk
// (columns [16kk, 16kk + 16)): its panel, then +32 bytes a k-step inside
// the row
template <int D>
__device__ __forceinline__ uint32_t kstep_off(int kk, int rows) {
  constexpr int kRowBytes = panel_cols(D) * 2;
  constexpr int kSteps = kRowBytes / 32;  // k-steps a panel
  return (kk / kSteps) * rows * kRowBytes + (kk % kSteps) * 32;
}

// element offset of the 8-column chunk that holds (row r, column col) in a
// tile of kRows rows at padded width D, with its panel's swizzle
template <int D, int kRows>
__device__ __forceinline__ int tile_chunk(int r, int col) {
  constexpr int P = panel_cols(D);
  const int swz = P == 64 ? (r & 7) : ((r >> 1) & 3);
  return (col / P) * kRows * P + r * P + ((((col % P) / 8) ^ swz) * 8);
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

// arrive on barrier `id` without waiting (the others of its `threads` wait
// in named_barrier)
__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
#define HIVED_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HIVED_R32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HIVED_R48                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
#define HIVED_R64                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// The wgmma instructions, one per (N, operand form, type): TY is the
// operand type's PTX name (bf16 or f16), MN 1 for an MN-major b.
#define HIVED_SS32(TY, MN)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." #TY "." #TY " " HIVED_R16 \
               ", %16, %17, p, 1, 1, 0, " #MN ";\n}\n"                               \
               : HIVED_D8(0), HIVED_D8(8)                                         \
               : "l"(a), "l"(b), "r"(accumulate))
#define HIVED_SS64(TY, MN)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " " HIVED_R32 \
               ", %32, %33, p, 1, 1, 0, " #MN ";\n}\n"                               \
               : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24)             \
               : "l"(a), "l"(b), "r"(accumulate))
#define HIVED_SS96(TY, MN)                                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n96k16.f32." #TY "." #TY " " HIVED_R48 \
               ", %48, %49, p, 1, 1, 0, " #MN ";\n}\n"                                \
               : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24), HIVED_D8(32), \
                 HIVED_D8(40)                                                      \
               : "l"(a), "l"(b), "r"(accumulate))
#define HIVED_SS128(TY, MN)                                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " " HIVED_R64 \
               ", %64, %65, p, 1, 1, 0, " #MN ";\n}\n"                                 \
               : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24), HIVED_D8(32), \
                 HIVED_D8(40), HIVED_D8(48), HIVED_D8(56)                           \
               : "l"(a), "l"(b), "r"(accumulate))
#define HIVED_RS64(TY)                                                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " " HIVED_R32 \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
               : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24)             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
#define HIVED_RS96(TY)                                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n96k16.f32." #TY "." #TY " " HIVED_R48 \
               ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"                       \
               : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24), HIVED_D8(32), \
                 HIVED_D8(40)                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
#define HIVED_RS128(TY)                                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                         \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " " HIVED_R64 \
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
               : HIVED_D8(0), HIVED_D8(8), HIVED_D8(16), HIVED_D8(24), HIVED_D8(32), \
                 HIVED_D8(40), HIVED_D8(48), HIVED_D8(56)                           \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))

// d (64 x N, f32) = a b + (accumulate ? d : 0), one k-step of 16: a (64 x 16)
// and b (16 x N) K-major in shared memory, through their descriptors; a and
// b of type In (bf16 or fp16)
template <int N, typename In>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N is 32, 64 or 128");
  if constexpr (N == 32 && std::is_same<In, __half>::value) {
    HIVED_SS32(f16, 0);
  } else if constexpr (N == 32) {
    HIVED_SS32(bf16, 0);
  } else if constexpr (N == 64 && std::is_same<In, __half>::value) {
    HIVED_SS64(f16, 0);
  } else if constexpr (N == 64) {
    HIVED_SS64(bf16, 0);
  } else if constexpr (std::is_same<In, __half>::value) {
    HIVED_SS128(f16, 0);
  } else {
    HIVED_SS128(bf16, 0);
  }
}

// d (64 x N, f32) = a b + (accumulate ? d : 0), one k-step of 16: a (64 x 16)
// K-major and b (16 x N) MN-major, both in shared memory through their
// descriptors
template <int N, typename In>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t a, uint64_t b,
                                            int accumulate) {
  static_assert(N == 64 || N == 96 || N == 128, "wgmma_ss_mn: N is 64, 96 or 128");
  if constexpr (N == 64 && std::is_same<In, __half>::value) {
    HIVED_SS64(f16, 1);
  } else if constexpr (N == 64) {
    HIVED_SS64(bf16, 1);
  } else if constexpr (N == 96 && std::is_same<In, __half>::value) {
    HIVED_SS96(f16, 1);
  } else if constexpr (N == 96) {
    HIVED_SS96(bf16, 1);
  } else if constexpr (std::is_same<In, __half>::value) {
    HIVED_SS128(f16, 1);
  } else {
    HIVED_SS128(bf16, 1);
  }
}

// d (64 x N, f32) = a b + (accumulate ? d : 0), one k-step of 16: a (64 x 16)
// in registers (four pairs of In, the layout above), b (16 x N) MN-major in
// shared memory through its descriptor
template <int N, typename In>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  static_assert(N == 64 || N == 96 || N == 128, "wgmma_rs: N is 64, 96 or 128");
  if constexpr (N == 64 && std::is_same<In, __half>::value) {
    HIVED_RS64(f16);
  } else if constexpr (N == 64) {
    HIVED_RS64(bf16);
  } else if constexpr (N == 96 && std::is_same<In, __half>::value) {
    HIVED_RS96(f16);
  } else if constexpr (N == 96) {
    HIVED_RS96(bf16);
  } else if constexpr (std::is_same<In, __half>::value) {
    HIVED_RS128(f16);
  } else {
    HIVED_RS128(bf16);
  }
}

#undef HIVED_SS32
#undef HIVED_SS64
#undef HIVED_SS96
#undef HIVED_SS128
#undef HIVED_RS64
#undef HIVED_RS96
#undef HIVED_RS128
#undef HIVED_D8
#undef HIVED_R16
#undef HIVED_R32
#undef HIVED_R48
#undef HIVED_R64

// ------------------------------------------------------ thread-block clusters
// The wide kernels (flash_fwd_wide.cu, flash_bwd_wide.cu) run a cluster of
// blocks that store into each other's shared memory (distributed shared memory): st_async
// writes at another block's shared::cluster address (map_rank) and completes
// its bytes as transactions on that block's mbarrier, which the receiver
// arms with mbar_expect_tx and waits on with cluster-scope acquire.

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives, then waits for the
// others: what each did before is visible to all after
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the shared::cluster address, in block `rank`, of this block's shared::cta
// address `addr`: the same offset in that block
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// asynchronous stores into another block's shared memory at `addr`, each
// completing its bytes on that block's mbarrier `bar` (both from map_rank)
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, uint2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "r"(v.x), "r"(v.y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// mbar_wait that also acquires what other blocks stored with st_async
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait_cluster(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait_cluster(addr, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

}  // namespace hived
