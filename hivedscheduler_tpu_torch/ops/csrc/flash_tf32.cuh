// The 3xTF32 building blocks of the f32-input wgmma kernels: K1
// (flash_fwd_tf32.cu), K2 and K3 (flash_bwd_tf32.cu), for D a multiple of 8
// up to 128 at the padded width Dp = 64 or 128, and K1 (flash_fwd_tf32_wide.cu)
// and K2 and K3 (flash_bwd_tf32_wide.cu) past D 128 on thread-block clusters
// of 128-column panels.
//
// 3xTF32. Every product a b is formed as big(a) big(b) + big(a) small(b) +
// small(a) big(b) on wgmma ...f32.tf32.tf32 (k-steps of 8), accumulated in
// f32, where big(x) = cvt.rna.tf32.f32(x) (rounded to nearest) and small(x)
// = cvt.rna.tf32.f32(x - big(x)): about 2^-22 of a product, where one TF32
// pass is about 2^-11.
//
// Shared tiles. Every f32 tile is Dp / 32 column blocks of [rows][32] f32,
// each row 128 bytes, 128-byte swizzled (the 16-byte chunk c of row r at
// chunk c ^ (r % 8)), as TMA writes it from a box of 32 f32 columns and
// wgmma reads it as a K-major operand: 8-row groups 1024 bytes apart, a
// k-step of 8 f32 +32 bytes along the row, +rows * 128 bytes to the next
// column block. wgmma takes tf32 operands from shared memory only K-major,
// so a B operand lies K-major in a big and a small plane (same layout, same
// offsets), and an operand that would be MN-major is made A instead: its
// fragments are read by ld.shared (frag_rows, frag_cols) and split in
// registers (split4).

#pragma once

#include "flash_common.cuh"
#include "flash_strides.cuh"
#include "hopper.cuh"

namespace hived {

// the generic family's type codes (flash_generic.cu): these kernels take f32
// inputs and store f32 only
constexpr int kF32Code = 2;

// warp specialisation: a producer warpgroup (warp 0: TMA, and K3's lse and
// delta; warps 1-3: the big/small split of streamed tiles) and two consumer
// warpgroups;
// 128 x 56 + 256 x 224 = 64512 of the SM's 65536 registers
constexpr int kProdRegs = 56;
constexpr int kConsRegs = 224;

// ------------------------------------------------------------ host side

// Tensor map of an f32 [B, T, heads, D] tensor with element strides (sb,
// st, sh): a box is 32 columns (128 bytes) of one head and `rows` rows of one
// batch, 128-byte swizzled; rows at or past T and columns at or past D read
// as zeros, and the box's full bytes complete on its barrier.
inline int make_f32_map(CUtensorMap* map, const void* base, int B, int T, int heads, int D,
                        int64_t sb, int64_t st, int64_t sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 4, static_cast<cuuint64_t>(st) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
                                 dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// ---------------------------------------------------------- device side

// rows [row0, row0 + kRows) of one head of an f32 map, columns [col0, col0 +
// Dp) (the cluster kernels' 128-column panel at col0), as the Dp / 32 column
// blocks of a tile; kRows * Dp * 4 bytes on `bar`
template <int Dp, int kRows>
__device__ __forceinline__ void tma_tile(float* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row0, int b, int col0 = 0) {
#pragma unroll
  for (int blk = 0; blk < Dp / 32; ++blk) {
    tma_load_4d(dst + blk * kRows * 32, map, bar, col0 + blk * 32, head, row0, b);
  }
}

// float offset of element (r, c) of a tile of kRows rows (the layout above)
template <int kRows>
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 5) * (kRows * 32) + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// x rounded to tf32 (to nearest, ties away from zero), as an f32 bit
// pattern whose low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small (to 2^-22 of x), each a tf32 bit pattern
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// The tf32 A fragment of wgmma m64nNk8 for thread t of the warpgroup (warp w
// = t / 32, g = lane / 4, t4 = lane % 4): a[0] = A[16w + g][t4], a[1] =
// A[16w + g + 8][t4], a[2] = A[16w + g][t4 + 4], a[3] = A[16w + g + 8][t4 + 4]
// of the 64 x 8 k-step (mma.sync m16n8k8's tf32 A layout, a warp's 16 rows).
// m = the thread's row 16w + g of the M block, k = 8 kk + t4 of k-step kk.
// From a tile whose rows are the product's M (A = the tile):
template <int kRows>
__device__ __forceinline__ void frag_rows(float (&x)[4], const float* p, int m, int k) {
  x[0] = p[sw<kRows>(m, k)];
  x[1] = p[sw<kRows>(m + 8, k)];
  x[2] = p[sw<kRows>(m, k + 4)];
  x[3] = p[sw<kRows>(m + 8, k + 4)];
}

// from a tile whose rows are the product's K (A = the tile transposed)
template <int kRows>
__device__ __forceinline__ void frag_cols(uint32_t (&x)[4], const float* p, int m, int k) {
  x[0] = __float_as_uint(p[sw<kRows>(k, m)]);
  x[1] = __float_as_uint(p[sw<kRows>(k, m + 8)]);
  x[2] = __float_as_uint(p[sw<kRows>(k + 4, m)]);
  x[3] = __float_as_uint(p[sw<kRows>(k + 4, m + 8)]);
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], big[i], small[i]);
}

#define TF32_D8(i)                                                                      \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 x 32, f32) += a b (or = a b with accumulate 0), one k-step of 8: a
// (64 x 8 tf32) in registers, b (8 x 32 tf32) K-major in shared memory
__device__ __forceinline__ void tf32_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : TF32_D8(0), TF32_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += a b, one k-step of 8, as tf32_rs32
__device__ __forceinline__ void tf32_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : TF32_D8(0), TF32_D8(8), TF32_D8(16), TF32_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef TF32_D8

// the three passes of one 3xTF32 k-step into d: small(a) big(b), big(a)
// small(b), big(a) big(b); b_big and b_small the descriptors of the planes
template <int N>
__device__ __forceinline__ void tf32x3(float (&d)[N / 2], const uint32_t (&a_big)[4],
                                       const uint32_t (&a_small)[4], uint64_t b_big,
                                       uint64_t b_small, int accumulate) {
  if constexpr (N == 32) {
    tf32_rs32(d, a_small, b_big, accumulate);
    tf32_rs32(d, a_big, b_small, 1);
    tf32_rs32(d, a_big, b_big, 1);
  } else {
    tf32_rs64(d, a_small, b_big, accumulate);
    tf32_rs64(d, a_big, b_small, 1);
    tf32_rs64(d, a_big, b_big, 1);
  }
}

// The producer's split warps (warps 1-3 of the producer warpgroup; warp 0
// issues the TMA loads): `n` f32 values at `big`, as TMA wrote them, into
// tf32 big values there and small ones at `small`, the same offsets (the
// swizzle moves whole 16-byte chunks, so float4 i of one plane pairs with
// float4 i of the other). `idx` is the thread's index among the 96.
constexpr int kSplitThreads = 96;

__device__ __forceinline__ void split_planes(float* big, float* small, int n, int idx) {
  float4* b4 = reinterpret_cast<float4*>(big);
  float4* s4 = reinterpret_cast<float4*>(small);
#pragma unroll 4
  for (int i = idx; i < n / 4; i += kSplitThreads) {
    const float4 x = b4[i];
    uint32_t hb[4], lb[4];
    split_tf32(x.x, hb[0], lb[0]);
    split_tf32(x.y, hb[1], lb[1]);
    split_tf32(x.z, hb[2], lb[2]);
    split_tf32(x.w, hb[3], lb[3]);
    b4[i] = make_float4(__uint_as_float(hb[0]), __uint_as_float(hb[1]), __uint_as_float(hb[2]),
                        __uint_as_float(hb[3]));
    s4[i] = make_float4(__uint_as_float(lb[0]), __uint_as_float(lb[1]), __uint_as_float(lb[2]),
                        __uint_as_float(lb[3]));
  }
}

// A pair of adjacent values (col, col + 1; col even) of a 32-column f32 B
// tile of kRows rows, as big and small planes
template <int kRows>
__device__ __forceinline__ void store_split2(float* big, float* small, int r, int c, float x,
                                             float y) {
  uint32_t bx, sx, by, sy;
  split_tf32(x, bx, sx);
  split_tf32(y, by, sy);
  const int off = sw<kRows>(r, c);
  *reinterpret_cast<float2*>(big + off) = make_float2(__uint_as_float(bx), __uint_as_float(by));
  *reinterpret_cast<float2*>(small + off) = make_float2(__uint_as_float(sx), __uint_as_float(sy));
}

// The long sums (o and dq over every key, dk and dv over every q row of the
// group) are not left in a wgmma accumulator: the tensor cores' f32
// accumulation drops bits toward zero at each instruction, which over
// thousands of k-steps biases the sum (on an H100 it put dk and dv past the
// 2e-5 limit at the flagship shape, more the more rows it summed). Each
// tile's products go to a fresh accumulator, which is added to the f32 sum
// by plain (round-to-nearest) adds once its wgmmas are done (K1 rescales
// the sum first: flash_fwd_tf32.cu).
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N], float (&part)[N]) {
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

// the shapes and types the 3xTF32 entry points at D <= 128 take: f32 in and
// out, D a multiple of 8 up to 128
inline bool bad_tf32_args(int B, int T, int H, int H_kv, int D, int in_type, int out_type) {
  return B <= 0 || T <= 0 || H_kv <= 0 || H % H_kv != 0 || D < 8 || D > 128 || D % 8 != 0 ||
         in_type != kF32Code || out_type != kF32Code;
}

}  // namespace hived
