// Device helpers of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the TPU kernels' masking constants, bf16 packing, quad
// reductions and the shared-memory attribute, which all three kernels use;
// and, for K3 (flash_bwd_dkv_kernel) alone, 64-row tiles streamed into
// padded shared memory with cp.async and mma.sync m16n8k16 (bf16 in, f32
// accumulate) with its fragment loads. K1 and K2 take their tiles and
// products from hopper.cuh instead (TMA and wgmma).
//
// Fragment layout of mma.sync m16n8k16 for lane l, g = l / 4, t = l % 4:
// - A (16x16, row major), four registers of two bf16: (row g, cols 2t, 2t+1),
//   (row g+8, cols 2t, 2t+1), (row g, cols 2t+8, 2t+9), (row g+8, cols 2t+8, 2t+9);
// - B (16x8), two registers: (rows 2t, 2t+1; col g), (rows 2t+8, 2t+9; col g);
// - C (16x8, f32), four values: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).
// The C values of two neighbouring n-tiles are exactly an A fragment, which
// is how a score tile becomes the A operand of the next product in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace hived {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // K3: rows of every tile, keys and q rows
constexpr int kWarps = 4;  // K3: each warp owns 16 rows of a block's tile
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row
constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels
constexpr float kClamp = -0.5e30f;  // the m_safe clamp of the TPU forward
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + 64) of a [T, D] slice with row stride `stride`
// elements into a padded shared tile; rows at or past T are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t stride,
                                          int row0, int T) {
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  constexpr int kChunks = kTile * kChunksPerRow;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const int gr = row0 + r;
    const bool valid = gr < T;
    const bf16* g = src + static_cast<int64_t>(valid ? gr : 0) * stride + col;
    cp_async16(dst + r * (D + kPad) + col, g, valid);
  }
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c[4] += a[4] (16x16, row major) * (b0, b1) (16x8, column major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16x16 block at (row0, col0) of a row-major shared tile
// with row stride `s` elements
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int s, int row0, int col0) {
  const int lane = threadIdx.x % 32;
  const bf16* p = tile + (row0 + (lane >> 2)) * s + col0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * s);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * s + 8);
}

// B fragment with B[k][n] = tile[n0 + n][k0 + k]: the 16x8 block of tile^T,
// as K is in q k^T (the pairs along k are adjacent in memory)
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1, const bf16* tile, int s,
                                            int k0, int n0) {
  const int lane = threadIdx.x % 32;
  const bf16* p = tile + (n0 + (lane >> 2)) * s + k0 + 2 * (lane & 3);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment with B[k][n] = tile[k0 + k][n0 + n]: the 16x8 block of tile
// itself, as V is in p v (the pairs along k are a row apart: scalar loads)
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1, const bf16* tile, int s,
                                            int k0, int n0) {
  const int lane = threadIdx.x % 32;
  const bf16* p = tile + (k0 + 2 * (lane & 3)) * s + n0 + (lane >> 2);
  b0 = pack_bf16(p[0], p[s]);
  b1 = pack_bf16(p[8 * s], p[9 * s]);
}

// max and sum over the 4 lanes of a quad (the lanes that share a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Set the dynamic shared memory a kernel needs above the 48 KB default, once
// per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace hived
