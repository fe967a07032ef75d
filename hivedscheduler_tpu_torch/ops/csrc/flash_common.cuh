// Device helpers of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the TPU kernels' masking constants, bf16 packing, quad
// reductions and the shared-memory attribute. The Hopper building blocks
// all three kernels take their tiles and products from (TMA, mbarriers,
// wgmma) are in hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace hived {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels
constexpr float kClamp = -0.5e30f;  // the m_safe clamp of the TPU forward
constexpr float kLog2e = 1.4426950408889634f;

// Head dims: the kernels take any D that is a multiple of 8 up to 256 (the
// JAX package's rule, D % 8 == 0, within the three widths instantiated) and
// run it at the padded width Dp = 64, 128 or 256. TMA loads the columns of a
// box at or past D as zeros (the tensor map's innermost extent is D), so
// q k^T, do v^T and every delta are those of the real D; the epilogues store
// only columns < D. A multiple of 8 keeps each 16-byte row chunk whole and
// every global row 16-byte aligned, as a tensor map needs. At Dp = 256 one
// 64-row accumulator of the whole width is 128 f32 registers a thread, so
// each kernel has its own plan there (flash_fwd.cu, flash_bwd.cu).
inline bool head_dim_ok(int D) { return D >= 8 && D <= 256 && D % 8 == 0; }
inline int padded_head_dim(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Two adjacent f32 results of an accumulator row into an output: packed to
// bf16 (the model's outputs), or kept in f32 (the sequence-parallel ring's
// per-hop partials, which are merged across hops before any rounding). The
// address is 4-byte aligned for bf16 and 8-byte aligned for f32 (even
// columns, even row strides).
__device__ __forceinline__ void store_out2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store_out2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
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
