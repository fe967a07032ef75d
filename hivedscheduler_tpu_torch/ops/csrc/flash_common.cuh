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

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
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
