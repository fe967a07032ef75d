// Device helpers of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_fwd_wide.cu, flash_bwd_wide.cu, flash_generic.cu): the
// TPU kernels' masking constants, bf16 and fp16 packing, quad reductions,
// the fp16 ds scaling of the backward and the shared-memory attribute. The
// Hopper building blocks the wgmma kernels take their tiles and products
// from (TMA, mbarriers, wgmma) are in hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace hived {

using bf16 = __nv_bfloat16;
using f16 = __half;

// The 16-bit input types of the wgmma kernels: bf16, or fp16 (the same
// instruction shapes and swizzles; fp16 has three more mantissa bits and
// ends at 65504).
template <typename In>
constexpr bool kIsF16 = std::is_same<In, f16>::value;

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels
constexpr float kClamp = -0.5e30f;  // the m_safe clamp of the TPU forward
constexpr float kLog2e = 1.4426950408889634f;

// Head dims: the wgmma kernels take any D that is a multiple of 8 up to 256
// (the JAX package's rule, D % 8 == 0, within the three widths instantiated;
// flash_generic.cu takes every D % 8 == 0 past that) and
// run it at the padded width Dp = 64, 128 or 256. TMA loads the columns of a
// box at or past D as zeros (the tensor map's innermost extent is D), so
// q k^T, do v^T and every delta are those of the real D; the epilogues store
// only columns < D. A multiple of 8 keeps each 16-byte row chunk whole and
// every global row 16-byte aligned, as a tensor map needs. At Dp = 256 one
// 64-row accumulator of the whole width is 128 f32 registers a thread, so
// each kernel has its own plan there (flash_fwd.cu, flash_bwd.cu). K2 and
// K3 have a padded width of their own, 96, for 64 < D <= 96 (three 32-column
// panels, hopper.cuh), so that no product runs the 128 template's zero
// columns; K1 runs those D at 128.
inline bool head_dim_ok(int D) { return D >= 8 && D <= 256 && D % 8 == 0; }
inline int padded_head_dim(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }
inline int bwd_padded_head_dim(int D) {
  return D <= 64 ? 64 : D <= 96 ? 96 : D <= 128 ? 128 : 256;
}

// two f32 values rounded to a pair of the input type, as one 32-bit wgmma
// operand register
template <typename In>
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack_f32<bf16>(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <>
__device__ __forceinline__ uint32_t pack_f32<f16>(float lo, float hi) {
  __half2 p = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// a pair of the input type, widened to f32
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 x) { return __bfloat1622float2(x); }
__device__ __forceinline__ float2 to_float2(__half2 x) { return __half22float2(x); }

// Two adjacent f32 results of an accumulator row into an output: packed to
// bf16 or fp16 (the model's outputs), or kept in f32 (the sequence-parallel
// ring's per-hop partials, which are merged across hops before any
// rounding). The address is 4-byte aligned for 16-bit types and 8-byte
// aligned for f32 (even columns, even row strides).
__device__ __forceinline__ void store_out2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store_out2(f16* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
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

// The fp16 scaling of ds in K2 and K3 (flash_bwd.cu, flash_bwd_wide.cu): ds
// is packed scaled by 2^E a row (see flash_bwd.cu's note). Accumulator-layout
// arrays hold row a (e.g. row_a, key_a) at indices with bit 1 clear and row b
// at those with bit 1 set, in K2's s, dp and dq and in K3's dp^T and dk alike.
constexpr int kDsExpMax = 126;  // 2^E stays a normal f32, and so does 2^-E

// the E that puts m * 2^E in [2^14, 2^15) (2^15 leaves room under fp16's
// 65504 for the rounding); a zero or tiny m keeps the largest E
__device__ __forceinline__ int ds_exponent(float m) {
  return min(kDsExpMax, 141 - static_cast<int>((__float_as_uint(m) >> 23) & 0xffu));
}

// 2^e for e <= 127, built from its bits (0 below 2^-126)
__device__ __forceinline__ float pow2i(int e) {
  return e < -126 ? 0.f : __uint_as_float(static_cast<uint32_t>(127 + e) << 23);
}

// A tile's ds in f32 (accumulator layout) -> the two rows' new exponents
// (never above the old ones), the accumulator's rows moved to them, and the
// scales 2^E to pack this tile's ds with. The rows' values lie in one quad.
template <int N, int M>
__device__ __forceinline__ void ds_row_scales(const float (&ds)[N], float (&acc)[M], int& e_a,
                                              int& e_b, float& sc_a, float& sc_b) {
  float mx_a = 0.f, mx_b = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i & 2) {
      mx_b = fmaxf(mx_b, fabsf(ds[i]));
    } else {
      mx_a = fmaxf(mx_a, fabsf(ds[i]));
    }
  }
  const int na = min(e_a, ds_exponent(quad_max(mx_a)));
  const int nb = min(e_b, ds_exponent(quad_max(mx_b)));
  const float ra = pow2i(na - e_a);
  const float rb = pow2i(nb - e_b);
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] *= (i & 2) ? rb : ra;
  e_a = na;
  e_b = nb;
  sc_a = pow2i(na);
  sc_b = pow2i(nb);
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
