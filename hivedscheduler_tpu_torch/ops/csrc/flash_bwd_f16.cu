// K2's and K3's fp16 entry points (hived_flash_bwd_dq_f16, _dq_f16_f32,
// _dkv_f16, _dkv_f16_f32): the kernels of flash_bwd.cu instantiated for fp16
// inputs, built as a library of their own so that nvcc compiles it beside the
// bf16 one.

#define HIVED_FLASH_F16
#include "flash_bwd.cu"
