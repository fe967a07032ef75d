// K1's fp16 entry points (hived_flash_fwd_f16, hived_flash_fwd_f16_f32): the
// kernel of flash_fwd.cu instantiated for fp16 inputs, built as a library of
// its own so that nvcc compiles it beside the bf16 one.

#define HIVED_FLASH_F16
#include "flash_fwd.cu"
