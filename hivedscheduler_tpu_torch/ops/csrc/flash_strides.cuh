// The [B, T, heads] element strides an input or output of the cluster
// kernels (flash_cluster.cuh) and the 3xTF32 kernels (flash_tf32.cuh) is
// addressed by, D contiguous: one definition, so that a source may include
// both headers (flash_bwd_tf32_wide.cu).

#pragma once

#include <stdint.h>

namespace hived {

struct Strides {
  int64_t b, t, h;
};

}  // namespace hived
