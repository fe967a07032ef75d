// What the cluster kernels share: K1 (flash_fwd_wide.cu) and K2 and K3
// (flash_bwd_wide.cu) past D 256 at 16-bit inputs, and K1
// (flash_fwd_tf32_wide.cu) and K2 and K3 (flash_bwd_tf32_wide.cu) past D 128
// at f32 inputs. Each splits its outputs into 128-column panels, one block a
// panel, and runs a thread-block cluster of P = ceil(D / 128) of them on one
// tile of work, so that the scores are formed once: each block's partial
// scores over its panel go, through distributed shared memory, to the block
// that owns them, which adds the P partials in rank order. This header has
// the panel and group arithmetic, the TMA load of a 16-bit panel, the sends
// (st.async, whose bytes complete on the receiver's mbarrier), the argument
// rules the 16-bit and the f32 entry points share and the cluster launch.

#pragma once

#include "flash_common.cuh"
#include "flash_strides.cuh"
#include "hopper.cuh"

namespace hived {

template <typename T>
__device__ __forceinline__ T* at(T* base, const Strides& s, int b, int h) {
  return base + b * s.b + h * s.h;
}

enum TypeCode { kBf16 = 0, kF16 = 1, kF32 = 2 };

constexpr int kPanel = 128;                 // output columns a block owns
constexpr int kKeys = 64;                   // keys a K/V tile (K1, K2) or a block (K3) holds
constexpr int kRowsQ = 128;                 // q rows a K1 or K2 block holds
constexpr int kGroups = 8;                  // groups of a 64 x 64 score tile dealt to owners
constexpr int kMaxPanels = 8;               // the portable cluster size
constexpr int kMaxD = kPanel * kMaxPanels;  // 1024
constexpr int kSmemMax = 232448;            // dynamic shared memory a block may have
constexpr int kGroupBytes = 128 * 16;       // one group of a consumer's f32 values

// blocks a cluster for head dim D: ceil(D / 128); 7 run as 8, whose eighth
// panel is all zero columns (8 groups over 7 blocks: one block owns two, and
// in fp16 K2's receive buffers for two groups of 7 blocks' partials would
// not fit beside its tiles)
__host__ __device__ inline int wide_panels(int D) {
  const int p = (D + kPanel - 1) / kPanel;
  return p == 7 ? 8 : p;
}

// the most groups one block owns
__host__ __device__ inline int max_owned(int P) { return (kGroups + P - 1) / P; }

// the block that owns group n: block o owns groups [first_group(o), first_group(o + 1))
__device__ __forceinline__ int owner_of(int n, int P) { return n * P / kGroups; }

__device__ __forceinline__ int first_group(int o, int P) { return (o * kGroups + P - 1) / P; }

// a [kRows][128] panel from column col0 as two [kRows][64] column blocks
template <int kRows, typename In>
__device__ __forceinline__ void tma_load_panel(In* dst, const CUtensorMap* map, uint64_t* bar,
                                               int col0, int head, int row0, int b) {
  tma_load_4d(dst, map, bar, col0, head, row0, b);
  tma_load_4d(dst + kRows * 64, map, bar, col0 + 64, head, row0, b);
}

// thread t's values of one group from the P blocks, in rank order
// (`recv` at block 0's, the blocks `stride` float4 apart), added
__device__ __forceinline__ float4 sum_partials(const float4* recv, int stride, int P) {
  float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int src = 0; src < P; ++src) {
    const float4 v = recv[src * stride];
    tot.x += v.x;
    tot.y += v.y;
    tot.z += v.z;
    tot.w += v.w;
  }
  return tot;
}

// a group's value to its owner `o`'s receive buffer, at the offset of
// `local`: by a plain store if this block owns it, else completing on the
// owner's barrier at `bar`'s offset
__device__ __forceinline__ void send(float4* local, const uint64_t* bar, float4 v, int o,
                                     int rank) {
  if (o == rank) {
    *local = v;
  } else {
    st_async(map_rank(smem_u32(local), o), v, map_rank(smem_u32(bar), o));
  }
}

// v to the offset of `local` in every other block of the cluster, completing
// on their barrier at `bar`'s offset
template <typename V>
__device__ __forceinline__ void send_others(const V* local, const uint64_t* bar, V v, int P,
                                            int rank) {
  const uint32_t addr = smem_u32(local);
  const uint32_t b = smem_u32(bar);
  for (int dst = 0; dst < P; ++dst) {
    if (dst != rank) st_async(map_rank(addr, dst), v, map_rank(b, dst));
  }
}

// one value to the same offset in every block of the cluster: this block's
// by a plain store, the others' completing on their barrier at `bar`'s offset
template <typename V>
__device__ __forceinline__ void broadcast(unsigned char* local, const uint64_t* bar, V v, int P,
                                          int rank) {
  *reinterpret_cast<V*>(local) = v;
  send_others(reinterpret_cast<const V*>(local), bar, v, P, rank);
}

// the shapes and types the 16-bit entry points take: 256 < D <= 1024, D % 8
// == 0, bf16 or fp16 inputs, the output in the input type or f32
inline bool bad_args(int B, int T, int H, int H_kv, int D, int in_type, int out_type) {
  return B <= 0 || T <= 0 || H_kv <= 0 || H % H_kv != 0 || D <= 256 || D > kMaxD ||
         D % 8 != 0 || (in_type != kBf16 && in_type != kF16) ||
         (out_type != in_type && out_type != kF32);
}

// the shapes and types the 3xTF32 entry points past D 128 take: f32 in and
// out, 128 < D <= 1024, D % 8 == 0
inline bool bad_f32_args(int B, int T, int H, int H_kv, int D, int in_type, int out_type) {
  return B <= 0 || T <= 0 || H_kv <= 0 || H % H_kv != 0 || D <= 128 || D > kMaxD ||
         D % 8 != 0 || in_type != kF32 || out_type != kF32;
}

// the launch configuration of clusters of P blocks along x, with `smem` bytes
// of dynamic shared memory; `cluster` holds the attribute it points to
inline cudaLaunchConfig_t cluster_config(dim3 grid, int P, int smem, cudaStream_t stream,
                                         cudaLaunchAttribute& cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWsThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = P;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// `kernel` on `grid` in clusters of P blocks; its shared-memory ceiling is
// set once (`attr_set`). Returns the cudaError_t of the launch.
template <typename Args>
cudaError_t launch_clusters(void (*kernel)(Args), const Args& a, dim3 grid, int P, int smem,
                            cudaStream_t stream, bool& attr_set) {
  cudaError_t err = allow_smem(kernel, kSmemMax, attr_set);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(grid, P, smem, stream, cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the clusters of P blocks of `kernel` at `smem` bytes each that the card
// holds at once, or -1 - the cudaError_t of the query
template <typename Args>
int max_clusters(void (*kernel)(Args), int P, int smem, bool& attr_set) {
  cudaError_t err = allow_smem(kernel, kSmemMax, attr_set);
  int n = 0;
  if (err == cudaSuccess) {
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg = cluster_config(dim3(P, 1, 1), P, smem, nullptr, cluster);
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  return err == cudaSuccess ? n : -1 - static_cast<int>(err);
}

}  // namespace hived
