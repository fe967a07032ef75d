// How fast a thread-block cluster's blocks exchange data through distributed
// shared memory, the cost that sets the pace of the cluster K1, K2 and K3
// (csrc/flash_fwd_wide.cu, csrc/flash_bwd_wide.cu). A cluster of P blocks,
// each of two warpgroups of 128 threads; every round, each warpgroup sends
// `per` float4 a thread to the same warpgroup of each other block and waits
// until the others' have landed.
// Four ways, by `mode`:
//   0: st.async from registers, the bytes completing on the receiver's
//      mbarrier (the cluster kernels' way);
//   1: plain remote stores (st.shared::cluster), a cluster-scope fence a
//      thread, a named barrier, then one releasing arrive a receiver;
//   2: stores into the sender's own shared memory, then one bulk copy
//      (cp.async.bulk) a receiver, completing on its mbarrier;
//   3: stores into the sender's own shared memory, a releasing arrive a
//      receiver, remote loads (ld.shared::cluster) by the receivers, and a
//      second arrive when they are done (so the senders may overwrite).
// Rounds alternate between two barriers, so a block one round ahead never
// completes another's current phase.

#include "csrc/flash_common.cuh"
#include "csrc/hopper.cuh"

namespace {

using namespace hived;

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

constexpr int kMaxPer = 16;

// shared memory: receive [warpgroup][sender slot (P - 1)][per][128] and stage
// [warpgroup][receiver (P)][per][128] float4, then barriers [2 rounds][2
// warpgroups] and, for mode 3, the done barriers after them
__host__ __device__ inline int smem_bytes(int P, int per) {
  return (4 * P - 2) * per * 128 * 16 + 8 * 8 + 1024;
}

template <int kMode>
__global__ void __launch_bounds__(256, 1) exchange(int per, int rounds, long long* cycles,
                                                   float* sink) {
  extern __shared__ unsigned char raw[];
  unsigned char* smem = align_1024(raw);
  const int P = gridDim.x;
  const int rank = static_cast<int>(cluster_rank());
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int stride = per * 128;
  float4* recv = reinterpret_cast<float4*>(smem) + wg * (P - 1) * stride;
  float4* stage = reinterpret_cast<float4*>(smem) + (2 * (P - 1) + wg * P) * stride;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (4 * P - 2) * stride * 16);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 8; ++i) mbar_init(&bars[i], kMode == 0 || kMode == 2 ? 1 : P - 1);
    mbar_init_fence();
  }
  cluster_sync();
  float acc = 0.f;
  const long long t0 = clock64();
  for (int r = 0; r < rounds; ++r) {
    const float4 v = make_float4(r, t, wg, rank);
    uint64_t* full = bars + 2 * (r & 1) + wg;
    const uint32_t parity = (r >> 1) & 1;
    if (kMode == 0) {
      if (t == 0) mbar_expect_tx(full, (P - 1) * stride * 16);
      for (int o = 0; o < P; ++o) {
        if (o == rank) continue;
        const uint32_t a = smem_u32(recv + (rank < o ? rank : rank - 1) * stride + t);
        for (int i = 0; i < per; ++i) {
          st_async(map_rank(a + i * 128 * 16, o), v, map_rank(smem_u32(full), o));
        }
      }
      mbar_wait_cluster(full, parity);
    } else if (kMode == 1) {
      for (int o = 0; o < P; ++o) {
        if (o == rank) continue;
        const uint32_t a = smem_u32(recv + (rank < o ? rank : rank - 1) * stride + t);
        for (int i = 0; i < per; ++i) st_cluster(map_rank(a + i * 128 * 16, o), v);
      }
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      named_barrier(1 + wg, 128);
      if (t < P - 1) arrive_remote(map_rank(smem_u32(full), t < rank ? t : t + 1));
      mbar_wait_cluster(full, parity);
    } else if (kMode == 2) {
      if (t == 0) mbar_expect_tx(full, (P - 1) * stride * 16);
      for (int o = 0; o < P; ++o) {
        for (int i = 0; i < per; ++i) stage[(o * per + i) * 128 + t] = v;
      }
      fence_async_shared();
      named_barrier(1 + wg, 128);
      if (t < P - 1) {
        const int o = t < rank ? t : t + 1;
        bulk_copy(map_rank(smem_u32(recv + (rank < o ? rank : rank - 1) * stride), o),
                  stage + o * stride, stride * 16, map_rank(smem_u32(full), o));
      }
      mbar_wait_cluster(full, parity);
    } else {
      for (int o = 0; o < P; ++o) {
        for (int i = 0; i < per; ++i) stage[(o * per + i) * 128 + t] = v;
      }
      named_barrier(1 + wg, 128);
      if (t < P - 1) arrive_remote(map_rank(smem_u32(full), t < rank ? t : t + 1));
      mbar_wait_cluster(full, parity);
      for (int o = 0; o < P; ++o) {
        if (o == rank) continue;
        float4 x[kMaxPer];
#pragma unroll
        for (int i = 0; i < kMaxPer; ++i) {
          if (i < per) x[i] = ld_cluster(map_rank(smem_u32(stage + (rank * per + i) * 128 + t), o));
        }
#pragma unroll
        for (int i = 0; i < kMaxPer; ++i) {
          if (i < per) acc += x[i].x;
        }
      }
      named_barrier(1 + wg, 128);
      if (t < P - 1) arrive_remote(map_rank(smem_u32(full + 4), t < rank ? t : t + 1));
      mbar_wait_cluster(full + 4, parity);
    }
    if (kMode != 3) acc += recv[t].x;
  }
  const long long t1 = clock64();
  cluster_sync();
  if (t == 0) cycles[(blockIdx.y * P + rank) * 2 + wg] = t1 - t0;
  if (acc == 12345.f) sink[0] = acc;  // keeps the loads
}

}  // namespace

// `clusters` clusters of P blocks run `rounds` rounds of `mode`; cycles
// [clusters * P * 2] gets each warpgroup's clock64 cycles over the rounds.
// Returns 0 or the cudaError_t.
extern "C" int hived_dsmem_rate(int mode, int P, int clusters, int per, int rounds,
                                long long* cycles, float* sink) {
  if (mode < 0 || mode > 3 || P < 2 || P > 8 || per < 1 || per > kMaxPer ||
      smem_bytes(P, per) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = mode == 0 ? exchange<0> : mode == 1 ? exchange<1> : mode == 2 ? exchange<2>
                                                                              : exchange<3>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(P, per));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P, clusters, 1);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem_bytes(P, per);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = P;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, per, rounds, cycles, sink);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
