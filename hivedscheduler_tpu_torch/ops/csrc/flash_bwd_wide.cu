// Flash-attention backward for Hopper (sm_90a) past D 256: dq (K2) and dk/dv
// (K3) for bf16 and fp16 inputs at 256 < D <= 1024, on wgmma, each tile's
// scores formed once by a thread-block cluster.
//
// Replaces hivedscheduler_tpu/ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_backward) at those inputs. The
// functions are flash_bwd.cu's: with scale = 1/sqrt(D),
//   s = scale * q k^T under the causal mask (NEG_INF = -1e30),
//   p = exp(s - lse),  dp = do v^T,  delta = rowsum(do * o),
//   ds = p * (dp - delta),
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T do,
// GQA read in place and K3 summing a kv head's q-head group in its own loop.
// f32 inputs, and 16-bit inputs past D 1024, stay on the CUDA-core family
// (flash_generic.cu).
//
// Bound on an H100: the same products as flash_bwd.cu's (K2 three, K3 four
// of 2*D flops per (row, key) pair the mask leaves); at the D 512 CLI shape
// (q [8,2048,4,512], k/v [8,2048,2,512], causal) 206.3 and 275.0 GFLOP,
// 0.209 and 0.278 ms at 989 TFLOP/s: the tensor cores bound both.
//
// Why one block cannot hold a tile. At D 512 one 64-key tile's dk and dv
// accumulators are 2 x 64 x 512 f32 = 256 KB, the whole register file of an
// SM, and K2's dq for 64 rows 128 KB; q, do and one K/V stage at 64 x 512
// 16-bit are 4 x 64 KB of shared memory, past the 227 KB a block may have.
// So the outputs are split by 128-column panel across blocks, P = ceil(D /
// 128) of them, as the CUDA-core family splits them; what changes is that
// the panels stop forming the scores again (there 3x the real work for K2,
// 2.5x for K3 at D 512).
//
// Plan: one cluster of P blocks per tile, block `rank` owning output columns
// [128 rank, 128 rank + 128). Each block is, in structure, flash_bwd.cu's
// D 128 kernel on its own panel: a producer warpgroup feeding TMA rings and
// two consumer warpgroups under setmaxnreg. TMA zero-fills a panel's columns
// at or past D (D 264's third panel holds 8 live columns).
// - K2: one cluster per (b*h, 128-row q tile), heaviest causal tiles first.
//   A block's q and do panels are stationary; it streams the K and V panels
//   of 64-key tiles through a two-stage ring; consumer c owns q rows [64c,
//   64c + 64).
// - K3: one cluster per (b*h_kv, 64-key tile), key tile 0 first. A block's K
//   and V panels are stationary; it streams the q and do panels of every q
//   head of the GQA group through a three-stage ring. Consumer A forms s^T
//   and p^T and accumulates dv; B forms dp^T and ds^T and accumulates dk
//   (flash_bwd.cu's split by product).
// - Per score tile every block forms its panel's PARTIAL s and dp (K3: s^T,
//   dp^T) with SS wgmma m64n64k16. The partials are summed across the
//   cluster by a reduce-scatter through distributed shared memory: the 8
//   eight-column groups of a 64 x 64 tile are dealt out to the blocks (block
//   o owns groups [ceil(8o / P), ceil(8(o + 1) / P))), and every block sends
//   each group's partial to its owner's receive buffer, its own groups' into
//   its own by plain stores, the others' with st.async, whose bytes complete
//   on the owner's mbarrier. Each owner adds the P partials in rank order,
//   forms p and ds (masking only on the causal diagonal and a ragged last
//   tile) and sends them to every block's operand tile the same way. Every
//   buffer is thread-major: thread t of every block holds the same
//   accumulator positions, so a value goes from thread t to thread t, and
//   each thread reads back its whole A operand (16 bytes a k-step, stored
//   whole when one owner holds both of its groups) for an RS wgmma
//   m64n128k16 against its own stationary or streamed panel (MN-major): dq
//   += ds k, dv += p^T do, dk += ds^T q. K3's owner A hands its f32 p^T to
//   its own B, which forms ds^T.
// - K2's delta = rowsum(do * o) is summed the same way before the first
//   tile: each block's partial over its panel's columns goes to every block,
//   which adds the P partials in rank order; rank 0 writes delta for K3.
// - Total work: 1x the products plus the exchange, which sets the pace. A K2
//   block sends (P - 1) / P of 2 x 32 KB of f32 partials a 64-key tile and
//   receives (P - 1) / P of a 16 KB ds tile (bf16; 32 KB of f32 in fp16);
//   a K3 block a third of that a q tile. An H100 SM's port to the cluster
//   carried about 15.5 bytes a cycle out (ops/dsmem_rate.cu, driven by
//   ops/dsmem_rate.py; PERF.md), so at P = 4 K2's 60 KB a tile take ~4,000
//   cycles against ~2,000 of products. K2's consumer 1 starts once consumer
//   0 has sent its first partials, so that their sends take turns on that
//   port.
// - Each receive and operand buffer is written once a tile and read before
//   its readers send what its writers wait for next (partials after the last
//   operand tile, operand tiles after the partials they are summed from), so
//   one of each suffices, and a thread reads back only what thread t of
//   some block wrote: its own stores need no barrier. An owner arms its
//   barrier (arrive.expect_tx) for the next tile only after its wait on the
//   last; bytes that land earlier drive the count below zero and complete
//   nothing while the arrival is pending. A cluster barrier after the
//   barriers' initialisation keeps every store from landing before them,
//   and one at the end keeps every block resident until all have finished.
// - Each element of p and ds is formed by one owner from the same partials
//   in the same order, so every block multiplies the same operand tile, and
//   two runs are bit-identical. Every output element is stored by one
//   block, with no atomics.
// - fp16 keeps flash_bwd.cu's per-row 2^E scaling of ds: the owners send ds
//   in f32, and every block derives E from the summed ds of its rows (the
//   same values, so the same E), rescales its accumulator and packs. p (in
//   [0, 1]) packs unscaled, as bf16 does.
// - Designs measured at the D 512 CLI shape (PERF.md): each owner loading
//   the partials from the other blocks (ld.shared::cluster) after
//   release/acquire signals took K2 3.09 and K3 3.31 ms (a remote round trip
//   ~1,400 cycles under load, and a releasing arrive ~1,000); pushes that
//   kept a block's own partials in registers spilled in K2's owner phase
//   (2.36 and 2.15 ms). This one, every partial through the receive
//   buffers: 1.70 and 1.71 ms; staggering K2's consumers took K2 to ~1.55.
//
// Shared memory (the rings take as many stages as fit, at most 227 KB): the
// 16-bit panels as in the D 128 kernels (K2 q 32 + do 32 + 1 or 2 x (16 +
// 16) KB; K3 K 16 + V 16 + 2 or 3 x (16 + 16) KB), the receive buffers (P
// blocks x the groups owned x 2 KB each of s and dp) and the operand tiles.
// P = 7 (8 groups dealt 2-1-1-1-1-1-1) runs as P = 8, whose eighth panel is
// all zero columns, so that no block's receive buffers hold two groups of
// seven blocks.
//
// A cluster that cannot be scheduled, or a launch that fails, returns its
// CUDA error; nothing falls back.

#include "flash_cluster.cuh"

namespace {

using namespace hived;

constexpr int kRowsS = 64;  // q rows a K3 stage holds

// the four f32 of one group of an accumulator-layout array
__device__ __forceinline__ float4 group4(const float* x) {
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void ungroup4(float* x, float4 v) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

template <typename In>
__device__ __forceinline__ uint2 pack4(float4 v) {
  return make_uint2(pack_f32<In>(v.x, v.y), pack_f32<In>(v.z, v.w));
}

// A packed operand tile (bf16 or fp16 pairs: K2's ds, K3's p^T and bf16
// ds^T) is [k-step][128 threads] uint4, the four A registers of the k-step
// (keys or q rows [16kk, 16kk + 16)): group n's two pairs, rows a and b of
// columns 8n + 2 t4 and the next, are the uint2 at half n & 1 of k-step n / 2.
__device__ __forceinline__ unsigned char* packed_at(unsigned char* tile, int n, int t) {
  return tile + ((n / 2) * 128 + t) * 16 + (n & 1) * 8;
}

// one thread's f32 values of a whole tile (fp16 ds) -> the rows' scales (the
// accumulator moved to them) and the packed A operand
template <typename In>
__device__ __forceinline__ void pack_scaled(uint32_t (&a)[4][4], const float (&x)[32],
                                            float (&acc)[64], int& e_a, int& e_b) {
  float sc_a, sc_b;
  ds_row_scales(x, acc, e_a, e_b, sc_a, sc_b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_f32<In>(x[8 * kk] * sc_a, x[8 * kk + 1] * sc_a);
    a[kk][1] = pack_f32<In>(x[8 * kk + 2] * sc_b, x[8 * kk + 3] * sc_b);
    a[kk][2] = pack_f32<In>(x[8 * kk + 4] * sc_a, x[8 * kk + 5] * sc_a);
    a[kk][3] = pack_f32<In>(x[8 * kk + 6] * sc_b, x[8 * kk + 7] * sc_b);
  }
}

// Group n's packed values (`v`) of a packed tile, owned groups [own0, own1),
// to every block: an even group whose odd neighbour is owned too is held
// (`held`) and sent with it, its k-step in one 16-byte store.
__device__ __forceinline__ void broadcast_packed(unsigned char* tile, const uint64_t* bar,
                                                 uint2 v, uint2& held, int n, int own0, int own1,
                                                 int t, int P, int rank) {
  if ((n & 1) == 0 && n + 1 < own1) {
    held = v;
  } else if ((n & 1) == 1 && n > own0) {
    broadcast(packed_at(tile, n - 1, t), bar, make_uint4(held.x, held.y, v.x, v.y), P, rank);
  } else {
    broadcast(packed_at(tile, n, t), bar, v, P, rank);
  }
}

// the whole packed tile as this thread's A operand
__device__ __forceinline__ void load_packed(uint32_t (&a)[4][4], const unsigned char* tile, int t) {
#pragma unroll
  for (int kk = 0; kk < kGroups / 2; ++kk) {
    const uint4 v = *reinterpret_cast<const uint4*>(tile + (kk * 128 + t) * 16);
    a[kk][0] = v.x;
    a[kk][1] = v.y;
    a[kk][2] = v.z;
    a[kk][3] = v.w;
  }
}

struct WideArgs {
  CUtensorMap tq, tk, tv, tdo;
  const void* o;     // K2: the forward's o, in the input type
  const float* lse;  // [B*H, T]
  float* delta;      // [B*H, T]: K2 writes it, K3 reads it
  void* out0;        // dq (K2) or dk (K3): the input type or f32, the kernel's OutT
  void* out1;        // dv (K3)
  int T, H, group, D, P, causal;
  Strides so, s0, s1;
  float scale;
};

// ------------------------------------------------------------------- K2

// shared-memory layout at P blocks a cluster, byte offsets from a
// 1024-aligned base
struct DqLayout {
  int stages;  // K/V ring depth: 2 if it fits, else 1
  int q, dout, k, v;
  int recv;   // [consumer][block][owned group][s, dp][128 threads] float4
  int ds;     // [consumer]: a packed tile (bf16), or [group][128 threads] float4 (fp16: f32)
  int dpart;  // [block][128 rows] f32: delta's partials, at the ds tiles (used before them)
  int bars;   // qdo_full, kv_full[2], kv_empty[2], xfull[2], dsfull[2], dfull
  int bytes;
};

__host__ __device__ inline DqLayout dq_layout(int P, bool f16) {
  constexpr int kQTile = kRowsQ * kPanel * 2, kKTile = kKeys * kPanel * 2;
  const int recv = 2 * P * max_owned(P) * 2 * kGroupBytes;
  const int ds = 2 * kGroups * 128 * (f16 ? 16 : 8);
  const int rest = 2 * kQTile + recv + ds + 10 * 8 + 1024;  // + alignment slack
  DqLayout L;
  L.stages = rest + 2 * 2 * kKTile <= kSmemMax ? 2 : 1;
  L.q = 0;
  L.dout = L.q + kQTile;
  L.k = L.dout + kQTile;
  L.v = L.k + L.stages * kKTile;
  L.recv = L.v + L.stages * kKTile;
  L.ds = L.recv + recv;
  L.dpart = L.ds;
  L.bars = L.ds + ds;
  L.bytes = L.bars + 10 * 8 + 1024;
  return L;
}

template <typename In, typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
    wide_dq_kernel(const __grid_constant__ WideArgs a) {
  using Pair = typename std::conditional<kIsF16<In>, __half2, __nv_bfloat162>::type;
  constexpr int kUnit = kIsF16<In> ? 16 : 8;  // bytes of a thread's ds of one group
  const int P = a.P;
  const DqLayout L = dq_layout(P, kIsF16<In>);
  const int S = L.stages;
  const int G = max_owned(P);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  In* sQ = reinterpret_cast<In*>(smem + L.q);
  In* sDo = reinterpret_cast<In*>(smem + L.dout);
  In* sK = reinterpret_cast<In*>(smem + L.k);
  In* sV = reinterpret_cast<In*>(smem + L.v);
  float* sDpart = reinterpret_cast<float*>(smem + L.dpart);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* kv_full = qdo_full + 1;
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* xfull = kv_empty + 2;  // [consumer]: the other senders' partials landed
  uint64_t* dsfull = xfull + 2;    // [consumer]: the other owners' ds landed
  uint64_t* dfull = dsfull + 2;    // the other blocks' delta partials landed

  const int rank = static_cast<int>(cluster_rank());  // the panel
  const int col0 = rank * kPanel;
  const int T = a.T;
  const int n_q_tiles = (T + kRowsQ - 1) / kRowsQ;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.z);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * kRowsQ;
  const int n_k_tiles = (T + kKeys - 1) / kKeys;
  // consumer c's rows meet keys up to their diagonal, tile 2 q_tile + c
  const int n_kv = a.causal ? min(n_k_tiles, 2 * q_tile + 2) : n_k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], kWsConsumerThreads);
      mbar_init(&xfull[s], 1);  // each arrival is an arrive.expect_tx of the phase's bytes
      mbar_init(&dsfull[s], 1);
    }
    mbar_init(dfull, 1);
    mbar_init_fence();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread starts every load
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int h_kv = h / a.group;
      mbar_expect_tx(qdo_full, 2 * kRowsQ * kPanel * 2);
      tma_load_panel<kRowsQ>(sQ, &a.tq, qdo_full, col0, h, q0, b);
      tma_load_panel<kRowsQ>(sDo, &a.tdo, qdo_full, col0, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int stage = S == 2 ? j & 1 : 0;
        if (j >= S) mbar_wait(&kv_empty[stage], ((j / S) - 1) & 1);
        mbar_expect_tx(&kv_full[stage], 2 * kKeys * kPanel * 2);
        tma_load_panel<kKeys>(sK + stage * kKeys * kPanel, &a.tk, &kv_full[stage], col0, h_kv,
                              j * kKeys, b);
        tma_load_panel<kKeys>(sV + stage * kKeys * kPanel, &a.tv, &kv_full[stage], col0, h_kv,
                              j * kKeys, b);
      }
    }
  } else {
    // consumer c owns q rows [64c, 64c + 64) of the tile and dq's columns of
    // the panel
    regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int r0 = 64 * c + 16 * warp;  // the warp's first row in the tile
    const int row_a = q0 + r0 + g;      // rows of the accumulators' e = 0, 1
    const int row_b = row_a + 8;        // and e = 2, 3
    const int n_kv_c = a.causal ? min(n_k_tiles, 2 * q_tile + 1 + c) : n_k_tiles;
    const int64_t lrow = static_cast<int64_t>(bh) * T;
    const int own0 = first_group(rank, P);
    const int n_own = first_group(rank + 1, P) - own0;

    // delta's partial over the panel's columns for the warp's 16 rows, two
    // lanes a row: do from its swizzled tile, o from global memory below the
    // real D; sent to every block, each of which adds the P partials of its
    // rows in rank order
    if (c == 0 && tid == 0) mbar_expect_tx(dfull, (P - 1) * kRowsQ * 4);
    mbar_wait(qdo_full, 0);
    {
      const int r = r0 + lane / 2;
      const int row = q0 + r;
      const int lc0 = (lane & 1) * 64;
      float sum = 0.f;
      if (row < T) {
        const In* orow = at(static_cast<const In*>(a.o), a.so, b, h) + row * a.so.t;
#pragma unroll
        for (int cc = 0; cc < 64; cc += 8) {
          const int lc = lc0 + cc;
          if (col0 + lc >= a.D) break;
          const In* drow =
              sDo + (lc / 64) * kRowsQ * 64 + r * 64 + ((((lc % 64) / 8) ^ (r & 7)) * 8);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow);
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + col0 + lc);
          const Pair* d2 = reinterpret_cast<const Pair*>(&dv);
          const Pair* o2 = reinterpret_cast<const Pair*>(&ov);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 df = to_float2(d2[e]);
            const float2 of = to_float2(o2[e]);
            sum += df.x * of.x + df.y * of.y;
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((lane & 1) == 0) {
        broadcast(reinterpret_cast<unsigned char*>(sDpart + rank * kRowsQ + r), dfull, sum, P,
                  rank);
      }
    }
    named_barrier(3, kWsConsumerThreads);  // this block's partials stored
    mbar_wait_cluster(dfull, 0);
    float dl_a = 0.f, dl_b = 0.f;
    for (int src = 0; src < P; ++src) {
      dl_a += sDpart[src * kRowsQ + r0 + g];
      dl_b += sDpart[src * kRowsQ + r0 + g + 8];
    }
    // the partials share the ds tiles' bytes, written from the first tile on
    named_barrier(3, kWsConsumerThreads);
    if (rank == 0 && t4 == 0) {
      if (row_a < T) a.delta[lrow + row_a] = dl_a;
      if (row_b < T) a.delta[lrow + row_b] = dl_b;
    }
    // rows past T: lse = +inf, so p = 0
    const float lb_a = row_a < T ? a.lse[lrow + row_a] * kLog2e : CUDART_INF_F;
    const float lb_b = row_b < T ? a.lse[lrow + row_b] * kLog2e : CUDART_INF_F;
    const float scale_log2 = a.scale * kLog2e;

    // K-major descriptors of this consumer's q and do rows and of stage 0's
    // K and V panels; MN-major of stage 0's K panel (LBO: its column blocks)
    const uint64_t dQ = desc_sw128(sQ + 64 * c * 64, 16);
    const uint64_t dDo = desc_sw128(sDo + 64 * c * 64, 16);
    const uint64_t dK = desc_sw128(sK, 16);
    const uint64_t dV = desc_sw128(sV, 16);
    const uint64_t dKn = desc_sw128(sK, kKeys * 128);
    // this consumer's receive buffer ([block][owned group][s, dp][t]) and ds
    // tile (bf16: packed; fp16: [group][t] float4)
    float4* recv = reinterpret_cast<float4*>(smem + L.recv) + c * P * G * 2 * 128;
    unsigned char* ds_tile = smem + L.ds + c * kGroups * 128 * kUnit;

    float acc[kPanel / 2];
#pragma unroll
    for (int i = 0; i < kPanel / 2; ++i) acc[i] = 0.f;
    int e_a = kDsExpMax, e_b = kDsExpMax;  // fp16: the rows' ds exponents
    // consumer 1 starts once consumer 0 has sent its first partials, so that
    // the two consumers' sends take turns on the SM's port to the cluster
    if (c == 1) named_barrier(4, kWsConsumerThreads);

    for (int j = 0; j < n_kv_c; ++j) {
      const int stage = S == 2 ? j & 1 : 0;
      const uint32_t stage_off = stage * kKeys * kPanel * 2;
      if (tid == 0) {  // the last tile's waits are done: arm this tile's
        mbar_expect_tx(&xfull[c], (P - 1) * n_own * 2 * kGroupBytes);
        mbar_expect_tx(&dsfull[c], (kGroups - n_own) * 128 * kUnit);
      }

      // the panel's partial s = q k^T and dp = do v^T
      float s[kKeys / 2], dp[kKeys / 2];
      mbar_wait(&kv_full[stage], (j / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPanel / 16; ++kk) {
        const uint32_t qcol = (kk / 4) * kRowsQ * 128 + (kk % 4) * 32;
        const uint32_t kcol = stage_off + (kk / 4) * kKeys * 128 + (kk % 4) * 32;
        wgmma_ss<kKeys, In>(s, desc_add(dQ, qcol), desc_add(dK, kcol), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kPanel / 16; ++kk) {
        const uint32_t qcol = (kk / 4) * kRowsQ * 128 + (kk % 4) * 32;
        const uint32_t kcol = stage_off + (kk / 4) * kKeys * 128 + (kk % 4) * 32;
        wgmma_ss<kKeys, In>(dp, desc_add(dDo, qcol), desc_add(dV, kcol), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // every group's partials to its owner, this block's own groups too
#pragma unroll
      for (int n = 0; n < kGroups; ++n) {
        const int o = owner_of(n, P);
        float4* slot = recv + ((rank * G + n - first_group(o, P)) * 2) * 128 + tid;
        send(slot, &xfull[c], group4(s + 4 * n), o, rank);
        send(slot + 128, &xfull[c], group4(dp + 4 * n), o, rank);
      }
      if (c == 0 && j == 0) named_arrive(4, kWsConsumerThreads);

      // the groups this block owns: the partials added in rank order, then p
      // and ds, sent to every block
      mbar_wait_cluster(&xfull[c], j & 1);
      const bool mask = j == n_kv_c - 1;
      uint2 held;  // bf16: an even group's packed ds, sent with its neighbour's
      for (int n = own0; n < own0 + n_own; ++n) {
        const float4* gr = recv + (n - own0) * 2 * 128 + tid;
        const float4 st = sum_partials(gr, G * 2 * 128, P);
        const float4 dt = sum_partials(gr + 128, G * 2 * 128, P);
        const float sv[4] = {st.x, st.y, st.z, st.w};
        const float dv[4] = {dt.x, dt.y, dt.z, dt.w};
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool top = i < 2;  // row_a, else row_b
          float p = exp2f(fmaf(sv[i], scale_log2, top ? -lb_a : -lb_b));
          if (mask) {
            const int col = j * kKeys + 8 * n + 2 * t4 + (i & 1);
            if (col >= T || (a.causal && col > (top ? row_a : row_b))) p = 0.f;
          }
          e[i] = p * (dv[i] - (top ? dl_a : dl_b));
        }
        const float4 ds4 = make_float4(e[0], e[1], e[2], e[3]);
        if constexpr (kIsF16<In>) {
          broadcast(ds_tile + (n * 128 + tid) * 16, &dsfull[c], ds4, P, rank);
        } else {
          broadcast_packed(ds_tile, &dsfull[c], pack4<In>(ds4), held, n, own0, own0 + n_own, tid,
                           P, rank);
        }
      }
      // the tile's other groups; this thread's own stores need no barrier
      mbar_wait_cluster(&dsfull[c], j & 1);

      // the whole tile's ds as the A operand (fp16: each row scaled)
      uint32_t ds[kKeys / 16][4];
      if constexpr (kIsF16<In>) {
#pragma unroll
        for (int n = 0; n < kGroups; ++n) {
          ungroup4(s + 4 * n, reinterpret_cast<const float4*>(ds_tile)[n * 128 + tid]);
        }
        pack_scaled<In>(ds, s, acc, e_a, e_b);
      } else {
        load_packed(ds, ds_tile, tid);
      }

      // dq += ds k: k-step kk reads keys [16kk, 16kk + 16) of the K panel
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_rs<kPanel, In>(acc, ds[kk], desc_add(dKn, stage_off + kk * 2048), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&kv_empty[stage]);
    }

    if constexpr (kIsF16<In>) {  // undo the rows' ds scales
      const float inv_a = pow2i(-e_a);
      const float inv_b = pow2i(-e_b);
#pragma unroll
      for (int i = 0; i < kPanel / 2; ++i) acc[i] *= (i & 2) ? inv_b : inv_a;
    }
    OutT* dqp = at(static_cast<OutT*>(a.out0), a.s0, b, h);
#pragma unroll
    for (int n = 0; n < kPanel / 8; ++n) {
      const bool live = col0 + n * 8 < a.D;  // columns past the real D: not stored
      const int col = col0 + n * 8 + 2 * t4;
      if (live && row_a < T) {
        store_out2(dqp + row_a * a.s0.t + col, acc[4 * n] * a.scale, acc[4 * n + 1] * a.scale);
      }
      if (live && row_b < T) {
        store_out2(dqp + row_b * a.s0.t + col, acc[4 * n + 2] * a.scale,
                   acc[4 * n + 3] * a.scale);
      }
    }
  }
  cluster_sync();
}

// ------------------------------------------------------------------- K3

// shared-memory layout at P blocks a cluster, byte offsets from a
// 1024-aligned base
struct DkvLayout {
  int stages;  // q/do ring depth: 3 if it fits, else 2
  int k, v, q, dout;
  int recv;   // [A s^T, B dp^T][block][owned group][128 threads] float4
  int pf;     // [owned group][128 threads] float4: A's f32 p^T, to B
  int pb;     // p^T, a packed tile
  int ds;     // ds^T: a packed tile (bf16), or [group][128 threads] float4 (fp16: f32)
  int lse, delta;  // [stage][64] f32: lse x log2 e, delta
  int bars;  // kv_full, full[3], empty[3], p_full, p_empty, xfull[2], tfull[2]
  int bytes;
};

__host__ __device__ inline DkvLayout dkv_layout(int P, bool f16) {
  constexpr int kKTile = kKeys * kPanel * 2, kQTile = kRowsS * kPanel * 2;
  constexpr int kStageBytes = 2 * kQTile + 2 * kRowsS * 4;
  const int recv = 2 * P * max_owned(P) * kGroupBytes;
  const int pf = max_owned(P) * kGroupBytes;
  const int pb = kGroups * 128 * 8;
  const int ds = kGroups * 128 * (f16 ? 16 : 8);
  const int rest = 2 * kKTile + recv + pf + pb + ds + 13 * 8 + 1024;  // + alignment slack
  DkvLayout L;
  L.stages = rest + 3 * kStageBytes <= kSmemMax ? 3 : 2;
  L.k = 0;
  L.v = L.k + kKTile;
  L.q = L.v + kKTile;
  L.dout = L.q + L.stages * kQTile;
  L.recv = L.dout + L.stages * kQTile;
  L.pf = L.recv + recv;
  L.pb = L.pf + pf;
  L.ds = L.pb + pb;
  L.lse = L.ds + ds;
  L.delta = L.lse + L.stages * kRowsS * 4;
  L.bars = L.delta + L.stages * kRowsS * 4;
  L.bytes = L.bars + 13 * 8 + 1024;
  return L;
}

template <typename In, typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
    wide_dkv_kernel(const __grid_constant__ WideArgs a) {
  constexpr int kUnit = kIsF16<In> ? 16 : 8;  // bytes of a thread's ds^T of one group
  const int P = a.P;
  const DkvLayout L = dkv_layout(P, kIsF16<In>);
  const int S = L.stages;
  const int G = max_owned(P);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  In* sK = reinterpret_cast<In*>(smem + L.k);
  In* sV = reinterpret_cast<In*>(smem + L.v);
  In* sQ = reinterpret_cast<In*>(smem + L.q);
  In* sDo = reinterpret_cast<In*>(smem + L.dout);
  float4* sPf = reinterpret_cast<float4*>(smem + L.pf);
  float* sLb = reinterpret_cast<float*>(smem + L.lse);
  float* sDelta = reinterpret_cast<float*>(smem + L.delta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + 3;
  uint64_t* p_full = empty + 3;    // A's f32 p^T stored, for B
  uint64_t* p_empty = p_full + 1;  // B has read it
  uint64_t* xfull = p_empty + 1;   // [A, B]: the other senders' partials landed
  uint64_t* tfull = xfull + 2;     // [A, B]: the other owners' p^T or ds^T landed

  const int rank = static_cast<int>(cluster_rank());  // the panel
  const int col0 = rank * kPanel;
  const int T = a.T;
  const int h_kv_count = a.H / a.group;
  const int b = blockIdx.y / h_kv_count;
  const int h_kv = blockIdx.y % h_kv_count;
  const int k0 = blockIdx.z * kKeys;  // z = 0, the heaviest tiles, is scheduled first
  const int n_q_tiles = (T + kRowsS - 1) / kRowsS;
  const int first = a.causal ? k0 / kRowsS : 0;  // earlier q tiles see none of these keys
  const int per_head = n_q_tiles - first;
  const int n_iter = a.group * per_head;  // q tile `it % per_head` of head `it / per_head`

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 3; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread's expect_tx, each lane's lse/delta
      mbar_init(&empty[s], kWsConsumerThreads);
    }
    mbar_init(p_full, 128);
    mbar_init(p_empty, 128);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&xfull[s], 1);  // each arrival is an arrive.expect_tx of the phase's bytes
      mbar_init(&tfull[s], 1);
    }
    mbar_init_fence();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one warp; its thread 0 starts every TMA load, its 32 lanes
    // store each stage's lse and delta
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kKeys * kPanel * 2);
        tma_load_panel<kKeys>(sK, &a.tk, kv_full, col0, h_kv, k0, b);
        tma_load_panel<kKeys>(sV, &a.tv, kv_full, col0, h_kv, k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int stage = it % S;
        const int hq = h_kv * a.group + it / per_head;
        const int q0 = (first + it % per_head) * kRowsS;
        if (it >= S) mbar_wait(&empty[stage], ((it / S) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * kRowsS * kPanel * 2);
          tma_load_panel<kRowsS>(sQ + stage * kRowsS * kPanel, &a.tq, &full[stage], col0, hq, q0,
                                 b);
          tma_load_panel<kRowsS>(sDo + stage * kRowsS * kPanel, &a.tdo, &full[stage], col0, hq,
                                 q0, b);
        }
        const int64_t lrow = static_cast<int64_t>(b * a.H + hq) * T;
#pragma unroll
        for (int j = 0; j < kRowsS / 32; ++j) {
          const int r = lane + 32 * j;
          const int row = q0 + r;
          sLb[stage * kRowsS + r] = row < T ? a.lse[lrow + row] * kLog2e : CUDART_INF_F;
          sDelta[stage * kRowsS + r] = row < T ? a.delta[lrow + row] : 0.f;
        }
        mbar_arrive(&full[stage]);  // releases this lane's stores
      }
    }
  } else {
    // consumers A (wg 1: s^T, p^T, dv) and B (wg 2: dp^T, ds^T, dk), both
    // over the block's 64 keys and its panel of dk and dv
    regs_inc<kConsumerRegs>();
    const int ab = wg - 1;  // 0: A, 1: B
    const bool is_a = ab == 0;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int key_a = k0 + 16 * warp + g;  // keys of the accumulators' e = 0, 1
    const int key_b = key_a + 8;           // and e = 2, 3
    const int own0 = first_group(rank, P);
    const int n_own = first_group(rank + 1, P) - own0;
    const float scale_log2 = a.scale * kLog2e;

    // K-major stage-0 descriptors of the score operands (A: K and q, B: V
    // and do) and MN-major of the stage-0 do (A) or q (B) panel
    const uint64_t dKV = desc_sw128(is_a ? sK : sV, 16);
    const uint64_t dQD = desc_sw128(is_a ? sQ : sDo, 16);
    const uint64_t dQDn = desc_sw128(is_a ? sDo : sQ, kRowsS * 128);
    // this consumer's receive buffer ([block][owned group][t]) and operand
    // tile (A: p^T packed; B: ds^T, packed in bf16, [group][t] float4 in fp16)
    float4* recv = reinterpret_cast<float4*>(smem + L.recv) + ab * P * G * 128;
    unsigned char* tile = smem + (is_a ? L.pb : L.ds);
    const int unit = is_a ? 8 : kUnit;

    float acc[kPanel / 2];  // A: dv, B: dk
#pragma unroll
    for (int i = 0; i < kPanel / 2; ++i) acc[i] = 0.f;
    int e_a = kDsExpMax, e_b = kDsExpMax;  // fp16, B: the keys' ds exponents
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int stage = it % S;
      const int q0 = (first + it % per_head) * kRowsS;
      const uint32_t stage_off = stage * kRowsS * kPanel * 2;
      if (tid == 0) {  // the last tile's waits are done: arm this tile's
        mbar_expect_tx(&xfull[ab], (P - 1) * n_own * kGroupBytes);
        mbar_expect_tx(&tfull[ab], (kGroups - n_own) * 128 * unit);
      }
      mbar_wait(&full[stage], (it / S) & 1);

      // the panel's partial s^T = k q^T (A) or dp^T = v do^T (B)
      float x[kRowsS / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPanel / 16; ++kk) {
        const uint32_t kcol = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
        const uint32_t qcol = stage_off + (kk / 4) * kRowsS * 128 + (kk % 4) * 32;
        wgmma_ss<kRowsS, In>(x, desc_add(dKV, kcol), desc_add(dQD, qcol), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);

      // every group's partial to its owner, this block's own groups too
#pragma unroll
      for (int n = 0; n < kGroups; ++n) {
        const int o = owner_of(n, P);
        send(recv + (rank * G + n - first_group(o, P)) * 128 + tid, &xfull[ab], group4(x + 4 * n),
             o, rank);
      }
      mbar_wait_cluster(&xfull[ab], it & 1);

      uint2 held;  // an even group's packed p^T or (bf16) ds^T, sent with its neighbour's
      if (is_a) {
        // p^T = exp(scale s^T - lse) of the groups this block owns: f32 to
        // B, packed to every block. The columns are q rows: lse (times log2
        // e) and the mask are per column. Only the causal diagonal (the
        // head's first q tile) and a ragged last tile are masked: there
        // s^T = -inf for q rows past T and, causal, for keys past the row.
        const bool mask = (a.causal && q0 == k0) || q0 + kRowsS > T;
        const float* lb = sLb + stage * kRowsS;
        if (it > 0) mbar_wait(p_empty, (it - 1) & 1);
        for (int n = own0; n < own0 + n_own; ++n) {
          const float4 st = sum_partials(recv + (n - own0) * 128 + tid, G * 128, P);
          const float sv[4] = {st.x, st.y, st.z, st.w};
          float p[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 8 * n + 2 * t4 + (i & 1);
            const int row = q0 + col;
            const int key = (i & 2) ? key_b : key_a;
            const bool dead = mask && (row >= T || (a.causal && key > row));
            p[i] = exp2f(fmaf(dead ? -CUDART_INF_F : sv[i], scale_log2, -lb[col]));
          }
          const float4 p4 = make_float4(p[0], p[1], p[2], p[3]);
          sPf[(n - own0) * 128 + tid] = p4;
          broadcast_packed(tile, &tfull[ab], pack4<In>(p4), held, n, own0, own0 + n_own, tid, P,
                           rank);
        }
        mbar_arrive(p_full);
      } else {
        // ds^T = p^T (dp^T - delta) of the groups this block owns, from A's
        // p^T; delta per column (q row)
        const float* dl = sDelta + stage * kRowsS;
        mbar_wait(p_full, it & 1);
        for (int n = own0; n < own0 + n_own; ++n) {
          const float4 dt = sum_partials(recv + (n - own0) * 128 + tid, G * 128, P);
          const float4 p4 = sPf[(n - own0) * 128 + tid];
          const int col = 8 * n + 2 * t4;
          const float4 ds4 = make_float4(p4.x * (dt.x - dl[col]), p4.y * (dt.y - dl[col + 1]),
                                         p4.z * (dt.z - dl[col]), p4.w * (dt.w - dl[col + 1]));
          if constexpr (kIsF16<In>) {
            broadcast(tile + (n * 128 + tid) * 16, &tfull[ab], ds4, P, rank);
          } else {
            broadcast_packed(tile, &tfull[ab], pack4<In>(ds4), held, n, own0, own0 + n_own, tid,
                             P, rank);
          }
        }
        mbar_arrive(p_empty);
      }
      // the tile's other groups; this thread's own stores need no barrier
      mbar_wait_cluster(&tfull[ab], it & 1);

      // the whole tile as the A operand: p^T, or ds^T (fp16: each key's row
      // scaled)
      uint32_t op[kRowsS / 16][4];
      if (kIsF16<In> && !is_a) {
#pragma unroll
        for (int n = 0; n < kGroups; ++n) {
          ungroup4(x + 4 * n, reinterpret_cast<const float4*>(tile)[n * 128 + tid]);
        }
        pack_scaled<In>(op, x, acc, e_a, e_b);
      } else {
        load_packed(op, tile, tid);
      }

      // dv += p^T do (A) or dk += ds^T q (B): k-step kk reads q rows [16kk,
      // 16kk + 16), 2048 bytes down the stage's panel
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRowsS / 16; ++kk) {
        wgmma_rs<kPanel, In>(acc, op[kk], desc_add(dQDn, stage_off + kk * 2048), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[stage]);
    }

    // dv as it is; dk times the scale (fp16: and each key's 2^-E)
    float mul_a = 1.f, mul_b = 1.f;
    if (!is_a) {
      mul_a = kIsF16<In> ? a.scale * pow2i(-e_a) : a.scale;
      mul_b = kIsF16<In> ? a.scale * pow2i(-e_b) : a.scale;
    }
    OutT* out = at(static_cast<OutT*>(is_a ? a.out1 : a.out0), is_a ? a.s1 : a.s0, b, h_kv);
    const int64_t ost = is_a ? a.s1.t : a.s0.t;
#pragma unroll
    for (int n = 0; n < kPanel / 8; ++n) {
      const bool live = col0 + n * 8 < a.D;  // columns past the real D: not stored
      const int col = col0 + n * 8 + 2 * t4;
      if (live && key_a < T) {
        store_out2(out + key_a * ost + col, acc[4 * n] * mul_a, acc[4 * n + 1] * mul_a);
      }
      if (live && key_b < T) {
        store_out2(out + key_b * ost + col, acc[4 * n + 2] * mul_b, acc[4 * n + 3] * mul_b);
      }
    }
  }
  cluster_sync();
}

// ------------------------------------------------------------- launching

template <bool kDkv, typename In, typename OutT>
cudaError_t launch(const WideArgs& a, int B, cudaStream_t stream) {
  static bool attr_set = false;
  // the panels along x, one cluster of them; tiles along z, heaviest first
  const dim3 grid(a.P, B * (kDkv ? a.H / a.group : a.H),
                  kDkv ? (a.T + kKeys - 1) / kKeys : (a.T + kRowsQ - 1) / kRowsQ);
  const int smem = kDkv ? dkv_layout(a.P, kIsF16<In>).bytes : dq_layout(a.P, kIsF16<In>).bytes;
  return launch_clusters(kDkv ? wide_dkv_kernel<In, OutT> : wide_dq_kernel<In, OutT>, a, grid,
                         a.P, smem, stream, attr_set);
}

template <bool kDkv>
int launch_types(const WideArgs& a, int B, int in_type, int out_type, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = out_type == kF32;
  cudaError_t err;
  if (in_type == kBf16) {
    err = f32 ? launch<kDkv, bf16, float>(a, B, s) : launch<kDkv, bf16, bf16>(a, B, s);
  } else {
    err = f32 ? launch<kDkv, f16, float>(a, B, s) : launch<kDkv, f16, f16>(a, B, s);
  }
  return static_cast<int>(err);
}

// the four tensor maps (q and do boxes of q_rows rows, k and v of 64; s the
// element strides of q, k, v, do) and the arguments every launch shares
template <typename In>
int base_args(WideArgs& a, const void* q, const void* k, const void* v, const void* dout, int B,
              int T, int H, int H_kv, int D, int causal, int q_rows, const int64_t* s) {
  int err = make_tile_map<In>(&a.tq, q, B, T, H, D, s[0], s[1], s[2], q_rows);
  if (err == 0) err = make_tile_map<In>(&a.tk, k, B, T, H_kv, D, s[3], s[4], s[5], kKeys);
  if (err == 0) err = make_tile_map<In>(&a.tv, v, B, T, H_kv, D, s[6], s[7], s[8], kKeys);
  if (err == 0) err = make_tile_map<In>(&a.tdo, dout, B, T, H, D, s[9], s[10], s[11], q_rows);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.P = wide_panels(D);
  a.causal = causal != 0;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  return err;
}

}  // namespace

// K2. q, o, do [B, T, H, D] and k/v [B, T, H_kv, D] of in_type (0 bf16, 1
// fp16), dq [B, T, H, D] of out_type (in_type, or 2 for f32), addressed
// through the given element strides (D contiguous, every row 16-byte
// aligned, strides positive), 256 < D <= 1024; lse [B*H, T] f32 from the
// forward; delta [B*H, T] f32 is written for K3. Returns 0, the CUresult of
// a tensor map that could not be encoded, or the cudaError_t of the launch.
extern "C" int hived_flash_wide_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int T, int H, int H_kv, int D, int causal,
    int in_type, int out_type, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
    int64_t o_st, int64_t o_sh, int64_t do_sb, int64_t do_st, int64_t do_sh, int64_t dq_sb,
    int64_t dq_st, int64_t dq_sh, void* stream) {
  if (bad_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t s[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                         v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  WideArgs a = {};
  const int err = in_type == kBf16
                      ? base_args<bf16>(a, q, k, v, dout, B, T, H, H_kv, D, causal, kRowsQ, s)
                      : base_args<f16>(a, q, k, v, dout, B, T, H, H_kv, D, causal, kRowsQ, s);
  if (err != 0) return err;
  a.o = o;
  a.so = {o_sb, o_st, o_sh};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.out0 = dq;
  a.s0 = {dq_sb, dq_st, dq_sh};
  return launch_types<false>(a, B, in_type, out_type, stream);
}

// K3. q, do [B, T, H, D] and k/v [B, T, H_kv, D] of in_type, dk/dv [B, T,
// H_kv, D] of out_type, through their element strides, 256 < D <= 1024; lse
// and delta [B*H, T] f32 (delta from K2). The GQA group sum is inside the
// kernel. Returns 0, the CUresult of a tensor map that could not be encoded,
// or the cudaError_t of the launch.
extern "C" int hived_flash_wide_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int T, int H, int H_kv, int D, int causal,
    int in_type, int out_type, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t do_sb,
    int64_t do_st, int64_t do_sh, int64_t dk_sb, int64_t dk_st, int64_t dk_sh, int64_t dv_sb,
    int64_t dv_st, int64_t dv_sh, void* stream) {
  if (bad_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t s[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                         v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  WideArgs a = {};
  const int err = in_type == kBf16
                      ? base_args<bf16>(a, q, k, v, dout, B, T, H, H_kv, D, causal, kRowsS, s)
                      : base_args<f16>(a, q, k, v, dout, B, T, H, H_kv, D, causal, kRowsS, s);
  if (err != 0) return err;
  a.lse = static_cast<const float*>(lse);
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.out0 = dk;
  a.s0 = {dk_sb, dk_st, dk_sh};
  a.out1 = dv;
  a.s1 = {dv_sb, dv_st, dv_sh};
  return launch_types<true>(a, B, in_type, out_type, stream);
}

// The clusters of K2 (dkv 0) or K3 (dkv 1) on bf16 inputs at head dim D that
// the card holds at once, or -1 - the cudaError_t of the query.
extern "C" int hived_flash_wide_clusters(int D, int dkv) {
  const int P = wide_panels(D);
  static bool dq_set = false, dkv_set = false;
  return dkv ? max_clusters(wide_dkv_kernel<bf16, bf16>, P, dkv_layout(P, false).bytes, dkv_set)
             : max_clusters(wide_dq_kernel<bf16, bf16>, P, dq_layout(P, false).bytes, dq_set);
}
