// Flash-attention backward for Hopper (sm_90a) at f32 inputs past D 128: dq
// (K2) and dk/dv (K3) for 128 < D <= 1024 on the tensor cores in 3xTF32,
// each tile's scores formed once by a thread-block cluster.
//
// Replaces hivedscheduler_tpu/ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_backward) at those inputs, to f32
// accuracy. As those kernels compute it, with scale = 1/sqrt(D) of the real
// D:
//   qs = scale * q (in f32, before any product),
//   s = qs k^T under the causal mask (NEG_INF = -1e30),
//   p = exp(s - lse),  dp = do v^T,  delta = rowsum(do * o),
//   ds = p * (dp - delta),
//   dq = scale * ds k,  dk = ds^T qs,  dv = p^T do,
// GQA read in place and K3 summing a kv head's q-head group in its own loop;
// K2 writes delta for K3. Any T works: TMA zero-fills rows at or past T and
// columns at or past D, and the epilogues store only rows < T and columns <
// D. Every product is 3xTF32 (flash_tf32.cuh): big big + big small + small
// big of the operands' tf32 parts, in f32 accumulators, each tile's part
// promoted to the f32 sums by plain adds.
//
// Bound on an H100: K2 does three products of 2*D flops per (row, key) pair
// the mask leaves (q k^T, do v^T, ds k) and K3 four (q k^T and do v^T again,
// p^T do, ds^T q), each at 3xTF32, a third of TF32's 495 TFLOP/s: 165
// TFLOP/s. At Gemma-2B's width in f32 (q [8,2048,8,256], k/v [8,2048,1,256],
// causal) that is 206.3 and 275.0 GFLOP, 1.2503 and 1.6667 ms, against about
// 0.13 ms for their bytes at 3.35 TB/s: the tensor cores bound both.
//
// Why a cluster. The 3xTF32 K2 and K3 at D <= 128 (flash_bwd_tf32.cu) take
// 224 of a block's 227 KB at Dp 128: f32 tiles are twice bf16's, and every
// streamed B operand is two tf32 planes. So the outputs are split into
// 128-column panels, one block each, P = ceil(D / 128) blocks a cluster, as
// the 16-bit cluster kernels split them (flash_bwd_wide.cu). The CUDA-core
// family, which ran these shapes before, split them the same way but formed
// the scores again in every panel (at P = 2, K2 5/3 and K3 3/2 of the real
// work); here every panel forms a partial of the scores and the cluster adds
// the partials, so the real work is done once at every D.
//
// Plan. Block `rank` owns output columns [128 rank, 128 rank + 128). Each
// block is a producer warpgroup (warp 0: TMA; warps 1-3: the big/small split
// of streamed tiles) and two consumer warpgroups, split by product so that
// each consumer reads one stream of tiles:
// - K2: one cluster per (b*h, 64-row q tile), heaviest causal tiles first.
//   The q and do panels (f32) are stationary A operands, read by ld.shared,
//   q times the scale, and split in registers; 32-key K and V panels stream
//   by TMA and are split into big and small planes in place (K through two
//   stages, V through one: V is released once dp is formed). Consumer 0
//   forms the panel's partial s = qs k^T, consumer 1 its dp = do v^T; after
//   the exchange each forms its 64 columns of the panel's dq^T += k^T ds^T
//   (A: k^T read down the K planes; B: ds stored [row][key] as planes).
// - K3: one cluster per (b*h_kv, 64-key tile), key tile 0 first. The K and V
//   panels (f32) are stationary A operands; 32-row q and do panels stream
//   through a ring each, q split as scale * q. Consumer A forms the partial
//   s^T = k qs^T and accumulates dk^T += qs^T ds (B: ds^T planes); consumer
//   B forms dp^T = v do^T and accumulates dv^T += do^T p (B: p^T planes).
// - The exchange is flash_bwd_wide.cu's, over the four 8-column groups of a
//   64 x 32 score tile (one float4 a thread each): every block sends each
//   group's partial s and dp (K3: s^T and dp^T) to the group's owner (block
//   o owns groups [ceil(4o / P), ceil(4(o + 1) / P))), its own groups' by
//   plain stores, the others' with st.async, whose bytes complete on the
//   owner's mbarrier (flash_cluster.cuh). The owner adds the P partials in
//   rank order, forms p and ds in f32 (masking only on the causal diagonal
//   and a ragged last tile), stores them into its own planes and sends the
//   f32 values to every other block, which splits them into its planes: K2
//   sends ds; K3 sends p^T and ds^T. The k-th group a block owns is formed
//   by its consumer k % 2; a received group n of K2 is split by consumer n %
//   2, and in K3 consumer A splits ds^T, B p^T. Each element of p and ds is
//   formed by one owner from the same partials in the same order, so every
//   block multiplies the same operands, and each output element is stored
//   by one block with no atomics: two runs are bit-identical.
// - K2's delta = rowsum(do * o) is summed the same way before the first
//   tile: each block's partial over its panel's columns goes to every block,
//   which adds the P partials in rank order; rank 0 writes delta for K3.
// - Each receive buffer is written once a tile and read before its readers
//   send what its writers wait for next (partials before the operands formed
//   from them, operands before the next tile's partials), as in
//   flash_bwd_wide.cu. A consumer that waits on an exchange barrier waits on
//   it every tile, and the barrier is armed for the next tile only after its
//   armer's wait on the last, so no wait can read a phase two tiles old. A
//   cluster barrier after the barriers' initialisation keeps every store
//   from landing before them, and one at the end keeps every block resident
//   until all have finished.
//
// Shared memory (a block may have 227 KB): K2 q 32 + do 32 KB, two K stages
// of big and small planes 64 KB and one V stage 32 KB, the ds planes 16 KB,
// the partials' receive buffers (P blocks x the groups owned x s and dp, 2
// KB each: 16 KB at P = 2, 32 at P = 8) and ds's 8 KB: 201 to 217 KB. K3: K
// 32 + V 32 KB, the q and do rings (32 KB a stage: two q stages and one do
// stage where they fit, at P = 2 and 4, else one each), the p^T and ds^T
// planes 32 KB, the partials' receive buffers and p^T's and ds^T's 16 KB:
// 197 to 226 KB. Registers a consumer thread: a score tile 16, K2's dq^T 32
// or K3's dk^T or dv^T 64, a tile's part 32 and the A fragments of two
// k-steps (ptxas gives this 384-thread launch 168: flash_bwd_tf32.cu).
//
// A cluster that cannot be scheduled, or a launch that fails, returns its
// CUDA error; nothing falls back.

#include "flash_cluster.cuh"
#include "flash_tf32.cuh"

namespace {

using namespace hived;

constexpr int kRows = 64;         // K2: q rows a block holds; K3: keys (the M of the scores)
constexpr int kCols = 32;         // K2: keys a K/V tile holds; K3: q rows a q/do tile (their N)
constexpr int kTileGroups = 4;    // 8-column groups of a 64 x 32 score tile
constexpr int kPlane = kCols * kPanel * 4;    // one f32 plane of a 32-row panel: 16 KB
constexpr int kStationary = kRows * kPanel * 4;  // a 64-row f32 panel: 32 KB
constexpr int kOpPlane = kRows * kCols * 4;   // one plane of a 64 x 32 operand tile: 8 KB

// block o owns groups [group0(o, P), group0(o + 1, P)) of a tile's four
__host__ __device__ inline int group0(int o, int P) { return (o * kTileGroups + P - 1) / P; }

__device__ __forceinline__ int group_owner(int n, int P) { return n * P / kTileGroups; }

// the most groups one block owns
__host__ __device__ inline int groups_owned(int P) { return (kTileGroups + P - 1) / P; }

// blocks a cluster for head dim D
__host__ __device__ inline int f32_panels(int D) { return (D + kPanel - 1) / kPanel; }

// the stage of use `it` of a ring of S (1 or 2) stages, and the parity of
// that stage's round
__device__ __forceinline__ int stage_of(int it, int S) { return S == 2 ? it & 1 : 0; }

__device__ __forceinline__ uint32_t round_of(int it, int S) { return (S == 2 ? it >> 1 : it) & 1; }

// split_planes (flash_tf32.cuh) of `mul` times the values: K3's q tiles,
// split as scale * q
__device__ __forceinline__ void split_scaled(float* big, float* small, int n, int idx, float mul) {
  float4* b4 = reinterpret_cast<float4*>(big);
  float4* s4 = reinterpret_cast<float4*>(small);
#pragma unroll 4
  for (int i = idx; i < n / 4; i += kSplitThreads) {
    const float4 x = b4[i];
    uint32_t hb[4], lb[4];
    split_tf32(x.x * mul, hb[0], lb[0]);
    split_tf32(x.y * mul, hb[1], lb[1]);
    split_tf32(x.z * mul, hb[2], lb[2]);
    split_tf32(x.w * mul, hb[3], lb[3]);
    b4[i] = make_float4(__uint_as_float(hb[0]), __uint_as_float(hb[1]), __uint_as_float(hb[2]),
                        __uint_as_float(hb[3]));
    s4[i] = make_float4(__uint_as_float(lb[0]), __uint_as_float(lb[1]), __uint_as_float(lb[2]),
                        __uint_as_float(lb[3]));
  }
}

// The panel's partial score product d = a b^T over its 128 columns (16
// k-steps of 8): a the 64 rows of a stationary f32 panel (the thread's row
// m), each k-step's fragment read by ld.shared while the last k-step's
// wgmmas run, times `mul` and split in registers; b the big and small
// planes of a 32-row panel, D contiguous
__device__ __forceinline__ void panel_scores(float (&d)[kCols / 2], const float* a, float mul,
                                             int m, int t4, uint64_t b_big, uint64_t b_small) {
  float x[4];
  frag_rows<kRows>(x, a, m, t4);
#pragma unroll
  for (int kk = 0; kk < kPanel / 8; ++kk) {
    uint32_t xb[4], xs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] *= mul;
    split4(x, xb, xs);
    const uint32_t off = (kk / 4) * kCols * 128 + (kk % 4) * 32;
    wgmma_fence();
    tf32x3<kCols>(d, xb, xs, desc_add(b_big, off), desc_add(b_small, off), kk > 0);
    wgmma_commit();
    if (kk + 1 < kPanel / 8) frag_rows<kRows>(x, a, m, 8 * (kk + 1) + t4);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(d);
}

// One tile's part of a transposed output, acc += a^T b over 4 k-steps of 8
// (promoted in f32): a^T read down the big and small planes `tb`, `ts` of a
// 32-row panel (the thread's M index m: a panel column), each k-step's
// fragments while the last k-step's wgmmas run; b the big and small planes
// of a [64][32] operand tile, its 32 columns contiguous
__device__ __forceinline__ void out_part(float (&acc)[kRows / 2], const float* tb, const float* ts,
                                         int m, int t4, uint64_t b_big, uint64_t b_small) {
  float part[kRows / 2];
  uint32_t nb[4], ns[4];
  frag_cols<kCols>(nb, tb, m, t4);
  frag_cols<kCols>(ns, ts, m, t4);
#pragma unroll
  for (int kk = 0; kk < kCols / 8; ++kk) {
    uint32_t xb[4], xs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xb[i] = nb[i];
      xs[i] = ns[i];
    }
    wgmma_fence();
    tf32x3<kRows>(part, xb, xs, desc_add(b_big, kk * 32), desc_add(b_small, kk * 32), kk > 0);
    wgmma_commit();
    if (kk + 1 < kCols / 8) {
      frag_cols<kCols>(nb, tb, m, 8 * (kk + 1) + t4);
      frag_cols<kCols>(ns, ts, m, 8 * (kk + 1) + t4);
    }
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  promote(acc, part);
}

__device__ __forceinline__ float4 group4(const float* x) {
  return make_float4(x[0], x[1], x[2], x[3]);
}

// a thread's values of group n of a score tile (rows m and m + 8, columns 8n
// + 2 t4 and the next) into the big and small planes of a [64][32] operand
// tile
__device__ __forceinline__ void store_group(float* big, float* small, int m, int n, int t4,
                                            float4 v) {
  store_split2<kRows>(big, small, m, 8 * n + 2 * t4, v.x, v.y);
  store_split2<kRows>(big, small, m + 8, 8 * n + 2 * t4, v.z, v.w);
}

struct Args {
  CUtensorMap tq, tk, tv, tdo;
  const float* o;    // K2: the forward's o
  const float* lse;  // [B*H, T]
  float* delta;      // [B*H, T]: K2 writes it, K3 reads it
  float* out0;       // dq (K2) or dk (K3)
  float* out1;       // dv (K3)
  int T, H, group, D, P, causal;
  Strides so, s0, s1;
  float scale;
};

// ------------------------------------------------------------------- K2

// qdo_full, k_raw[2], k_full[2], k_empty[2], v_raw, v_full, v_empty, xfull,
// dsfull, dfull
constexpr int kDqBars = 13;

struct DqLayout {
  int q, dout, k, v, ds, recv, dsr, bars, bytes;
};

// K2's shared memory at P blocks a cluster, byte offsets from a 1024-aligned
// base
__host__ __device__ inline DqLayout dq_layout(int P) {
  DqLayout L;
  L.q = 0;
  L.dout = L.q + kStationary;
  L.k = L.dout + kStationary;   // [stage]: K big, K small
  L.v = L.k + 2 * 2 * kPlane;   // V big, V small
  L.ds = L.v + 2 * kPlane;      // ds big, ds small: [64 rows][32 keys]
  L.recv = L.ds + 2 * kOpPlane;  // [s, dp][block][owned group][128 threads] float4
  // [group][128 threads] float4: ds from the other owners; before the first
  // tile, delta's partials [block][64 rows] f32
  L.dsr = L.recv + 2 * P * groups_owned(P) * kGroupBytes;
  L.bars = L.dsr + kTileGroups * kGroupBytes;
  L.bytes = L.bars + kDqBars * 8 + 1024;  // + alignment slack
  return L;
}

__global__ void __launch_bounds__(kWsThreads, 1)
    tf32_wide_dq_kernel(const __grid_constant__ Args a) {
  const int P = a.P;
  const DqLayout L = dq_layout(P);
  const int G = groups_owned(P);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* sQ = reinterpret_cast<float*>(smem + L.q);
  float* sDo = reinterpret_cast<float*>(smem + L.dout);
  float* vb = reinterpret_cast<float*>(smem + L.v);
  float* vs = vb + kPlane / 4;
  float* dsb = reinterpret_cast<float*>(smem + L.ds);
  float* dss = dsb + kOpPlane / 4;
  float4* recv = reinterpret_cast<float4*>(smem + L.recv);
  float4* dsr = reinterpret_cast<float4*>(smem + L.dsr);
  float* sDpart = reinterpret_cast<float*>(smem + L.dsr);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* k_raw = qdo_full + 1;
  uint64_t* k_full = k_raw + 2;
  uint64_t* k_empty = k_full + 2;
  uint64_t* v_raw = k_empty + 2;
  uint64_t* v_full = v_raw + 1;
  uint64_t* v_empty = v_full + 1;
  uint64_t* xfull = v_empty + 1;  // the other blocks' partials of the owned groups landed
  uint64_t* dsfull = xfull + 1;   // the other owners' ds landed
  uint64_t* dfull = dsfull + 1;   // the other blocks' delta partials landed

  const int rank = static_cast<int>(cluster_rank());  // the panel
  const int col0 = rank * kPanel;
  const int T = a.T;
  const int n_q_tiles = (T + kRows - 1) / kRows;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.z);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * kRows;
  const int n_k_tiles = (T + kCols - 1) / kCols;
  // the rows meet keys up to q0 + 63: tiles up to 2 q_tile + 1
  const int n_kv = a.causal ? min(n_k_tiles, 2 * q_tile + 2) : n_k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_raw[s], 1);
      mbar_init(&k_full[s], kSplitThreads);
      mbar_init(&k_empty[s], kWsConsumerThreads);  // both consumers' threads, dq^T done
    }
    mbar_init(v_raw, 1);
    mbar_init(v_full, kSplitThreads);
    mbar_init(v_empty, 128);  // consumer 1's threads, dp done
    mbar_init(xfull, 1);      // each arrival is an arrive.expect_tx of the phase's bytes
    mbar_init(dsfull, 1);
    mbar_init(dfull, 1);
    mbar_init_fence();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: thread 0 loads q and do once, then K tile j into K stage j %
    // 2 and V tile j into the V stage as soon as each is free; warps 1-3
    // split each as it lands
    regs_dec<kProdRegs>();
    const int ptid = threadIdx.x;
    if (ptid == 0) {
      const int h_kv = h / a.group;
      mbar_expect_tx(qdo_full, 2 * kStationary);
      tma_tile<kPanel, kRows>(sQ, &a.tq, qdo_full, h, q0, b, col0);
      tma_tile<kPanel, kRows>(sDo, &a.tdo, qdo_full, h, q0, b, col0);
      for (int j = 0; j < n_kv; ++j) {
        const int ks = j & 1;
        float* kb = reinterpret_cast<float*>(smem + L.k + ks * 2 * kPlane);
        if (j >= 2) mbar_wait(&k_empty[ks], ((j >> 1) - 1) & 1);
        mbar_expect_tx(&k_raw[ks], kPlane);
        tma_tile<kPanel, kCols>(kb, &a.tk, &k_raw[ks], h_kv, j * kCols, b, col0);
        if (j >= 1) mbar_wait(v_empty, (j - 1) & 1);
        mbar_expect_tx(v_raw, kPlane);
        tma_tile<kPanel, kCols>(vb, &a.tv, v_raw, h_kv, j * kCols, b, col0);
      }
    } else if (ptid >= 32) {
      for (int j = 0; j < n_kv; ++j) {
        const int ks = j & 1;
        float* kb = reinterpret_cast<float*>(smem + L.k + ks * 2 * kPlane);
        mbar_wait(&k_raw[ks], (j >> 1) & 1);
        split_planes(kb, kb + kPlane / 4, kCols * kPanel, ptid - 32);
        fence_async_shared();  // the planes, visible to wgmma
        mbar_arrive(&k_full[ks]);
        mbar_wait(v_raw, j & 1);
        split_planes(vb, vs, kCols * kPanel, ptid - 32);
        fence_async_shared();
        mbar_arrive(v_full);
      }
    }
  } else {
    // consumer 0 forms the partial s, consumer 1 the partial dp; consumer c
    // accumulates the panel's dq^T rows [64c, 64c + 64) (its D columns)
    regs_inc<kConsRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int m_a = 16 * warp + g;  // the rows of the score accumulators: m_a, m_a + 8
    const int row_a = q0 + m_a;
    const int row_b = row_a + 8;
    const int64_t lrow = static_cast<int64_t>(bh) * T;
    const int own0 = group0(rank, P);
    const int n_own = group0(rank + 1, P) - own0;

    // delta's partial over the panel's columns below the real D, four
    // threads a row (32 columns each): do from its tile, o from global
    // memory; sent to every block, each of which adds the P partials of its
    // rows in rank order
    if (c == 0 && tid == 0) mbar_expect_tx(dfull, (P - 1) * kRows * 4);
    mbar_wait(qdo_full, 0);
    {
      const int r = 32 * c + tid / 4;
      const int row = q0 + r;
      const int lc0 = 32 * (tid & 3);
      float sum = 0.f;
      if (row < T) {
        const float* orow = at(a.o, a.so, b, h) + row * a.so.t + col0;
#pragma unroll
        for (int cc = 0; cc < 32; cc += 4) {
          const int lc = lc0 + cc;
          if (col0 + lc >= a.D) break;
          const float4 d4 = *reinterpret_cast<const float4*>(sDo + sw<kRows>(r, lc));
          const float4 o4 = *reinterpret_cast<const float4*>(orow + lc);
          sum = fmaf(d4.x, o4.x, sum);
          sum = fmaf(d4.y, o4.y, sum);
          sum = fmaf(d4.z, o4.z, sum);
          sum = fmaf(d4.w, o4.w, sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((tid & 3) == 0) {
        broadcast(reinterpret_cast<unsigned char*>(sDpart + rank * kRows + r), dfull, sum, P,
                  rank);
      }
    }
    named_barrier(1, kWsConsumerThreads);  // this block's partials stored
    mbar_wait_cluster(dfull, 0);
    float dl_a = 0.f, dl_b = 0.f;
    for (int src = 0; src < P; ++src) {
      dl_a += sDpart[src * kRows + m_a];
      dl_b += sDpart[src * kRows + m_a + 8];
    }
    // the partials share ds's receive buffer, which the other owners fill
    // from the first tile on
    named_barrier(1, kWsConsumerThreads);
    if (rank == 0 && c == 0 && t4 == 0) {
      if (row_a < T) a.delta[lrow + row_a] = dl_a;
      if (row_b < T) a.delta[lrow + row_b] = dl_b;
    }
    // rows past T: lse = +inf, so p = 0
    const float lb_a = row_a < T ? a.lse[lrow + row_a] * kLog2e : CUDART_INF_F;
    const float lb_b = row_b < T ? a.lse[lrow + row_b] * kLog2e : CUDART_INF_F;

    const float* sA = c == 0 ? sQ : sDo;
    const float mul = c == 0 ? a.scale : 1.f;
    const uint64_t dDsb = desc_sw128(dsb, 16), dDss = desc_sw128(dss, 16);
    float acc[kRows / 2];
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < n_kv; ++j) {
      const int ks = j & 1;
      float* kb = reinterpret_cast<float*>(smem + L.k + ks * 2 * kPlane);
      float* kbs = kb + kPlane / 4;
      if (c == 0 && tid == 0) {  // the last tile's waits are done: arm this tile's
        if (n_own > 0) mbar_expect_tx(xfull, (P - 1) * n_own * 2 * kGroupBytes);
        mbar_expect_tx(dsfull, (kTileGroups - n_own) * kGroupBytes);
      }

      // the panel's partial s = qs k^T (consumer 0) or dp = do v^T (1);
      // both read the K planes, in dq^T
      mbar_wait(&k_full[ks], (j >> 1) & 1);
      if (c == 1) mbar_wait(v_full, j & 1);
      float x[kCols / 2];
      panel_scores(x, sA, mul, m_a, t4, desc_sw128(c == 0 ? kb : vb, 16),
                   desc_sw128(c == 0 ? kbs : vs, 16));
      if (c == 1) mbar_arrive(v_empty);

      // every group's partial to its owner, this block's own groups too
#pragma unroll
      for (int n = 0; n < kTileGroups; ++n) {
        const int o = group_owner(n, P);
        send(recv + ((c * P + rank) * G + n - group0(o, P)) * 128 + tid, xfull,
             group4(x + 4 * n), o, rank);
      }
      named_barrier(1, kWsConsumerThreads);  // both consumers' own-group partials stored

      // the groups this block owns: the partials added in rank order, then
      // p and ds, into this block's planes and to every other block
      const int k0 = j * kCols;
      const bool mask = k0 + kCols > T || (a.causal && k0 + kCols - 1 > q0);
      if (c < n_own) mbar_wait_cluster(xfull, j & 1);
      for (int k = c; k < n_own; k += 2) {
        const int n = own0 + k;
        const float4 st = sum_partials(recv + k * 128 + tid, G * 128, P);
        const float4 dt = sum_partials(recv + (P * G + k) * 128 + tid, G * 128, P);
        const float sv[4] = {st.x, st.y, st.z, st.w};
        const float dv[4] = {dt.x, dt.y, dt.z, dt.w};
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool top = i < 2;  // row_a, else row_b
          float p = exp2f(fmaf(sv[i], kLog2e, top ? -lb_a : -lb_b));
          if (mask) {
            const int key = k0 + 8 * n + 2 * t4 + (i & 1);
            if (key >= T || (a.causal && key > (top ? row_a : row_b))) p = 0.f;
          }
          e[i] = p * (dv[i] - (top ? dl_a : dl_b));
        }
        const float4 ds4 = make_float4(e[0], e[1], e[2], e[3]);
        store_group(dsb, dss, m_a, n, t4, ds4);
        send_others(dsr + n * 128 + tid, dsfull, ds4, P, rank);
      }

      // the other owners' groups into the planes, group n by consumer n % 2
      mbar_wait_cluster(dsfull, j & 1);
      for (int n = c; n < kTileGroups; n += 2) {
        if (n < own0 || n >= own0 + n_own) store_group(dsb, dss, m_a, n, t4, dsr[n * 128 + tid]);
      }
      fence_async_shared();
      named_barrier(1, kWsConsumerThreads);  // the whole ds tile's planes stored

      // dq^T += k^T ds^T: M = the panel's columns [64c, 64c + 64), N = the
      // 64 rows, k-step kk = keys [8kk, 8kk + 8)
      out_part(acc, kb, kbs, 64 * c + m_a, t4, dDsb, dDss);
      mbar_arrive(&k_empty[ks]);
    }

    // dq = scale dq^T, stored transposed: element idx is D column 64c + m_a
    // (+8 if idx & 2) of the panel, row 8 (idx >> 2) + 2 t4 + (idx & 1)
    float* dqp = at(a.out0, a.s0, b, h);
#pragma unroll
    for (int idx = 0; idx < kRows / 2; ++idx) {
      const int col = col0 + 64 * c + m_a + ((idx & 2) ? 8 : 0);
      const int row = q0 + 8 * (idx >> 2) + 2 * t4 + (idx & 1);
      if (col < a.D && row < T) dqp[row * a.s0.t + col] = acc[idx] * a.scale;
    }
  }
  cluster_sync();
}

// ------------------------------------------------------------------- K3

// kv_full, q_raw[2], q_full[2], q_empty[2], d_raw[2], d_full[2], d_empty[2],
// xfull, tfull
constexpr int kDkvBars = 15;

struct DkvLayout {
  int q_stages, do_stages;  // ring depths: 2 where they fit, else 1
  int k, v, q, dout, p, ds, recv, tr, lse, delta, bars, bytes;
};

// K3's shared memory at P blocks a cluster, byte offsets from a 1024-aligned
// base
__host__ __device__ inline DkvLayout dkv_layout(int P) {
  const int recv = 2 * P * groups_owned(P) * kGroupBytes;
  const int rest = 2 * kStationary + 4 * kOpPlane + recv + 2 * kTileGroups * kGroupBytes +
                   2 * 2 * kCols * 4 + kDkvBars * 8 + 1024;  // + alignment slack
  DkvLayout L;
  L.q_stages = rest + 3 * 2 * kPlane <= kSmemMax ? 2 : 1;
  L.do_stages = rest + (L.q_stages + 2) * 2 * kPlane <= kSmemMax ? 2 : 1;
  L.k = 0;
  L.v = L.k + kStationary;
  L.q = L.v + kStationary;                        // [stage]: qs big, qs small
  L.dout = L.q + L.q_stages * 2 * kPlane;         // [stage]: do big, do small
  L.p = L.dout + L.do_stages * 2 * kPlane;        // p^T big, small: [64 keys][32 q rows]
  L.ds = L.p + 2 * kOpPlane;                      // ds^T big, small
  L.recv = L.ds + 2 * kOpPlane;                   // [s^T, dp^T][block][owned group][128] float4
  L.tr = L.recv + recv;                           // [p^T, ds^T][group][128 threads] float4
  L.lse = L.tr + 2 * kTileGroups * kGroupBytes;   // [q stage][32 rows]: lse x log2 e
  L.delta = L.lse + L.q_stages * kCols * 4;       // [q stage][32 rows]
  L.bars = L.delta + L.q_stages * kCols * 4;
  L.bytes = L.bars + kDkvBars * 8 + 1024;
  return L;
}

__global__ void __launch_bounds__(kWsThreads, 1)
    tf32_wide_dkv_kernel(const __grid_constant__ Args a) {
  const int P = a.P;
  const DkvLayout L = dkv_layout(P);
  const int G = groups_owned(P);
  const int SQ = L.q_stages;
  const int SD = L.do_stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* sK = reinterpret_cast<float*>(smem + L.k);
  float* sV = reinterpret_cast<float*>(smem + L.v);
  float* pb = reinterpret_cast<float*>(smem + L.p);
  float* ps = pb + kOpPlane / 4;
  float* dsb = reinterpret_cast<float*>(smem + L.ds);
  float* dss = dsb + kOpPlane / 4;
  float4* recv = reinterpret_cast<float4*>(smem + L.recv);
  float4* tr = reinterpret_cast<float4*>(smem + L.tr);
  float* sLb = reinterpret_cast<float*>(smem + L.lse);
  float* sDelta = reinterpret_cast<float*>(smem + L.delta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* q_raw = kv_full + 1;
  uint64_t* q_full = q_raw + 2;
  uint64_t* q_empty = q_full + 2;
  uint64_t* d_raw = q_empty + 2;
  uint64_t* d_full = d_raw + 2;
  uint64_t* d_empty = d_full + 2;
  uint64_t* xfull = d_empty + 2;  // the other blocks' partials of the owned groups landed
  uint64_t* tfull = xfull + 1;    // the other owners' p^T and ds^T landed

  const int rank = static_cast<int>(cluster_rank());  // the panel
  const int col0 = rank * kPanel;
  const int T = a.T;
  const int h_kv_count = a.H / a.group;
  const int b = blockIdx.y / h_kv_count;
  const int h_kv = blockIdx.y % h_kv_count;
  const int k0 = blockIdx.z * kRows;  // z = 0, the heaviest tiles, is scheduled first
  const int n_q_tiles = (T + kCols - 1) / kCols;
  const int first = a.causal ? k0 / kCols : 0;  // earlier q tiles see none of these keys
  const int per_head = n_q_tiles - first;
  const int n_iter = a.group * per_head;  // q tile `it % per_head` of head `it / per_head`

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_raw[s], 1);
      // warp 0's lanes (lse and delta stored) and the split warps (split done)
      mbar_init(&q_full[s], 32 + kSplitThreads);
      mbar_init(&q_empty[s], 128);  // consumer A's threads, dk^T done
      mbar_init(&d_raw[s], 1);
      mbar_init(&d_full[s], kSplitThreads);
      mbar_init(&d_empty[s], 128);  // consumer B's threads, dv^T done
    }
    mbar_init(xfull, 1);  // each arrival is an arrive.expect_tx of the phase's bytes
    mbar_init(tfull, 1);
    mbar_init_fence();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: warp 0 loads each q and do tile as soon as its stage is free
    // (lane 0) and stores the q tile's lse and delta (the 32 lanes); warps
    // 1-3 split each tile as it lands
    regs_dec<kProdRegs>();
    const int ptid = threadIdx.x;
    if (ptid < 32) {
      if (ptid == 0) {
        mbar_expect_tx(kv_full, 2 * kStationary);
        tma_tile<kPanel, kRows>(sK, &a.tk, kv_full, h_kv, k0, b, col0);
        tma_tile<kPanel, kRows>(sV, &a.tv, kv_full, h_kv, k0, b, col0);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int hq = h_kv * a.group + it / per_head;
        const int r0 = (first + it % per_head) * kCols;
        const int qs = stage_of(it, SQ);
        if (it >= SQ) mbar_wait(&q_empty[qs], round_of(it, SQ) ^ 1);
        if (ptid == 0) {
          float* qb = reinterpret_cast<float*>(smem + L.q + qs * 2 * kPlane);
          mbar_expect_tx(&q_raw[qs], kPlane);
          tma_tile<kPanel, kCols>(qb, &a.tq, &q_raw[qs], hq, r0, b, col0);
        }
        const int64_t lrow = static_cast<int64_t>(b * a.H + hq) * T;
        const int row = r0 + ptid;
        sLb[qs * kCols + ptid] = row < T ? a.lse[lrow + row] * kLog2e : CUDART_INF_F;
        sDelta[qs * kCols + ptid] = row < T ? a.delta[lrow + row] : 0.f;
        mbar_arrive(&q_full[qs]);  // releases this lane's stores
        const int dst = stage_of(it, SD);
        if (it >= SD) mbar_wait(&d_empty[dst], round_of(it, SD) ^ 1);
        if (ptid == 0) {
          float* db = reinterpret_cast<float*>(smem + L.dout + dst * 2 * kPlane);
          mbar_expect_tx(&d_raw[dst], kPlane);
          tma_tile<kPanel, kCols>(db, &a.tdo, &d_raw[dst], hq, r0, b, col0);
        }
      }
    } else {
      for (int it = 0; it < n_iter; ++it) {
        const int qs = stage_of(it, SQ);
        float* qb = reinterpret_cast<float*>(smem + L.q + qs * 2 * kPlane);
        mbar_wait(&q_raw[qs], round_of(it, SQ));
        split_scaled(qb, qb + kPlane / 4, kCols * kPanel, ptid - 32, a.scale);
        fence_async_shared();
        mbar_arrive(&q_full[qs]);
        const int dst = stage_of(it, SD);
        float* db = reinterpret_cast<float*>(smem + L.dout + dst * 2 * kPlane);
        mbar_wait(&d_raw[dst], round_of(it, SD));
        split_planes(db, db + kPlane / 4, kCols * kPanel, ptid - 32);
        fence_async_shared();
        mbar_arrive(&d_full[dst]);
      }
    }
  } else {
    // consumers A (wg 1: s^T and dk^T, the q ring) and B (wg 2: dp^T and
    // dv^T, the do ring), both over the block's 64 keys and its panel
    regs_inc<kConsRegs>();
    const bool is_a = wg == 1;
    const int ab = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int m_a = 16 * warp + g;  // keys of the score accumulators: m_a, m_a + 8
    const int key_a = k0 + m_a;
    const int key_b = key_a + 8;
    const int own0 = group0(rank, P);
    const int n_own = group0(rank + 1, P) - own0;

    const float* sA = is_a ? sK : sV;  // the A operand of the score product
    // the B planes of the output product: A's ds^T, B's p^T
    float* ob = is_a ? dsb : pb;
    float* os = is_a ? dss : ps;
    const uint64_t dOb = desc_sw128(ob, 16), dOs = desc_sw128(os, 16);
    float acc[2][kRows / 2];  // dk^T (A) or dv^T (B), by 64-column M block
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) acc[mb][i] = 0.f;
    }
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int qs = stage_of(it, SQ);
      const int dst = stage_of(it, SD);
      const int r0 = (first + it % per_head) * kCols;
      // this consumer's streamed planes: A the q stage's, B the do stage's
      float* tb = reinterpret_cast<float*>(is_a ? smem + L.q + qs * 2 * kPlane
                                                : smem + L.dout + dst * 2 * kPlane);
      float* ts = tb + kPlane / 4;
      if (is_a && tid == 0) {  // the last tile's waits are done: arm this tile's
        if (n_own > 0) mbar_expect_tx(xfull, (P - 1) * n_own * 2 * kGroupBytes);
        mbar_expect_tx(tfull, (kTileGroups - n_own) * 2 * kGroupBytes);
      }
      // A: its B operand; both: the q tile's lse and delta
      mbar_wait(&q_full[qs], round_of(it, SQ));
      if (!is_a) mbar_wait(&d_full[dst], round_of(it, SD));

      // the panel's partial s^T = k qs^T (A) or dp^T = v do^T (B)
      float x[kCols / 2];
      panel_scores(x, sA, 1.f, m_a, t4, desc_sw128(tb, 16), desc_sw128(ts, 16));

      // every group's partial to its owner, this block's own groups too
#pragma unroll
      for (int n = 0; n < kTileGroups; ++n) {
        const int o = group_owner(n, P);
        send(recv + ((ab * P + rank) * G + n - group0(o, P)) * 128 + tid, xfull,
             group4(x + 4 * n), o, rank);
      }
      named_barrier(1, kWsConsumerThreads);  // both consumers' own-group partials stored

      // the groups this block owns: p^T = exp(s^T - lse) and ds^T = p^T
      // (dp^T - delta), into this block's planes and to every other block.
      // The columns are q rows: lse (times log2 e) and delta are per column.
      // Only the causal diagonal and a ragged last tile are masked; rows at
      // or past T have lse = +inf, so p^T = 0.
      const bool mask = (a.causal && r0 < k0 + kRows) || r0 + kCols > T;
      const float* lb = sLb + qs * kCols;
      const float* dl = sDelta + qs * kCols;
      if (ab < n_own) mbar_wait_cluster(xfull, it & 1);
      for (int k = ab; k < n_own; k += 2) {
        const int n = own0 + k;
        const float4 st = sum_partials(recv + k * 128 + tid, G * 128, P);
        const float4 dt = sum_partials(recv + (P * G + k) * 128 + tid, G * 128, P);
        const float sv[4] = {st.x, st.y, st.z, st.w};
        const float dv[4] = {dt.x, dt.y, dt.z, dt.w};
        float p[4], e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * n + 2 * t4 + (i & 1);
          const int row = r0 + col;
          const int key = (i & 2) ? key_b : key_a;
          const bool dead = mask && (row >= T || (a.causal && key > row));
          p[i] = dead ? 0.f : exp2f(fmaf(sv[i], kLog2e, -lb[col]));
          e[i] = p[i] * (dv[i] - dl[col]);
        }
        const float4 p4 = make_float4(p[0], p[1], p[2], p[3]);
        const float4 ds4 = make_float4(e[0], e[1], e[2], e[3]);
        store_group(pb, ps, m_a, n, t4, p4);
        store_group(dsb, dss, m_a, n, t4, ds4);
        send_others(tr + n * 128 + tid, tfull, p4, P, rank);
        send_others(tr + (kTileGroups + n) * 128 + tid, tfull, ds4, P, rank);
      }

      // the other owners' groups into the planes: A ds^T, B p^T
      mbar_wait_cluster(tfull, it & 1);
      const float4* got = tr + (is_a ? kTileGroups : 0) * 128 + tid;
#pragma unroll
      for (int n = 0; n < kTileGroups; ++n) {
        if (n < own0 || n >= own0 + n_own) store_group(ob, os, m_a, n, t4, got[n * 128]);
      }
      fence_async_shared();
      named_barrier(1, kWsConsumerThreads);  // the whole tile's planes stored

      // A: dk^T += qs^T ds, B: dv^T += do^T p: M = the panel's columns
      // (block mb: [64mb, 64mb + 64)), N = the 64 keys, k-step kk = q rows
      // [8kk, 8kk + 8)
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) out_part(acc[mb], tb, ts, 64 * mb + m_a, t4, dOb, dOs);
      mbar_arrive(is_a ? &q_empty[qs] : &d_empty[dst]);
    }

    // dk (A; q carried the scale) and dv (B), stored transposed: element idx
    // of block mb is D column 64mb + m_a (+8 if idx & 2) of the panel, key 8
    // (idx >> 2) + 2 t4 + (idx & 1)
    float* out = at(is_a ? a.out0 : a.out1, is_a ? a.s0 : a.s1, b, h_kv);
    const int64_t ost = is_a ? a.s0.t : a.s1.t;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int idx = 0; idx < kRows / 2; ++idx) {
        const int col = col0 + 64 * mb + m_a + ((idx & 2) ? 8 : 0);
        const int key = k0 + 8 * (idx >> 2) + 2 * t4 + (idx & 1);
        if (col < a.D && key < T) out[key * ost + col] = acc[mb][idx];
      }
    }
  }
  cluster_sync();
}

// ------------------------------------------------------------- launching

template <bool kDkv>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static bool attr_set = false;
  // the panels along x, one cluster of them; 64-row (K2) or 64-key (K3)
  // tiles along z, heaviest first
  const dim3 grid(a.P, B * (kDkv ? a.H / a.group : a.H), (a.T + kRows - 1) / kRows);
  const int smem = kDkv ? dkv_layout(a.P).bytes : dq_layout(a.P).bytes;
  return launch_clusters(kDkv ? tf32_wide_dkv_kernel : tf32_wide_dq_kernel, a, grid, a.P, smem,
                         stream, attr_set);
}

// the four tensor maps (q and do boxes of q_rows rows, k and v of kv_rows;
// s the element strides of q, k, v, do) and the arguments every launch shares
int base_args(Args& a, const void* q, const void* k, const void* v, const void* dout, int B,
              int T, int H, int H_kv, int D, int causal, int q_rows, int kv_rows,
              const int64_t* s) {
  int err = make_f32_map(&a.tq, q, B, T, H, D, s[0], s[1], s[2], q_rows);
  if (err == 0) err = make_f32_map(&a.tk, k, B, T, H_kv, D, s[3], s[4], s[5], kv_rows);
  if (err == 0) err = make_f32_map(&a.tv, v, B, T, H_kv, D, s[6], s[7], s[8], kv_rows);
  if (err == 0) err = make_f32_map(&a.tdo, dout, B, T, H, D, s[9], s[10], s[11], q_rows);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.P = f32_panels(D);
  a.causal = causal != 0;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  return err;
}

}  // namespace

// K2. q, o, do [B, T, H, D] and k/v [B, T, H_kv, D] in f32, dq [B, T, H, D]
// in f32, addressed through the given element strides (D contiguous, every
// row 16-byte aligned, strides positive), 128 < D <= 1024; lse [B*H, T] f32
// from the forward; delta [B*H, T] f32 is written for K3. in_type and
// out_type are the generic family's codes and must both be 2 (f32). Returns
// 0, the CUresult of a tensor map that could not be encoded, or the
// cudaError_t of the launch.
extern "C" int hived_flash_tf32_wide_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int T, int H, int H_kv, int D, int causal,
    int in_type, int out_type, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
    int64_t o_st, int64_t o_sh, int64_t do_sb, int64_t do_st, int64_t do_sh, int64_t dq_sb,
    int64_t dq_st, int64_t dq_sh, void* stream) {
  if (bad_f32_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t s[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                         v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  Args a = {};
  const int err = base_args(a, q, k, v, dout, B, T, H, H_kv, D, causal, kRows, kCols, s);
  if (err != 0) return err;
  a.o = static_cast<const float*>(o);
  a.so = {o_sb, o_st, o_sh};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.out0 = static_cast<float*>(dq);
  a.s0 = {dq_sb, dq_st, dq_sh};
  return static_cast<int>(launch<false>(a, B, static_cast<cudaStream_t>(stream)));
}

// K3. q, do [B, T, H, D] and k/v [B, T, H_kv, D] in f32, dk/dv [B, T, H_kv,
// D] in f32, through their element strides, 128 < D <= 1024; lse and delta
// [B*H, T] f32 (delta from K2). The GQA group sum is inside the kernel. The
// type codes as K2's. Returns 0, the CUresult of a tensor map that could not
// be encoded, or the cudaError_t of the launch.
extern "C" int hived_flash_tf32_wide_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int T, int H, int H_kv, int D, int causal,
    int in_type, int out_type, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t do_sb,
    int64_t do_st, int64_t do_sh, int64_t dk_sb, int64_t dk_st, int64_t dk_sh, int64_t dv_sb,
    int64_t dv_st, int64_t dv_sh, void* stream) {
  if (bad_f32_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t s[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                         v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  Args a = {};
  const int err = base_args(a, q, k, v, dout, B, T, H, H_kv, D, causal, kCols, kRows, s);
  if (err != 0) return err;
  a.lse = static_cast<const float*>(lse);
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.out0 = static_cast<float*>(dk);
  a.s0 = {dk_sb, dk_st, dk_sh};
  a.out1 = static_cast<float*>(dv);
  a.s1 = {dv_sb, dv_st, dv_sh};
  return static_cast<int>(launch<true>(a, B, static_cast<cudaStream_t>(stream)));
}

// The clusters of K2 (dkv 0) or K3 (dkv 1) at head dim D that the card holds
// at once, or -1 - the cudaError_t of the query.
extern "C" int hived_flash_tf32_wide_clusters(int D, int dkv) {
  const int P = f32_panels(D);
  static bool dq_set = false, dkv_set = false;
  return dkv ? max_clusters(tf32_wide_dkv_kernel, P, dkv_layout(P).bytes, dkv_set)
             : max_clusters(tf32_wide_dq_kernel, P, dq_layout(P).bytes, dq_set);
}
