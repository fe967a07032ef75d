// Flash-attention backward for Hopper (sm_90a): dq (K2) and dk/dv (K3),
// bf16 in, f32 accumulation, no atomics.
//
// Replaces hivedscheduler_tpu/ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (both launched by _flash_backward). They compute the same
// functions from the forward's o and lse: for every (batch, q head), with
// scale = 1/sqrt(D),
//   s = scale * q k^T under the causal mask (NEG_INF = -1e30),
//   p = exp(s - lse),  dp = do v^T,  delta = rowsum(do * o),
//   ds = p * (dp - delta),
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T do.
// GQA is read in place (q head h uses kv head h / (H / H_kv)); K3 folds the
// sum over a kv head's q-head group into its own loop, so no per-q-head f32
// partials are written and nothing is reduced afterwards. lse is [B*H, T].
//
// Bound on an H100: K2 does three products of 2*D flops per (row, key) pair
// the mask leaves (q k^T, do v^T, ds k) and K3 four (q k^T and do v^T again,
// p^T do, ds^T q). At the flagship shape (B=8, T=2048, H=16, H_kv=8, D=128,
// causal) that is 206.3 and 275.0 GFLOP, 0.209 and 0.278 ms at
// 989 TFLOP/s, against 0.10 and 0.08 ms for their bytes at 3.35 TB/s: the
// tensor cores bound both.
//
// Every output element is owned by one block, so a run is bit-reproducible.
//
// K2 (hopper.cuh has the building blocks): wgmma on TMA-fed shared tiles,
// with a producer warpgroup and two consumer warpgroups, like K1.
// - One block of three warpgroups per (b*h, 128-row q tile), heaviest
//   causal tiles first. The producer's one thread TMA-loads the q and do
//   tiles once, then streams 64-key K/V tiles up to the causal diagonal
//   through a two-stage ring of full/empty mbarrier pairs (at D=128,
//   32 + 32 + 2 x (16 + 16) KB).
// - Each consumer warpgroup owns 64 q rows. Before the loop it computes
//   delta = rowsum(do * o) in f32 for its rows (do from the swizzled shared
//   tile, o from global memory) and writes it to a [B*H, T] f32 buffer that
//   K3 reads instead of o. Per tile: s = q k^T and dp = do v^T as SS wgmma
//   m64n64k16 (32 f32 registers each); p = exp(s - lse) and ds = p (dp -
//   delta) in f32; ds, rounded to bf16 only as the A operand in registers,
//   times K as the MN-major B operand, accumulates dq as RS wgmma
//   m64n{D}k16. So no operand is read with scalar shared loads.
// - Only a consumer's last tile is masked (its causal diagonal, or the keys
//   at or past a ragged T): there p = 0 exactly where the TPU kernel's
//   NEG_INF makes exp underflow to 0. A consumer's rows past T get lse =
//   +inf, so their p is 0; TMA loads rows past T as zeros.
//
// K3 (the same building blocks): key-stationary, as the TPU kernel is.
// - One block of three warpgroups per (b*h_kv, 64-key tile), key tile 0
//   (which meets every q tile under the causal mask) first. The producer's
//   thread TMA-loads the K and V tiles once, then streams 64-row q and do
//   tiles of every q head of the GQA group, each from the causal diagonal
//   on, through a three-stage ring of full/empty mbarrier pairs (at D=128,
//   16 + 16 + 3 x (16 + 16) KB). The ring spans the head boundaries: its
//   phases run on across them.
// - lse and delta reach shared memory by plain loads of the producer's
//   warp, not by TMA: a tensor map or bulk copy over [B*H, T] f32 needs a
//   16-byte row stride, T % 4 == 0, and T is any length here. The 32 lanes
//   store the stage's 64 + 64 floats (lse times log2 e, and +inf and 0 for
//   rows past T), and each lane arrives on the stage's full barrier after
//   its own stores (the barrier counts 32 such arrivals beside the TMA
//   thread's expect_tx), so no lane's stores rely on another's arrival.
// - The two consumer warpgroups split the products, not the keys: A
//   computes s^T = k q^T (SS wgmma m64n64k16, q rows along the columns) and
//   p^T = exp(scale s^T - lse), and accumulates dv += p^T do; B computes
//   dp^T = v do^T and ds^T = p^T (dp^T - delta) with A's p^T, and
//   accumulates dk += ds^T q. A hands p^T to B in f32 through two
//   shared-memory buffers (thread-major, so B's thread t reads the values
//   of A's thread t; p_full/p_empty mbarriers), so ds^T is formed from the
//   f32 p^T, as in the TPU kernel. Each stores its p^T or ds^T as bf16 in a
//   128-byte swizzled 64 x 64 tile, and dv and dk are SS wgmma m64n{D}k16
//   with that tile K-major and the stage's do or q tile MN-major.
// - Why split by product: a consumer that owned its keys' dk and dv (64 +
//   64 f32 a thread at D=128) beside s^T and dp^T (32 + 32) was past what
//   ptxas would allocate under setmaxnreg 240 (160 or more accumulator
//   registers serialized every wgmma, with spills, in each layout tried:
//   RS or SS dk/dv products, n-halves of D, one or two score tiles live);
//   with 64 + 32 accumulator registers each consumer's wgmmas pipeline.
// - Masking: only A's tile at the causal diagonal (the head's first q tile)
//   and a ragged last tile are compared; there s^T = -inf, so p^T = 0 for
//   causal pairs (where the TPU kernel's NEG_INF makes exp underflow to 0)
//   and for rows past T, and ds^T = 0 with it.
// Inputs are addressed through their [B, T, H, D] strides (D contiguous).
//
// Head dims: as K1 (flash_fwd.cu), any D that is a multiple of 8 up to 256
// runs on the template of its padded width Dp = 64, 128 or 256. TMA fills
// the columns of a box past the real D with zeros and credits the whole box
// to the stage's barrier, so the expect_tx counts stay the full tiles'
// bytes; zero columns of q, k, v and do add nothing to s, dp, dq, dk or dv.
// K2's delta reads o from global memory only below D, and every epilogue
// stores only columns < D. The scale is the real D's.
//
// Dp = 256 (Gemma's head dim). A whole-width accumulator is 128 f32
// registers a thread there, and K2's dq beside s and dp (192), or K3's dv
// beside s^T and dk beside dp^T (160 each), is the load that serialized
// every wgmma with spills (see K3's note below). So at Dp = 256 the outputs'
// columns are split in halves of 128 and every consumer keeps 64 + 32 + 32
// or 64 + 32 accumulator registers, as at Dp = 128:
// - K2: a block takes 64 q rows (not 128), and its two consumers both
//   compute s and dp over the whole D for those rows, consumer c
//   accumulating dq's columns [128c, 128c + 128). Shared memory: q 32 + do
//   32 + 2 x (32 + 32) KB = 192 KB. The score products run twice: 5/3 of
//   the real work (s, dp, dq).
// - K3: the grid takes the column half as its z index, so two blocks share
//   a key tile: each computes s^T and dp^T over the whole D and keeps dk
//   and dv for its half. Two q/do stages, not three, and one f32 p^T
//   buffer, not two: 32 + 32 + 2 x (32 + 32) + 8 + 8 + 16 KB = 224 KB,
//   under the 227 KB a block may have. The score products run twice: 3/2
//   of the real work (s^T, dp^T, dv, dk).
// Each output element is still owned by one block, with no atomics.
//
// Output type: dq, dk and dv are stored in bf16 (hived_flash_bwd_dq,
// hived_flash_bwd_dkv) or in f32 (the _f32 entry points), the counterpart
// of _flash_backward's grad_dtype=f32, which the sequence-parallel ring
// calls once a hop and sums over hops in f32. Only the epilogues' stores
// differ; K3's GQA group sum stays inside the kernel either way (the TPU
// kernel's caller sums f32 per-q-head partials and then casts).

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hived;

struct Strides {
  int64_t b, t, h;
};

template <typename T>
__device__ __forceinline__ T* at(T* base, const Strides& s, int b, int h) {
  return base + b * s.b + h * s.h;
}

// ------------------------------------------------------------------- K2

constexpr int kDqBlockN = 64;  // keys per K/V tile
constexpr int kDqStages = 2;   // K/V ring depth

// q rows per block at the padded width Dp: 128, the two consumer warpgroups
// 64 each; at Dp = 256, 64, both consumers on the same rows
constexpr int dq_block_m(int Dp) { return Dp > 128 ? 64 : 128; }

// shared-memory layout, byte offsets from a 1024-aligned base
template <int D>
struct DqSmem {
  static constexpr bool kSplitD = D > 128;          // consumers split dq's columns
  static constexpr int kBlockM = dq_block_m(D);
  static constexpr int kAccD = kSplitD ? D / 2 : D;  // dq columns a consumer owns
  static constexpr int kQTile = kBlockM * D * 2;     // q or do
  static constexpr int kKTile = kDqBlockN * D * 2;   // k or v
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kQTile;
  static constexpr int kK = kDo + kQTile;
  static constexpr int kV = kK + kDqStages * kKTile;
  static constexpr int kLse = kV + kDqStages * kKTile;  // 64 f32 a consumer
  static constexpr int kDelta = kLse + 128 * 4;        // 64 f32 a consumer
  static constexpr int kBars = kDelta + 128 * 4;       // qdo_full, kv_full[], empty[]
  static constexpr int kBytes = kBars + (1 + 2 * kDqStages) * 8 + 1024;  // + alignment slack
};

struct DqArgs {
  CUtensorMap tq, tk, tv, tdo;
  const bf16* o;
  const float* lse;
  float* delta;
  void* dq;  // bf16 or f32, the kernel's OutT
  int T, H, group;
  int D;  // the real head dim; the kernel runs at its template's padded width
  Strides so, sdq;
  float scale;
};

// ds = p (dp - delta) of one tile, p = exp(scale s - lse), packed to bf16 as
// the A operand of ds k (k-step kk: keys [16kk, 16kk + 16)); on the last tile
// p = 0 for keys past T and, causal, past the row
template <bool kMask, bool kCausal>
__device__ __forceinline__ void ds_tile(uint32_t (&ds)[kDqBlockN / 16][4],
                                        const float (&s)[kDqBlockN / 2],
                                        const float (&dp)[kDqBlockN / 2], float scale_log2,
                                        float lb_a, float lb_b, float dl_a, float dl_b, int k0,
                                        int row_a, int t4, int T) {
#pragma unroll
  for (int kk = 0; kk < kDqBlockN / 16; ++kk) {
    float e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool top = (i & 2) == 0;  // row_a, else row_a + 8
      float p = exp2f(fmaf(s[8 * kk + i], scale_log2, top ? -lb_a : -lb_b));
      if (kMask) {
        const int col = k0 + 16 * kk + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = top ? row_a : row_a + 8;
        if (col >= T || (kCausal && col > row)) p = 0.f;
      }
      e[i] = p * (dp[8 * kk + i] - (top ? dl_a : dl_b));
    }
    ds[kk][0] = pack_f32(e[0], e[1]);
    ds[kk][1] = pack_f32(e[2], e[3]);
    ds[kk][2] = pack_f32(e[4], e[5]);
    ds[kk][3] = pack_f32(e[6], e[7]);
  }
}

template <int D, bool kCausal, typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ DqArgs a) {
  using L = DqSmem<D>;
  constexpr int kBlockM = L::kBlockM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sDo = reinterpret_cast<bf16*>(smem + L::kDo);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = qdo_full + 1;
  uint64_t* empty = kv_full + kDqStages;

  const int T = a.T;
  const int n_q_tiles = (T + kBlockM - 1) / kBlockM;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * kBlockM;
  const int n_k_tiles = (T + kDqBlockN - 1) / kDqBlockN;
  // consumer c's rows meet keys up to their diagonal, tile 2 q_tile + c (at
  // Dp = 256 both consumers' rows: tile q_tile)
  const int n_kv =
      kCausal ? min(n_k_tiles, L::kSplitD ? q_tile + 1 : 2 * q_tile + 2) : n_k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&empty[s], kWsConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread starts every load
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int h_kv = h / a.group;
      mbar_expect_tx(qdo_full, 2 * L::kQTile);
      tma_load_tile<D, kBlockM>(sQ, &a.tq, qdo_full, h, q0, b);
      tma_load_tile<D, kBlockM>(sDo, &a.tdo, qdo_full, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int stage = j % kDqStages;
        if (j >= kDqStages) mbar_wait(&empty[stage], ((j / kDqStages) - 1) & 1);
        mbar_expect_tx(&kv_full[stage], 2 * L::kKTile);
        tma_load_tile<D, kDqBlockN>(sK + stage * kDqBlockN * D, &a.tk, &kv_full[stage], h_kv,
                                    j * kDqBlockN, b);
        tma_load_tile<D, kDqBlockN>(sV + stage * kDqBlockN * D, &a.tv, &kv_full[stage], h_kv,
                                    j * kDqBlockN, b);
      }
    }
    return;
  }

  // consumer c owns q rows [64c, 64c + 64) of the tile, all of dq's
  // columns; at Dp = 256 the tile's 64 rows, dq's columns [128c, 128c + 128)
  regs_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rows_c = L::kSplitD ? 0 : 64 * c;       // the consumer's first row in the tile
  const int col_c = L::kSplitD ? L::kAccD * c : 0;  // its first dq column
  const int r0 = rows_c + 16 * warp;                // the warp's first row in the tile
  // the warp's 16 lse and delta values in shared memory (a consumer's own)
  const int slot = L::kSplitD ? 64 * c + 16 * warp : r0;
  const int row_a = q0 + r0 + g;  // rows of the accumulators' e = 0, 1
  const int row_b = row_a + 8;    // and e = 2, 3
  const int n_kv_c =
      kCausal ? min(n_k_tiles, L::kSplitD ? q_tile + 1 : 2 * q_tile + 1 + c) : n_k_tiles;
  const int64_t lrow = static_cast<int64_t>(bh) * T;

  // delta = rowsum(do * o) for the warp's 16 rows, two lanes a row, each
  // summing half of the padded width in f32: do from its swizzled tile (chunk
  // c of row r at chunk c ^ (r % 8)), o from global memory, columns < the
  // real D only (past it lies the next head's o; D % 8 == 0 keeps each
  // 8-column chunk whole)
  mbar_wait(qdo_full, 0);
  {
    const int r = r0 + lane / 2;
    const int row = q0 + r;
    const int c0 = (lane & 1) * (D / 2);
    float sum = 0.f;
    if (row < T) {
      const bf16* orow = at(a.o, a.so, b, h) + row * a.so.t;
#pragma unroll
      for (int cc = 0; cc < D / 2; cc += 8) {
        const int col = c0 + cc;
        if (col >= a.D) break;
        const bf16* drow =
            sDo + (col / 64) * kBlockM * 64 + r * 64 + ((((col % 64) / 8) ^ (r & 7)) * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + col);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 df = __bfloat1622float2(d2[e]);
          const float2 of = __bfloat1622float2(o2[e]);
          sum += df.x * of.x + df.y * of.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0) {
      sDelta[slot + lane / 2] = sum;
      sLse[slot + lane / 2] = row < T ? a.lse[lrow + row] : CUDART_INF_F;
      // at Dp = 256 both consumers sum the same rows; consumer 0 writes them
      if (row < T && (!L::kSplitD || c == 0)) a.delta[lrow + row] = sum;
    }
  }
  __syncwarp();
  const float lb_a = sLse[slot + g] * kLog2e;
  const float lb_b = sLse[slot + g + 8] * kLog2e;
  const float dl_a = sDelta[slot + g];
  const float dl_b = sDelta[slot + g + 8];
  const float scale_log2 = a.scale * kLog2e;

  // K-major descriptors of this consumer's q and do rows and of stage 0's K
  // and V tiles; MN-major of stage 0's K tile (LBO: its 64-column blocks)
  const uint64_t dQ = desc_sw128(sQ + rows_c * 64, 16);
  const uint64_t dDo = desc_sw128(sDo + rows_c * 64, 16);
  const uint64_t dK = desc_sw128(sK, 16);
  const uint64_t dV = desc_sw128(sV, 16);
  // MN-major K from its column block col_c / 64 on
  const uint64_t dKn = desc_add(desc_sw128(sK, kDqBlockN * 128), (col_c / 64) * kDqBlockN * 128);

  float acc[L::kAccD / 2];
#pragma unroll
  for (int i = 0; i < L::kAccD / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_kv_c; ++j) {
    const int stage = j % kDqStages;
    const uint32_t stage_off = stage * L::kKTile;

    // s = q k^T and dp = do v^T: k-step kk reads columns [16kk, 16kk + 16)
    float s[kDqBlockN / 2], dp[kDqBlockN / 2];
    mbar_wait(&kv_full[stage], (j / kDqStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qcol = (kk / 4) * kBlockM * 128 + (kk % 4) * 32;
      const uint32_t kcol = stage_off + (kk / 4) * kDqBlockN * 128 + (kk % 4) * 32;
      wgmma_ss<kDqBlockN>(s, desc_add(dQ, qcol), desc_add(dK, kcol), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qcol = (kk / 4) * kBlockM * 128 + (kk % 4) * 32;
      const uint32_t kcol = stage_off + (kk / 4) * kDqBlockN * 128 + (kk % 4) * 32;
      wgmma_ss<kDqBlockN>(dp, desc_add(dDo, qcol), desc_add(dV, kcol), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    uint32_t ds[kDqBlockN / 16][4];
    if (j == n_kv_c - 1) {
      ds_tile<true, kCausal>(ds, s, dp, scale_log2, lb_a, lb_b, dl_a, dl_b, j * kDqBlockN,
                             row_a, t4, T);
    } else {
      ds_tile<false, kCausal>(ds, s, dp, scale_log2, lb_a, lb_b, dl_a, dl_b, 0, 0, 0, 0);
    }

    // dq += ds k: k-step kk reads keys [16kk, 16kk + 16) of K, 2048 bytes on
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqBlockN / 16; ++kk) {
      wgmma_rs<L::kAccD>(acc, ds[kk], desc_add(dKn, stage_off + kk * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[stage]);
  }

  OutT* dqp = at(static_cast<OutT*>(a.dq), a.sdq, b, h);
#pragma unroll
  for (int n = 0; n < L::kAccD / 8; ++n) {
    const bool live = col_c + n * 8 < a.D;  // padding columns past the real D: not stored
    const int col = col_c + n * 8 + 2 * t4;
    if (live && row_a < T) {
      store_out2(dqp + row_a * a.sdq.t + col, acc[4 * n] * a.scale, acc[4 * n + 1] * a.scale);
    }
    if (live && row_b < T) {
      store_out2(dqp + row_b * a.sdq.t + col, acc[4 * n + 2] * a.scale,
                 acc[4 * n + 3] * a.scale);
    }
  }
}

// ------------------------------------------------------------------- K3

constexpr int kDkvBlockN = 64;  // keys per block, shared by both consumer warpgroups
constexpr int kDkvBlockM = 64;  // q rows per streamed q/do tile

// shared-memory layout, byte offsets from a 1024-aligned base
template <int D>
struct DkvSmem {
  static constexpr bool kSplitD = D > 128;          // blocks split dk's and dv's columns
  static constexpr int kAccD = kSplitD ? D / 2 : D;  // dk, dv columns a block owns
  static constexpr int kStages = kSplitD ? 2 : 3;    // q/do ring depth
  static constexpr int kPBufs = kSplitD ? 1 : 2;     // f32 p^T buffers, A to B
  static constexpr int kKTile = kDkvBlockN * D * 2;              // k or v
  static constexpr int kQTile = kDkvBlockM * D * 2;              // q or do, one stage
  static constexpr int kPTile = kDkvBlockN * kDkvBlockM * 2;     // p^T or ds^T, bf16
  static constexpr int kPf = kDkvBlockN * kDkvBlockM * 4;        // p^T in f32, one buffer
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKTile;
  static constexpr int kQ = kV + kKTile;
  static constexpr int kDo = kQ + kStages * kQTile;
  static constexpr int kPb = kDo + kStages * kQTile;  // p^T bf16 (consumer A's A operand)
  static constexpr int kDs = kPb + kPTile;           // ds^T bf16 (consumer B's A operand)
  static constexpr int kPfs = kDs + kPTile;          // the p^T f32 buffers, A to B
  static constexpr int kLse = kPfs + kPBufs * kPf;   // per stage kDkvBlockM f32
  static constexpr int kDelta = kLse + kStages * kDkvBlockM * 4;
  // kv_full, full[], empty[], p_full[], p_empty[]
  static constexpr int kBars = kDelta + kStages * kDkvBlockM * 4;
  static constexpr int kBytes =
      kBars + (1 + 2 * kStages + 2 * kPBufs) * 8 + 1024;  // + alignment slack
};

struct DkvArgs {
  CUtensorMap tq, tk, tv, tdo;
  const float* lse;
  const float* delta;
  void* dk;  // bf16 or f32, the kernel's OutT
  void* dv;
  int T, H, group;
  int D;  // the real head dim; the kernel runs at its template's padded width
  Strides sdk, sdv;
  float scale;
};

// s^T = -inf (so p^T = 0) for the rows of a masked tile at or past T and,
// causal, for keys past the row; in place, so that masked and unmasked
// tiles share one exp path and one register layout. Element i of k-step kk
// is q row q0 + 16kk + 8(i >> 2) + 2 t4 + (i & 1) and key key_a (+8 if i & 2).
template <bool kCausal>
__device__ __forceinline__ void mask_tile(float (&s)[kDkvBlockM / 2], int key_a, int q0, int t4,
                                          int T) {
#pragma unroll
  for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + 16 * kk + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int key = (i & 2) ? key_a + 8 : key_a;
      if (row >= T || (kCausal && key > row)) s[8 * kk + i] = -CUDART_INF_F;
    }
  }
}

// p^T = exp(scale s^T - lse) of one tile, in place: the columns are q rows,
// so lse (stored times log2 e) is read per column, for k-step kk columns
// [16kk, 16kk + 16)
__device__ __forceinline__ void p_tile(float (&s)[kDkvBlockM / 2], const float* lb,
                                       float scale_log2, int t4) {
#pragma unroll
  for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
    const float2 l_lo = *reinterpret_cast<const float2*>(lb + 16 * kk + 2 * t4);
    const float2 l_hi = *reinterpret_cast<const float2*>(lb + 16 * kk + 8 + 2 * t4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 l = (i & 4) ? l_hi : l_lo;
      s[8 * kk + i] = exp2f(fmaf(s[8 * kk + i], scale_log2, (i & 1) ? -l.y : -l.x));
    }
  }
}

// One bf16 pair of the accumulator layout into a p^T or ds^T tile (64 x 64
// bf16, 128-byte swizzled, K-major as the A operand of p^T do or ds^T q):
// pair r of k-step kk holds row 16w + g + 8 (r & 1), columns 16kk + 8 (r >> 1)
// + 2 t4 and the next, so 16-byte chunk 2kk + (r >> 1) of its row, which the
// swizzle stores at chunk ^ (row % 8) = chunk ^ g. The eight rows of a warp's
// store land in eight different chunks: no bank conflicts.
__device__ __forceinline__ void store_pair(unsigned char* tile, int warp, int g, int t4, int kk,
                                           int r, uint32_t v) {
  const int row = 16 * warp + g + 8 * (r & 1);
  const int chunk = 2 * kk + (r >> 1);
  *reinterpret_cast<uint32_t*>(tile + row * 128 + ((chunk ^ g) << 4) + 4 * t4) = v;
}

template <int D, bool kCausal, typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ DkvArgs a) {
  using L = DkvSmem<D>;
  constexpr int kStages = L::kStages;
  constexpr int kPBufs = L::kPBufs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sDo = reinterpret_cast<bf16*>(smem + L::kDo);
  unsigned char* sPb = smem + L::kPb;
  unsigned char* sDs = smem + L::kDs;
  float4* sPf = reinterpret_cast<float4*>(smem + L::kPfs);
  float* sLb = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* p_full = empty + kStages;
  uint64_t* p_empty = p_full + kPBufs;

  const int T = a.T;
  const int h_kv_count = a.H / a.group;
  const int b = blockIdx.x / h_kv_count;
  const int h_kv = blockIdx.x % h_kv_count;
  const int k0 = blockIdx.y * kDkvBlockN;  // y = 0, the heaviest tiles, is scheduled first
  const int col0 = L::kSplitD ? blockIdx.z * L::kAccD : 0;  // the block's first dk, dv column
  const int n_q_tiles = (T + kDkvBlockM - 1) / kDkvBlockM;
  const int first = kCausal ? k0 / kDkvBlockM : 0;  // earlier q tiles see none of these keys
  const int per_head = n_q_tiles - first;
  const int n_iter = a.group * per_head;  // q tile `it % per_head` of head `it / per_head`

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread's expect_tx, each lane's lse/delta
      mbar_init(&empty[s], kWsConsumerThreads);
    }
    for (int s = 0; s < kPBufs; ++s) {
      mbar_init(&p_full[s], 128);   // consumer A's threads, p^T stored
      mbar_init(&p_empty[s], 128);  // consumer B's threads, p^T read
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one warp; its thread 0 starts every TMA load, its 32 lanes
    // store each stage's lse and delta
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kKTile);
        tma_load_tile<D, kDkvBlockN>(sK, &a.tk, kv_full, h_kv, k0, b);
        tma_load_tile<D, kDkvBlockN>(sV, &a.tv, kv_full, h_kv, k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int stage = it % kStages;
        const int hq = h_kv * a.group + it / per_head;
        const int q0 = (first + it % per_head) * kDkvBlockM;
        if (it >= kStages) mbar_wait(&empty[stage], ((it / kStages) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * L::kQTile);
          tma_load_tile<D, kDkvBlockM>(sQ + stage * kDkvBlockM * D, &a.tq, &full[stage], hq,
                                       q0, b);
          tma_load_tile<D, kDkvBlockM>(sDo + stage * kDkvBlockM * D, &a.tdo, &full[stage],
                                       hq, q0, b);
        }
        const int64_t lrow = static_cast<int64_t>(b * a.H + hq) * T;
#pragma unroll
        for (int j = 0; j < kDkvBlockM / 32; ++j) {
          const int r = lane + 32 * j;
          const int row = q0 + r;
          sLb[stage * kDkvBlockM + r] = row < T ? a.lse[lrow + row] * kLog2e : CUDART_INF_F;
          sDelta[stage * kDkvBlockM + r] = row < T ? a.delta[lrow + row] : 0.f;
        }
        mbar_arrive(&full[stage]);  // releases this lane's stores
      }
    }
    return;
  }

  // consumers A (wg 1: p^T, dv) and B (wg 2: dp^T, ds^T, dk), both over the
  // block's 64 keys
  regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int key_a = k0 + 16 * warp + g;  // keys of the accumulators' e = 0, 1
  const int key_b = key_a + 8;           // and e = 2, 3

  // the stage-0 descriptors: K-major q, do and the score operands, MN-major
  // q and do (LBO: their 64-column blocks, 64 rows x 128 bytes apart) from
  // the block's first column block of dk and dv on
  const uint64_t dQ = desc_sw128(sQ, 16);
  const uint64_t dDo = desc_sw128(sDo, 16);
  const uint32_t col0_off = (col0 / 64) * kDkvBlockM * 128;
  const uint64_t dQn = desc_add(desc_sw128(sQ, kDkvBlockM * 128), col0_off);
  const uint64_t dDon = desc_add(desc_sw128(sDo, kDkvBlockM * 128), col0_off);

  if (wg == 1) {
    // A: s^T = k q^T, p^T = exp(scale s^T - lse), handed to B in f32 and
    // stored in bf16 for dv += p^T do
    const uint64_t dK = desc_sw128(sK, 16);
    const uint64_t dP = desc_sw128(sPb, 16);
    const float scale_log2 = a.scale * kLog2e;
    float dv[L::kAccD / 2];
#pragma unroll
    for (int i = 0; i < L::kAccD / 2; ++i) dv[i] = 0.f;
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int stage = it % kStages;
      const int q0 = (first + it % per_head) * kDkvBlockM;
      const uint32_t stage_off = stage * L::kQTile;
      const int pb = kPBufs == 2 ? it & 1 : 0;
      mbar_wait(&full[stage], (it / kStages) & 1);

      float s[kDkvBlockM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kcol = (kk / 4) * kDkvBlockN * 128 + (kk % 4) * 32;
        const uint32_t qcol = stage_off + (kk / 4) * kDkvBlockM * 128 + (kk % 4) * 32;
        wgmma_ss<kDkvBlockM>(s, desc_add(dK, kcol), desc_add(dQ, qcol), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      // only the causal diagonal (the first q tile) and a ragged last tile
      if ((kCausal && q0 == k0) || q0 + kDkvBlockM > T) mask_tile<kCausal>(s, key_a, q0, t4, T);
      p_tile(s, sLb + stage * kDkvBlockM, scale_log2, t4);

      // p^T in f32 to B, thread-major: B's thread t reads what A's thread t
      // wrote, the same accumulator positions
      if (it >= kPBufs) mbar_wait(&p_empty[pb], ((kPBufs == 2 ? it >> 1 : it) - 1) & 1);
      float4* pf = sPf + pb * (kDkvBlockN * kDkvBlockM / 4);
#pragma unroll
      for (int j = 0; j < kDkvBlockM / 8; ++j) {
        pf[j * 128 + tid] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      }
      mbar_arrive(&p_full[pb]);

#pragma unroll
      for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          store_pair(sPb, warp, g, t4, kk, r, pack_f32(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]));
        }
      }
      // every thread's pairs visible to wgmma before any thread issues it
      fence_async_shared();
      named_barrier(1, 128);

      // dv += p^T do: k-step kk reads q rows [16kk, 16kk + 16), +32 bytes
      // along the p^T rows, +2048 bytes down the do tile
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
        wgmma_ss_mn<L::kAccD>(dv, desc_add(dP, kk * 32), desc_add(dDon, stage_off + kk * 2048),
                              1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      mbar_arrive(&empty[stage]);
    }
    OutT* dvp = at(static_cast<OutT*>(a.dv), a.sdv, b, h_kv);
#pragma unroll
    for (int n = 0; n < L::kAccD / 8; ++n) {
      const bool live = col0 + n * 8 < a.D;  // padding columns past the real D: not stored
      const int col = col0 + n * 8 + 2 * t4;
      if (live && key_a < T) store_out2(dvp + key_a * a.sdv.t + col, dv[4 * n], dv[4 * n + 1]);
      if (live && key_b < T) {
        store_out2(dvp + key_b * a.sdv.t + col, dv[4 * n + 2], dv[4 * n + 3]);
      }
    }
    return;
  }

  // B: dp^T = v do^T, ds^T = p^T (dp^T - delta) in f32 with A's p^T, stored
  // in bf16 for dk += ds^T q
  const uint64_t dV = desc_sw128(sV, 16);
  const uint64_t dDs = desc_sw128(sDs, 16);
  float dk[L::kAccD / 2];
#pragma unroll
  for (int i = 0; i < L::kAccD / 2; ++i) dk[i] = 0.f;
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % kStages;
    const uint32_t stage_off = stage * L::kQTile;
    const int pb = kPBufs == 2 ? it & 1 : 0;
    mbar_wait(&full[stage], (it / kStages) & 1);

    float dp[kDkvBlockM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t kcol = (kk / 4) * kDkvBlockN * 128 + (kk % 4) * 32;
      const uint32_t qcol = stage_off + (kk / 4) * kDkvBlockM * 128 + (kk % 4) * 32;
      wgmma_ss<kDkvBlockM>(dp, desc_add(dV, kcol), desc_add(dDo, qcol), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);

    mbar_wait(&p_full[pb], (kPBufs == 2 ? it >> 1 : it) & 1);
    const float4* pf = sPf + pb * (kDkvBlockN * kDkvBlockM / 4);
    const float* dl = sDelta + stage * kDkvBlockM;
#pragma unroll
    for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
      const float4 p_lo = pf[(2 * kk) * 128 + tid];
      const float4 p_hi = pf[(2 * kk + 1) * 128 + tid];
      const float p[8] = {p_lo.x, p_lo.y, p_lo.z, p_lo.w, p_hi.x, p_hi.y, p_hi.z, p_hi.w};
      const float2 d_lo = *reinterpret_cast<const float2*>(dl + 16 * kk + 2 * t4);
      const float2 d_hi = *reinterpret_cast<const float2*>(dl + 16 * kk + 8 + 2 * t4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 d = (r & 2) ? d_hi : d_lo;
        const int e = 8 * kk + 2 * r;
        store_pair(sDs, warp, g, t4, kk, r,
                   pack_f32(p[2 * r] * (dp[e] - d.x), p[2 * r + 1] * (dp[e + 1] - d.y)));
      }
    }
    mbar_arrive(&p_empty[pb]);
    fence_async_shared();
    named_barrier(2, 128);

    // dk += ds^T q, as dv in A
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
      wgmma_ss_mn<L::kAccD>(dk, desc_add(dDs, kk * 32), desc_add(dQn, stage_off + kk * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    mbar_arrive(&empty[stage]);
  }
  OutT* dkp = at(static_cast<OutT*>(a.dk), a.sdk, b, h_kv);
#pragma unroll
  for (int n = 0; n < L::kAccD / 8; ++n) {
    const bool live = col0 + n * 8 < a.D;
    const int col = col0 + n * 8 + 2 * t4;
    if (live && key_a < T) {
      store_out2(dkp + key_a * a.sdk.t + col, dk[4 * n] * a.scale, dk[4 * n + 1] * a.scale);
    }
    if (live && key_b < T) {
      store_out2(dkp + key_b * a.sdk.t + col, dk[4 * n + 2] * a.scale,
                 dk[4 * n + 3] * a.scale);
    }
  }
}

template <int D, bool kCausal, typename OutT>
cudaError_t launch_dq(const DqArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = DqSmem<D>::kBytes;
  static bool attr_set = false;
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, kCausal, OutT>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + DqSmem<D>::kBlockM - 1) / DqSmem<D>::kBlockM, B * a.H);
  flash_bwd_dq_kernel<D, kCausal, OutT><<<grid, kWsThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kCausal, typename OutT>
cudaError_t launch_dkv(const DkvArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = DkvSmem<D>::kBytes;
  static bool attr_set = false;
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, kCausal, OutT>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  // key tiles along y, so that every tile 0 (the heaviest) is scheduled
  // first; the column halves of dk and dv along z at Dp = 256
  const dim3 grid(B * (a.H / a.group), (a.T + kDkvBlockN - 1) / kDkvBlockN,
                  DkvSmem<D>::kSplitD ? 2 : 1);
  flash_bwd_dkv_kernel<D, kCausal, OutT><<<grid, kWsThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

bool bad_dims(int B, int T, int H, int H_kv, int D) {
  return B <= 0 || T <= 0 || H_kv <= 0 || H % H_kv != 0 || !head_dim_ok(D);
}

template <typename OutT>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, int B, int T, int H, int H_kv, int D,
           int causal, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
           int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_st,
           int64_t o_sh, int64_t do_sb, int64_t do_st, int64_t do_sh, int64_t dq_sb,
           int64_t dq_st, int64_t dq_sh, void* stream) {
  if (bad_dims(B, T, H, H_kv, D)) return static_cast<int>(cudaErrorInvalidValue);
  DqArgs a;
  const int Dp = padded_head_dim(D);
  const int rows = dq_block_m(Dp);
  int err = make_tile_map(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, rows);
  if (err == 0) err = make_tile_map(&a.tdo, dout, B, T, H, D, do_sb, do_st, do_sh, rows);
  if (err == 0) err = make_tile_map(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, kDqBlockN);
  if (err == 0) err = make_tile_map(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, kDqBlockN);
  if (err != 0) return err;
  a.o = static_cast<const bf16*>(o);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.so = {o_sb, o_st, o_sh};
  a.sdq = {dq_sb, dq_st, dq_sh};
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  if (Dp == 64) {
    launched = causal ? launch_dq<64, true, OutT>(a, B, s) : launch_dq<64, false, OutT>(a, B, s);
  } else if (Dp == 128) {
    launched =
        causal ? launch_dq<128, true, OutT>(a, B, s) : launch_dq<128, false, OutT>(a, B, s);
  } else {
    launched =
        causal ? launch_dq<256, true, OutT>(a, B, s) : launch_dq<256, false, OutT>(a, B, s);
  }
  return static_cast<int>(launched);
}

template <typename OutT>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int B, int T, int H, int H_kv, int D,
            int causal, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
            int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t do_sb,
            int64_t do_st, int64_t do_sh, int64_t dk_sb, int64_t dk_st, int64_t dk_sh,
            int64_t dv_sb, int64_t dv_st, int64_t dv_sh, void* stream) {
  if (bad_dims(B, T, H, H_kv, D)) return static_cast<int>(cudaErrorInvalidValue);
  DkvArgs a;
  int err = make_tile_map(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, kDkvBlockM);
  if (err == 0) err = make_tile_map(&a.tdo, dout, B, T, H, D, do_sb, do_st, do_sh, kDkvBlockM);
  if (err == 0) err = make_tile_map(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, kDkvBlockN);
  if (err == 0) err = make_tile_map(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, kDkvBlockN);
  if (err != 0) return err;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.sdk = {dk_sb, dk_st, dk_sh};
  a.sdv = {dv_sb, dv_st, dv_sh};
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  const int Dp = padded_head_dim(D);
  if (Dp == 64) {
    launched =
        causal ? launch_dkv<64, true, OutT>(a, B, s) : launch_dkv<64, false, OutT>(a, B, s);
  } else if (Dp == 128) {
    launched =
        causal ? launch_dkv<128, true, OutT>(a, B, s) : launch_dkv<128, false, OutT>(a, B, s);
  } else {
    launched =
        causal ? launch_dkv<256, true, OutT>(a, B, s) : launch_dkv<256, false, OutT>(a, B, s);
  }
  return static_cast<int>(launched);
}

}  // namespace

#define HIVED_DQ_PARAMS                                                                    \
  const void *q, const void *k, const void *v, const void *o, const void *dout,            \
      const void *lse, void *delta, void *dq, int B, int T, int H, int H_kv, int D,        \
      int causal, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,    \
      int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_st,  \
      int64_t o_sh, int64_t do_sb, int64_t do_st, int64_t do_sh, int64_t dq_sb,            \
      int64_t dq_st, int64_t dq_sh, void *stream
#define HIVED_DQ_ARGS                                                                      \
  q, k, v, o, dout, lse, delta, dq, B, T, H, H_kv, D, causal, q_sb, q_st, q_sh, k_sb, k_st, \
      k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, do_sb, do_st, do_sh, dq_sb, dq_st, dq_sh,  \
      stream
#define HIVED_DKV_PARAMS                                                                   \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,          \
      const void *delta, void *dk, void *dv, int B, int T, int H, int H_kv, int D,         \
      int causal, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,    \
      int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t do_sb,               \
      int64_t do_st, int64_t do_sh, int64_t dk_sb, int64_t dk_st, int64_t dk_sh,           \
      int64_t dv_sb, int64_t dv_st, int64_t dv_sh, void *stream
#define HIVED_DKV_ARGS                                                                     \
  q, k, v, dout, lse, delta, dk, dv, B, T, H, H_kv, D, causal, q_sb, q_st, q_sh, k_sb, k_st, \
      k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh, dk_sb, dk_st, dk_sh, dv_sb, dv_st,      \
      dv_sh, stream

// K2. q, o, do [B, T, H, D], k/v [B, T, H_kv, D] and dq [B, T, H, D] in
// bf16, addressed through the given element strides (D contiguous, every
// row 16-byte aligned, strides positive); lse [B*H, T] f32 from the
// forward; delta [B*H, T] f32 is written for K3. Returns 0, the CUresult of
// a tensor map that could not be encoded, or the cudaError_t of the launch.
extern "C" int hived_flash_bwd_dq(HIVED_DQ_PARAMS) { return bwd_dq<bf16>(HIVED_DQ_ARGS); }

// K2 with dq in f32 (its strides even, its base 8-byte aligned); o is bf16.
extern "C" int hived_flash_bwd_dq_f32(HIVED_DQ_PARAMS) { return bwd_dq<float>(HIVED_DQ_ARGS); }

// K3. q, do [B, T, H, D], k/v and dk/dv [B, T, H_kv, D] in bf16, through
// their element strides (D contiguous; q, do, k and v every row 16-byte
// aligned, strides positive); lse and delta [B*H, T] f32 (delta from K2).
// Returns 0, the CUresult of a tensor map that could not be encoded, or the
// cudaError_t of the launch.
extern "C" int hived_flash_bwd_dkv(HIVED_DKV_PARAMS) { return bwd_dkv<bf16>(HIVED_DKV_ARGS); }

// K3 with dk and dv in f32 (their strides even, their bases 8-byte aligned).
extern "C" int hived_flash_bwd_dkv_f32(HIVED_DKV_PARAMS) {
  return bwd_dkv<float>(HIVED_DKV_ARGS);
}
