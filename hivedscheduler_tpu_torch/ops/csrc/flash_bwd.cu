// Flash-attention backward for Hopper (sm_90a): dq (K2) and dk/dv (K3),
// bf16 or fp16 in, f32 accumulation, no atomics.
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
// with a producer warpgroup and two consumer warpgroups, like K1 (at Dp <=
// 128; Dp = 256 below).
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
// K3 (the same building blocks): key-stationary, as the TPU kernel is (at
// Dp <= 128, and at Dp = 256 on small grids; Dp = 256 below).
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
// Dp = 96 (Phi-3-mini's head dim, and 72-88; bwd_padded_head_dim,
// flash_common.cuh; K1 runs these D at 128). At the 128 template a quarter
// of K2's and K3's tensor-core work multiplied zero columns: the K-major
// products (s, dp; s^T, dp^T) ran 8 k-steps where 6 hold data, the MN-major
// ones (dq, dv, dk) 128 output columns where 96 do. So the Dp 64/128
// templates are also instantiated at 96, on tiles of three 32-column panels
// with the 64-byte swizzle (hopper.cuh: one tensor map of 32-column boxes,
// desc_sw64, m64n96k16): 6 k-steps and 96 columns, nothing past 96. The
// blocks, tiles, stages, masks and each output element's order of arithmetic
// are the Dp 128 instances' (zero k-steps add exact zeros; K2's delta keeps
// its lanes' split, columns 0-63 and 64 up to D), so dq, dk and dv equal
// theirs bit for bit. K2's block takes 96 KB of shared memory, K3's 144 KB,
// and each consumer's dq, dv or dk is 48 f32 registers a thread, not 64. The
// panel helpers (panel_cols, desc_tile, kstep_off, tile_chunk) fold to the
// Dp 64/128/256 instances' former constants, whose SASS is unchanged
// (`python -m hivedscheduler_tpu_torch.ops.kernel_ab --sass`).
// K3 at Dp = 96 may also turn its grid: key tiles along x, (b, h_kv) pairs
// along y, so that each pair's key tiles run side by side, heaviest first.
// Its blocks stream the q and do tiles of their pair's heads. With the pairs
// along x, the blocks that run at once hold about SMs / pairs key tiles of
// each pair; under two, hardly any of them share what they stream: at
// Phi-3-mini's 256 pairs the narrower products saved nothing there
// (1.54-1.65 ms either way on an H100's 132 SMs), and turned the kernel took
// 1.32-1.39 ms; at 128 pairs (batch 4) 0.77 against 0.68. At 64 pairs (GQA
// 4) the turned grid, which gives up scheduling every heaviest tile first,
// was 3% slower (and 2% at D 128). So bwd_dkv turns it where 2 B H_kv > SMs.
// The Dp 64/128/256 grids keep their order.
//
// Dp = 256 (Gemma's head dim). A whole-width accumulator is 128 f32
// registers a thread there: K2's dq beside s and dp, K3's dv beside s^T and
// dk beside dp^T. In a block with a producer warpgroup ptxas gives 168
// registers a thread, too few (K1's Dp 256 kernel in flash_fwd.cu found the
// same), so K2 and K3 at Dp = 256 (flash_bwd_dq_kernel_d256,
// flash_bwd_dkv_kernel_d256) are blocks of the two consumer warpgroups
// alone, 256 threads, where ptxas lets a consumer hold up to 255 (K2
// 220-231, K3 233-240, no spill, no serialized wgmma:
// `python -m hivedscheduler_tpu_torch.ops.regs_probe`). Each score is formed
// once:
// - K2: a block takes 128 q rows, consumer c rows [64c, 64c + 64) with all
//   256 columns of dq (two m64n128k16 RS products a k-step, ds packed in
//   registers, K the MN-major B operand). q and do are loaded once as two
//   64-row halves, one a consumer, each laid out as a 64-row tile. K/V
//   tiles are 64 keys, K in two stages and V in one (V is read only by dp):
//   q 64 + do 64 + 2 x 32 + 32 KB = 224 KB; form (b) of step 0, 1.46x
//   faster than form (a), 32-key tiles in two stages each (192 KB), whose
//   m64n32k16 score products ran slower (ops/regs_probe.py has both). The
//   consumers load their own tiles: thread 0 loads q, do and the first
//   stages; after its last read of a stage (V after dp, K after the dq
//   product) each consumer warp takes a ticket of the stage, and the warp
//   that takes the last loads the stage's next tile there. They take
//   turns at the tensor cores, a product each, through named barriers 3
//   and 4, as K1's do. Each consumer computes and writes delta for its own
//   rows and masks only its own last tile (its causal diagonal, or the
//   tile that holds a ragged T); consumer 0 reads one tile fewer, causal,
//   and takes the turns of the tile it skips; a consumer whose rows are all
//   past T leaves at once.
// - K3: one block per (b*h_kv, 64-key tile), consumers A and B split by
//   product as at Dp <= 128, each with all 256 columns of dv or dk (two
//   m64n128k16 SS products a k-step). Two q/do stages and one f32 p^T
//   buffer: K 32 + V 32 + 2 x (32 + 32) + 8 + 8 + 16 KB = 224 KB, under the
//   227 KB a block may have. The q/do stages stream through the group's
//   heads loaded by warp tickets: the warp that takes a stage's last ticket
//   (A after dv, B after dk) loads its next tile, lane 0 the TMA and all 32
//   lanes the stage's lse and delta, each arriving on the stage's full
//   barrier after its own stores.
// - Small grids: K3's blocks are whole key tiles, B * H_kv * ceil(T / 64),
//   32 at one sp = 4 ring hop of Gemma-2B's heads. Where that is fewer than
//   the card's SMs, bwd_dkv runs the Dp = 256 instances of
//   flash_bwd_dkv_kernel instead: two blocks a key tile (the grid's z), each
//   forming s^T and dp^T over the whole D and keeping dk's and dv's columns
//   for its half (3/2 of the real work), 1.6x faster there than one block a
//   key tile. Their layout is the same 224 KB with a producer warpgroup.
// Each output element is owned by one block, with no atomics; every
// output element runs the same k-steps in the same order at Dp = 256 in
// every form, so bf16 reruns and forms agree bit for bit.
//
// Output type: dq, dk and dv are stored in the input type
// (hived_flash_bwd_dq, hived_flash_bwd_dkv and their _f16 forms) or in f32
// (the _f32 entry points), the counterpart of _flash_backward's
// grad_dtype=f32, which the sequence-parallel ring calls once a hop and sums
// over hops in f32. Only the epilogues' stores differ; K3's GQA group sum
// stays inside the kernel either way (the TPU kernel's caller sums f32
// per-q-head partials and then casts).
//
// Input type: bf16 or fp16 (the _f16 entry points), a template parameter:
// the tensor maps' data type, the wgmma type suffix and the packing of p and
// ds differ. The fp16 entry points are a library of their own
// (flash_bwd_f16.cu defines HIVED_FLASH_F16 and includes this file), so that
// nvcc compiles them beside the bf16 ones. fp16 keeps three more mantissa
// bits than bf16 but ends at 65504 and turns subnormal below 6.1e-5, and ds
// = p (dp - delta) is linear in do:
// at the magnitudes of a model's gradients (do of 1e-5 and below) most of ds
// would pack to fp16 subnormals or to 0, where bf16 keeps 8 bits. So in fp16
// each operand row of ds (K2: a q row, K3: a key) is packed scaled by 2^E,
// with E chosen per tile so that the row's largest |ds| lands in [2^14,
// 2^15), and E only falls from tile to tile: when it falls, the row's f32
// accumulator is multiplied by the power of two between the two scales
// before the next product, and the epilogue multiplies by 2^-E. Powers of
// two are exact, so the scaling adds no rounding of its own. p (in [0, 1])
// packs unscaled, as in K1. bf16 packs ds unscaled, as before.

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

// shared-memory layout at Dp = 64, 96 and 128, byte offsets from a
// 1024-aligned base: 128 q rows a block, the two consumer warpgroups 64 each
template <int D>
struct DqSmem {
  static constexpr int kBlockM = 128;
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
  const void* o;  // the input type
  const float* lse;
  float* delta;
  void* dq;  // the input type or f32, the kernel's OutT
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
    ds[kk][0] = pack_f32<bf16>(e[0], e[1]);
    ds[kk][1] = pack_f32<bf16>(e[2], e[3]);
    ds[kk][2] = pack_f32<bf16>(e[4], e[5]);
    ds[kk][3] = pack_f32<bf16>(e[6], e[7]);
  }
}

// K2's ds of one tile in f32, in place of s: as ds_tile, before any packing
template <bool kMask, bool kCausal>
__device__ __forceinline__ void ds_values(float (&s)[kDqBlockN / 2],
                                          const float (&dp)[kDqBlockN / 2], float scale_log2,
                                          float lb_a, float lb_b, float dl_a, float dl_b, int k0,
                                          int row_a, int t4, int T) {
#pragma unroll
  for (int kk = 0; kk < kDqBlockN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool top = (i & 2) == 0;
      float p = exp2f(fmaf(s[8 * kk + i], scale_log2, top ? -lb_a : -lb_b));
      if (kMask) {
        const int col = k0 + 16 * kk + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = top ? row_a : row_a + 8;
        if (col >= T || (kCausal && col > row)) p = 0.f;
      }
      s[8 * kk + i] = p * (dp[8 * kk + i] - (top ? dl_a : dl_b));
    }
  }
}

template <int D, bool kCausal, typename In, typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ DqArgs a) {
  using L = DqSmem<D>;
  using Pair = typename std::conditional<kIsF16<In>, __half2, __nv_bfloat162>::type;
  constexpr int kBlockM = L::kBlockM;
  constexpr int P = panel_cols(D);  // a tile panel's columns (hopper.cuh)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  In* sQ = reinterpret_cast<In*>(smem + L::kQ);
  In* sDo = reinterpret_cast<In*>(smem + L::kDo);
  In* sK = reinterpret_cast<In*>(smem + L::kK);
  In* sV = reinterpret_cast<In*>(smem + L::kV);
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
  // consumer c's rows meet keys up to their diagonal, tile 2 q_tile + c
  const int n_kv = kCausal ? min(n_k_tiles, 2 * q_tile + 2) : n_k_tiles;

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

  // consumer c owns q rows [64c, 64c + 64) of the tile, all of dq's columns
  regs_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rows_c = 64 * c;          // the consumer's first row in the tile
  const int r0 = rows_c + 16 * warp;  // the warp's first row in the tile
  const int slot = r0;                // the warp's 16 lse and delta values in shared memory
  const int row_a = q0 + r0 + g;      // rows of the accumulators' e = 0, 1
  const int row_b = row_a + 8;        // and e = 2, 3
  const int n_kv_c = kCausal ? min(n_k_tiles, 2 * q_tile + 1 + c) : n_k_tiles;
  const int64_t lrow = static_cast<int64_t>(bh) * T;

  // delta = rowsum(do * o) for the warp's 16 rows, two lanes a row, each
  // summing half of the padded width in f32 (at Dp = 96 as at 128: columns
  // 0-63 and 64 up to D, so delta keeps its last bits): do from its
  // swizzled tile (tile_chunk), o from global memory, columns < the real D
  // only (past it lies the next head's o; D % 8 == 0 keeps each 8-column
  // chunk whole)
  constexpr int kHalfCols = D == 96 ? 64 : D / 2;
  mbar_wait(qdo_full, 0);
  {
    const int r = r0 + lane / 2;
    const int row = q0 + r;
    const int c0 = (lane & 1) * kHalfCols;
    float sum = 0.f;
    if (row < T) {
      const In* orow = at(static_cast<const In*>(a.o), a.so, b, h) + row * a.so.t;
#pragma unroll
      for (int cc = 0; cc < kHalfCols; cc += 8) {
        const int col = c0 + cc;
        if (col >= a.D) break;
        const In* drow = sDo + tile_chunk<D, kBlockM>(r, col);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + col);
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
      sDelta[slot + lane / 2] = sum;
      sLse[slot + lane / 2] = row < T ? a.lse[lrow + row] : CUDART_INF_F;
      if (row < T) a.delta[lrow + row] = sum;
    }
  }
  __syncwarp();
  const float lb_a = sLse[slot + g] * kLog2e;
  const float lb_b = sLse[slot + g + 8] * kLog2e;
  const float dl_a = sDelta[slot + g];
  const float dl_b = sDelta[slot + g + 8];
  const float scale_log2 = a.scale * kLog2e;

  // K-major descriptors of this consumer's q and do rows and of stage 0's K
  // and V tiles; MN-major of stage 0's K tile (LBO: its panels)
  const uint64_t dQ = desc_tile<D>(sQ + rows_c * P, 16);
  const uint64_t dDo = desc_tile<D>(sDo + rows_c * P, 16);
  const uint64_t dK = desc_tile<D>(sK, 16);
  const uint64_t dV = desc_tile<D>(sV, 16);
  const uint64_t dKn = desc_tile<D>(sK, kDqBlockN * P * 2);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int e_a = kDsExpMax, e_b = kDsExpMax;  // fp16: the rows' ds exponents

  for (int j = 0; j < n_kv_c; ++j) {
    const int stage = j % kDqStages;
    const uint32_t stage_off = stage * L::kKTile;

    // s = q k^T and dp = do v^T: k-step kk reads columns [16kk, 16kk + 16)
    float s[kDqBlockN / 2], dp[kDqBlockN / 2];
    mbar_wait(&kv_full[stage], (j / kDqStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qcol = kstep_off<D>(kk, kBlockM);
      const uint32_t kcol = stage_off + kstep_off<D>(kk, kDqBlockN);
      wgmma_ss<kDqBlockN, In>(s, desc_add(dQ, qcol), desc_add(dK, kcol), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qcol = kstep_off<D>(kk, kBlockM);
      const uint32_t kcol = stage_off + kstep_off<D>(kk, kDqBlockN);
      wgmma_ss<kDqBlockN, In>(dp, desc_add(dDo, qcol), desc_add(dV, kcol), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    uint32_t ds[kDqBlockN / 16][4];
    if constexpr (kIsF16<In>) {
      if (j == n_kv_c - 1) {
        ds_values<true, kCausal>(s, dp, scale_log2, lb_a, lb_b, dl_a, dl_b, j * kDqBlockN,
                                 row_a, t4, T);
      } else {
        ds_values<false, kCausal>(s, dp, scale_log2, lb_a, lb_b, dl_a, dl_b, 0, 0, 0, 0);
      }
      float sc_a, sc_b;
      ds_row_scales(s, acc, e_a, e_b, sc_a, sc_b);
#pragma unroll
      for (int kk = 0; kk < kDqBlockN / 16; ++kk) {
        ds[kk][0] = pack_f32<In>(s[8 * kk] * sc_a, s[8 * kk + 1] * sc_a);
        ds[kk][1] = pack_f32<In>(s[8 * kk + 2] * sc_b, s[8 * kk + 3] * sc_b);
        ds[kk][2] = pack_f32<In>(s[8 * kk + 4] * sc_a, s[8 * kk + 5] * sc_a);
        ds[kk][3] = pack_f32<In>(s[8 * kk + 6] * sc_b, s[8 * kk + 7] * sc_b);
      }
    } else if (j == n_kv_c - 1) {
      ds_tile<true, kCausal>(ds, s, dp, scale_log2, lb_a, lb_b, dl_a, dl_b, j * kDqBlockN,
                             row_a, t4, T);
    } else {
      ds_tile<false, kCausal>(ds, s, dp, scale_log2, lb_a, lb_b, dl_a, dl_b, 0, 0, 0, 0);
    }

    // dq += ds k: k-step kk reads keys [16kk, 16kk + 16) of K, 16 rows of
    // each panel on (2048 bytes, 1024 at Dp = 96)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqBlockN / 16; ++kk) {
      wgmma_rs<D, In>(acc, ds[kk], desc_add(dKn, stage_off + kk * 16 * P * 2), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[stage]);
  }

  if constexpr (kIsF16<In>) {  // undo the rows' ds scales
    const float inv_a = pow2i(-e_a);
    const float inv_b = pow2i(-e_b);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? inv_b : inv_a;
  }
  OutT* dqp = at(static_cast<OutT*>(a.dq), a.sdq, b, h);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const bool live = n * 8 < a.D;  // padding columns past the real D: not stored
    const int col = n * 8 + 2 * t4;
    if (live && row_a < T) {
      store_out2(dqp + row_a * a.sdq.t + col, acc[4 * n] * a.scale, acc[4 * n + 1] * a.scale);
    }
    if (live && row_b < T) {
      store_out2(dqp + row_b * a.sdq.t + col, acc[4 * n + 2] * a.scale,
                 acc[4 * n + 3] * a.scale);
    }
  }
}

// ------------------------------------------------------- K2 at Dp = 256

// the Dp = 256 kernels' block: two consumer warpgroups and no producer (the
// header)
constexpr int kD256Threads = 256;
// keys a K/V tile of K2 at Dp = 256: form (b) of the header (32 is form (a))
constexpr int kDq256Keys = 64;

// K2's shared-memory layout at Dp = 256, byte offsets from a 1024-aligned
// base: q and do as two 64-row halves each, one a consumer, each laid out as
// a 64-row tile; kKeys-key K and V tiles, V in one stage at 64 keys (V is
// read only by dp, released before the dq product)
template <int kKeys>
struct Dq256Smem {
  static constexpr int kKStages = 2;
  static constexpr int kVStages = kKeys == 64 ? 1 : kKStages;
  static constexpr int kHalf = 64 * 256 * 2;      // a consumer's 64 rows of q or do
  static constexpr int kKTile = kKeys * 256 * 2;  // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + 2 * kHalf;
  static constexpr int kK = kDo + 2 * kHalf;
  static constexpr int kV = kK + kKStages * kKTile;
  static constexpr int kLse = kV + kVStages * kKTile;  // 64 f32 a consumer
  static constexpr int kDelta = kLse + 128 * 4;        // 64 f32 a consumer
  static constexpr int kBars = kDelta + 128 * 4;       // qdo_full, k_full[], v_full[]
  static constexpr int kTickets = kBars + (1 + kKStages + kVStages) * 8;  // an int a stage
  static constexpr int kBytes = kTickets + (kKStages + kVStages) * 4 + 1024;
};

// K2's ds of one kN-key tile in f32, in place of s, as ds_values (a copy
// over kN, so that the Dp 64/128 instances keep their code)
template <int kN, bool kMask, bool kCausal>
__device__ __forceinline__ void ds_values_d256(float (&s)[kN / 2], const float (&dp)[kN / 2],
                                               float scale_log2, float lb_a, float lb_b,
                                               float dl_a, float dl_b, int k0, int row_a, int t4,
                                               int T) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool top = (i & 2) == 0;
      float p = exp2f(fmaf(s[8 * kk + i], scale_log2, top ? -lb_a : -lb_b));
      if (kMask) {
        const int col = k0 + 16 * kk + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = top ? row_a : row_a + 8;
        if (col >= T || (kCausal && col > row)) p = 0.f;
      }
      s[8 * kk + i] = p * (dp[8 * kk + i] - (top ? dl_a : dl_b));
    }
  }
}

// ds_row_scales (flash_common.cuh) for an accumulator held as two halves of
// 64 f32 (the output columns [0, 128) and [128, 256))
template <int N>
__device__ __forceinline__ void ds_row_scales_d256(const float (&ds)[N], float (&acc0)[64],
                                                   float (&acc1)[64], int& e_a, int& e_b,
                                                   float& sc_a, float& sc_b) {
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
  for (int i = 0; i < 64; ++i) {
    acc0[i] *= (i & 2) ? rb : ra;
    acc1[i] *= (i & 2) ? rb : ra;
  }
  e_a = na;
  e_b = nb;
  sc_a = pow2i(na);
  sc_b = pow2i(nb);
}

// K2 at Dp = 256 (the header has the design): 128 q rows a block, consumer c
// rows [64c, 64c + 64) with all 256 columns of dq, kDq256Keys-key tiles
template <bool kCausal, typename In, typename OutT>
__global__ void __launch_bounds__(kD256Threads, 1)
    flash_bwd_dq_kernel_d256(const __grid_constant__ DqArgs a) {
  constexpr int D = 256;
  constexpr int kN = kDq256Keys;
  using L = Dq256Smem<kN>;
  constexpr int kKStages = L::kKStages;
  constexpr int kVStages = L::kVStages;
  using Pair = typename std::conditional<kIsF16<In>, __half2, __nv_bfloat162>::type;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  In* sQ = reinterpret_cast<In*>(smem + L::kQ);
  In* sDo = reinterpret_cast<In*>(smem + L::kDo);
  In* sK = reinterpret_cast<In*>(smem + L::kK);
  In* sV = reinterpret_cast<In*>(smem + L::kV);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = qdo_full + 1;
  uint64_t* v_full = k_full + kKStages;
  int* k_tickets = reinterpret_cast<int*>(smem + L::kTickets);
  int* v_tickets = k_tickets + kKStages;

  const int T = a.T;
  const int n_q_tiles = (T + 127) / 128;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * 128;
  const int n_t = (T + kN - 1) / kN;  // key tiles of the sequence
  // 2, or 1 when every row of consumer 1 is past T
  const int n_cons = q0 + 64 < T ? 2 : 1;
  // key tiles consumer c reads: causal, those up to its last row's diagonal
  // tile, (q0 + 64c + 64) / kN tiles (tiles past it are never loaded);
  // consumer 1's take in consumer 0's
  const int n_kv0 = kCausal ? min(n_t, (q0 + 64) / kN) : n_t;
  const int n_kv = kCausal ? min(n_t, (q0 + 64 * n_cons) / kN) : n_t;

  const int h_kv = h / a.group;
  // K or V tile j into its stage
  auto load_k = [&](int j) {
    const int stage = j % kKStages;
    mbar_expect_tx(&k_full[stage], L::kKTile);
    tma_load_tile<D, kN>(sK + stage * kN * D, &a.tk, &k_full[stage], h_kv, j * kN, b);
  };
  auto load_v = [&](int j) {
    const int stage = j % kVStages;
    mbar_expect_tx(&v_full[stage], L::kKTile);
    tma_load_tile<D, kN>(sV + stage * kN * D, &a.tv, &v_full[stage], h_kv, j * kN, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&k_full[s], 1);
      k_tickets[s] = 0;
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&v_full[s], 1);
      v_tickets[s] = 0;
    }
    mbar_init_fence();
    mbar_expect_tx(qdo_full, n_cons * 2 * L::kHalf);
    for (int half = 0; half < n_cons; ++half) {
      tma_load_tile<D, 64>(sQ + half * 64 * D, &a.tq, qdo_full, h, q0 + 64 * half, b);
      tma_load_tile<D, 64>(sDo + half * 64 * D, &a.tdo, qdo_full, h, q0 + 64 * half, b);
    }
    for (int j = 0; j < min(kKStages, n_kv); ++j) load_k(j);
    for (int j = 0; j < min(kVStages, n_kv); ++j) load_v(j);
  }
  __syncthreads();

  const int c = threadIdx.x / 128;
  if (c >= n_cons) return;  // every row of this consumer is past T
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = 16 * warp;        // the warp's first row in the consumer's half
  const int slot = 64 * c + r0;    // the warp's 16 lse and delta values in shared memory
  const int row_a = q0 + 64 * c + r0 + g;  // rows of the accumulators' e = 0, 1
  const int row_b = row_a + 8;             // and e = 2, 3
  const int n_c = c == 0 ? n_kv0 : n_kv;
  const int64_t lrow = static_cast<int64_t>(bh) * T;
  const In* sDoC = sDo + c * 64 * D;  // the consumer's half of do

  // delta = rowsum(do * o) for the warp's 16 rows, as in K2 above (two
  // lanes a row, the columns < the real D), written by the consumer that
  // owns the rows
  mbar_wait(qdo_full, 0);
  {
    const int r = r0 + lane / 2;
    const int row = q0 + 64 * c + r;
    const int c0 = (lane & 1) * (D / 2);
    float sum = 0.f;
    if (row < T) {
      const In* orow = at(static_cast<const In*>(a.o), a.so, b, h) + row * a.so.t;
#pragma unroll
      for (int cc = 0; cc < D / 2; cc += 8) {
        const int col = c0 + cc;
        if (col >= a.D) break;
        const In* drow = sDoC + (col / 64) * 64 * 64 + r * 64 + ((((col % 64) / 8) ^ (r & 7)) * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + col);
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
      sDelta[slot + lane / 2] = sum;
      sLse[slot + lane / 2] = row < T ? a.lse[lrow + row] : CUDART_INF_F;
      if (row < T) a.delta[lrow + row] = sum;
    }
  }
  __syncwarp();
  const float lb_a = sLse[slot + g] * kLog2e;
  const float lb_b = sLse[slot + g + 8] * kLog2e;
  const float dl_a = sDelta[slot + g];
  const float dl_b = sDelta[slot + g + 8];
  const float scale_log2 = a.scale * kLog2e;

  // K-major descriptors of this consumer's q and do halves and of stage 0's
  // K and V tiles; MN-major of stage 0's K tile (LBO: its 64-column blocks,
  // kN rows x 128 bytes apart)
  const uint64_t dQ = desc_sw128(sQ + c * 64 * D, 16);
  const uint64_t dDo = desc_sw128(sDoC, 16);
  const uint64_t dK = desc_sw128(sK, 16);
  const uint64_t dV = desc_sw128(sV, 16);
  const uint64_t dKn = desc_sw128(sK, kN * 128);

  // dq's columns [0, 128) and [128, 256)
  float dq0[64], dq1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    dq0[i] = 0.f;
    dq1[i] = 0.f;
  }
  int e_a = kDsExpMax, e_b = kDsExpMax;  // fp16: the rows' ds exponents

  // Turns at the tensor cores, a product each, as K1's at Dp = 256
  // (flash_fwd.cu): consumer c issues after its turn's barrier (3 + c) and
  // then passes the turn; consumer 0 goes first, takes the turns of the
  // tiles it skips, and consumer 1 does not pass its last, so no barrier
  // ever holds two arrivals of one consumer.
  const bool turns = n_cons == 2;
  const int n_turns = 2 * n_kv;
  if (turns && c == 1) named_arrive(3, 256);
  int turn = 0;
  for (int j = 0; j < n_c; ++j) {
    const int ks = j % kKStages;
    const int vs = j % kVStages;
    const uint32_t k_off = ks * L::kKTile;
    const uint32_t v_off = vs * L::kKTile;

    // s = q k^T and dp = do v^T: k-step kk reads columns [16kk, 16kk + 16)
    float s[kN / 2], dp[kN / 2];
    mbar_wait(&k_full[ks], (j / kKStages) & 1);
    mbar_wait(&v_full[vs], (j / kVStages) & 1);
    if (turns) named_barrier(3 + c, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qcol = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      const uint32_t kcol = k_off + (kk / 4) * kN * 128 + (kk % 4) * 32;
      wgmma_ss<kN, In>(s, desc_add(dQ, qcol), desc_add(dK, kcol), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qcol = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      const uint32_t vcol = v_off + (kk / 4) * kN * 128 + (kk % 4) * 32;
      wgmma_ss<kN, In>(dp, desc_add(dDo, qcol), desc_add(dV, vcol), kk > 0);
    }
    wgmma_commit();
    if (turns && (c == 0 || turn + 1 < n_turns)) named_arrive(4 - c, 256);
    ++turn;
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // V's stage is free once every consumer warp is past its dp: each warp
    // takes a ticket, and the warp that takes the last loads tile j +
    // kVStages there (K's the same after the dq product below)
    if (j + kVStages < n_kv && lane == 0 &&
        atomicAdd(&v_tickets[vs], 1) % (4 * n_cons) == 4 * n_cons - 1) {
      load_v(j + kVStages);
    }

    // ds = p (dp - delta) in f32 in place of s; masked only on the tiles
    // that hold the consumer's causal diagonal (its last 64 / kN) or T
    if ((kCausal && j >= n_c - 64 / kN) || (j + 1) * kN > T) {
      ds_values_d256<kN, true, kCausal>(s, dp, scale_log2, lb_a, lb_b, dl_a, dl_b, j * kN, row_a,
                                        t4, T);
    } else {
      ds_values_d256<kN, false, kCausal>(s, dp, scale_log2, lb_a, lb_b, dl_a, dl_b, 0, 0, 0, 0);
    }
    // packed to the input type as the A operand of ds k (fp16: each row
    // scaled by its 2^E)
    float sc_a = 1.f, sc_b = 1.f;
    if constexpr (kIsF16<In>) ds_row_scales_d256(s, dq0, dq1, e_a, e_b, sc_a, sc_b);
    uint32_t ds[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      if constexpr (kIsF16<In>) {
        ds[kk][0] = pack_f32<In>(s[8 * kk] * sc_a, s[8 * kk + 1] * sc_a);
        ds[kk][1] = pack_f32<In>(s[8 * kk + 2] * sc_b, s[8 * kk + 3] * sc_b);
        ds[kk][2] = pack_f32<In>(s[8 * kk + 4] * sc_a, s[8 * kk + 5] * sc_a);
        ds[kk][3] = pack_f32<In>(s[8 * kk + 6] * sc_b, s[8 * kk + 7] * sc_b);
      } else {
        ds[kk][0] = pack_f32<In>(s[8 * kk], s[8 * kk + 1]);
        ds[kk][1] = pack_f32<In>(s[8 * kk + 2], s[8 * kk + 3]);
        ds[kk][2] = pack_f32<In>(s[8 * kk + 4], s[8 * kk + 5]);
        ds[kk][3] = pack_f32<In>(s[8 * kk + 6], s[8 * kk + 7]);
      }
    }

    // dq += ds k: k-step kk reads keys [16kk, 16kk + 16) of K, 2048 bytes
    // on, into dq0 from K's column blocks 0-1 and dq1 from blocks 2-3
    if (turns) named_barrier(3 + c, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint64_t dk = desc_add(dKn, k_off + kk * 2048);
      wgmma_rs<128, In>(dq0, ds[kk], dk, 1);
      wgmma_rs<128, In>(dq1, ds[kk], desc_add(dk, 2 * kN * 128), 1);
    }
    wgmma_commit();
    if (turns && (c == 0 || turn + 1 < n_turns)) named_arrive(4 - c, 256);
    ++turn;
    wgmma_wait<0>();
    fence_regs(dq0);
    fence_regs(dq1);
    if (j + kKStages < n_kv && lane == 0 &&
        atomicAdd(&k_tickets[ks], 1) % (4 * n_cons) == 4 * n_cons - 1) {
      load_k(j + kKStages);
    }
  }
  if (turns && c == 0) {
    for (; turn < n_turns; ++turn) {  // the turns of the tiles it skips
      named_barrier(3, 256);
      named_arrive(4, 256);
    }
  }

  if constexpr (kIsF16<In>) {  // undo the rows' ds scales
    const float inv_a = pow2i(-e_a);
    const float inv_b = pow2i(-e_b);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      dq0[i] *= (i & 2) ? inv_b : inv_a;
      dq1[i] *= (i & 2) ? inv_b : inv_a;
    }
  }
  OutT* dqp = at(static_cast<OutT*>(a.dq), a.sdq, b, h);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    // columns at or past the real D are padding: the next head's dq lies
    // there (dq0's columns are all below D: D > 128 here)
    const int col = n * 8 + 2 * t4;
    const bool live = 128 + n * 8 < a.D;
    if (row_a < T) {
      store_out2(dqp + row_a * a.sdq.t + col, dq0[4 * n] * a.scale, dq0[4 * n + 1] * a.scale);
      if (live) {
        store_out2(dqp + row_a * a.sdq.t + 128 + col, dq1[4 * n] * a.scale,
                   dq1[4 * n + 1] * a.scale);
      }
    }
    if (row_b < T) {
      store_out2(dqp + row_b * a.sdq.t + col, dq0[4 * n + 2] * a.scale,
                 dq0[4 * n + 3] * a.scale);
      if (live) {
        store_out2(dqp + row_b * a.sdq.t + 128 + col, dq1[4 * n + 2] * a.scale,
                   dq1[4 * n + 3] * a.scale);
      }
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
  // bwd_dkv may turn the grid at Dp = 96: key tiles along x (the header)
  static constexpr bool kMayTurn = D == 96;
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
  void* dk;  // the input type or f32, the kernel's OutT
  void* dv;
  int T, H, group;
  int D;  // the real head dim; the kernel runs at its template's padded width
  Strides sdk, sdv;
  float scale;
  int keys_first;  // Dp = 96: key tiles along x, (b, h_kv) pairs along y
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

// One 16-bit pair of the accumulator layout into a p^T or ds^T tile (64 x 64
// of the input type, 128-byte swizzled, K-major as the A operand of p^T do or ds^T q):
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

template <int D, bool kCausal, typename In, typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ DkvArgs a) {
  using L = DkvSmem<D>;
  constexpr int kStages = L::kStages;
  constexpr int kPBufs = L::kPBufs;
  constexpr int P = panel_cols(D);  // a tile panel's columns (hopper.cuh)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  In* sK = reinterpret_cast<In*>(smem + L::kK);
  In* sV = reinterpret_cast<In*>(smem + L::kV);
  In* sQ = reinterpret_cast<In*>(smem + L::kQ);
  In* sDo = reinterpret_cast<In*>(smem + L::kDo);
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
  // the block's (b, h_kv) pair and key tile (unsigned, as blockIdx): pairs
  // along x and key tiles along y, y = 0 (the heaviest tiles) scheduled
  // first, or turned (keys_first): each pair's tiles side by side
  unsigned bkv = blockIdx.x, tile = blockIdx.y;
  if constexpr (L::kMayTurn) {
    if (a.keys_first) {
      bkv = blockIdx.y;
      tile = blockIdx.x;
    }
  }
  const int b = bkv / h_kv_count;
  const int h_kv = bkv % h_kv_count;
  const int k0 = tile * kDkvBlockN;
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
  // q and do (LBO: their panels, 64 rows x 128 bytes apart, or 64 bytes at
  // Dp = 96) from the block's first panel of dk and dv on
  const uint64_t dQ = desc_tile<D>(sQ, 16);
  const uint64_t dDo = desc_tile<D>(sDo, 16);
  const uint32_t col0_off = (col0 / P) * kDkvBlockM * P * 2;
  const uint64_t dQn = desc_add(desc_tile<D>(sQ, kDkvBlockM * P * 2), col0_off);
  const uint64_t dDon = desc_add(desc_tile<D>(sDo, kDkvBlockM * P * 2), col0_off);

  if (wg == 1) {
    // A: s^T = k q^T, p^T = exp(scale s^T - lse), handed to B in f32 and
    // stored in the input type for dv += p^T do
    const uint64_t dK = desc_tile<D>(sK, 16);
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
        const uint32_t kcol = kstep_off<D>(kk, kDkvBlockN);
        const uint32_t qcol = stage_off + kstep_off<D>(kk, kDkvBlockM);
        wgmma_ss<kDkvBlockM, In>(s, desc_add(dK, kcol), desc_add(dQ, qcol), kk > 0);
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
          store_pair(sPb, warp, g, t4, kk, r,
                     pack_f32<In>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]));
        }
      }
      // every thread's pairs visible to wgmma before any thread issues it
      fence_async_shared();
      named_barrier(1, 128);

      // dv += p^T do: k-step kk reads q rows [16kk, 16kk + 16), +32 bytes
      // along the p^T rows, 16 rows of each panel down the do tile (2048
      // bytes, 1024 at Dp = 96)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
        wgmma_ss_mn<L::kAccD, In>(dv, desc_add(dP, kk * 32),
                                  desc_add(dDon, stage_off + kk * 16 * P * 2), 1);
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
  // in the input type (fp16: each key's row scaled) for dk += ds^T q
  const uint64_t dV = desc_tile<D>(sV, 16);
  const uint64_t dDs = desc_sw128(sDs, 16);
  float dk[L::kAccD / 2];
#pragma unroll
  for (int i = 0; i < L::kAccD / 2; ++i) dk[i] = 0.f;
  int e_a = kDsExpMax, e_b = kDsExpMax;  // fp16: the keys' ds exponents
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
      const uint32_t kcol = kstep_off<D>(kk, kDkvBlockN);
      const uint32_t qcol = stage_off + kstep_off<D>(kk, kDkvBlockM);
      wgmma_ss<kDkvBlockM, In>(dp, desc_add(dV, kcol), desc_add(dDo, qcol), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);

    mbar_wait(&p_full[pb], (kPBufs == 2 ? it >> 1 : it) & 1);
    const float4* pf = sPf + pb * (kDkvBlockN * kDkvBlockM / 4);
    const float* dl = sDelta + stage * kDkvBlockM;
    if constexpr (kIsF16<In>) {
      // ds^T in f32 in place of dp^T, then each key's row scaled and packed
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
          dp[e] = p[2 * r] * (dp[e] - d.x);
          dp[e + 1] = p[2 * r + 1] * (dp[e + 1] - d.y);
        }
      }
      mbar_arrive(&p_empty[pb]);
      float sc_a, sc_b;
      ds_row_scales(dp, dk, e_a, e_b, sc_a, sc_b);
#pragma unroll
      for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          const float sc = (r & 1) ? sc_b : sc_a;  // bit 1 of e: key_b
          store_pair(sDs, warp, g, t4, kk, r, pack_f32<In>(dp[e] * sc, dp[e + 1] * sc));
        }
      }
    } else {
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
                     pack_f32<In>(p[2 * r] * (dp[e] - d.x), p[2 * r + 1] * (dp[e + 1] - d.y)));
        }
      }
      mbar_arrive(&p_empty[pb]);
    }
    fence_async_shared();
    named_barrier(2, 128);

    // dk += ds^T q, as dv in A
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
      wgmma_ss_mn<L::kAccD, In>(dk, desc_add(dDs, kk * 32),
                                desc_add(dQn, stage_off + kk * 16 * P * 2), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    mbar_arrive(&empty[stage]);
  }
  if constexpr (kIsF16<In>) {  // undo the keys' ds scales
    const float inv_a = pow2i(-e_a);
    const float inv_b = pow2i(-e_b);
#pragma unroll
    for (int i = 0; i < L::kAccD / 2; ++i) dk[i] *= (i & 2) ? inv_b : inv_a;
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

// ------------------------------------------------------- K3 at Dp = 256

// K3's shared-memory layout at Dp = 256, byte offsets from a 1024-aligned
// base: the column-split layout's 224 KB (the header), here serving all 256
// columns; tickets in place of the stages' empty barriers
struct Dkv256Smem {
  static constexpr int kStages = 2;                          // q/do ring depth
  static constexpr int kKTile = kDkvBlockN * 256 * 2;        // k or v
  static constexpr int kQTile = kDkvBlockM * 256 * 2;        // q or do, one stage
  static constexpr int kPTile = kDkvBlockN * kDkvBlockM * 2;  // p^T or ds^T, 16-bit
  static constexpr int kPf = kDkvBlockN * kDkvBlockM * 4;     // p^T in f32, A to B
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKTile;
  static constexpr int kQ = kV + kKTile;
  static constexpr int kDo = kQ + kStages * kQTile;
  static constexpr int kPb = kDo + kStages * kQTile;
  static constexpr int kDs = kPb + kPTile;
  static constexpr int kPfs = kDs + kPTile;
  static constexpr int kLse = kPfs + kPf;  // per stage kDkvBlockM f32
  static constexpr int kDelta = kLse + kStages * kDkvBlockM * 4;
  // kv_full, full[], p_full, p_empty
  static constexpr int kBars = kDelta + kStages * kDkvBlockM * 4;
  static constexpr int kTickets = kBars + (1 + kStages + 2) * 8;  // an int a stage
  static constexpr int kBytes = kTickets + kStages * 4 + 1024;
};

// K3 at Dp = 256 (the header has the design): one block per (b*h_kv,
// 64-key tile), consumers A and B split by product, each with all 256
// columns of its output
template <bool kCausal, typename In, typename OutT>
__global__ void __launch_bounds__(kD256Threads, 1)
    flash_bwd_dkv_kernel_d256(const __grid_constant__ DkvArgs a) {
  constexpr int D = 256;
  using L = Dkv256Smem;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  In* sK = reinterpret_cast<In*>(smem + L::kK);
  In* sV = reinterpret_cast<In*>(smem + L::kV);
  In* sQ = reinterpret_cast<In*>(smem + L::kQ);
  In* sDo = reinterpret_cast<In*>(smem + L::kDo);
  unsigned char* sPb = smem + L::kPb;
  unsigned char* sDs = smem + L::kDs;
  float4* sPf = reinterpret_cast<float4*>(smem + L::kPfs);
  float* sLb = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* p_full = full + kStages;
  uint64_t* p_empty = p_full + 1;
  int* tickets = reinterpret_cast<int*>(smem + L::kTickets);

  const int T = a.T;
  const int h_kv_count = a.H / a.group;
  const int b = blockIdx.x / h_kv_count;
  const int h_kv = blockIdx.x % h_kv_count;
  const int k0 = blockIdx.y * kDkvBlockN;  // y = 0, the heaviest tiles, is scheduled first
  const int n_q_tiles = (T + kDkvBlockM - 1) / kDkvBlockM;
  const int first = kCausal ? k0 / kDkvBlockM : 0;  // earlier q tiles see none of these keys
  const int per_head = n_q_tiles - first;
  const int n_iter = a.group * per_head;  // q tile `it % per_head` of head `it / per_head`

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the loading lane 0's expect_tx, each lane's lse/delta
      tickets[s] = 0;
    }
    mbar_init(p_full, 128);   // consumer A's threads, p^T stored
    mbar_init(p_empty, 128);  // consumer B's threads, p^T read
    mbar_init_fence();
    mbar_expect_tx(kv_full, 2 * L::kKTile);
    tma_load_tile<D, kDkvBlockN>(sK, &a.tk, kv_full, h_kv, k0, b);
    tma_load_tile<D, kDkvBlockN>(sV, &a.tv, kv_full, h_kv, k0, b);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;  // consumer A (0: p^T, dv) or B (1: dp^T, ds^T, dk)
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int key_a = k0 + 16 * warp + g;  // keys of the accumulators' e = 0, 1
  const int key_b = key_a + 8;           // and e = 2, 3

  // q/do tile `it` of the walk into its stage, by one whole warp: lane 0
  // starts the TMA loads, the 32 lanes store the stage's lse (times log2 e)
  // and delta (+inf and 0 for rows past T), and each lane arrives on the
  // stage's full barrier after its own stores
  auto load_stage = [&](int it) {
    const int stage = it % kStages;
    const int hq = h_kv * a.group + it / per_head;
    const int q0 = (first + it % per_head) * kDkvBlockM;
    if (lane == 0) {
      mbar_expect_tx(&full[stage], 2 * L::kQTile);
      tma_load_tile<D, kDkvBlockM>(sQ + stage * kDkvBlockM * D, &a.tq, &full[stage], hq, q0, b);
      tma_load_tile<D, kDkvBlockM>(sDo + stage * kDkvBlockM * D, &a.tdo, &full[stage], hq, q0,
                                   b);
    }
    const int64_t lrow = static_cast<int64_t>(b * a.H + hq) * T;
#pragma unroll
    for (int j = 0; j < kDkvBlockM / 32; ++j) {
      const int r = lane + 32 * j;
      const int row = q0 + r;
      sLb[stage * kDkvBlockM + r] = row < T ? a.lse[lrow + row] * kLog2e : CUDART_INF_F;
      sDelta[stage * kDkvBlockM + r] = row < T ? a.delta[lrow + row] : 0.f;
    }
    mbar_arrive(&full[stage]);
  };
  // the stage of tile `it` is free once every warp of both consumers is past
  // its reads of it: each warp takes a ticket, and the warp that takes the
  // last loads tile it + kStages there
  auto release = [&](int it) {
    if (it + kStages >= n_iter) return;
    int ticket = 0;
    if (lane == 0) ticket = atomicAdd(&tickets[it % kStages], 1);
    if (__shfl_sync(0xffffffffu, ticket, 0) % 8 == 7) load_stage(it + kStages);
  };
  if (threadIdx.x < 32) {
    for (int it = 0; it < min(kStages, n_iter); ++it) load_stage(it);
  }

  // the stage-0 descriptors: K-major q, do and the score operands, MN-major
  // q and do (LBO: their 64-column blocks, 64 rows x 128 bytes apart)
  const uint64_t dQ = desc_sw128(sQ, 16);
  const uint64_t dDo = desc_sw128(sDo, 16);
  const uint64_t dQn = desc_sw128(sQ, kDkvBlockM * 128);
  const uint64_t dDon = desc_sw128(sDo, kDkvBlockM * 128);

  if (wg == 0) {
    // A: s^T = k q^T, p^T = exp(scale s^T - lse), handed to B in f32 and
    // stored in the input type for dv += p^T do
    const uint64_t dK = desc_sw128(sK, 16);
    const uint64_t dP = desc_sw128(sPb, 16);
    const float scale_log2 = a.scale * kLog2e;
    float dv0[64], dv1[64];  // dv's columns [0, 128) and [128, 256)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      dv0[i] = 0.f;
      dv1[i] = 0.f;
    }
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int stage = it % kStages;
      const int q0 = (first + it % per_head) * kDkvBlockM;
      const uint32_t stage_off = stage * L::kQTile;
      mbar_wait(&full[stage], (it / kStages) & 1);

      float s[kDkvBlockM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kcol = (kk / 4) * kDkvBlockN * 128 + (kk % 4) * 32;
        const uint32_t qcol = stage_off + (kk / 4) * kDkvBlockM * 128 + (kk % 4) * 32;
        wgmma_ss<kDkvBlockM, In>(s, desc_add(dK, kcol), desc_add(dQ, qcol), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      // only the causal diagonal (the head's first q tile) and a ragged last tile
      if ((kCausal && q0 == k0) || q0 + kDkvBlockM > T) mask_tile<kCausal>(s, key_a, q0, t4, T);
      p_tile(s, sLb + stage * kDkvBlockM, scale_log2, t4);

      // p^T in f32 to B, thread-major: B's thread t reads what A's thread t
      // wrote, the same accumulator positions
      if (it > 0) mbar_wait(p_empty, (it - 1) & 1);
#pragma unroll
      for (int j = 0; j < kDkvBlockM / 8; ++j) {
        sPf[j * 128 + tid] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      }
      mbar_arrive(p_full);

#pragma unroll
      for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          store_pair(sPb, warp, g, t4, kk, r,
                     pack_f32<In>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]));
        }
      }
      // every thread's pairs visible to wgmma before any thread issues it
      fence_async_shared();
      named_barrier(1, 128);

      // dv += p^T do: k-step kk reads q rows [16kk, 16kk + 16), +32 bytes
      // along the p^T rows, +2048 bytes down the do tile; dv0 from do's
      // column blocks 0-1, dv1 from blocks 2-3
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
        const uint64_t dpk = desc_add(dP, kk * 32);
        const uint64_t ddo = desc_add(dDon, stage_off + kk * 2048);
        wgmma_ss_mn<128, In>(dv0, dpk, ddo, 1);
        wgmma_ss_mn<128, In>(dv1, dpk, desc_add(ddo, 2 * kDkvBlockM * 128), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv0);
      fence_regs(dv1);
      release(it);
    }
    OutT* dvp = at(static_cast<OutT*>(a.dv), a.sdv, b, h_kv);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      // dv0's columns are all below D (D > 128 here); dv1's past D are padding
      const int col = n * 8 + 2 * t4;
      const bool live = 128 + n * 8 < a.D;
      if (key_a < T) {
        store_out2(dvp + key_a * a.sdv.t + col, dv0[4 * n], dv0[4 * n + 1]);
        if (live) store_out2(dvp + key_a * a.sdv.t + 128 + col, dv1[4 * n], dv1[4 * n + 1]);
      }
      if (key_b < T) {
        store_out2(dvp + key_b * a.sdv.t + col, dv0[4 * n + 2], dv0[4 * n + 3]);
        if (live) {
          store_out2(dvp + key_b * a.sdv.t + 128 + col, dv1[4 * n + 2], dv1[4 * n + 3]);
        }
      }
    }
    return;
  }

  // B: dp^T = v do^T, ds^T = p^T (dp^T - delta) in f32 with A's p^T, stored
  // in the input type (fp16: each key's row scaled) for dk += ds^T q
  const uint64_t dV = desc_sw128(sV, 16);
  const uint64_t dDs = desc_sw128(sDs, 16);
  float dk0[64], dk1[64];  // dk's columns [0, 128) and [128, 256)
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    dk0[i] = 0.f;
    dk1[i] = 0.f;
  }
  int e_a = kDsExpMax, e_b = kDsExpMax;  // fp16: the keys' ds exponents
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % kStages;
    const uint32_t stage_off = stage * L::kQTile;
    mbar_wait(&full[stage], (it / kStages) & 1);

    float dp[kDkvBlockM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t kcol = (kk / 4) * kDkvBlockN * 128 + (kk % 4) * 32;
      const uint32_t qcol = stage_off + (kk / 4) * kDkvBlockM * 128 + (kk % 4) * 32;
      wgmma_ss<kDkvBlockM, In>(dp, desc_add(dV, kcol), desc_add(dDo, qcol), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);

    // ds^T in f32 in place of dp^T, then packed (fp16: each key's row scaled)
    mbar_wait(p_full, it & 1);
    const float* dl = sDelta + stage * kDkvBlockM;
#pragma unroll
    for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
      const float4 p_lo = sPf[(2 * kk) * 128 + tid];
      const float4 p_hi = sPf[(2 * kk + 1) * 128 + tid];
      const float p[8] = {p_lo.x, p_lo.y, p_lo.z, p_lo.w, p_hi.x, p_hi.y, p_hi.z, p_hi.w};
      const float2 d_lo = *reinterpret_cast<const float2*>(dl + 16 * kk + 2 * t4);
      const float2 d_hi = *reinterpret_cast<const float2*>(dl + 16 * kk + 8 + 2 * t4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 d = (r & 2) ? d_hi : d_lo;
        const int e = 8 * kk + 2 * r;
        dp[e] = p[2 * r] * (dp[e] - d.x);
        dp[e + 1] = p[2 * r + 1] * (dp[e + 1] - d.y);
      }
    }
    mbar_arrive(p_empty);
    float sc_a = 1.f, sc_b = 1.f;
    if constexpr (kIsF16<In>) ds_row_scales_d256(dp, dk0, dk1, e_a, e_b, sc_a, sc_b);
#pragma unroll
    for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kk + 2 * r;
        if constexpr (kIsF16<In>) {
          const float sc = (r & 1) ? sc_b : sc_a;  // bit 1 of e: key_b
          store_pair(sDs, warp, g, t4, kk, r, pack_f32<In>(dp[e] * sc, dp[e + 1] * sc));
        } else {
          store_pair(sDs, warp, g, t4, kk, r, pack_f32<In>(dp[e], dp[e + 1]));
        }
      }
    }
    fence_async_shared();
    named_barrier(2, 128);

    // dk += ds^T q, as dv in A
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvBlockM / 16; ++kk) {
      const uint64_t dsk = desc_add(dDs, kk * 32);
      const uint64_t dq = desc_add(dQn, stage_off + kk * 2048);
      wgmma_ss_mn<128, In>(dk0, dsk, dq, 1);
      wgmma_ss_mn<128, In>(dk1, dsk, desc_add(dq, 2 * kDkvBlockM * 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk0);
    fence_regs(dk1);
    release(it);
  }
  if constexpr (kIsF16<In>) {  // undo the keys' ds scales
    const float inv_a = pow2i(-e_a);
    const float inv_b = pow2i(-e_b);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      dk0[i] *= (i & 2) ? inv_b : inv_a;
      dk1[i] *= (i & 2) ? inv_b : inv_a;
    }
  }
  OutT* dkp = at(static_cast<OutT*>(a.dk), a.sdk, b, h_kv);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = n * 8 + 2 * t4;
    const bool live = 128 + n * 8 < a.D;
    if (key_a < T) {
      store_out2(dkp + key_a * a.sdk.t + col, dk0[4 * n] * a.scale, dk0[4 * n + 1] * a.scale);
      if (live) {
        store_out2(dkp + key_a * a.sdk.t + 128 + col, dk1[4 * n] * a.scale,
                   dk1[4 * n + 1] * a.scale);
      }
    }
    if (key_b < T) {
      store_out2(dkp + key_b * a.sdk.t + col, dk0[4 * n + 2] * a.scale,
                 dk0[4 * n + 3] * a.scale);
      if (live) {
        store_out2(dkp + key_b * a.sdk.t + 128 + col, dk1[4 * n + 2] * a.scale,
                   dk1[4 * n + 3] * a.scale);
      }
    }
  }
}

template <int D, bool kCausal, typename In, typename OutT>
cudaError_t launch_dq(const DqArgs& a, int B, cudaStream_t stream) {
  static bool attr_set = false;
  if constexpr (D == 256) {
    constexpr int kSmem = Dq256Smem<kDq256Keys>::kBytes;
    const cudaError_t err =
        allow_smem(flash_bwd_dq_kernel_d256<kCausal, In, OutT>, kSmem, attr_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.T + 127) / 128, B * a.H);
    flash_bwd_dq_kernel_d256<kCausal, In, OutT><<<grid, kD256Threads, kSmem, stream>>>(a);
  } else {
    constexpr int kSmem = DqSmem<D>::kBytes;
    const cudaError_t err =
        allow_smem(flash_bwd_dq_kernel<D, kCausal, In, OutT>, kSmem, attr_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.T + DqSmem<D>::kBlockM - 1) / DqSmem<D>::kBlockM, B * a.H);
    flash_bwd_dq_kernel<D, kCausal, In, OutT><<<grid, kWsThreads, kSmem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int D, bool kCausal, typename In, typename OutT>
cudaError_t launch_dkv(const DkvArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = DkvSmem<D>::kBytes;
  static bool attr_set = false;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel<D, kCausal, In, OutT>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  // key tiles along y, so that every tile 0 (the heaviest) is scheduled
  // first, or turned at Dp = 96 (keys_first); the column halves of dk and
  // dv along z at Dp = 256
  const int n_tiles = (a.T + kDkvBlockN - 1) / kDkvBlockN;
  const int n_kv = B * (a.H / a.group);
  const dim3 grid = DkvSmem<D>::kMayTurn && a.keys_first
                        ? dim3(n_tiles, n_kv)
                        : dim3(n_kv, n_tiles, DkvSmem<D>::kSplitD ? 2 : 1);
  flash_bwd_dkv_kernel<D, kCausal, In, OutT><<<grid, kWsThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kCausal, typename In, typename OutT>
cudaError_t launch_dkv_d256(const DkvArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = Dkv256Smem::kBytes;
  static bool attr_set = false;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel_d256<kCausal, In, OutT>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (a.H / a.group), (a.T + kDkvBlockN - 1) / kDkvBlockN);
  flash_bwd_dkv_kernel_d256<kCausal, In, OutT><<<grid, kD256Threads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

bool bad_dims(int B, int T, int H, int H_kv, int D) {
  return B <= 0 || T <= 0 || H_kv <= 0 || H % H_kv != 0 || !head_dim_ok(D);
}

template <typename In, typename OutT>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, int B, int T, int H, int H_kv, int D,
           int causal, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
           int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_st,
           int64_t o_sh, int64_t do_sb, int64_t do_st, int64_t do_sh, int64_t dq_sb,
           int64_t dq_st, int64_t dq_sh, void* stream) {
  if (bad_dims(B, T, H, H_kv, D)) return static_cast<int>(cudaErrorInvalidValue);
  DqArgs a;
  const int Dp = bwd_padded_head_dim(D);
  // a box's rows: a q or do tile's and a K/V tile's, or at Dp = 256 a q or
  // do half's and a kDq256Keys-key tile's; its columns a panel's
  const int rows = Dp == 256 ? 64 : DqSmem<128>::kBlockM;
  const int keys = Dp == 256 ? kDq256Keys : kDqBlockN;
  const int cols = panel_cols(Dp);
  int err = make_tile_map<In>(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, rows, cols);
  if (err == 0) {
    err = make_tile_map<In>(&a.tdo, dout, B, T, H, D, do_sb, do_st, do_sh, rows, cols);
  }
  if (err == 0) err = make_tile_map<In>(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, keys, cols);
  if (err == 0) err = make_tile_map<In>(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, keys, cols);
  if (err != 0) return err;
  a.o = o;
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
    launched = causal ? launch_dq<64, true, In, OutT>(a, B, s)
                      : launch_dq<64, false, In, OutT>(a, B, s);
  } else if (Dp == 96) {
    launched = causal ? launch_dq<96, true, In, OutT>(a, B, s)
                      : launch_dq<96, false, In, OutT>(a, B, s);
  } else if (Dp == 128) {
    launched = causal ? launch_dq<128, true, In, OutT>(a, B, s)
                      : launch_dq<128, false, In, OutT>(a, B, s);
  } else {
    launched = causal ? launch_dq<256, true, In, OutT>(a, B, s)
                      : launch_dq<256, false, In, OutT>(a, B, s);
  }
  return static_cast<int>(launched);
}

template <typename In, typename OutT>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int B, int T, int H, int H_kv, int D,
            int causal, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
            int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t do_sb,
            int64_t do_st, int64_t do_sh, int64_t dk_sb, int64_t dk_st, int64_t dk_sh,
            int64_t dv_sb, int64_t dv_st, int64_t dv_sh, void* stream) {
  if (bad_dims(B, T, H, H_kv, D)) return static_cast<int>(cudaErrorInvalidValue);
  DkvArgs a;
  const int Dp = bwd_padded_head_dim(D);
  const int cols = panel_cols(Dp);
  int err = make_tile_map<In>(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, kDkvBlockM, cols);
  if (err == 0) {
    err = make_tile_map<In>(&a.tdo, dout, B, T, H, D, do_sb, do_st, do_sh, kDkvBlockM, cols);
  }
  if (err == 0) {
    err = make_tile_map<In>(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, kDkvBlockN, cols);
  }
  if (err == 0) {
    err = make_tile_map<In>(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, kDkvBlockN, cols);
  }
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
  // the grid's shape against the card's SMs: at Dp = 96 a grid whose
  // blocks running at once would hold fewer than two key tiles of a (b,
  // h_kv) pair is turned, so that each pair's key tiles run side by side
  // (the header); at Dp = 256 fewer key-tile blocks than SMs take the column
  // split
  int dev = 0, sms = 0;
  cudaError_t got = cudaGetDevice(&dev);
  if (got == cudaSuccess) got = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  a.keys_first = Dp == 96 && 2 * B * H_kv > sms;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  if (Dp == 64) {
    launched = causal ? launch_dkv<64, true, In, OutT>(a, B, s)
                      : launch_dkv<64, false, In, OutT>(a, B, s);
  } else if (Dp == 96) {
    launched = causal ? launch_dkv<96, true, In, OutT>(a, B, s)
                      : launch_dkv<96, false, In, OutT>(a, B, s);
  } else if (Dp == 128) {
    launched = causal ? launch_dkv<128, true, In, OutT>(a, B, s)
                      : launch_dkv<128, false, In, OutT>(a, B, s);
  } else {
    // the column-split K3 (two blocks a key tile) where a grid of whole key
    // tiles would leave SMs idle, else the Dp = 256 kernel (the header)
    const bool split = B * H_kv * ((T + kDkvBlockN - 1) / kDkvBlockN) < sms;
    if (split) {
      launched = causal ? launch_dkv<256, true, In, OutT>(a, B, s)
                        : launch_dkv<256, false, In, OutT>(a, B, s);
    } else {
      launched = causal ? launch_dkv_d256<true, In, OutT>(a, B, s)
                        : launch_dkv_d256<false, In, OutT>(a, B, s);
    }
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

#ifndef HIVED_FLASH_F16
// K2. q, o, do [B, T, H, D], k/v [B, T, H_kv, D] and dq [B, T, H, D] in
// bf16, addressed through the given element strides (D contiguous, every
// row 16-byte aligned, strides positive); lse [B*H, T] f32 from the
// forward; delta [B*H, T] f32 is written for K3. Returns 0, the CUresult of
// a tensor map that could not be encoded, or the cudaError_t of the launch.
extern "C" int hived_flash_bwd_dq(HIVED_DQ_PARAMS) { return bwd_dq<bf16, bf16>(HIVED_DQ_ARGS); }

// K2 with dq in f32 (its strides even, its base 8-byte aligned); o is bf16.
extern "C" int hived_flash_bwd_dq_f32(HIVED_DQ_PARAMS) {
  return bwd_dq<bf16, float>(HIVED_DQ_ARGS);
}

// K3. q, do [B, T, H, D], k/v and dk/dv [B, T, H_kv, D] in bf16, through
// their element strides (D contiguous; q, do, k and v every row 16-byte
// aligned, strides positive); lse and delta [B*H, T] f32 (delta from K2).
// Returns 0, the CUresult of a tensor map that could not be encoded, or the
// cudaError_t of the launch.
extern "C" int hived_flash_bwd_dkv(HIVED_DKV_PARAMS) {
  return bwd_dkv<bf16, bf16>(HIVED_DKV_ARGS);
}

// K3 with dk and dv in f32 (their strides even, their bases 8-byte aligned).
extern "C" int hived_flash_bwd_dkv_f32(HIVED_DKV_PARAMS) {
  return bwd_dkv<bf16, float>(HIVED_DKV_ARGS);
}

#else

// K2 with q, k, v, o and do in fp16: dq in fp16, or in f32.
extern "C" int hived_flash_bwd_dq_f16(HIVED_DQ_PARAMS) { return bwd_dq<f16, f16>(HIVED_DQ_ARGS); }

extern "C" int hived_flash_bwd_dq_f16_f32(HIVED_DQ_PARAMS) {
  return bwd_dq<f16, float>(HIVED_DQ_ARGS);
}

// K3 with q, k, v and do in fp16: dk and dv in fp16, or in f32.
extern "C" int hived_flash_bwd_dkv_f16(HIVED_DKV_PARAMS) {
  return bwd_dkv<f16, f16>(HIVED_DKV_ARGS);
}

extern "C" int hived_flash_bwd_dkv_f16_f32(HIVED_DKV_PARAMS) {
  return bwd_dkv<f16, float>(HIVED_DKV_ARGS);
}

#endif  // HIVED_FLASH_F16
