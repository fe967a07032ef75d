// Flash-attention forward (K1) for Hopper (sm_90a), bf16 or fp16 in, f32
// softmax state.
//
// Replaces hivedscheduler_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_forward). It computes the same function: for every (batch, q head)
// and query row, o = softmax(scale * q k^T [causal mask]) v over the row's
// keys, with scale = 1/sqrt(D), the running max m, the running sum l and the
// output accumulator all in f32, NEG_INF = -1e30 for masked scores, the
// m_safe clamp at -0.5e30 and the l == 0 guard, and lse = m_safe + log(l).
// GQA is read in place: q head h uses kv head h / (H / H_kv), so compact
// k/v is never expanded. lse is stored [B*H, T] (the 128-lane copy of the
// TPU kernel is a layout artefact of its vector unit).
//
// Bound on an H100: two products of 2*D flops per (row, key) pair, counted
// over the keys the mask leaves (T(T+1)/2 per head when causal). At the
// flagship shape (B=8, T=2048, H=16, H_kv=8, D=128, causal) that is
// 137.5 GFLOP, 0.139 ms at 989 TFLOP/s, against 0.060 ms for the 202 MB
// the call must move at 3.35 TB/s: the tensor cores bound it, not memory.
//
// Design (hopper.cuh has the building blocks): only wgmma reaches the
// card's full tensor-core rate, and it wants its operands in swizzled shared
// memory fed without spending the consumers' registers or instructions.
// - One block of three warpgroups per (b*h, 128-row q tile), heaviest
//   causal tiles first. Warpgroup 0 is the producer: it gives up its
//   registers (setmaxnreg) and one thread starts TMA loads, the q tile
//   once, then 128-key K and V tiles into a two-stage ring of full/empty
//   mbarrier pairs (at D=128, 32 + 2 x (32 + 32) KB: one block an SM).
// - Warpgroups 1 and 2 are consumers of 64 q rows each. They ask for 240
//   registers a thread with setmaxnreg; ptxas reports the block's launch
//   count, 168, and no spill (what it makes of the request: Dp = 256
//   below). Per tile: s = q k^T as SS wgmma
//   m64n128k16 (D/16 k-steps, 64 f32 registers); scale, mask and online
//   softmax in f32, a row within one quad of lanes; o += p v as RS wgmma
//   (p packed to bf16 in registers is the A operand, V the MN-major B
//   operand, so no scalar V loads); then the stage is released on its
//   empty barrier. The two consumers run out of step, so one's softmax
//   overlaps the other's products.
// - Only the last tile of a block's loop is masked: it holds the causal
//   diagonal, and the keys at or past a ragged T. Keys past T are loaded as
//   zeros by TMA (the box never crosses into the next batch) and get -inf.
// - The 1/sqrt(D) scale is applied to the f32 scores, not to a bf16 q.
// Inputs are addressed through their [B, T, H, D] strides (D contiguous):
// tensor maps are encoded per call from the strides, so the caller makes no
// [B*H, T, D] copy.
// Head dims: any D that is a multiple of 8 up to 256 runs on the template
// of its padded width Dp = 64, 128 or 256 (flash_common.cuh). The tensor
// maps declare the real D, so TMA fills a box's columns past D with zeros
// (and credits the whole box to the stage's barrier, as for rows past T):
// zero q and k columns leave the scores unchanged, zero v columns give zero
// o columns, and the epilogue stores only columns < D. The scale is the
// real D's. The tensor cores do Dp / D times the work (4/3 at D = 96, 1.88
// at D = 136, 4/3 at D = 192).
// At Dp = 256 (Gemma's head dim; flash_fwd_kernel_d256) each score is
// formed once, as at Dp = 64 and 128: a block takes 128 q rows, consumer c
// rows [64c, 64c + 64) with all 256 columns of o, over 64-key K/V tiles.
// Per tile a consumer forms s = q k^T as SS wgmma m64n64k16 (16 k-steps, 32
// f32 registers), its online softmax, and o += p v as two RS wgmma
// m64n128k16 a k-step (V's column blocks 0-1, then 2-3) into o's 128 f32
// registers a thread; a K/V tile is loaded once a 128 rows. Registers
// decide the block's shape: a consumer holds ~200 (o 128, s 32, p 16). With
// nvcc 12.9, ptxas gave this kernel 168 registers a thread in every block
// of more than 256 threads tried: 288 threads, and 384 whose consumers ask
// for 168 or 240 with setmaxnreg, after the block's barrier or in
// FlashAttention-3's order (a warp-uniform warpgroup index, a third
// warpgroup alone loading); each spilled 548-624 bytes and serialized its
// wgmma (C7512; `python -m hivedscheduler_tpu_torch.ops.regs_probe`).
// FlashAttention-3 holds 240 a consumer in such a block; what it does that
// this kernel does not is not known. So the block is the two consumer
// warpgroups alone (190-205 registers, no spill), and they
// load their own tiles: thread 0 loads q and the first two K/V tiles; after
// tile j every consumer warp takes a ticket of the stage, and the warp that
// takes the last loads tile j + 2 there, so neither consumer waits for the
// other. The consumers take turns at the tensor cores, a product each (two
// named barriers), so one's products queue ahead of the other's and its
// softmax runs under them. Each consumer masks only its own last tile:
// causal, consumer c stops at its diagonal tile 2 q_tile + c (consumer 0
// never reads the block's last tile); past a ragged T it is the tile that
// holds T. q is loaded as two 64-row halves, one a consumer, each laid out
// as a K tile is, so the s product walks both with the same offsets (the
// tensor maps take 64-row boxes); a half wholly past T is not loaded and
// its consumer leaves at once. Shared memory: q 64 + 2 x (32 + 32) = 192
// KB. The other way to form each score once, 64-row blocks whose consumers
// split o's columns and each form half of a tile's scores, would trade
// registers for an exchange of row maxima, p and l through shared memory
// and a barrier between the consumers every tile; with the registers to
// hold o whole, neither is needed.
//
// Input type: bf16 (hived_flash_fwd, hived_flash_fwd_f32) or fp16
// (hived_flash_fwd_f16, hived_flash_fwd_f16_f32), a template parameter: the
// tensor maps' data type, the wgmma type suffix and the packing of p differ,
// nothing else. The fp16 entry points are a library of their own
// (flash_fwd_f16.cu defines HIVED_FLASH_F16 and includes this file), so that
// nvcc compiles them beside the bf16 ones. p lies in [0, 1]: in fp16 a p
// below 6.1e-5 is subnormal, with an absolute error under 2^-25, far below
// bf16's relative 2^-9 on the p that carry o. f32 inputs, and D past 256,
// run flash_generic.cu.
//
// Output type: o is stored in the input type (hived_flash_fwd,
// hived_flash_fwd_f16) or in f32 (the _f32 entry points), the counterpart of
// _flash_forward's out_dtype=f32, which the sequence-parallel ring calls once
// a hop and merges in f32. Only the epilogue's store differs: at the same
// inputs the f32 o, rounded once to the input type, is the 16-bit kernel's o
// bit for bit; lse is the same f32 either way. The f32 form writes twice o's
// bytes (at the flagship shape 64 MB more than the bf16 form's 202 MB, still
// under the operations' bound).

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hived;

constexpr int kStages = 2;  // K/V ring depth

// shared-memory layout at Dp = 64 and 128, byte offsets from a 1024-aligned
// base: 128 q rows a block (two consumer warpgroups of 64), 128 keys a K/V
// tile
template <int D>
struct FwdSmem {
  static constexpr int kBlock = 128;
  static constexpr int kTile = kBlock * D * 2;  // one tile (Q, K or V)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;  // q_full, k_full[], v_full[], empty[]
  static constexpr int kBytes = kBars + (1 + 3 * kStages) * 8 + 1024;  // + alignment slack
};

// the same at Dp = 256: 128 q rows a block as two 64-row halves, one a
// consumer, each laid out as a K tile is; 64 keys a K/V tile
struct Fwd256Smem {
  static constexpr int kBlock = 128;
  static constexpr int kKeys = 64;
  static constexpr int kTile = kKeys * 256 * 2;  // 32 KB: a q half, a K or a V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;  // q_full, k_full[], v_full[]
  static constexpr int kTickets = kBars + (1 + 2 * kStages) * 8;  // one int a stage
  static constexpr int kBytes = kTickets + kStages * 4 + 1024;
};

// the Dp = 256 block: two consumer warpgroups and no producer, since ptxas
// gave this kernel 168 registers a thread past 256 threads (the header)
constexpr int kD256Threads = 256;

struct FwdArgs {
  CUtensorMap tq, tk, tv;
  void* o;  // the input type or f32, the kernel's OutT
  float* lse;
  int T, H, group;
  int D;  // the real head dim; the kernel runs at its template's padded width
  int64_t o_sb, o_st, o_sh;
  float scale;
};

// scores of one tile in place: scale, and on the last tile mask (keys past T
// to -inf, causal keys past the row to NEG_INF, as _fwd_kernel does)
template <int kN, bool kMask, bool kCausal>
__device__ __forceinline__ void scale_mask(float (&s)[kN / 2], float scale, int k0, int row_a,
                                           int t4, int T) {
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e] * scale;
      if (kMask) {
        const int row = e < 2 ? row_a : row_a + 8;
        const int col = k0 + n * 8 + 2 * t4 + (e & 1);
        if (col >= T) {
          x = -CUDART_INF_F;
        } else if (kCausal && col > row) {
          x = kNegInf;
        }
      }
      s[4 * n + e] = x;
    }
  }
}

template <int D, bool kCausal, typename In, typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_kernel(const __grid_constant__ FwdArgs a) {
  using L = FwdSmem<D>;
  constexpr int kN = L::kBlock;  // keys per tile, and q rows per block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  In* sQ = reinterpret_cast<In*>(smem + L::kQ);
  In* sK = reinterpret_cast<In*>(smem + L::kK);
  In* sV = reinterpret_cast<In*>(smem + L::kV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int T = a.T;
  const int n_q_tiles = (T + kN - 1) / kN;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * kN;
  int n_kv = (T + kN - 1) / kN;
  if (kCausal) n_kv = min(n_kv, q_tile + 1);  // tiles past the diagonal are never loaded

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
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
      mbar_expect_tx(q_full, L::kTile);
      tma_load_tile<D, kN>(sQ, &a.tq, q_full, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int stage = j % kStages;
        if (j >= kStages) mbar_wait(&empty[stage], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&k_full[stage], L::kTile);
        tma_load_tile<D, kN>(sK + stage * kN * D, &a.tk, &k_full[stage], h_kv, j * kN, b);
        mbar_expect_tx(&v_full[stage], L::kTile);
        tma_load_tile<D, kN>(sV + stage * kN * D, &a.tv, &v_full[stage], h_kv, j * kN, b);
      }
    }
    return;
  }

  // consumer c owns q rows [64c, 64c + 64) of the tile, all of o's columns
  regs_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rows_c = 64 * c;                      // the consumer's first row in the tile
  const int row_a = q0 + rows_c + 16 * warp + g;  // rows of s[4n], s[4n+1]
  const int row_b = row_a + 8;                    // rows of s[4n+2], s[4n+3]

  // K-major descriptors of this consumer's q rows and of stage 0's K tile;
  // MN-major of stage 0's V tile (LBO: the 64-column blocks of V)
  const uint64_t dQ = desc_sw128(sQ + rows_c * 64, 16);
  const uint64_t dK = desc_sw128(sK, 16);
  const uint64_t dV = desc_sw128(sV, kN * 128);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;
  float l_a = 0.f, l_b = 0.f;  // this thread's share of the row sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int stage = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t stage_off = stage * L::kTile;

    // s = q k^T: k-step kk reads columns [16kk, 16kk + 16) of q and K
    float s[kN / 2];
    mbar_wait(&k_full[stage], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk / 4) * kN * 128 + (kk % 4) * 32;
      wgmma_ss<kN, In>(s, desc_add(dQ, col), desc_add(dK, stage_off + col), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (j == n_kv - 1) {
      scale_mask<kN, true, kCausal>(s, a.scale, j * kN, row_a, t4, T);
    } else {
      scale_mask<kN, false, kCausal>(s, a.scale, 0, 0, 0, 0);
    }

    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float ms_a = fmaxf(mn_a, kClamp);
    const float ms_b = fmaxf(mn_b, kClamp);
    const float corr_a = exp2f((fmaxf(m_a, kClamp) - ms_a) * kLog2e);
    const float corr_b = exp2f((fmaxf(m_b, kClamp) - ms_b) * kLog2e);
    m_a = mn_a;
    m_b = mn_b;
    const float mb_a = ms_a * kLog2e;
    const float mb_b = ms_b * kLog2e;

    // p = exp(s - m_safe), packed to the input type as the A operand of p v: the
    // accumulators of keys [16kk, 16kk + 16) are k-step kk's registers
    uint32_t p[kN / 16][4];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = exp2f(fmaf(s[8 * kk + i], kLog2e, (i & 2) ? -mb_b : -mb_a));
      }
      sum_a += e[0] + e[1] + e[4] + e[5];
      sum_b += e[2] + e[3] + e[6] + e[7];
      p[kk][0] = pack_f32<In>(e[0], e[1]);
      p[kk][1] = pack_f32<In>(e[2], e[3]);
      p[kk][2] = pack_f32<In>(e[4], e[5]);
      p[kk][3] = pack_f32<In>(e[6], e[7]);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= corr_a;
      o[4 * n + 1] *= corr_a;
      o[4 * n + 2] *= corr_b;
      o[4 * n + 3] *= corr_b;
    }

    // o += p v: k-step kk reads keys [16kk, 16kk + 16) of V, 2048 bytes on
    mbar_wait(&v_full[stage], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      wgmma_rs<D, In>(o, p[kk], desc_add(dV, stage_off + kk * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[stage]);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float ls_a = l_a == 0.f ? 1.f : l_a;
  const float ls_b = l_b == 0.f ? 1.f : l_b;
  const float inv_a = 1.f / ls_a;
  const float inv_b = 1.f / ls_b;
  OutT* op = static_cast<OutT*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    // columns at or past the real D are padding: the next head's o lies there
    const bool live = n * 8 < a.D;
    const int col = n * 8 + 2 * t4;
    if (live && row_a < T) {
      store_out2(op + row_a * a.o_st + col, o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    }
    if (live && row_b < T) {
      store_out2(op + row_b * a.o_st + col, o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
    }
  }
  if (t4 == 0) {
    float* lp = a.lse + static_cast<int64_t>(bh) * T;
    if (row_a < T) lp[row_a] = fmaxf(m_a, kClamp) + logf(ls_a);
    if (row_b < T) lp[row_b] = fmaxf(m_b, kClamp) + logf(ls_b);
  }
}

// K1 at Dp = 256 (the file's header has the design): 128 q rows a block,
// consumer c rows [64c, 64c + 64) with all 256 columns of o, 64-key tiles
template <bool kCausal, typename In, typename OutT>
__global__ void __launch_bounds__(kD256Threads, 1)
    flash_fwd_kernel_d256(const __grid_constant__ FwdArgs a) {
  using L = Fwd256Smem;
  constexpr int D = 256;
  constexpr int kN = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  In* sQ = reinterpret_cast<In*>(smem + L::kQ);
  In* sK = reinterpret_cast<In*>(smem + L::kK);
  In* sV = reinterpret_cast<In*>(smem + L::kV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  int* tickets = reinterpret_cast<int*>(smem + L::kTickets);

  const int T = a.T;
  const int n_q_tiles = (T + L::kBlock - 1) / L::kBlock;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * L::kBlock;
  const int n_t = (T + kN - 1) / kN;  // key tiles of the sequence
  // 2, or 1 when every row of consumer 1 is past T
  const int n_cons = q0 + 64 < T ? 2 : 1;
  // key tiles consumer c reads: causal, those up to its diagonal tile
  // 2 q_tile + c (tiles past it are never loaded); consumer 1's take in
  // consumer 0's
  const int n_kv0 = kCausal ? min(n_t, 2 * q_tile + 1) : n_t;
  const int n_kv = kCausal ? min(n_t, 2 * q_tile + n_cons) : n_t;

  const int h_kv = h / a.group;
  // K/V tile j into its stage (j % kStages)
  auto load_kv = [&](int j) {
    const int stage = j % kStages;
    mbar_expect_tx(&k_full[stage], L::kTile);
    tma_load_tile<D, kN>(sK + stage * kN * D, &a.tk, &k_full[stage], h_kv, j * kN, b);
    mbar_expect_tx(&v_full[stage], L::kTile);
    tma_load_tile<D, kN>(sV + stage * kN * D, &a.tv, &v_full[stage], h_kv, j * kN, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      tickets[s] = 0;
    }
    mbar_init_fence();
    mbar_expect_tx(q_full, n_cons * L::kTile);
    for (int half = 0; half < n_cons; ++half) {
      tma_load_tile<D, 64>(sQ + half * 64 * D, &a.tq, q_full, h, q0 + 64 * half, b);
    }
    for (int j = 0; j < min(kStages, n_kv); ++j) load_kv(j);
  }
  __syncthreads();

  const int c = threadIdx.x / 128;
  if (c >= n_cons) return;  // every row of this consumer is past T
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row_a = q0 + 64 * c + 16 * warp + g;  // rows of s[4n], s[4n+1]
  const int row_b = row_a + 8;                    // rows of s[4n+2], s[4n+3]
  const int n_c = c == 0 ? n_kv0 : n_kv;

  // K-major descriptors of this consumer's q half and of stage 0's K tile
  // (one layout: a k-step's offset serves both); MN-major of stage 0's V
  // tile (LBO: the 64-column blocks of V)
  const uint64_t dQ = desc_sw128(sQ + c * 64 * D, 16);
  const uint64_t dK = desc_sw128(sK, 16);
  const uint64_t dV = desc_sw128(sV, kN * 128);

  // o's columns [0, 128) and [128, 256)
  float o0[64], o1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    o0[i] = 0.f;
    o1[i] = 0.f;
  }
  float m_a = kNegInf, m_b = kNegInf;
  float l_a = 0.f, l_b = 0.f;  // this thread's share of the row sums

  // The consumers take turns at the tensor cores, a product each: consumer
  // c issues one after its turn's barrier (3 + c: its 128 threads and the
  // other's 128 arriving) and then passes the turn, so its products queue
  // ahead of the other's and its softmax runs under them. Consumer 0 goes
  // first. The turns alternate strictly, so no barrier ever holds two
  // arrivals of one consumer: consumer 0 also takes the turns of a tile it
  // skips, and consumer 1 does not pass its last.
  const bool turns = n_cons == 2;
  const int n_turns = 2 * n_kv;
  if (turns && c == 1) named_arrive(3, 256);
  int turn = 0;
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_c; ++j) {
    const int stage = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t stage_off = stage * L::kTile;

    // s = q k^T: k-step kk reads columns [16kk, 16kk + 16) of q and K
    float s[kN / 2];
    mbar_wait(&k_full[stage], parity);
    if (turns) named_barrier(3 + c, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk / 4) * kN * 128 + (kk % 4) * 32;
      wgmma_ss<kN, In>(s, desc_add(dQ, col), desc_add(dK, stage_off + col), kk > 0);
    }
    wgmma_commit();
    if (turns && (c == 0 || turn + 1 < n_turns)) named_arrive(4 - c, 256);
    ++turn;
    wgmma_wait<0>();
    fence_regs(s);

    if (j == n_c - 1) {
      scale_mask<kN, true, kCausal>(s, a.scale, j * kN, row_a, t4, T);
    } else {
      scale_mask<kN, false, kCausal>(s, a.scale, 0, 0, 0, 0);
    }

    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float ms_a = fmaxf(mn_a, kClamp);
    const float ms_b = fmaxf(mn_b, kClamp);
    const float corr_a = exp2f((fmaxf(m_a, kClamp) - ms_a) * kLog2e);
    const float corr_b = exp2f((fmaxf(m_b, kClamp) - ms_b) * kLog2e);
    m_a = mn_a;
    m_b = mn_b;
    const float mb_a = ms_a * kLog2e;
    const float mb_b = ms_b * kLog2e;

    // p = exp(s - m_safe), packed to the input type as the A operand of p v: the
    // accumulators of keys [16kk, 16kk + 16) are k-step kk's registers
    uint32_t p[kN / 16][4];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = exp2f(fmaf(s[8 * kk + i], kLog2e, (i & 2) ? -mb_b : -mb_a));
      }
      sum_a += e[0] + e[1] + e[4] + e[5];
      sum_b += e[2] + e[3] + e[6] + e[7];
      p[kk][0] = pack_f32<In>(e[0], e[1]);
      p[kk][1] = pack_f32<In>(e[2], e[3]);
      p[kk][2] = pack_f32<In>(e[4], e[5]);
      p[kk][3] = pack_f32<In>(e[6], e[7]);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o0[4 * n] *= corr_a;
      o0[4 * n + 1] *= corr_a;
      o0[4 * n + 2] *= corr_b;
      o0[4 * n + 3] *= corr_b;
      o1[4 * n] *= corr_a;
      o1[4 * n + 1] *= corr_a;
      o1[4 * n + 2] *= corr_b;
      o1[4 * n + 3] *= corr_b;
    }

    // o += p v: k-step kk reads keys [16kk, 16kk + 16) of V, 2048 bytes on,
    // into o0 from V's column blocks 0-1 and o1 from blocks 2-3
    mbar_wait(&v_full[stage], parity);
    if (turns) named_barrier(3 + c, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint64_t dv = desc_add(dV, stage_off + kk * 2048);
      wgmma_rs<128, In>(o0, p[kk], dv, 1);
      wgmma_rs<128, In>(o1, p[kk], desc_add(dv, 2 * kN * 128), 1);
    }
    wgmma_commit();
    if (turns && (c == 0 || turn + 1 < n_turns)) named_arrive(4 - c, 256);
    ++turn;
    wgmma_wait<0>();
    fence_regs(o0);
    fence_regs(o1);

    // the stage is free once every consumer warp is past its reads of it:
    // each warp takes a ticket, and the warp that takes the last loads tile
    // j + kStages there, so no consumer waits for the other
    if (j + kStages < n_kv && lane == 0 &&
        atomicAdd(&tickets[stage], 1) % (4 * n_cons) == 4 * n_cons - 1) {
      load_kv(j + kStages);
    }
  }
  if (turns && c == 0) {
    for (; turn < n_turns; ++turn) {  // the turns of the tile it skips
      named_barrier(3, 256);
      named_arrive(4, 256);
    }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float ls_a = l_a == 0.f ? 1.f : l_a;
  const float ls_b = l_b == 0.f ? 1.f : l_b;
  const float inv_a = 1.f / ls_a;
  const float inv_b = 1.f / ls_b;
  OutT* op = static_cast<OutT*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    // columns at or past the real D are padding: the next head's o lies there
    // (o0's columns are all below D: D > 128 here)
    const int col = n * 8 + 2 * t4;
    const bool live = 128 + n * 8 < a.D;
    if (row_a < T) {
      store_out2(op + row_a * a.o_st + col, o0[4 * n] * inv_a, o0[4 * n + 1] * inv_a);
      if (live) {
        store_out2(op + row_a * a.o_st + 128 + col, o1[4 * n] * inv_a, o1[4 * n + 1] * inv_a);
      }
    }
    if (row_b < T) {
      store_out2(op + row_b * a.o_st + col, o0[4 * n + 2] * inv_b, o0[4 * n + 3] * inv_b);
      if (live) {
        store_out2(op + row_b * a.o_st + 128 + col, o1[4 * n + 2] * inv_b,
                   o1[4 * n + 3] * inv_b);
      }
    }
  }
  if (t4 == 0) {
    float* lp = a.lse + static_cast<int64_t>(bh) * T;
    if (row_a < T) lp[row_a] = fmaxf(m_a, kClamp) + logf(ls_a);
    if (row_b < T) lp[row_b] = fmaxf(m_b, kClamp) + logf(ls_b);
  }
}

template <int D, bool kCausal, typename In, typename OutT>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  static bool attr_set = false;
  if constexpr (D == 256) {
    constexpr int kSmem = Fwd256Smem::kBytes;
    const cudaError_t err = allow_smem(flash_fwd_kernel_d256<kCausal, In, OutT>, kSmem, attr_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.T + Fwd256Smem::kBlock - 1) / Fwd256Smem::kBlock, B * a.H);
    flash_fwd_kernel_d256<kCausal, In, OutT><<<grid, kD256Threads, kSmem, stream>>>(a);
  } else {
    constexpr int kSmem = FwdSmem<D>::kBytes;
    const cudaError_t err = allow_smem(flash_fwd_kernel<D, kCausal, In, OutT>, kSmem, attr_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.T + FwdSmem<D>::kBlock - 1) / FwdSmem<D>::kBlock, B * a.H);
    flash_fwd_kernel<D, kCausal, In, OutT><<<grid, kWsThreads, kSmem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int D, typename In, typename OutT>
cudaError_t launch_d(const FwdArgs& a, int B, int causal, cudaStream_t stream) {
  return causal ? launch<D, true, In, OutT>(a, B, stream)
                : launch<D, false, In, OutT>(a, B, stream);
}

template <typename In, typename OutT>
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int T, int H, int H_kv, int D, int causal,
              int64_t q_sb, int64_t q_st, int64_t q_sh,
              int64_t k_sb, int64_t k_st, int64_t k_sh,
              int64_t v_sb, int64_t v_st, int64_t v_sh,
              int64_t o_sb, int64_t o_st, int64_t o_sh,
              void* stream) {
  if (B <= 0 || T <= 0 || H_kv <= 0 || H % H_kv != 0 || !head_dim_ok(D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs a;
  const int Dp = padded_head_dim(D);
  // a box's rows: a tile's, or at Dp = 256 a q half's and a K/V tile's
  const int rows = Dp == 256 ? Fwd256Smem::kKeys : FwdSmem<128>::kBlock;
  int err = make_tile_map<In>(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, rows);
  if (err == 0) err = make_tile_map<In>(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, rows);
  if (err == 0) err = make_tile_map<In>(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, rows);
  if (err != 0) return err;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.o_sb = o_sb; a.o_st = o_st; a.o_sh = o_sh;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t launched = Dp == 64    ? launch_d<64, In, OutT>(a, B, causal, s)
                               : Dp == 128 ? launch_d<128, In, OutT>(a, B, causal, s)
                                           : launch_d<256, In, OutT>(a, B, causal, s);
  return static_cast<int>(launched);
}

}  // namespace

#define HIVED_FWD_PARAMS                                                                   \
  const void *q, const void *k, const void *v, void *o, void *lse, int B, int T, int H,    \
      int H_kv, int D, int causal, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb, \
      int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, \
      int64_t o_st, int64_t o_sh, void *stream
#define HIVED_FWD_ARGS                                                                     \
  q, k, v, o, lse, B, T, H, H_kv, D, causal, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb,     \
      v_st, v_sh, o_sb, o_st, o_sh, stream

#ifndef HIVED_FLASH_F16
// q [B, T, H, D], k/v [B, T, H_kv, D] and o [B, T, H, D] in bf16, addressed
// through the given element strides (D contiguous; q, k and v 16-byte
// aligned with strides a multiple of 8); lse [B*H, T] f32. Returns 0, the
// CUresult of a tensor map that could not be encoded, or the cudaError_t of
// the launch.
extern "C" int hived_flash_fwd(HIVED_FWD_PARAMS) {
  return flash_fwd<bf16, bf16>(HIVED_FWD_ARGS);
}

// The same with o [B, T, H, D] in f32 (its strides even, its base 8-byte
// aligned).
extern "C" int hived_flash_fwd_f32(HIVED_FWD_PARAMS) {
  return flash_fwd<bf16, float>(HIVED_FWD_ARGS);
}

#else

// The same two with q, k and v in fp16: o in fp16 (its strides even, its
// base 4-byte aligned), or in f32.
extern "C" int hived_flash_fwd_f16(HIVED_FWD_PARAMS) {
  return flash_fwd<f16, f16>(HIVED_FWD_ARGS);
}

extern "C" int hived_flash_fwd_f16_f32(HIVED_FWD_PARAMS) {
  return flash_fwd<f16, float>(HIVED_FWD_ARGS);
}

#endif  // HIVED_FLASH_F16
