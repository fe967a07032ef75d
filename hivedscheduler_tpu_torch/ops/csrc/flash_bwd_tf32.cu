// Flash-attention backward for Hopper (sm_90a) at f32 inputs: dq (K2) and
// dk/dv (K3) on the tensor cores in 3xTF32, f32 accumulation, no atomics,
// for every D that is a multiple of 8 up to 128.
//
// Replaces hivedscheduler_tpu/ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_backward) at f32 inputs, to f32
// accuracy. For every (batch, q head), with scale = 1/sqrt(D) of the real D,
//   s = scale * q k^T under the causal mask (NEG_INF = -1e30),
//   p = exp(s - lse),  dp = do v^T,  delta = rowsum(do * o),
//   ds = p * (dp - delta),
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T do.
// As in flash_bwd.cu: K2 writes delta for K3; K3 folds the sum over a kv
// head's q-head group into its own loop; every output element is owned by
// one block and nothing uses atomics, so two runs are bit-identical; any T
// works (TMA zero-fills rows at or past T and columns at or past D), and lse
// and delta arrive by plain loads, since a tensor map over [B*H, T] f32
// needs T % 4 == 0. D runs at its padded width Dp = 64 or 128.
//
// 3xTF32. Every product a b is formed as big(a) big(b) + big(a) small(b) +
// small(a) big(b) on wgmma ...f32.tf32.tf32 (k-steps of 8), accumulated in
// f32, where big(x) = cvt.rna.tf32.f32(x) (rounded to nearest, made
// explicitly: nothing relies on wgmma cutting an f32 bit pattern to tf32)
// and small(x) = cvt.rna.tf32.f32(x - big(x)). The dropped small small term
// is about 2^-22 of a product; one TF32 pass alone is about 2^-11 (it reads
// ~4e-4 relative Frobenius, past the 2e-5 the f32 checks hold).
//
// Bound on an H100: K2 does three products of 2*D flops per (row, key) pair
// the mask leaves (q k^T, do v^T, ds k) and K3 four (q k^T and do v^T
// again, p^T do, ds^T q), each at 3xTF32, so at a third of TF32's 495
// TFLOP/s: 165 TFLOP/s. At the flagship shape in f32 (B=8, T=2048, H=16,
// H_kv=8, D=128, causal) that is 206.3 and 275.0 GFLOP, 1.250 and 1.667 ms,
// against 0.16 and 0.14 ms for their bytes at 3.35 TB/s: the tensor cores
// bound both.
//
// The K-major rule. wgmma takes tf32 operands from shared memory only
// K-major (the contraction index contiguous); the transposes exist for
// 16-bit types only. The bf16 kernels read three operands MN-major (K in
// ds k, do in p^T do, q in ds^T q). Here every product is turned so that
// the operand that would be MN-major is A, taken into registers by ld.shared
// from the tile as it lies, where no layout rule applies, and the one from
// the accumulators is B, stored K-major in shared memory by the threads that
// computed it:
//   K2: s = q k^T and dp = do v^T (A: q, do rows; B: the K and V tiles as
//       they lie, D contiguous); dq^T = k^T ds^T (A: k^T read down the K
//       tile; B: ds stored [row][key], keys contiguous);
//   K3: s^T = k q^T and dp^T = v do^T (A: k, v rows; B: the q and do tiles
//       as they lie); dv^T = do^T p and dk^T = q^T ds (A: do^T, q^T read
//       down the tiles; B: p^T and ds^T stored [key][row], rows contiguous).
// So no operand is copied transposed, no fragment is permuted, and the
// epilogues store dq, dk and dv transposed from the accumulators.
//
// Shared-memory layout. Every f32 tile is Dp / 32 column blocks of [rows][32]
// f32, each row 128 bytes, 128-byte swizzled (the 16-byte chunk c of row r at
// chunk c ^ (r % 8)), as TMA writes it from a box of 32 f32 columns and wgmma
// reads it as a K-major operand: 8-row groups 1024 bytes apart, a k-step of
// 8 f32 +32 bytes along the row, +rows * 128 bytes to the next column block.
// A B operand needs a big and a small plane (same layout, same offsets); an
// A operand taken into registers is split there. Three warps of the
// producer warpgroup split each streamed B tile in place after TMA lands it
// in f32 (big over the f32 values, small in the plane beside it), while its
// first warp has the next tile's load in flight as soon as a stage is free.
//
// The budget (Dp = 128; a block may have 227 KB). A direct translation of the
// bf16 K2 (64 rows x 64 keys, big and small planes of q, do, K, V and a
// transposed K) would take 320 KB. Instead:
// - K2: one block per (b*h, 64-row q tile), its two consumer warpgroups
//   taking alternate 32-key tiles (each its own dq^T partial, summed once at
//   the end): q and do in f32 (A, split in registers), 32 + 32 KB; a stage
//   per consumer of K and V big and small planes, 2 x 64 KB; a ds plane pair
//   per consumer, 2 x 16 KB: 224 KB.
// - K3: one block per (b*h_kv, 64-key tile), streaming 32-row q/do tiles of
//   every head of the group through two stages; k and v in f32 (A, split in
//   registers), 32 + 32 KB; per stage q and do big and small planes, 2 x 64
//   KB; the p^T and ds^T plane pairs, 16 + 16 KB: 224 KB. Consumer A forms
//   s^T, p^T (stored as B planes, which consumer B reads back as big +
//   small, within 2^-22 of the f32 p^T) and dv; consumer B dp^T, ds^T and
//   dk, as the bf16 K3 splits its products.
// Registers a consumer thread: K2 s 16 + dp 16 + dq^T 64, K3 s^T (or dp^T)
// 16 + dv^T (or dk^T) 64, each tile's part of dq^T, dv^T or dk^T 32 more
// (one M block at a time, see promote); A fragments live one k-step (big and
// small, 8 registers an operand), at most two k-steps in flight
// (wgmma_wait<1>). ptxas reports 168 registers a thread for every instance
// (the launch's share of 384 threads), and a design that held each
// consumer's stationary A operand in registers across tiles (64 more)
// spilled 400-800 bytes and ran slower: the consumers did not get the room
// setmaxnreg's 224 would give them. So A is read again every tile.

#include "flash_tf32.cuh"

namespace {

using namespace hived;

// The score product of one tile, d = a b^T over Dp / 8 k-steps: a the 64
// rows of an f32 tile of kRowsA rows (the thread's row m), each k-step's
// fragment read by ld.shared and split in registers; b the tile's big and
// small planes of N rows (N keys or q rows), D contiguous
template <int Dp, int N, int kRowsA>
__device__ __forceinline__ void score_tile(float (&d)[N / 2], const float* a, int m, int t4,
                                           uint64_t b_big, uint64_t b_small) {
#pragma unroll
  for (int kk = 0; kk < Dp / 8; ++kk) {
    float x[4];
    uint32_t xb[4], xs[4];
    frag_rows<kRowsA>(x, a, m, 8 * kk + t4);
    split4(x, xb, xs);
    const uint32_t off = (kk / 4) * N * 128 + (kk % 4) * 32;
    wgmma_fence();
    tf32x3<N>(d, xb, xs, desc_add(b_big, off), desc_add(b_small, off), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(d);
}

// One tile's part of a transposed output, acc += a^T b over K k-steps of 8
// (promoted in f32): a^T read down the big and small planes `tb`, `ts` of a
// tile of K rows (the thread's M index m), b the big and small B planes of N
// rows, K contiguous
template <int K, int N>
__device__ __forceinline__ void out_tile(float (&acc)[N / 2], const float* tb, const float* ts,
                                         int m, int t4, uint64_t b_big, uint64_t b_small) {
  float part[N / 2];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t xb[4], xs[4];
    frag_cols<K>(xb, tb, m, 8 * kk + t4);
    frag_cols<K>(xs, ts, m, 8 * kk + t4);
    wgmma_fence();
    tf32x3<N>(part, xb, xs, desc_add(b_big, kk * 32), desc_add(b_small, kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  promote(acc, part);
}

// ------------------------------------------------------------------- K2

constexpr int kDqRows = 64;  // q rows per block (the M of s and dp)
constexpr int kDqKeys = 32;  // keys per K/V tile (the N of s and dp)

// shared-memory layout, byte offsets from a 1024-aligned base
template <int Dp>
struct DqL {
  static constexpr int kQTile = kDqRows * Dp * 4;  // q or do, f32
  static constexpr int kPlane = kDqKeys * Dp * 4;  // one plane of a k or v tile
  static constexpr int kDsPlane = kDqRows * kDqKeys * 4;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kQTile;
  // consumer c's stage: k big, k small, v big, v small
  static constexpr int kStage0 = kDo + kQTile;
  static constexpr int kStage = 4 * kPlane;
  static constexpr int kDs0 = kStage0 + 2 * kStage;  // consumer c's ds big and small
  static constexpr int kLse = kDs0 + 4 * kDsPlane;
  static constexpr int kDelta = kLse + kDqRows * 4;
  // qdo_full, raw[2], kv_full[2], kv_empty[2]
  static constexpr int kBars = kDelta + kDqRows * 4;
  static constexpr int kBytes = kBars + 7 * 8 + 1024;  // + alignment slack
};

struct DqArgs {
  CUtensorMap tq, tk, tv, tdo;
  const float* o;
  const float* lse;
  float* delta;
  float* dq;
  int T, H, group, D;
  Strides so, sdq;
  float scale;
};

template <int Dp, bool kCausal>
__global__ void __launch_bounds__(kWsThreads, 1)
    tf32_dq_kernel(const __grid_constant__ DqArgs a) {
  using L = DqL<Dp>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sDo = reinterpret_cast<float*>(smem + L::kDo);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* raw = qdo_full + 1;
  uint64_t* kv_full = raw + 2;
  uint64_t* kv_empty = kv_full + 2;

  const int T = a.T;
  const int n_q_tiles = (T + kDqRows - 1) / kDqRows;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * kDqRows;
  const int n_k_tiles = (T + kDqKeys - 1) / kDqKeys;
  // the rows meet keys up to q0 + 63: tiles up to 2 q_tile + 1
  const int n_kv = kCausal ? min(n_k_tiles, 2 * q_tile + 2) : n_k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&raw[s], 1);
      mbar_init(&kv_full[s], kSplitThreads);  // the split warps, split done
      mbar_init(&kv_empty[s], 128);           // the consumer's threads, tile done
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: tile j goes to stage j % 2, the stage of consumer j % 2;
    // thread 0 loads each tile as soon as its stage is free, warps 1-3 split
    // each one as it lands
    regs_dec<kProdRegs>();
    const int ptid = threadIdx.x;
    if (ptid == 0) {
      mbar_expect_tx(qdo_full, 2 * L::kQTile);
      tma_tile<Dp, kDqRows>(sQ, &a.tq, qdo_full, h, q0, b);
      tma_tile<Dp, kDqRows>(sDo, &a.tdo, qdo_full, h, q0, b);
      const int h_kv = h / a.group;
      for (int j = 0; j < n_kv; ++j) {
        const int stage = j & 1;
        float* kb = reinterpret_cast<float*>(smem + L::kStage0 + stage * L::kStage);
        if (j >= 2) mbar_wait(&kv_empty[stage], ((j >> 1) - 1) & 1);
        mbar_expect_tx(&raw[stage], 2 * L::kPlane);
        tma_tile<Dp, kDqKeys>(kb, &a.tk, &raw[stage], h_kv, j * kDqKeys, b);
        tma_tile<Dp, kDqKeys>(kb + 2 * L::kPlane / 4, &a.tv, &raw[stage], h_kv, j * kDqKeys, b);
      }
    } else if (ptid >= 32) {
      for (int j = 0; j < n_kv; ++j) {
        const int stage = j & 1;
        float* kb = reinterpret_cast<float*>(smem + L::kStage0 + stage * L::kStage);
        float* vb = kb + 2 * L::kPlane / 4;
        mbar_wait(&raw[stage], (j >> 1) & 1);
        split_planes(kb, kb + L::kPlane / 4, kDqKeys * Dp, ptid - 32);
        split_planes(vb, vb + L::kPlane / 4, kDqKeys * Dp, ptid - 32);
        fence_async_shared();  // the planes, visible to wgmma
        mbar_arrive(&kv_full[stage]);
      }
    }
    return;
  }

  regs_inc<kConsRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int64_t lrow = static_cast<int64_t>(bh) * T;

  // delta = rowsum(do * o) in f32 over the real D, consumer c rows [32c,
  // 32c + 32), four lanes a row: do from its tile, o from global memory
  mbar_wait(qdo_full, 0);
  {
    const int r = 32 * c + tid / 4;
    const int row = q0 + r;
    float sum = 0.f;
    if (row < T) {
      const float* orow = a.o + b * a.so.b + h * a.so.h + row * a.so.t;
#pragma unroll
      for (int col = 4 * (tid & 3); col < Dp; col += 16) {
        if (col >= a.D) break;
        const float4 d4 = *reinterpret_cast<const float4*>(sDo + sw<kDqRows>(r, col));
        const float4 o4 = *reinterpret_cast<const float4*>(orow + col);
        sum = fmaf(d4.x, o4.x, sum);
        sum = fmaf(d4.y, o4.y, sum);
        sum = fmaf(d4.z, o4.z, sum);
        sum = fmaf(d4.w, o4.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if ((tid & 3) == 0) {
      sDelta[r] = row < T ? sum : 0.f;
      sLse[r] = row < T ? a.lse[lrow + row] : CUDART_INF_F;
      if (row < T) a.delta[lrow + row] = sum;
    }
  }
  named_barrier(1, 256);  // both consumers' rows in sLse and sDelta
  const int m_a = 16 * warp + g;  // the rows of the s and dp accumulators: m_a, m_a + 8
  const float lb_a = sLse[m_a] * kLog2e;
  const float lb_b = sLse[m_a + 8] * kLog2e;
  const float dl_a = sDelta[m_a];
  const float dl_b = sDelta[m_a + 8];
  const float scale_log2 = a.scale * kLog2e;

  float* kb = reinterpret_cast<float*>(smem + L::kStage0 + c * L::kStage);
  float* ks = kb + L::kPlane / 4;
  float* vb = ks + L::kPlane / 4;
  float* vs = vb + L::kPlane / 4;
  float* dsb = reinterpret_cast<float*>(smem + L::kDs0 + c * 2 * L::kDsPlane);
  float* dss = dsb + L::kDsPlane / 4;
  const uint64_t dKb = desc_sw128(kb, 16), dKs = desc_sw128(ks, 16);
  const uint64_t dVb = desc_sw128(vb, 16), dVs = desc_sw128(vs, 16);
  const uint64_t dDsb = desc_sw128(dsb, 16), dDss = desc_sw128(dss, 16);

  constexpr int kMb = Dp / 64;  // M blocks of dq^T
  float acc[kMb][32];
#pragma unroll
  for (int mb = 0; mb < kMb; ++mb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
  }

  for (int j = c, it = 0; j < n_kv; j += 2, ++it) {
    mbar_wait(&kv_full[c], it & 1);

    // s = q k^T and dp = do v^T, their k-steps interleaved: k-step kk reads
    // D columns [8kk, 8kk + 8)
    float s[16], dp[16];
#pragma unroll
    for (int kk = 0; kk < Dp / 8; ++kk) {
      float x[4];
      uint32_t qb[4], qs[4], db[4], dsm[4];
      frag_rows<kDqRows>(x, sQ, m_a, 8 * kk + t4);
      split4(x, qb, qs);
      frag_rows<kDqRows>(x, sDo, m_a, 8 * kk + t4);
      split4(x, db, dsm);
      const uint32_t off = (kk / 4) * kDqKeys * 128 + (kk % 4) * 32;
      wgmma_fence();
      tf32x3<kDqKeys>(s, qb, qs, desc_add(dKb, off), desc_add(dKs, off), kk > 0);
      tf32x3<kDqKeys>(dp, db, dsm, desc_add(dVb, off), desc_add(dVs, off), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p = exp(scale s - lse), 0 for keys at or past T and, causal, past the
    // row; ds = p (dp - delta) in place of s. Element i: row m_a (+8 if
    // i & 2), key 8 (i >> 2) + 2 t4 + (i & 1) of the tile.
    const int k0 = j * kDqKeys;
    const bool masked = k0 + kDqKeys > T || (kCausal && k0 + kDqKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool top = (i & 2) == 0;
      float p = exp2f(fmaf(s[i], scale_log2, top ? -lb_a : -lb_b));
      if (masked) {
        const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = q0 + m_a + (top ? 0 : 8);
        if (col >= T || (kCausal && col > row)) p = 0.f;
      }
      s[i] = p * (dp[i] - (top ? dl_a : dl_b));
    }
    // ds as the B operand of dq^T = k^T ds^T: [row][key], keys contiguous
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      store_split2<kDqRows>(dsb, dss, m_a + ((i & 2) ? 8 : 0), 8 * (i >> 2) + 2 * t4, s[i],
                            s[i + 1]);
    }
    fence_async_shared();
    named_barrier(2 + c, 128);  // this consumer's ds planes complete

    // dq^T += k^T ds^T: M = D (block mb: columns [64mb, 64mb + 64) of the K
    // tile), N = the 64 rows, k-step kk = keys [8kk, 8kk + 8)
#pragma unroll
    for (int mb = 0; mb < kMb; ++mb) {
      out_tile<kDqKeys, kDqRows>(acc[mb], kb, ks, 64 * mb + m_a, t4, dDsb, dDss);
    }
    mbar_arrive(&kv_empty[c]);
  }

  // consumer 1's dq^T partial to consumer 0 through its own stage (no tile
  // is loaded into it any more), thread-major: thread t of one reads what
  // thread t of the other wrote, the same accumulator positions
  float4* other = reinterpret_cast<float4*>(smem + L::kStage0 + L::kStage);
  if (c == 1) {
#pragma unroll
    for (int mb = 0; mb < kMb; ++mb) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        other[(mb * 8 + i) * 128 + tid] =
            make_float4(acc[mb][4 * i], acc[mb][4 * i + 1], acc[mb][4 * i + 2], acc[mb][4 * i + 3]);
      }
    }
  }
  named_barrier(1, 256);
  if (c == 1) return;

  // dq = scale (partial 0 + partial 1), stored transposed from dq^T: element
  // 4jj + e of block mb is D column 64mb + m_a (+8 if e & 2), row 8jj + 2 t4
  // + (e & 1)
  float* dqp = a.dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int mb = 0; mb < kMb; ++mb) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 y = other[(mb * 8 + i) * 128 + tid];
      const float add[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * i + e;
        const int col = 64 * mb + m_a + ((idx & 2) ? 8 : 0);
        const int row = q0 + 8 * (idx >> 2) + 2 * t4 + (idx & 1);
        if (col < a.D && row < T) dqp[row * a.sdq.t + col] = (acc[mb][idx] + add[e]) * a.scale;
      }
    }
  }
}

// ------------------------------------------------------------------- K3

constexpr int kDkvKeys = 64;  // keys per block (the M of s^T and dp^T)
constexpr int kDkvRows = 32;  // q rows per streamed q/do tile (their N)

// shared-memory layout, byte offsets from a 1024-aligned base
template <int Dp>
struct DkvL {
  static constexpr int kKTile = kDkvKeys * Dp * 4;  // k or v, f32
  static constexpr int kPlane = kDkvRows * Dp * 4;  // one plane of a q or do tile
  static constexpr int kPPlane = kDkvKeys * kDkvRows * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKTile;
  // stage s: q big, q small, do big, do small
  static constexpr int kStage0 = kV + kKTile;
  static constexpr int kStage = 4 * kPlane;
  static constexpr int kP = kStage0 + 2 * kStage;  // p^T big, small, then ds^T big, small
  static constexpr int kLse = kP + 4 * kPPlane;    // per stage kDkvRows f32 (times log2 e)
  static constexpr int kDelta = kLse + 2 * kDkvRows * 4;
  // kv_full, raw[2], full[2], empty[2], p_full, p_empty
  static constexpr int kBars = kDelta + 2 * kDkvRows * 4;
  static constexpr int kBytes = kBars + 9 * 8 + 1024;  // + alignment slack
};

struct DkvArgs {
  CUtensorMap tq, tk, tv, tdo;
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  int T, H, group, D;
  Strides sdk, sdv;
  float scale;
};

template <int Dp, bool kCausal>
__global__ void __launch_bounds__(kWsThreads, 1)
    tf32_dkv_kernel(const __grid_constant__ DkvArgs a) {
  using L = DkvL<Dp>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* pb = reinterpret_cast<float*>(smem + L::kP);
  float* ps = pb + L::kPPlane / 4;
  float* dsb = ps + L::kPPlane / 4;
  float* dss = dsb + L::kPPlane / 4;
  float* sLb = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* raw = kv_full + 1;
  uint64_t* full = raw + 2;
  uint64_t* empty = full + 2;
  uint64_t* p_full = empty + 2;
  uint64_t* p_empty = p_full + 1;

  const int T = a.T;
  const int h_kv_count = a.H / a.group;
  const int b = blockIdx.x / h_kv_count;
  const int h_kv = blockIdx.x % h_kv_count;
  const int k0 = blockIdx.y * kDkvKeys;  // y = 0, the heaviest tiles, is scheduled first
  const int n_q_tiles = (T + kDkvRows - 1) / kDkvRows;
  const int first = kCausal ? k0 / kDkvRows : 0;  // earlier q tiles see none of these keys
  const int per_head = n_q_tiles - first;
  const int n_iter = a.group * per_head;  // q tile `it % per_head` of head `it / per_head`

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&raw[s], 1);
      // warp 0's lanes (lse and delta stored) and the split warps (split done)
      mbar_init(&full[s], 32 + kSplitThreads);
      mbar_init(&empty[s], 256);  // both consumers' threads, stage done
    }
    mbar_init(p_full, 128);   // consumer A's threads, p^T stored
    mbar_init(p_empty, 128);  // consumer B's threads, p^T read
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: warp 0 loads each q/do tile as soon as its stage is free
    // (lane 0) and stores its rows' lse and delta (the 32 lanes); warps 1-3
    // split each tile as it lands
    regs_dec<kProdRegs>();
    const int ptid = threadIdx.x;
    if (ptid < 32) {
      if (ptid == 0) {
        mbar_expect_tx(kv_full, 2 * L::kKTile);
        tma_tile<Dp, kDkvKeys>(sK, &a.tk, kv_full, h_kv, k0, b);
        tma_tile<Dp, kDkvKeys>(sV, &a.tv, kv_full, h_kv, k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int stage = it & 1;
        const int hq = h_kv * a.group + it / per_head;
        const int q0 = (first + it % per_head) * kDkvRows;
        float* qb = reinterpret_cast<float*>(smem + L::kStage0 + stage * L::kStage);
        if (it >= 2) mbar_wait(&empty[stage], ((it >> 1) - 1) & 1);
        if (ptid == 0) {
          mbar_expect_tx(&raw[stage], 2 * L::kPlane);
          tma_tile<Dp, kDkvRows>(qb, &a.tq, &raw[stage], hq, q0, b);
          tma_tile<Dp, kDkvRows>(qb + 2 * L::kPlane / 4, &a.tdo, &raw[stage], hq, q0, b);
        }
        const int64_t lrow = static_cast<int64_t>(b * a.H + hq) * T;
        const int row = q0 + ptid;
        sLb[stage * kDkvRows + ptid] = row < T ? a.lse[lrow + row] * kLog2e : CUDART_INF_F;
        sDelta[stage * kDkvRows + ptid] = row < T ? a.delta[lrow + row] : 0.f;
        mbar_arrive(&full[stage]);  // releases this lane's stores
      }
    } else {
      for (int it = 0; it < n_iter; ++it) {
        const int stage = it & 1;
        float* qb = reinterpret_cast<float*>(smem + L::kStage0 + stage * L::kStage);
        float* db = qb + 2 * L::kPlane / 4;
        mbar_wait(&raw[stage], (it >> 1) & 1);
        split_planes(qb, qb + L::kPlane / 4, kDkvRows * Dp, ptid - 32);
        split_planes(db, db + L::kPlane / 4, kDkvRows * Dp, ptid - 32);
        fence_async_shared();
        mbar_arrive(&full[stage]);
      }
    }
    return;
  }

  regs_inc<kConsRegs>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m_a = 16 * warp + g;  // keys of the s^T and dp^T accumulators: m_a, m_a + 8
  const float scale_log2 = a.scale * kLog2e;
  const uint64_t dPb = desc_sw128(pb, 16), dPs = desc_sw128(ps, 16);
  const uint64_t dDsb = desc_sw128(dsb, 16), dDss = desc_sw128(dss, 16);
  constexpr int kMb = Dp / 64;  // M blocks of dv^T and dk^T

  // consumer A (wg 1): s^T, p^T and dv; consumer B (wg 2): dp^T, ds^T, dk
  const bool is_a = wg == 1;
  float acc[kMb][32];
#pragma unroll
  for (int mb = 0; mb < kMb; ++mb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
  }
  const float* sA = is_a ? sK : sV;  // the A operand of the score product
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    const int q0 = (first + it % per_head) * kDkvRows;
    float* qb = reinterpret_cast<float*>(smem + L::kStage0 + stage * L::kStage);
    float* qs = qb + L::kPlane / 4;
    float* db = qs + L::kPlane / 4;
    float* dsm = db + L::kPlane / 4;
    // A: s^T = k q^T, B: dp^T = v do^T
    float* bb = is_a ? qb : db;
    float* bs = is_a ? qs : dsm;
    const uint64_t dBb = desc_sw128(bb, 16), dBs = desc_sw128(bs, 16);
    mbar_wait(&full[stage], (it >> 1) & 1);

    float s[16];
    score_tile<Dp, kDkvRows, kDkvKeys>(s, sA, m_a, t4, dBb, dBs);

    // element i: key m_a (+8 if i & 2), q row 8 (i >> 2) + 2 t4 + (i & 1)
    // of the tile
    const float* lb = sLb + stage * kDkvRows;
    const float* dl = sDelta + stage * kDkvRows;
    if (is_a) {
      // p^T = exp(scale s^T - lse), 0 for causal keys past the row (rows at
      // or past T have lse = +inf, so p^T = 0); stored as the B planes of
      // dv^T = do^T p: [key][row], rows contiguous
      const bool masked = kCausal && q0 < k0 + kDkvKeys;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        float p = exp2f(fmaf(s[i], scale_log2, -lb[col]));
        if (masked && k0 + m_a + ((i & 2) ? 8 : 0) > q0 + col) p = 0.f;
        s[i] = p;
      }
      if (it >= 1) mbar_wait(p_empty, (it - 1) & 1);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        store_split2<kDkvKeys>(pb, ps, m_a + ((i & 2) ? 8 : 0), 8 * (i >> 2) + 2 * t4, s[i],
                               s[i + 1]);
      }
      fence_async_shared();
      mbar_arrive(p_full);
      named_barrier(1, 128);  // A's own wgmma reads every thread's p^T
    } else {
      // ds^T = p^T (dp^T - delta) with A's p^T read back as big + small;
      // stored as the B planes of dk^T = q^T ds
      mbar_wait(p_full, it & 1);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int off = sw<kDkvKeys>(m_a + ((i & 2) ? 8 : 0), 8 * (i >> 2) + 2 * t4);
        const float2 hi = *reinterpret_cast<const float2*>(pb + off);
        const float2 lo = *reinterpret_cast<const float2*>(ps + off);
        const int col = 8 * (i >> 2) + 2 * t4;
        s[i] = (hi.x + lo.x) * (s[i] - dl[col]);
        s[i + 1] = (hi.y + lo.y) * (s[i + 1] - dl[col + 1]);
      }
      mbar_arrive(p_empty);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        store_split2<kDkvKeys>(dsb, dss, m_a + ((i & 2) ? 8 : 0), 8 * (i >> 2) + 2 * t4, s[i],
                               s[i + 1]);
      }
      fence_async_shared();
      named_barrier(2, 128);
    }

    // A: dv^T += do^T p, B: dk^T += q^T ds: M = D (block mb: columns
    // [64mb, 64mb + 64) of the stage's do or q tile), N = the 64 keys,
    // k-step kk = q rows [8kk, 8kk + 8)
    const float* tb = is_a ? db : qb;
    const float* ts = is_a ? dsm : qs;
    const uint64_t dRb = is_a ? dPb : dDsb;
    const uint64_t dRs = is_a ? dPs : dDss;
#pragma unroll
    for (int mb = 0; mb < kMb; ++mb) {
      out_tile<kDkvRows, kDkvKeys>(acc[mb], tb, ts, 64 * mb + m_a, t4, dRb, dRs);
    }
    mbar_arrive(&empty[stage]);
  }

  // dv = acc (A), dk = scale acc (B), stored transposed: element 4jj + e of
  // block mb is D column 64mb + m_a (+8 if e & 2), key 8jj + 2 t4 + (e & 1)
  float* out = is_a ? a.dv + b * a.sdv.b + h_kv * a.sdv.h : a.dk + b * a.sdk.b + h_kv * a.sdk.h;
  const int64_t st = is_a ? a.sdv.t : a.sdk.t;
  const float mul = is_a ? 1.f : a.scale;
#pragma unroll
  for (int mb = 0; mb < kMb; ++mb) {
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int col = 64 * mb + m_a + ((idx & 2) ? 8 : 0);
      const int key = k0 + 8 * (idx >> 2) + 2 * t4 + (idx & 1);
      if (col < a.D && key < T) out[key * st + col] = acc[mb][idx] * mul;
    }
  }
}

// ------------------------------------------------------------- launching

template <int Dp, bool kCausal>
cudaError_t launch_dq(const DqArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = DqL<Dp>::kBytes;
  static_assert(kSmem <= 232448, "K2's shared memory exceeds a block's 227 KB");
  static bool attr_set = false;
  const cudaError_t err = allow_smem(tf32_dq_kernel<Dp, kCausal>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kDqRows - 1) / kDqRows, B * a.H);
  tf32_dq_kernel<Dp, kCausal><<<grid, kWsThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int Dp, bool kCausal>
cudaError_t launch_dkv(const DkvArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = DkvL<Dp>::kBytes;
  static_assert(kSmem <= 232448, "K3's shared memory exceeds a block's 227 KB");
  static bool attr_set = false;
  const cudaError_t err = allow_smem(tf32_dkv_kernel<Dp, kCausal>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  // key tiles along y, so that every tile 0 (the heaviest) is scheduled first
  const dim3 grid(B * (a.H / a.group), (a.T + kDkvKeys - 1) / kDkvKeys);
  tf32_dkv_kernel<Dp, kCausal><<<grid, kWsThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}


}  // namespace

// K2. q, o, do [B, T, H, D] and k/v [B, T, H_kv, D] in f32, dq [B, T, H, D]
// in f32, addressed through the given element strides (D contiguous, every
// row 16-byte aligned, strides positive); lse [B*H, T] f32 from the forward;
// delta [B*H, T] f32 is written for K3. in_type and out_type are the generic
// family's codes and must both be 2 (f32). Returns 0, the CUresult of a
// tensor map that could not be encoded, or the cudaError_t of the launch.
extern "C" int hived_flash_tf32_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int T, int H, int H_kv, int D, int causal,
    int in_type, int out_type, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
    int64_t o_st, int64_t o_sh, int64_t do_sb, int64_t do_st, int64_t do_sh, int64_t dq_sb,
    int64_t dq_st, int64_t dq_sh, void* stream) {
  if (bad_tf32_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DqArgs a;
  int err = make_f32_map(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, kDqRows);
  if (err == 0) err = make_f32_map(&a.tdo, dout, B, T, H, D, do_sb, do_st, do_sh, kDqRows);
  if (err == 0) err = make_f32_map(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, kDqKeys);
  if (err == 0) err = make_f32_map(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, kDqKeys);
  if (err != 0) return err;
  a.o = static_cast<const float*>(o);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.so = {o_sb, o_st, o_sh};
  a.sdq = {dq_sb, dq_st, dq_sh};
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  if (D <= 64) {
    launched = causal ? launch_dq<64, true>(a, B, s) : launch_dq<64, false>(a, B, s);
  } else {
    launched = causal ? launch_dq<128, true>(a, B, s) : launch_dq<128, false>(a, B, s);
  }
  return static_cast<int>(launched);
}

// K3. q, do [B, T, H, D] and k/v [B, T, H_kv, D] in f32, dk/dv [B, T, H_kv,
// D] in f32, through their element strides; lse and delta [B*H, T] f32
// (delta from K2). The GQA group sum is inside the kernel. The type codes as
// K2's. Returns 0, the CUresult of a tensor map that could not be encoded,
// or the cudaError_t of the launch.
extern "C" int hived_flash_tf32_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int T, int H, int H_kv, int D, int causal,
    int in_type, int out_type, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t do_sb,
    int64_t do_st, int64_t do_sh, int64_t dk_sb, int64_t dk_st, int64_t dk_sh, int64_t dv_sb,
    int64_t dv_st, int64_t dv_sh, void* stream) {
  if (bad_tf32_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DkvArgs a;
  int err = make_f32_map(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, kDkvRows);
  if (err == 0) err = make_f32_map(&a.tdo, dout, B, T, H, D, do_sb, do_st, do_sh, kDkvRows);
  if (err == 0) err = make_f32_map(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, kDkvKeys);
  if (err == 0) err = make_f32_map(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, kDkvKeys);
  if (err != 0) return err;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.sdk = {dk_sb, dk_st, dk_sh};
  a.sdv = {dv_sb, dv_st, dv_sh};
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  if (D <= 64) {
    launched = causal ? launch_dkv<64, true>(a, B, s) : launch_dkv<64, false>(a, B, s);
  } else {
    launched = causal ? launch_dkv<128, true>(a, B, s) : launch_dkv<128, false>(a, B, s);
  }
  return static_cast<int>(launched);
}
