// Flash-attention forward (K1) for Hopper (sm_90a) at f32 inputs: the
// products on the tensor cores in 3xTF32 (flash_tf32.cuh), the softmax state
// in f32, no atomics, for every D that is a multiple of 8 up to 128.
//
// Replaces hivedscheduler_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_forward) at f32 inputs, to f32 accuracy. For every (batch, q head)
// and query row it computes what _fwd_kernel computes: q scaled by 1/sqrt(D)
// (the real D) in f32, s = q k^T under the causal mask (NEG_INF = -1e30), an
// online softmax with the running max m, the m_safe clamp at -0.5e30 and the
// l == 0 guard, o = (sum p v) / l and lse = m_safe + log(l), stored [B*H, T].
// GQA is read in place. Any T works: TMA zero-fills rows at or past T and
// columns at or past D, keys at or past T get -inf, and the epilogue stores
// only rows < T and columns < D. Every output element is owned by one thread
// of one block and nothing uses atomics, so two runs are bit-identical.
//
// Bound on an H100: two products of 2*D flops per (row, key) pair the mask
// leaves, each at 3xTF32, so at a third of TF32's 495 TFLOP/s: 165 TFLOP/s.
// At the flagship shape in f32 (B=8, T=2048, H=16, H_kv=8, D=128, causal)
// that is 137.5 GFLOP, 0.8334 ms, against 0.121 ms for its 404 MB at 3.35
// TB/s: the tensor cores bound it.
//
// The products, turned by the K-major rule (flash_tf32.cuh; flash_bwd_tf32.cu
// says why):
// - s = q k^T is K-major as it lies. A is the consumer's q rows, read by
//   ld.shared from the f32 q tile (scaled in place once) and split in
//   registers; B is the K tile as TMA lands it, D contiguous, turned into big
//   and small planes in place by the producer's split warps (as K2's s).
// - o += p v would read V MN-major, so it is turned: o^T += v^T p^T. A is
//   v^T, read down the f32 V tile and split in registers, so V needs no
//   small plane; B is p^T, stored [row][key] (keys contiguous) as big and
//   small planes by the threads that computed p (as K2 stores ds).
// The softmax. A row of s lives in one quad of lanes (rows are s's M), but
// in o^T it is a column of the accumulator (rows are o^T's N), spread over
// the warpgroup. So each tile's per-row rescale, and l at the end, reach the
// threads that hold the row's column through shared memory (64 floats a
// tile, two buffers), behind the same barrier as the p planes.
// Promotion. Each tile's o^T products go to a fresh accumulator, folded into
// the f32 sum as o = o * corr + part by plain f32 arithmetic, not left in a
// wgmma accumulator across tiles (flash_tf32.cuh's promote).
//
// Plan (Dp = 128; a block may have 227 KB):
// - One block of three warpgroups per (b*h, 128-row q tile), heaviest causal
//   tiles first. The producer: warp 0 loads the q tile once and then 32-key
//   K and V tiles into two stages by TMA; warps 1-3 split each K tile. Two
//   consumers of 64 rows each share every stage, so each K/V tile is loaded
//   and split once per 128 rows, and the two run out of step (one's softmax
//   beside the other's products).
// - Shared memory: q 64 KB; per stage K big and small 32 KB and V 16 KB, two
//   stages 96 KB; a p plane pair per consumer, 2 x 16 KB: 194 KB in all.
// - Registers a consumer thread: o^T 64 (two 64-column M blocks), a tile's
//   part 32 (one M block at a time), s 16, the A fragments of two k-steps
//   (the next one's read while the current one's wgmmas run);
//   the row rescales are read from shared memory as they are applied
//   (ptxas caps the 384-thread launch at 168: flash_bwd_tf32.cu).
// - Only tiles that hold a consumer's causal diagonal (two of 32 keys for 64
//   rows) or keys at or past T are masked; a consumer skips the tiles wholly
//   past its rows (consumer 0 the block's last two), releasing their stage.

#include "flash_tf32.cuh"

namespace {

using namespace hived;

constexpr int kFwdRows = 128;  // q rows per block, 64 a consumer (the N of o^T)
constexpr int kFwdKeys = 32;   // keys per K/V tile (the N of s, the K of o^T)
constexpr int kConsRows = 64;  // q rows of a consumer (the M of s)

// shared-memory layout, byte offsets from a 1024-aligned base
template <int Dp>
struct FwdL {
  static constexpr int kQTile = kFwdRows * Dp * 4;    // q, f32
  static constexpr int kPlane = kFwdKeys * Dp * 4;    // one plane of a K or V tile
  static constexpr int kPPlane = kConsRows * kFwdKeys * 4;  // one p plane of a consumer
  static constexpr int kQ = 0;
  // stage s: K big, K small, V in f32
  static constexpr int kStage0 = kQ + kQTile;
  static constexpr int kStage = 3 * kPlane;
  static constexpr int kP0 = kStage0 + 2 * kStage;  // consumer c's p big and small
  // consumer c's row values (a tile's rescales, then l), two buffers of 64
  static constexpr int kRow = kP0 + 4 * kPPlane;
  // q_full, raw[2], full[2], empty[2]
  static constexpr int kBars = kRow + 2 * 2 * kConsRows * 4;
  static constexpr int kBytes = kBars + 7 * 8 + 1024;  // + alignment slack
};

struct FwdArgs {
  CUtensorMap tq, tk, tv;
  float* o;
  float* lse;
  int T, H, group, D;
  Strides so;
  float scale;
};

template <int Dp, bool kCausal>
__global__ void __launch_bounds__(kWsThreads, 1)
    tf32_fwd_kernel(const __grid_constant__ FwdArgs a) {
  using L = FwdL<Dp>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* raw = q_full + 1;
  uint64_t* full = raw + 2;
  uint64_t* empty = full + 2;

  const int T = a.T;
  const int n_q_tiles = (T + kFwdRows - 1) / kFwdRows;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * kFwdRows;
  const int n_k_tiles = (T + kFwdKeys - 1) / kFwdKeys;
  // the rows meet keys up to q0 + 127: tiles up to 4 q_tile + 3
  const int n_kv = kCausal ? min(n_k_tiles, 4 * q_tile + 4) : n_k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&raw[s], 1);
      mbar_init(&full[s], kSplitThreads);  // the split warps, K split
      mbar_init(&empty[s], kWsConsumerThreads);  // both consumers' threads, stage done
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: tile j goes to stage j % 2; thread 0 loads each tile as soon
    // as its stage is free, warps 1-3 split each K tile as it lands
    regs_dec<kProdRegs>();
    const int ptid = threadIdx.x;
    if (ptid == 0) {
      mbar_expect_tx(q_full, L::kQTile);
      tma_tile<Dp, kFwdRows>(sQ, &a.tq, q_full, h, q0, b);
      const int h_kv = h / a.group;
      for (int j = 0; j < n_kv; ++j) {
        const int stage = j & 1;
        float* kb = reinterpret_cast<float*>(smem + L::kStage0 + stage * L::kStage);
        if (j >= 2) mbar_wait(&empty[stage], ((j >> 1) - 1) & 1);
        mbar_expect_tx(&raw[stage], 2 * L::kPlane);
        tma_tile<Dp, kFwdKeys>(kb, &a.tk, &raw[stage], h_kv, j * kFwdKeys, b);
        tma_tile<Dp, kFwdKeys>(kb + 2 * L::kPlane / 4, &a.tv, &raw[stage], h_kv, j * kFwdKeys,
                               b);
      }
    } else if (ptid >= 32) {
      for (int j = 0; j < n_kv; ++j) {
        const int stage = j & 1;
        float* kb = reinterpret_cast<float*>(smem + L::kStage0 + stage * L::kStage);
        mbar_wait(&raw[stage], (j >> 1) & 1);
        split_planes(kb, kb + L::kPlane / 4, kFwdKeys * Dp, ptid - 32);
        fence_async_shared();  // the planes, visible to wgmma
        mbar_arrive(&full[stage]);
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
  const int m_a = 16 * warp + g;  // rows of the s accumulator in the consumer's 64: m_a, m_a + 8
  const int r0 = q0 + kConsRows * c;  // the consumer's first row
  const int row_a = r0 + m_a;
  const int row_b = row_a + 8;

  // q scaled by 1/sqrt(D) in f32 in place, as _fwd_kernel scales it: the
  // consumer's 64 rows are 8 KB at the same offset of every column block
  mbar_wait(q_full, 0);
#pragma unroll
  for (int blk = 0; blk < Dp / 32; ++blk) {
    float4* rows = reinterpret_cast<float4*>(sQ + (blk * kFwdRows + kConsRows * c) * 32);
#pragma unroll
    for (int i = tid; i < kConsRows * 32 / 4; i += 128) {
      const float4 x = rows[i];
      rows[i] = make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
    }
  }
  named_barrier(1 + c, 128);

  float* pb = reinterpret_cast<float*>(smem + L::kP0 + c * 2 * L::kPPlane);
  float* ps = pb + L::kPPlane / 4;
  float* sRow = reinterpret_cast<float*>(smem + L::kRow) + c * 2 * kConsRows;
  const uint64_t dPb = desc_sw128(pb, 16), dPs = desc_sw128(ps, 16);

  constexpr int kMb = Dp / 64;  // M blocks of o^T
  float acc[kMb][32];
#pragma unroll
  for (int mb = 0; mb < kMb; ++mb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
  }
  float m_a_run = kNegInf, m_b_run = kNegInf;
  float l_a = 0.f, l_b = 0.f;  // this thread's share of the row sums
  int it = 0;                  // tiles this consumer has taken

  for (int j = 0; j < n_kv; ++j) {
    const int stage = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    const int k0 = j * kFwdKeys;
    float* kb = reinterpret_cast<float*>(smem + L::kStage0 + stage * L::kStage);
    float* ks = kb + L::kPlane / 4;
    const float* sV = ks + L::kPlane / 4;
    mbar_wait(&raw[stage], parity);   // V, as TMA wrote it
    mbar_wait(&full[stage], parity);  // K's planes
    if (kCausal && k0 > r0 + kConsRows - 1) {  // no key of the tile meets these rows
      mbar_arrive(&empty[stage]);
      continue;
    }

    // s = q k^T over Dp / 8 k-steps, each k-step's q fragment read right
    // after the previous k-step's wgmmas are issued, so that its latency
    // hides under them (on an H100 a few percent faster than reading it
    // after the wait, as flash_bwd_tf32.cu's score_tile does); element i:
    // row m_a (+8 if i & 2), key 8 (i >> 2) + 2 t4 + (i & 1)
    float s[16];
    {
      const uint64_t dKb = desc_sw128(kb, 16), dKs = desc_sw128(ks, 16);
      const int m = kConsRows * c + m_a;
      float x[4];
      frag_rows<kFwdRows>(x, sQ, m, t4);
#pragma unroll
      for (int kk = 0; kk < Dp / 8; ++kk) {
        uint32_t xb[4], xs[4];
        split4(x, xb, xs);
        const uint32_t off = (kk / 4) * kFwdKeys * 128 + (kk % 4) * 32;
        wgmma_fence();
        tf32x3<kFwdKeys>(s, xb, xs, desc_add(dKb, off), desc_add(dKs, off), kk > 0);
        wgmma_commit();
        if (kk + 1 < Dp / 8) frag_rows<kFwdRows>(x, sQ, m, 8 * (kk + 1) + t4);
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      fence_regs(s);
    }

    // keys at or past T to -inf, causal keys past the row to NEG_INF, as
    // _fwd_kernel masks them
    if (k0 + kFwdKeys > T || (kCausal && k0 + kFwdKeys - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (col >= T) {
          s[i] = -CUDART_INF_F;
        } else if (kCausal && col > ((i & 2) ? row_b : row_a)) {
          s[i] = kNegInf;
        }
      }
    }

    // the online softmax of _fwd_kernel: m_new, m_safe, corr, p, l
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i & 2) {
        mx_b = fmaxf(mx_b, s[i]);
      } else {
        mx_a = fmaxf(mx_a, s[i]);
      }
    }
    const float mn_a = fmaxf(m_a_run, quad_max(mx_a));
    const float mn_b = fmaxf(m_b_run, quad_max(mx_b));
    const float ms_a = fmaxf(mn_a, kClamp);
    const float ms_b = fmaxf(mn_b, kClamp);
    const float corr_a = expf(fmaxf(m_a_run, kClamp) - ms_a);
    const float corr_b = expf(fmaxf(m_b_run, kClamp) - ms_b);
    m_a_run = mn_a;
    m_b_run = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i & 2) {
        s[i] = expf(s[i] - ms_b);
        sum_b += s[i];
      } else {
        s[i] = expf(s[i] - ms_a);
        sum_a += s[i];
      }
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;

    // p as the B operand of o^T = v^T p^T: [row][key], keys contiguous; the
    // rows' rescales beside it for the threads holding their o^T columns
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      store_split2<kConsRows>(pb, ps, m_a + ((i & 2) ? 8 : 0), 8 * (i >> 2) + 2 * t4, s[i],
                              s[i + 1]);
    }
    float* corr = sRow + (it & 1) * kConsRows;
    if (t4 == 0) {
      corr[m_a] = corr_a;
      corr[m_a + 8] = corr_b;
    }
    fence_async_shared();
    named_barrier(1 + c, 128);  // this consumer's p planes and rescales complete

    // o^T = o^T corr + v^T p^T: M = D (block mb: columns [64mb, 64mb + 64)
    // of the V tile), N = the 64 rows, k-step kk = keys [8kk, 8kk + 8)
    uint32_t u[4];
    frag_cols<kFwdKeys>(u, sV, m_a, t4);
#pragma unroll
    for (int mb = 0; mb < kMb; ++mb) {
      float part[32];
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 8; ++kk) {
        uint32_t xb[4], xs[4];
        const float x[4] = {__uint_as_float(u[0]), __uint_as_float(u[1]), __uint_as_float(u[2]),
                            __uint_as_float(u[3])};
        split4(x, xb, xs);
        wgmma_fence();
        tf32x3<64>(part, xb, xs, desc_add(dPb, kk * 32), desc_add(dPs, kk * 32), kk > 0);
        wgmma_commit();
        // the next k-step's v^T fragment, read while these wgmmas run
        if (kk + 1 < kFwdKeys / 8) {
          frag_cols<kFwdKeys>(u, sV, 64 * mb + m_a, 8 * (kk + 1) + t4);
        } else if (mb + 1 < kMb) {
          frag_cols<kFwdKeys>(u, sV, 64 * (mb + 1) + m_a, t4);
        }
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      fence_regs(part);
      // the rows' rescales, read here to keep registers: element 4jj + e
      // is row 8jj + 2 t4 + (e & 1)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 cr = *reinterpret_cast<const float2*>(corr + 8 * jj + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          acc[mb][i] = fmaf(acc[mb][i], (e & 1) ? cr.y : cr.x, part[i]);
        }
      }
    }
    mbar_arrive(&empty[stage]);
    ++it;
  }

  // l over the quad, guarded; lse = m_safe + log(l); l to the threads that
  // hold each row's o^T column, through the row buffer not read last
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float ls_a = l_a == 0.f ? 1.f : l_a;
  const float ls_b = l_b == 0.f ? 1.f : l_b;
  float* lrow = sRow + (it & 1) * kConsRows;
  if (t4 == 0) {
    lrow[m_a] = ls_a;
    lrow[m_a + 8] = ls_b;
    float* lp = a.lse + static_cast<int64_t>(bh) * T;
    if (row_a < T) lp[row_a] = fmaxf(m_a_run, kClamp) + logf(ls_a);
    if (row_b < T) lp[row_b] = fmaxf(m_b_run, kClamp) + logf(ls_b);
  }
  named_barrier(1 + c, 128);

  // o = o^T / l, stored transposed: element 4jj + e of block mb is D column
  // 64mb + m_a (+8 if e & 2), row 8jj + 2 t4 + (e & 1)
  float* op = a.o + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * jj + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * jj + 2 * t4 + (e & 1);
      const float l = (e & 1) ? l2.y : l2.x;
#pragma unroll
      for (int mb = 0; mb < kMb; ++mb) {
        const int col = 64 * mb + m_a + ((e & 2) ? 8 : 0);
        if (col < a.D && row < T) op[row * a.so.t + col] = acc[mb][4 * jj + e] / l;
      }
    }
  }
}

// ------------------------------------------------------------- launching

template <int Dp, bool kCausal>
cudaError_t launch_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = FwdL<Dp>::kBytes;
  static_assert(kSmem <= 232448, "K1's shared memory exceeds a block's 227 KB");
  static bool attr_set = false;
  const cudaError_t err = allow_smem(tf32_fwd_kernel<Dp, kCausal>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kFwdRows - 1) / kFwdRows, B * a.H);
  tf32_fwd_kernel<Dp, kCausal><<<grid, kWsThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// K1. q [B, T, H, D] and k/v [B, T, H_kv, D] in f32, o [B, T, H, D] in f32,
// addressed through the given element strides (D contiguous, every row
// 16-byte aligned, strides positive); lse [B*H, T] f32. in_type and out_type
// are the generic family's codes and must both be 2 (f32): the CUDA-core
// K1's signature. Returns 0, the CUresult of a tensor map that could not be
// encoded, or the cudaError_t of the launch.
extern "C" int hived_flash_tf32_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int T, int H, int H_kv, int D, int causal,
                                    int in_type, int out_type, int64_t q_sb, int64_t q_st,
                                    int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
                                    int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
                                    int64_t o_st, int64_t o_sh, void* stream) {
  if (bad_tf32_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs a;
  int err = make_f32_map(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, kFwdRows);
  if (err == 0) err = make_f32_map(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, kFwdKeys);
  if (err == 0) err = make_f32_map(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, kFwdKeys);
  if (err != 0) return err;
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.so = {o_sb, o_st, o_sh};
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  if (D <= 64) {
    launched = causal ? launch_fwd<64, true>(a, B, s) : launch_fwd<64, false>(a, B, s);
  } else {
    launched = causal ? launch_fwd<128, true>(a, B, s) : launch_fwd<128, false>(a, B, s);
  }
  return static_cast<int>(launched);
}
