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
// K3, still the first design (mma.sync m16n8k16 on cp.async tiles): one block
// of 4 warps per (b*h_kv, 64-key tile), each warp owning 16 keys, streaming
// q/do tiles (and their lse, delta) of every q head of its group from the
// causal diagonal on through double-buffered shared memory. It computes the
// transposed tiles s^T = k q^T and dp^T = v do^T directly, so p^T and ds^T
// are already the A operands of dv += p^T do and dk += ds^T q in registers;
// it takes a q tile in two halves of 32 rows to keep dk, dv (64 + 64 f32
// registers at D=128) and both score tiles in registers without spilling.
// Masking follows the forward: causal pairs get NEG_INF before the exp, and
// q rows past T get lse = +inf, so p = 0 and they contribute nothing.
// Inputs are addressed through their [B, T, H, D] strides (D contiguous).

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

constexpr int kDqBlockM = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int kDqBlockN = 64;   // keys per K/V tile
constexpr int kDqStages = 2;    // K/V ring depth

// shared-memory layout, byte offsets from a 1024-aligned base
template <int D>
struct DqSmem {
  static constexpr int kQTile = kDqBlockM * D * 2;  // q or do
  static constexpr int kKTile = kDqBlockN * D * 2;  // k or v
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kQTile;
  static constexpr int kK = kDo + kQTile;
  static constexpr int kV = kK + kDqStages * kKTile;
  static constexpr int kLse = kV + kDqStages * kKTile;  // kDqBlockM f32
  static constexpr int kDelta = kLse + kDqBlockM * 4;  // kDqBlockM f32
  static constexpr int kBars = kDelta + kDqBlockM * 4;  // qdo_full, kv_full[], empty[]
  static constexpr int kBytes = kBars + (1 + 2 * kDqStages) * 8 + 1024;  // + alignment slack
};

struct DqArgs {
  CUtensorMap tq, tk, tv, tdo;
  const bf16* o;
  const float* lse;
  float* delta;
  bf16* dq;
  int T, H, group;
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

template <int D, bool kCausal>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ DqArgs a) {
  using L = DqSmem<D>;
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
  const int n_q_tiles = (T + kDqBlockM - 1) / kDqBlockM;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * kDqBlockM;
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
      tma_load_tile<D, kDqBlockM>(sQ, &a.tq, qdo_full, h, q0, b);
      tma_load_tile<D, kDqBlockM>(sDo, &a.tdo, qdo_full, h, q0, b);
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

  // consumer c owns q rows [64c, 64c + 64) of the tile
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
  const int n_kv_c = kCausal ? min(n_k_tiles, 2 * q_tile + 1 + c) : n_k_tiles;
  const int64_t lrow = static_cast<int64_t>(bh) * T;

  // delta = rowsum(do * o) for the warp's 16 rows, two lanes a row, each
  // summing half of D in f32: do from its swizzled tile (chunk c of row r at
  // chunk c ^ (r % 8)), o from global memory
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
        const bf16* drow =
            sDo + (col / 64) * kDqBlockM * 64 + r * 64 + ((((col % 64) / 8) ^ (r & 7)) * 8);
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
      sDelta[r] = sum;
      sLse[r] = row < T ? a.lse[lrow + row] : CUDART_INF_F;
      if (row < T) a.delta[lrow + row] = sum;
    }
  }
  __syncwarp();
  const float lb_a = sLse[r0 + g] * kLog2e;
  const float lb_b = sLse[r0 + g + 8] * kLog2e;
  const float dl_a = sDelta[r0 + g];
  const float dl_b = sDelta[r0 + g + 8];
  const float scale_log2 = a.scale * kLog2e;

  // K-major descriptors of this consumer's q and do rows and of stage 0's K
  // and V tiles; MN-major of stage 0's K tile (LBO: its 64-column blocks)
  const uint64_t dQ = desc_sw128(sQ + 64 * c * 64, 16);
  const uint64_t dDo = desc_sw128(sDo + 64 * c * 64, 16);
  const uint64_t dK = desc_sw128(sK, 16);
  const uint64_t dV = desc_sw128(sV, 16);
  const uint64_t dKn = desc_sw128(sK, kDqBlockN * 128);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_kv_c; ++j) {
    const int stage = j % kDqStages;
    const uint32_t stage_off = stage * L::kKTile;

    // s = q k^T and dp = do v^T: k-step kk reads columns [16kk, 16kk + 16)
    float s[kDqBlockN / 2], dp[kDqBlockN / 2];
    mbar_wait(&kv_full[stage], (j / kDqStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qcol = (kk / 4) * kDqBlockM * 128 + (kk % 4) * 32;
      const uint32_t kcol = stage_off + (kk / 4) * kDqBlockN * 128 + (kk % 4) * 32;
      wgmma_ss<kDqBlockN>(s, desc_add(dQ, qcol), desc_add(dK, kcol), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qcol = (kk / 4) * kDqBlockM * 128 + (kk % 4) * 32;
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
      wgmma_rs<D>(acc, ds[kk], desc_add(dKn, stage_off + kk * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[stage]);
  }

  bf16* dqp = at(a.dq, a.sdq, b, h);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (row_a < T) {
      *reinterpret_cast<__nv_bfloat162*>(dqp + row_a * a.sdq.t + col) =
          __floats2bfloat162_rn(acc[4 * n] * a.scale, acc[4 * n + 1] * a.scale);
    }
    if (row_b < T) {
      *reinterpret_cast<__nv_bfloat162*>(dqp + row_b * a.sdq.t + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] * a.scale, acc[4 * n + 3] * a.scale);
    }
  }
}

// ------------------------------------------------------------------- K3

template <int D>
constexpr int dkv_smem_bytes() {
  // six bf16 tiles (k, v, two stages of q and do) and four 64-float
  // vectors (lse and delta, per stage)
  return 6 * kTile * (D + kPad) * static_cast<int>(sizeof(bf16)) +
         4 * kTile * static_cast<int>(sizeof(float));
}

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dk;
  bf16* dv;
  int T, H, group;
  Strides sq, sk, sv, sdo, sdk, sdv;
  float scale;
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int kS = D + kPad;
  constexpr int kDk = D / 16;        // k-steps over D
  constexpr int kDn = D / 8;         // n-tiles of dk, dv
  constexpr int kHalf = kTile / 2;   // q rows taken at a time
  constexpr int kHn = kHalf / 8;     // n-tiles of a half score tile
  constexpr int kHk = kHalf / 16;    // k-steps of p^T do over a half

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile * kS;
  bf16* sQ = sV + kTile * kS;
  bf16* sDo = sQ + 2 * kTile * kS;
  float* sLse = reinterpret_cast<float*>(sDo + 2 * kTile * kS);
  float* sDelta = sLse + 2 * kTile;

  const int T = a.T;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int k_tile = blockIdx.x;  // tile 0 meets every q tile: heaviest first
  const int h_kv_count = a.H / a.group;
  const int b = blockIdx.y / h_kv_count;
  const int h_kv = blockIdx.y % h_kv_count;
  const int k0 = k_tile * kTile;
  const int first = kCausal ? k_tile : 0;  // earlier q tiles see none of these keys
  const int per_head = n_tiles - first;
  const int n_iter = a.group * per_head;

  // iteration `it` takes q head h_kv * group + it / per_head and its q tile
  // first + it % per_head: the q and do tiles, and lse and delta of the rows
  // (rows past T get lse +inf, so p = 0)
  auto load_stage = [&](int it, int stage) {
    const int hq = h_kv * a.group + it / per_head;
    const int q0 = (first + it % per_head) * kTile;
    load_tile<D>(sQ + stage * kTile * kS, at(a.q, a.sq, b, hq), a.sq.t, q0, T);
    load_tile<D>(sDo + stage * kTile * kS, at(a.dout, a.sdo, b, hq), a.sdo.t, q0, T);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const int64_t lrow = static_cast<int64_t>(b * a.H + hq) * T;
      sLse[stage * kTile + threadIdx.x] = row < T ? a.lse[lrow + row] : CUDART_INF_F;
      sDelta[stage * kTile + threadIdx.x] = row < T ? a.delta[lrow + row] : 0.f;
    }
  };

  load_tile<D>(sK, at(a.k, a.sk, b, h_kv), a.sk.t, k0, T);
  load_tile<D>(sV, at(a.v, a.sv, b, h_kv), a.sv.t, k0, T);
  load_stage(0, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;            // the warp's first key in the tile
  const int key_a = k0 + r0 + g;       // keys held in c[0], c[1]
  const int key_b = key_a + 8;         // keys held in c[2], c[3]

  float dk[kDn][4], dv[kDn][4];
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) load_stage(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: this iteration's tiles landed
    __syncthreads();
    const int q0 = (first + it % per_head) * kTile;
    const bf16* cQ = sQ + stage * kTile * kS;
    const bf16* cDo = sDo + stage * kTile * kS;
    const float* cLse = sLse + stage * kTile;
    const float* cDelta = sDelta + stage * kTile;

    // not unrolled: the two halves must not keep k and v fragments live
    // across each other (at D=128 that spilled)
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * kHalf;  // first q row of the half, in the tile
      // s^T = k q^T and dp^T = v do^T for the warp's 16 keys and 32 q rows
      float p[kHn][4], ds[kHn][4];
#pragma unroll
      for (int n = 0; n < kHn; ++n) {
        p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
        ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, sK, kS, r0, kk * 16);
        load_a(va, sV, kS, r0, kk * 16);
#pragma unroll
        for (int n = 0; n < kHn; ++n) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, cQ, kS, kk * 16, c0 + n * 8);
          mma_bf16(p[n], ka, b0, b1);
          load_b_rows(b0, b1, cDo, kS, kk * 16, c0 + n * 8);
          mma_bf16(ds[n], va, b0, b1);
        }
      }

      // p^T = exp(s^T - lse) and ds^T = p^T (dp^T - delta), per q column
#pragma unroll
      for (int n = 0; n < kHn; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key_a : key_b;
          const int qc = c0 + n * 8 + 2 * t4 + (e & 1);
          float x = p[n][e] * a.scale;
          if (kCausal && key > q0 + qc) x = kNegInf;
          const float pv = exp2f((x - cLse[qc]) * kLog2e);
          p[n][e] = pv;
          ds[n][e] = pv * (ds[n][e] - cDelta[qc]);
        }
      }

      // dv += p^T do and dk += ds^T q over the half's q rows
#pragma unroll
      for (int kk = 0; kk < kHk; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_f32(p[2 * kk][0], p[2 * kk][1]);
        pa[1] = pack_f32(p[2 * kk][2], p[2 * kk][3]);
        pa[2] = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        pa[3] = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
        sa[0] = pack_f32(ds[2 * kk][0], ds[2 * kk][1]);
        sa[1] = pack_f32(ds[2 * kk][2], ds[2 * kk][3]);
        sa[2] = pack_f32(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
        sa[3] = pack_f32(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < kDn; ++n) {
          uint32_t b0, b1;
          load_b_cols(b0, b1, cDo, kS, c0 + kk * 16, n * 8);
          mma_bf16(dv[n], pa, b0, b1);
          load_b_cols(b0, b1, cQ, kS, c0 + kk * 16, n * 8);
          mma_bf16(dk[n], sa, b0, b1);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }

  bf16* dkp = at(a.dk, a.sdk, b, h_kv);
  bf16* dvp = at(a.dv, a.sdv, b, h_kv);
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    const int col = n * 8 + 2 * t4;
    if (key_a < T) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + key_a * a.sdk.t + col) =
          __floats2bfloat162_rn(dk[n][0] * a.scale, dk[n][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + key_a * a.sdv.t + col) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    }
    if (key_b < T) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + key_b * a.sdk.t + col) =
          __floats2bfloat162_rn(dk[n][2] * a.scale, dk[n][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + key_b * a.sdv.t + col) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
}

template <int D, bool kCausal>
cudaError_t launch_dq(const DqArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = DqSmem<D>::kBytes;
  static bool attr_set = false;
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, kCausal>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kDqBlockM - 1) / kDqBlockM, B * a.H);
  flash_bwd_dq_kernel<D, kCausal><<<grid, kWsThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t launch_dkv(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = dkv_smem_bytes<D>();
  static bool attr_set = false;
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, kCausal>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kTile - 1) / kTile, B * (a.H / a.group));
  flash_bwd_dkv_kernel<D, kCausal><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

bool bad_dims(int B, int T, int H, int H_kv, int D) {
  return B <= 0 || T <= 0 || H_kv <= 0 || H % H_kv != 0 || (D != 64 && D != 128);
}

}  // namespace

// K2. q, o, do [B, T, H, D], k/v [B, T, H_kv, D] and dq [B, T, H, D] in
// bf16, addressed through the given element strides (D contiguous, every
// row 16-byte aligned, strides positive); lse [B*H, T] f32 from the
// forward; delta [B*H, T] f32 is written for K3. Returns 0, the CUresult of
// a tensor map that could not be encoded, or the cudaError_t of the launch.
extern "C" int hived_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* delta, void* dq,
                                  int B, int T, int H, int H_kv, int D, int causal,
                                  int64_t q_sb, int64_t q_st, int64_t q_sh,
                                  int64_t k_sb, int64_t k_st, int64_t k_sh,
                                  int64_t v_sb, int64_t v_st, int64_t v_sh,
                                  int64_t o_sb, int64_t o_st, int64_t o_sh,
                                  int64_t do_sb, int64_t do_st, int64_t do_sh,
                                  int64_t dq_sb, int64_t dq_st, int64_t dq_sh,
                                  void* stream) {
  if (bad_dims(B, T, H, H_kv, D)) return static_cast<int>(cudaErrorInvalidValue);
  DqArgs a;
  int err = make_tile_map(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, kDqBlockM);
  if (err == 0) err = make_tile_map(&a.tdo, dout, B, T, H, D, do_sb, do_st, do_sh, kDqBlockM);
  if (err == 0) err = make_tile_map(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, kDqBlockN);
  if (err == 0) err = make_tile_map(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, kDqBlockN);
  if (err != 0) return err;
  a.o = static_cast<const bf16*>(o);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.so = {o_sb, o_st, o_sh};
  a.sdq = {dq_sb, dq_st, dq_sh};
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  if (D == 64) {
    launched = causal ? launch_dq<64, true>(a, B, s) : launch_dq<64, false>(a, B, s);
  } else {
    launched = causal ? launch_dq<128, true>(a, B, s) : launch_dq<128, false>(a, B, s);
  }
  return static_cast<int>(launched);
}

// K3. q, do [B, T, H, D], k/v and dk/dv [B, T, H_kv, D] in bf16, through
// their element strides (D contiguous); lse and delta [B*H, T] f32 (delta
// from K2). Returns the cudaError_t of the launch (0 on success).
extern "C" int hived_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv,
                                   int B, int T, int H, int H_kv, int D, int causal,
                                   int64_t q_sb, int64_t q_st, int64_t q_sh,
                                   int64_t k_sb, int64_t k_st, int64_t k_sh,
                                   int64_t v_sb, int64_t v_st, int64_t v_sh,
                                   int64_t do_sb, int64_t do_st, int64_t do_sh,
                                   int64_t dk_sb, int64_t dk_st, int64_t dk_sh,
                                   int64_t dv_sb, int64_t dv_st, int64_t dv_sh,
                                   void* stream) {
  if (bad_dims(B, T, H, H_kv, D)) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.sq = {q_sb, q_st, q_sh};
  a.sk = {k_sb, k_st, k_sh};
  a.sv = {v_sb, v_st, v_sh};
  a.sdo = {do_sb, do_st, do_sh};
  a.sdk = {dk_sb, dk_st, dk_sh};
  a.sdv = {dv_sb, dv_st, dv_sh};
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  if (D == 64) {
    launched = causal ? launch_dkv<64, true>(a, B, s) : launch_dkv<64, false>(a, B, s);
  } else {
    launched = causal ? launch_dkv<128, true>(a, B, s) : launch_dkv<128, false>(a, B, s);
  }
  return static_cast<int>(launched);
}
