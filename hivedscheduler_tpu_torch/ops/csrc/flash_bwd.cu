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
// Design, kept simple and correct first:
// - every output element is owned by one block, so a run is bit-reproducible:
//   K2 has one block of 4 warps per (b*h, 64-row q tile), each warp owning 16
//   q rows; K3 one block per (b*h_kv, 64-key tile), each warp owning 16 keys;
// - K2 streams K/V tiles up to the causal diagonal through double-buffered
//   shared memory (cp.async) and computes delta from do and o once per row,
//   writing it to a [B*H, T] f32 buffer that K3 reads instead of o;
// - K3 streams q/do tiles (and their lse, delta) of every q head of its
//   group from the causal diagonal on, and computes the transposed tiles
//   s^T = k q^T and dp^T = v do^T directly, so p^T and ds^T are already the
//   A operands of dv += p^T do and dk += ds^T q in registers; it takes a q
//   tile in two halves of 32 rows to keep dk, dv (64 + 64 f32 registers at
//   D=128) and both score tiles in registers without spilling;
// - all products are mma.sync m16n8k16, bf16 inputs and f32 accumulation;
//   p and ds are rounded to bf16 only as the A operand of a product;
// - masking follows the forward: causal pairs get NEG_INF before the exp,
//   keys at or past a ragged T get p = 0 exactly, and q rows past T get
//   lse = +inf, so p = 0 and they contribute nothing.
// Inputs are addressed through their [B, T, H, D] strides (D contiguous).

#include "flash_common.cuh"

namespace {

using namespace hived;

template <int D>
constexpr int bwd_smem_bytes() {
  // six bf16 tiles (K2: q, do, two stages of k and v; K3: k, v, two stages
  // of q and do) and up to four 64-float vectors (lse and delta, per stage)
  return 6 * kTile * (D + kPad) * static_cast<int>(sizeof(bf16)) +
         4 * kTile * static_cast<int>(sizeof(float));
}

struct Strides {
  int64_t b, t, h;
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;
  float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int T, H, group;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  float scale;
};

template <typename T>
__device__ __forceinline__ T* at(T* base, const Strides& s, int b, int h) {
  return base + b * s.b + h * s.h;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int kS = D + kPad;       // shared row stride, elements
  constexpr int kDk = D / 16;        // k-steps over D
  constexpr int kDn = D / 8;         // n-tiles of dq
  constexpr int kNn = kTile / 8;     // n-tiles of a score tile
  constexpr int kNk = kTile / 16;    // k-steps of ds k

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDo = sQ + kTile * kS;
  bf16* sK = sDo + kTile * kS;
  bf16* sV = sK + 2 * kTile * kS;
  float* sLse = reinterpret_cast<float*>(sV + 2 * kTile * kS);
  float* sDelta = sLse + kTile;

  const int T = a.T;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int q_tile = n_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int h_kv = h / a.group;
  const int q0 = q_tile * kTile;

  const bf16* kp = at(a.k, a.sk, b, h_kv);
  const bf16* vp = at(a.v, a.sv, b, h_kv);
  const int n_kv = kCausal ? q_tile + 1 : n_tiles;

  load_tile<D>(sQ, at(a.q, a.sq, b, h), a.sq.t, q0, T);
  load_tile<D>(sDo, at(a.dout, a.sdo, b, h), a.sdo.t, q0, T);
  cp_async_commit();
  load_tile<D>(sK, kp, a.sk.t, 0, T);
  load_tile<D>(sV, vp, a.sv.t, 0, T);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;               // the warp's first row in the tile
  const int row_a = q0 + r0 + g;          // rows held in c[0], c[1]
  const int row_b = row_a + 8;            // rows held in c[2], c[3]
  const int64_t lrow = static_cast<int64_t>(bh) * T;

  // delta = rowsum(do * o) for the warp's 16 rows, two lanes a row, each
  // summing half of D in f32 (do from shared memory, o from global memory)
  cp_async_wait<1>();  // q and do landed
  __syncthreads();
  {
    const int r = r0 + lane / 2;
    const int row = q0 + r;
    const int c0 = (lane & 1) * (D / 2);
    float sum = 0.f;
    if (row < T) {
      const bf16* orow = at(a.o, a.so, b, h) + row * a.so.t + c0;
      const bf16* drow = sDo + r * kS + c0;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += __bfloat162float(drow[c + e]) * __bfloat162float(oe[e]);
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
  const float lse_a = sLse[r0 + g];
  const float lse_b = sLse[r0 + g + 8];
  const float dl_a = sDelta[r0 + g];
  const float dl_b = sDelta[r0 + g + 8];

  float acc[kDn][4];
#pragma unroll
  for (int n = 0; n < kDn; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_kv) {
      load_tile<D>(sK + (stage ^ 1) * kTile * kS, kp, a.sk.t, (j + 1) * kTile, T);
      load_tile<D>(sV + (stage ^ 1) * kTile * kS, vp, a.sv.t, (j + 1) * kTile, T);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile j landed
    __syncthreads();
    const bf16* cK = sK + stage * kTile * kS;
    const bf16* cV = sV + stage * kTile * kS;

    // s = q k^T and dp = do v^T for the warp's 16 rows and the tile's keys
    float s[kNn][4], dp[kNn][4];
#pragma unroll
    for (int n = 0; n < kNn; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, sQ, kS, r0, kk * 16);
      load_a(da, sDo, kS, r0, kk * 16);
#pragma unroll
      for (int n = 0; n < kNn; ++n) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, cK, kS, kk * 16, n * 8);
        mma_bf16(s[n], qa, b0, b1);
        load_b_rows(b0, b1, cV, kS, kk * 16, n * 8);
        mma_bf16(dp[n], da, b0, b1);
      }
    }

    // ds = p (dp - delta), kept in s
    const int k0 = j * kTile;
#pragma unroll
    for (int n = 0; n < kNn; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        const int row = top ? row_a : row_b;
        const int col = k0 + n * 8 + 2 * t4 + (e & 1);
        float x = s[n][e] * a.scale;
        if (kCausal && col > row) x = kNegInf;
        const float p = col < T ? exp2f((x - (top ? lse_a : lse_b)) * kLog2e) : 0.f;
        s[n][e] = p * (dp[n][e] - (top ? dl_a : dl_b));
      }
    }

    // dq += ds k: the ds accumulator of n-tiles (2kk, 2kk+1) is the A
    // fragment of k-step kk; k is read untransposed along the key axis
#pragma unroll
    for (int kk = 0; kk < kNk; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kDn; ++n) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, cK, kS, kk * 16, n * 8);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }

  bf16* dqp = at(a.dq, a.sdq, b, h);
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    const int col = n * 8 + 2 * t4;
    if (row_a < T) {
      *reinterpret_cast<__nv_bfloat162*>(dqp + row_a * a.sdq.t + col) =
          __floats2bfloat162_rn(acc[n][0] * a.scale, acc[n][1] * a.scale);
    }
    if (row_b < T) {
      *reinterpret_cast<__nv_bfloat162*>(dqp + row_b * a.sdq.t + col) =
          __floats2bfloat162_rn(acc[n][2] * a.scale, acc[n][3] * a.scale);
    }
  }
}

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

enum class Which { kDq, kDkv };

template <Which W, int D, bool kCausal>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = bwd_smem_bytes<D>();
  static bool attr_set = false;
  const int n_tiles = (a.T + kTile - 1) / kTile;
  if constexpr (W == Which::kDq) {
    const cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, kCausal>, kSmem, attr_set);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<D, kCausal><<<dim3(n_tiles, B * a.H), kThreads, kSmem, stream>>>(a);
  } else {
    const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, kCausal>, kSmem, attr_set);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<D, kCausal>
        <<<dim3(n_tiles, B * (a.H / a.group)), kThreads, kSmem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <Which W>
int dispatch(const BwdArgs& a, int B, int H_kv, int D, int causal, void* stream) {
  if (B <= 0 || a.T <= 0 || H_kv <= 0 || a.H % H_kv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64:
      err = causal ? launch<W, 64, true>(a, B, s) : launch<W, 64, false>(a, B, s);
      break;
    case 128:
      err = causal ? launch<W, 128, true>(a, B, s) : launch<W, 128, false>(a, B, s);
      break;
    default:
      err = cudaErrorInvalidValue;
      break;
  }
  return static_cast<int>(err);
}

BwdArgs make_args(int T, int H, int H_kv, int D) {
  BwdArgs a = {};
  a.T = T;
  a.H = H;
  a.group = H_kv > 0 ? H / H_kv : 1;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  return a;
}

}  // namespace

// K2. q, o, do [B, T, H, D], k/v [B, T, H_kv, D] and dq [B, T, H, D] in
// bf16, addressed through the given element strides (D contiguous, o's rows
// 16-byte aligned); lse [B*H, T] f32 from the forward; delta [B*H, T] f32 is
// written for K3. Returns the cudaError_t of the launch (0 on success).
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
  BwdArgs a = make_args(T, H, H_kv, D);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.sq = {q_sb, q_st, q_sh};
  a.sk = {k_sb, k_st, k_sh};
  a.sv = {v_sb, v_st, v_sh};
  a.so = {o_sb, o_st, o_sh};
  a.sdo = {do_sb, do_st, do_sh};
  a.sdq = {dq_sb, dq_st, dq_sh};
  return dispatch<Which::kDq>(a, B, H_kv, D, causal, stream);
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
  BwdArgs a = make_args(T, H, H_kv, D);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.sq = {q_sb, q_st, q_sh};
  a.sk = {k_sb, k_st, k_sh};
  a.sv = {v_sb, v_st, v_sh};
  a.sdo = {do_sb, do_st, do_sh};
  a.sdk = {dk_sb, dk_st, dk_sh};
  a.sdv = {dv_sb, dv_st, dv_sh};
  return dispatch<Which::kDkv>(a, B, H_kv, D, causal, stream);
}
