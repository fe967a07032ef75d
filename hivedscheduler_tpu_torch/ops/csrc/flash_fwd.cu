// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax state.
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
// Design, kept simple and correct first:
// - one block of 4 warps per (b*h, 64-row q tile); each warp owns 16 rows,
//   so the softmax statistics of a row live in one quad of lanes and never
//   leave registers;
// - K and V tiles of 64 keys stream through shared memory with cp.async,
//   double buffered, so the next tile loads while this one multiplies;
//   rows are padded by 8 elements to spread shared-memory banks;
// - both products are mma.sync m16n8k16 with bf16 inputs and f32
//   accumulation; the score accumulator is re-packed in registers as the
//   A operand of the P*V product (bf16), the usual flash-attention trick;
// - the 1/sqrt(D) scale is applied to the f32 scores, not to a bf16 q;
// - causal tiles above the diagonal are never loaded; q tiles are issued
//   heaviest first so the long causal rows start early.
// Inputs are addressed through their [B, T, H, D] strides (D contiguous),
// so the caller makes no [B*H, T, D] copy.

#include "flash_common.cuh"

namespace {

using namespace hived;

constexpr int kBlockM = kTile;  // q rows per block (4 warps x 16)
constexpr int kBlockN = kTile;  // keys per k/v tile

template <int D>
constexpr int smem_bytes() {
  // q tile + two stages of k and v tiles
  return (kBlockM + 4 * kBlockN) * (D + kPad) * static_cast<int>(sizeof(bf16));
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  int T, H, group;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  float scale;
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int kS = D + kPad;  // shared row stride, elements
  constexpr int kDk = D / 16;   // k-steps of the q*k^T product
  constexpr int kDn = D / 8;    // n-tiles of the output
  constexpr int kNn = kBlockN / 8;   // n-tiles of the score tile
  constexpr int kNk = kBlockN / 16;  // k-steps of the p*v product

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBlockM * kS;
  bf16* sV = sK + 2 * kBlockN * kS;

  const int T = a.T;
  const int n_q_tiles = (T + kBlockM - 1) / kBlockM;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int h_kv = h / a.group;
  const int q0 = q_tile * kBlockM;

  const bf16* qp = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kp = a.k + b * a.k_sb + h_kv * a.k_sh;
  const bf16* vp = a.v + b * a.v_sb + h_kv * a.v_sh;

  int n_kv = (T + kBlockN - 1) / kBlockN;
  if (kCausal) n_kv = min(n_kv, (q0 + kBlockM - 1) / kBlockN + 1);

  load_tile<D>(sQ, qp, a.q_st, q0, T);
  load_tile<D>(sK, kp, a.k_st, 0, T);
  load_tile<D>(sV, vp, a.v_st, 0, T);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t4 = lane & 3;  // column pair within an 8-wide n-tile
  const int row_a = q0 + warp * 16 + g;  // rows held in c[0], c[1]
  const int row_b = row_a + 8;           // rows held in c[2], c[3]

  uint32_t qf[kDk][4];
  float acc[kDn][4];
#pragma unroll
  for (int n = 0; n < kDn; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_kv) {
      load_tile<D>(sK + (stage ^ 1) * kBlockN * kS, kp, a.k_st, (j + 1) * kBlockN, T);
      load_tile<D>(sV + (stage ^ 1) * kBlockN * kS, vp, a.v_st, (j + 1) * kBlockN, T);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile j (and q) landed
    __syncthreads();

    if (j == 0) {
      const bf16* qr = sQ + (warp * 16 + g) * kS + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk) {
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(qr + kk * 16);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * kS + kk * 16);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * kS + kk * 16 + 8);
      }
    }
    const bf16* cK = sK + stage * kBlockN * kS;
    const bf16* cV = sV + stage * kBlockN * kS;

    // s = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[kNn][4];
#pragma unroll
    for (int n = 0; n < kNn; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
      for (int n = 0; n < kNn; ++n) {
        const bf16* kr = cK + (n * 8 + g) * kS + kk * 16 + 2 * t4;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale in f32, then mask: keys past T never count, causal keys past
    // the row get NEG_INF exactly as the TPU kernel's _causal_mask
    const int k0 = j * kBlockN;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < kNn; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        const int col = k0 + n * 8 + 2 * t4 + (e & 1);
        float x = s[n][e] * a.scale;
        if (col >= T) {
          x = -CUDART_INF_F;
        } else if (kCausal && col > row) {
          x = kNegInf;
        }
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
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

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kNn; ++n) {
      s[n][0] = exp2f((s[n][0] - ms_a) * kLog2e);
      s[n][1] = exp2f((s[n][1] - ms_a) * kLog2e);
      s[n][2] = exp2f((s[n][2] - ms_b) * kLog2e);
      s[n][3] = exp2f((s[n][3] - ms_b) * kLog2e);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * corr_a + quad_sum(sum_a);
    l_b = l_b * corr_b + quad_sum(sum_b);

#pragma unroll
    for (int n = 0; n < kDn; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // o += p v: the score accumulator of n-tiles (2kk, 2kk+1) is exactly the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kNk; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vr = cV + (kk * 16 + 2 * t4) * kS + g;
#pragma unroll
      for (int n = 0; n < kDn; ++n) {
        const bf16* vc = vr + n * 8;
        mma_bf16(acc[n], pf, pack_bf16(vc[0], vc[kS]), pack_bf16(vc[8 * kS], vc[9 * kS]));
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }

  const float ls_a = l_a == 0.f ? 1.f : l_a;
  const float ls_b = l_b == 0.f ? 1.f : l_b;
  const float inv_a = 1.f / ls_a;
  const float inv_b = 1.f / ls_b;
  bf16* op = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    const int col = n * 8 + 2 * t4;
    if (row_a < T) {
      *reinterpret_cast<__nv_bfloat162*>(op + row_a * a.o_st + col) =
          __floats2bfloat162_rn(acc[n][0] * inv_a, acc[n][1] * inv_a);
    }
    if (row_b < T) {
      *reinterpret_cast<__nv_bfloat162*>(op + row_b * a.o_st + col) =
          __floats2bfloat162_rn(acc[n][2] * inv_b, acc[n][3] * inv_b);
    }
  }
  if (t4 == 0) {
    float* lp = a.lse + static_cast<int64_t>(bh) * T;
    if (row_a < T) lp[row_a] = fmaxf(m_a, kClamp) + logf(ls_a);
    if (row_b < T) lp[row_b] = fmaxf(m_b, kClamp) + logf(ls_b);
  }
}

template <int D, bool kCausal>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  static bool attr_set = false;
  const cudaError_t err = allow_smem(flash_fwd_kernel<D, kCausal>, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kBlockM - 1) / kBlockM, B * a.H);
  flash_fwd_kernel<D, kCausal><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Args& a, int B, int causal, cudaStream_t stream) {
  return causal ? launch<D, true>(a, B, stream) : launch<D, false>(a, B, stream);
}

}  // namespace

// q [B, T, H, D], k/v [B, T, H_kv, D] and o [B, T, H, D] in bf16, addressed
// through the given element strides (D must be contiguous); lse [B*H, T] f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int hived_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int T, int H, int H_kv, int D, int causal,
                               int64_t q_sb, int64_t q_st, int64_t q_sh,
                               int64_t k_sb, int64_t k_st, int64_t k_sh,
                               int64_t v_sb, int64_t v_st, int64_t v_sh,
                               int64_t o_sb, int64_t o_st, int64_t o_sh,
                               void* stream) {
  if (B <= 0 || T <= 0 || H_kv <= 0 || H % H_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_st = o_st; a.o_sh = o_sh;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64: err = launch_d<64>(a, B, causal, s); break;
    case 128: err = launch_d<128>(a, B, causal, s); break;
    default: err = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(err);
}
