// Flash attention K1-K3 on the CUDA cores in f32, for every input type and
// head dim the TPU kernels take that the wgmma kernels (flash_fwd.cu,
// flash_bwd.cu) do not: f32 inputs at any D, and bf16 or fp16 inputs at D
// past 256.
//
// Replaces hivedscheduler_tpu/ops/attention.py::_fwd_kernel, ::_bwd_dq_kernel
// and ::_bwd_dkv_kernel (launched by _flash_forward and _flash_backward) at
// those inputs, in their own arithmetic: every input is widened to f32 and
// every product and sum is an f32 FMA, so f32 inputs get the f32 result the
// TPU kernels compute (no TF32, no 16-bit operand). The functions are K1-K3's
// (see flash_fwd.cu, flash_bwd.cu): q scaled by 1/sqrt(D) in f32 before its
// products, as the TPU kernels and the plain versions scale it, NEG_INF =
// -1e30 for causal keys, the m_safe clamp and the l == 0 guard; dq = scale *
// ds k, dk = ds^T (scale q), dv = p^T do; K3 sums a kv head's q-head group
// inside its own loop. Inputs are bf16, fp16 or f32 (an input-type code);
// outputs are in the input type or in f32 (an output-type code: the ring's
// per-hop forms). D is any multiple of 8, with no upper limit.
//
// Bound on an H100: the same products as K1-K3 (2, 3 and 4 of 2*D flops per
// (row, key) pair the mask leaves). Run on the CUDA cores, their least time
// is at f32's 67 TFLOP/s, or at a third of TF32's 495 for the f32 result on
// the tensor cores (3xTF32, not used here); the wgmma kernels' 989 TFLOP/s
// for 16-bit work. This plan is simple and right first: making it fast is
// later work (ROADMAP A.8).
//
// Plan (the same for the three kernels):
// - A block of 256 threads takes one (batch * head, 64-row tile, 128-column
//   panel of its outputs): K1 a q tile and a panel of o, K2 a q tile and a
//   panel of dq, K3 a key tile and a panel of dk and dv. D > 128 takes
//   ceil(D / 128) panels, so blocks of different panels form the same scores
//   again (K1 does (P D + 128 P) / 2D of the real work at P panels: 2.5x at D
//   512; K2 3x; K3 2.5x).
// - The scores of a 64 x 64 tile are summed over the whole D in 64-column
//   chunks through shared memory, so the shared footprint does not grow with
//   D: each chunk of both operands is stored transposed ([column][row], f32,
//   float4 groups of rows XOR-swizzled by the column so that the transposing
//   stores spread over the banks), and thread (r, c) = (t / 16, t % 16) sums
//   rows 4r..4r+3 against keys 4c..4c+3 from two float4 reads a column. The
//   16 threads of a row group are one half-warp, whose shuffles reduce a row.
// - The softmax statistics (K1) and p and ds (K2, K3) stay in registers; p
//   (or ds) goes through shared memory once as the A operand of the panel
//   product, whose B operand (V, K, do or q) is the panel's 64 x 128 rows.
//   Thread (r, c) accumulates rows 4r..4r+3 and columns 4c..4c+3 and
//   64+4c..64+4c+3 of its panel.
// - Every panel forms the same scores in the same order, so their
//   statistics agree bit for bit; panel 0 writes lse (K1) or delta (K2).
// - Every output element is written by one block and nothing uses atomics:
//   two runs are bit-identical.
// Shared memory: K1 48 KB (the V panel over the score chunks), K2 80 KB, K3
// 96 KB, at any D.

#include "flash_common.cuh"

namespace {

using namespace hived;

constexpr int kThreads = 256;
constexpr int kTile = 64;    // q rows (K1, K2) or keys (K3) per block; keys or rows per tile
constexpr int kChunk = 64;   // columns of D per score-product chunk
constexpr int kPanel = 128;  // output columns per block
constexpr int kT = kTile * kTile;  // floats in a transposed chunk or a p/ds tile

enum TypeCode { kBf16 = 0, kF16 = 1, kF32 = 2 };

// elements of In in one 16-byte load
template <typename In>
constexpr int kVec = 16 / static_cast<int>(sizeof(In));

// 16 bytes of In at p (16-byte aligned), widened to f32
__device__ __forceinline__ void load_vec(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = to_float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const f16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = to_float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

struct Strides {
  int64_t b, t, h;
};

// four adjacent f32 results into an output of the input type or f32 (the
// address is 8-byte aligned for 16-bit types, 16-byte aligned for f32)
template <typename OutT>
__device__ __forceinline__ void store4(OutT* p, float a, float b, float c, float d) {
  store_out2(p, a, b);
  store_out2(p + 2, c, d);
}

template <>
__device__ __forceinline__ void store4<float>(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// float4 group g of column d of a transposed [column][64] tile (the groups
// of a column are XOR-swizzled by d / 4)
__device__ __forceinline__ int swz(int d, int g) { return d * kTile + 4 * (g ^ ((d >> 2) & 15)); }

__device__ __forceinline__ float4 ld_t(const float* t, int d, int g) {
  return *reinterpret_cast<const float4*>(t + swz(d, g));
}

// Rows row0..row0+63 and columns c0..c0+dn of one head of a [B, T, heads, D]
// input (base at the head's row 0, row stride st) into a transposed chunk,
// times mul; rows at or past T as zeros. Columns past dn are never read.
template <typename In>
__device__ __forceinline__ void load_chunk(float* t, const In* base, int64_t st, int row0, int T,
                                           int c0, int dn, float mul) {
  constexpr int V = kVec<In>;
  constexpr int kPerRow = kChunk / V;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int row = i / kPerRow;
    const int d = (i % kPerRow) * V;
    if (d >= dn) continue;
    float x[V];
    if (row0 + row < T) {
      load_vec(base + static_cast<int64_t>(row0 + row) * st + c0 + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) t[swz(d + e, row >> 2) + (row & 3)] = x[e] * mul;
  }
}

// Rows row0..row0+63 and columns p0..p0+127 of one head into a row-major
// [64][128] panel, times mul; rows at or past T and columns at or past D as
// zeros.
template <typename In>
__device__ __forceinline__ void load_panel(float* t, const In* base, int64_t st, int row0, int T,
                                           int p0, int D, float mul) {
  constexpr int V = kVec<In>;
  constexpr int kPerRow = kPanel / V;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int row = i / kPerRow;
    const int col = (i % kPerRow) * V;
    float x[V];
    if (row0 + row < T && p0 + col < D) {
      load_vec(base + static_cast<int64_t>(row0 + row) * st + p0 + col, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      *reinterpret_cast<float4*>(t + row * kPanel + col + e) =
          make_float4(x[e] * mul, x[e + 1] * mul, x[e + 2] * mul, x[e + 3] * mul);
    }
  }
}

// acc[i][j] += sum over the chunk's dn columns of a[.][4r + i] b[.][4c + j]
__device__ __forceinline__ void score_chunk(float (&acc)[4][4], const float* a, const float* b,
                                            int dn, int r, int c) {
#pragma unroll 8
  for (int d = 0; d < dn; ++d) {
    const float4 x = ld_t(a, d, r);
    const float4 y = ld_t(b, d, c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
    }
  }
}

// thread (r, c)'s 4 x 4 values (rows 4r.., columns 4c..) into a transposed
// tile: column 4c + j holds rows 4r..4r+3, the A operand of panel_product
__device__ __forceinline__ void store_t(float* t, const float (&x)[4][4], int r, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(t + swz(4 * c + j, r)) = make_float4(x[0][j], x[1][j], x[2][j],
                                                                    x[3][j]);
  }
}

// acc[i][j] += sum over k of a[k][4r + i] panel[k][col_j], col_j = 4c + j
// and 64 + 4c + j - 4 for j >= 4
__device__ __forceinline__ void panel_product(float (&acc)[4][8], const float* a,
                                              const float* panel, int r, int c) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float4 x = ld_t(a, k, r);
    const float4 y0 = *reinterpret_cast<const float4*>(panel + k * kPanel + 4 * c);
    const float4 y1 = *reinterpret_cast<const float4*>(panel + k * kPanel + 64 + 4 * c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
    }
  }
}

// a thread's 4 x 8 panel values for rows row0 + 4r + i into an output's
// columns p0 + 4c.. and p0 + 64 + 4c.. below D, rows below T, each scaled
template <typename OutT>
__device__ __forceinline__ void store_panel_as(OutT* base, int64_t st, const float (&acc)[4][8],
                                               const float (&mul)[4], int row0, int T, int p0,
                                               int D, int r, int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * r + i;
    if (row >= T) continue;
    OutT* p = base + static_cast<int64_t>(row) * st + p0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 64 * h + 4 * c;
      if (p0 + col < D) {  // D % 8 == 0: a group of 4 is all below D or all past it
        store4(p + col, acc[i][4 * h] * mul[i], acc[i][4 * h + 1] * mul[i],
               acc[i][4 * h + 2] * mul[i], acc[i][4 * h + 3] * mul[i]);
      }
    }
  }
}

// the same into an output of the input type In, or of f32 (the output type is
// an argument of the launch, so one instantiation serves both)
template <typename In>
__device__ __forceinline__ void store_panel(void* out, bool out_f32, const Strides& s, int b,
                                            int h, const float (&acc)[4][8],
                                            const float (&mul)[4], int row0, int T, int p0,
                                            int D, int r, int c) {
  if (out_f32) {
    store_panel_as(static_cast<float*>(out) + b * s.b + h * s.h, s.t, acc, mul, row0, T, p0, D,
                   r, c);
  } else {
    store_panel_as(static_cast<In*>(out) + b * s.b + h * s.h, s.t, acc, mul, row0, T, p0, D, r,
                   c);
  }
}

// max and sum over the 16 lanes of a half-warp (the threads of one row group)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ T* head_at(T* p, const Strides& s, int b, int h) {
  return p + b * s.b + h * s.h;
}

struct GenArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // K2: the forward's o, in the input type
  const void* dout;
  const float* lse;  // K2, K3: the forward's
  float* lse_out;    // K1
  float* delta;      // K2 writes it, K3 reads it
  void* out0;        // o (K1), dq (K2) or dk (K3): the input type or f32
  void* out1;        // dv (K3)
  int T, H, H_kv, group, D, n_panels;
  bool causal;
  bool out_f32;      // out0 and out1 in f32, else in the input type
  Strides sq, sk, sv, so, sdo, s0, s1;
  float scale;
};

// ------------------------------------------------------------------- K1

template <typename In>
__global__ void __launch_bounds__(kThreads, 2) generic_fwd_kernel(const GenArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;           // a chunk of q, scaled, transposed
  float* sK = smem + kT;      // a chunk of k, transposed
  float* sV = smem;           // the V panel, over sQ and sK once the scores are done
  float* sP = smem + 2 * kT;  // p, transposed

  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int T = a.T;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / a.n_panels;  // heaviest first
  const int p0 = (static_cast<int>(blockIdx.x) % a.n_panels) * kPanel;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int q0 = tile * kTile;
  const In* qb = head_at(static_cast<const In*>(a.q), a.sq, b, h);
  const In* kb = head_at(static_cast<const In*>(a.k), a.sk, b, h / a.group);
  const In* vb = head_at(static_cast<const In*>(a.v), a.sv, b, h / a.group);
  const bool causal = a.causal;
  const int n_kv = causal ? tile + 1 : n_tiles;

  float m[4], l[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }

  for (int jt = 0; jt < n_kv; ++jt) {
    const int k0 = jt * kTile;
    float s[4][4] = {};
    for (int c0 = 0; c0 < a.D; c0 += kChunk) {
      const int dn = min(kChunk, a.D - c0);
      __syncthreads();  // the last chunk's (or the V panel's) readers are done
      load_chunk(sQ, qb, a.sq.t, q0, T, c0, dn, a.scale);
      load_chunk(sK, kb, a.sk.t, k0, T, c0, dn, 1.f);
      __syncthreads();
      score_chunk(s, sQ, sK, dn, r, c);
    }
    // mask (keys past T to -inf, causal keys past the row to NEG_INF), then
    // the online softmax of _fwd_kernel
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * r + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * c + j;
        if (key >= T) {
          s[i][j] = -CUDART_INF_F;
        } else if (causal && key > row) {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = fmaxf(m_new, kClamp);
      const float corr = expf(fmaxf(m[i], kClamp) - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= corr;
    }
    __syncthreads();  // every thread is done with the score chunks
    store_t(sP, s, r, c);
    load_panel(sV, vb, a.sv.t, k0, T, p0, a.D, 1.f);
    __syncthreads();
    panel_product(o, sP, sV, r, c);
  }

  // o / l_safe, divided as the plain version divides
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ls = row_sum(l[i]);
    l[i] = ls == 0.f ? 1.f : ls;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] /= l[i];
  }
  store_panel<In>(a.out0, a.out_f32, a.s0, b, h, o, one, q0, T, p0, a.D, r, c);
  if (p0 == 0 && c == 0) {
    float* lp = a.lse_out + static_cast<int64_t>(blockIdx.y) * T;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * r + i;
      if (row < T) lp[row] = fmaxf(m[i], kClamp) + logf(l[i]);
    }
  }
}

// ------------------------------------------------------------------- K2

template <typename In>
__global__ void __launch_bounds__(kThreads, 2) generic_dq_kernel(const GenArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;             // chunks of q (scaled) and do, transposed
  float* sDo = smem + kT;
  float* sK = smem + 2 * kT;    // chunks of k and v, transposed
  float* sV = smem + 3 * kT;
  float* sKp = smem;            // the K panel, over sQ and sDo once the scores are done
  float* sDs = smem + 4 * kT;   // ds, transposed
  float* sLse = smem + 5 * kT;  // the tile's rows' lse and delta
  float* sDelta = sLse + kTile;

  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int T = a.T;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / a.n_panels;
  const int p0 = (static_cast<int>(blockIdx.x) % a.n_panels) * kPanel;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int q0 = tile * kTile;
  const In* qb = head_at(static_cast<const In*>(a.q), a.sq, b, h);
  const In* dob = head_at(static_cast<const In*>(a.dout), a.sdo, b, h);
  const In* ob = head_at(static_cast<const In*>(a.o), a.so, b, h);
  const In* kb = head_at(static_cast<const In*>(a.k), a.sk, b, h / a.group);
  const In* vb = head_at(static_cast<const In*>(a.v), a.sv, b, h / a.group);
  const int64_t lrow = static_cast<int64_t>(blockIdx.y) * T;

  // delta = rowsum(do * o) over the whole D in f32, four threads a row, each
  // summing every fourth 16-byte group; panel 0 writes it for K3
  {
    constexpr int V = kVec<In>;
    const int row = tid >> 2;
    float sum = 0.f;
    if (q0 + row < T) {
      const In* dr = dob + static_cast<int64_t>(q0 + row) * a.sdo.t;
      const In* orow = ob + static_cast<int64_t>(q0 + row) * a.so.t;
      for (int col = (tid & 3) * V; col < a.D; col += 4 * V) {
        float x[V], y[V];
        load_vec(dr + col, x);
        load_vec(orow + col, y);
#pragma unroll
        for (int e = 0; e < V; ++e) sum = fmaf(x[e], y[e], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if ((tid & 3) == 0) {
      const bool live = q0 + row < T;
      sDelta[row] = live ? sum : 0.f;
      sLse[row] = live ? a.lse[lrow + q0 + row] : CUDART_INF_F;
      if (live && p0 == 0) a.delta[lrow + q0 + row] = sum;
    }
  }
  __syncthreads();
  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = sLse[4 * r + i];
    dl[i] = sDelta[4 * r + i];
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const bool causal = a.causal;
  const int n_kv = causal ? tile + 1 : n_tiles;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int k0 = jt * kTile;
    float s[4][4] = {}, dp[4][4] = {};
    for (int c0 = 0; c0 < a.D; c0 += kChunk) {
      const int dn = min(kChunk, a.D - c0);
      __syncthreads();
      load_chunk(sQ, qb, a.sq.t, q0, T, c0, dn, a.scale);
      load_chunk(sDo, dob, a.sdo.t, q0, T, c0, dn, 1.f);
      load_chunk(sK, kb, a.sk.t, k0, T, c0, dn, 1.f);
      load_chunk(sV, vb, a.sv.t, k0, T, c0, dn, 1.f);
      __syncthreads();
      score_chunk(s, sQ, sK, dn, r, c);
      score_chunk(dp, sDo, sV, dn, r, c);
    }
    // p = exp(s - lse), 0 for keys past T and, causal, past the row; then
    // ds = p (dp - delta) in place of s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * r + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * c + j;
        const float p = (key >= T || (causal && key > row)) ? 0.f : expf(s[i][j] - lse[i]);
        s[i][j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    store_t(sDs, s, r, c);
    load_panel(sKp, kb, a.sk.t, k0, T, p0, a.D, 1.f);
    __syncthreads();
    panel_product(acc, sDs, sKp, r, c);
  }
  const float scale[4] = {a.scale, a.scale, a.scale, a.scale};
  store_panel<In>(a.out0, a.out_f32, a.s0, b, h, acc, scale, q0, T, p0, a.D, r, c);
}

// ------------------------------------------------------------------- K3

template <typename In>
__global__ void __launch_bounds__(kThreads, 2) generic_dkv_kernel(const GenArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sK = smem;             // chunks of k and v, transposed
  float* sV = smem + kT;
  float* sQ = smem + 2 * kT;    // chunks of q (scaled) and do, transposed
  float* sDo = smem + 3 * kT;
  float* sDoP = smem;           // the do and q panels, over the chunks
  float* sQP = smem + 2 * kT;
  float* sP = smem + 4 * kT;    // p and ds, transposed: [q row][key]
  float* sDs = smem + 5 * kT;
  float* sLse = smem + 6 * kT;  // the q tile's rows' lse and delta
  float* sDelta = sLse + kTile;

  const int tid = threadIdx.x;
  const int r = tid >> 4;  // keys 4r..4r+3
  const int c = tid & 15;  // q rows 4c..4c+3 of the scores
  const int T = a.T;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int key_tile = static_cast<int>(blockIdx.x) / a.n_panels;  // tile 0, the heaviest, first
  const int p0 = (static_cast<int>(blockIdx.x) % a.n_panels) * kPanel;
  const int b = blockIdx.y / a.H_kv;
  const int h_kv = blockIdx.y % a.H_kv;
  const int k0 = key_tile * kTile;
  const In* kb = head_at(static_cast<const In*>(a.k), a.sk, b, h_kv);
  const In* vb = head_at(static_cast<const In*>(a.v), a.sv, b, h_kv);
  const bool causal = a.causal;
  const int first = causal ? key_tile : 0;  // earlier q tiles see none of these keys

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dk[i][j] = dv[i][j] = 0.f;
  }
  for (int hq = h_kv * a.group; hq < (h_kv + 1) * a.group; ++hq) {
    const In* qb = head_at(static_cast<const In*>(a.q), a.sq, b, hq);
    const In* dob = head_at(static_cast<const In*>(a.dout), a.sdo, b, hq);
    const int64_t lrow = static_cast<int64_t>(b * a.H + hq) * T;
    for (int it = first; it < n_tiles; ++it) {
      const int q0 = it * kTile;
      // s^T = k (scale q)^T and dp^T = v do^T: keys down, q rows across
      float s[4][4] = {}, dp[4][4] = {};
      for (int c0 = 0; c0 < a.D; c0 += kChunk) {
        const int dn = min(kChunk, a.D - c0);
        __syncthreads();
        load_chunk(sK, kb, a.sk.t, k0, T, c0, dn, 1.f);
        load_chunk(sV, vb, a.sv.t, k0, T, c0, dn, 1.f);
        load_chunk(sQ, qb, a.sq.t, q0, T, c0, dn, a.scale);
        load_chunk(sDo, dob, a.sdo.t, q0, T, c0, dn, 1.f);
        if (c0 == 0 && tid < kTile) {
          const bool live = q0 + tid < T;
          sLse[tid] = live ? a.lse[lrow + q0 + tid] : 0.f;
          sDelta[tid] = live ? a.delta[lrow + q0 + tid] : 0.f;
        }
        __syncthreads();
        score_chunk(s, sK, sQ, dn, r, c);
        score_chunk(dp, sV, sDo, dn, r, c);
      }
      // p^T = exp(s^T - lse), 0 for q rows past T and, causal, for keys past
      // the row; ds^T = p^T (dp^T - delta) in place of dp
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + 4 * c + j;
        const float lse = sLse[4 * c + j];
        const float dl = sDelta[4 * c + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 4 * r + i;
          const float p = (row >= T || (causal && key > row)) ? 0.f : expf(s[i][j] - lse);
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - dl);
        }
      }
      __syncthreads();
      // [q row][key] tiles: q row 4c + j holds keys 4r..4r+3 (store_t with
      // the roles of r and c exchanged)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float4*>(sP + swz(4 * c + j, r)) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        *reinterpret_cast<float4*>(sDs + swz(4 * c + j, r)) =
            make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
      }
      load_panel(sDoP, dob, a.sdo.t, q0, T, p0, a.D, 1.f);
      load_panel(sQP, qb, a.sq.t, q0, T, p0, a.D, a.scale);
      __syncthreads();
      panel_product(dv, sP, sDoP, r, c);
      panel_product(dk, sDs, sQP, r, c);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_panel<In>(a.out0, a.out_f32, a.s0, b, h_kv, dk, one, k0, T, p0, a.D, r, c);
  store_panel<In>(a.out1, a.out_f32, a.s1, b, h_kv, dv, one, k0, T, p0, a.D, r, c);
}

// ------------------------------------------------------------- launching

enum Kernel { kFwd, kDq, kDkv };

constexpr int smem_bytes(Kernel kernel) {
  return kernel == kFwd ? 3 * kT * 4 : kernel == kDq ? 5 * kT * 4 + 2 * kTile * 4
                                                     : 6 * kT * 4 + 2 * kTile * 4;
}

template <Kernel kKernel, typename In>
cudaError_t launch(const GenArgs& a, int B, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(kKernel);
  auto kernel = kKernel == kFwd  ? generic_fwd_kernel<In>
                : kKernel == kDq ? generic_dq_kernel<In>
                                 : generic_dkv_kernel<In>;
  static bool attr_set = false;
  const cudaError_t err = allow_smem(kernel, kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.T + kTile - 1) / kTile;
  const dim3 grid(n_tiles * a.n_panels, B * (kKernel == kDkv ? a.H_kv : a.H));
  kernel<<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

// one instantiation per (kernel, input type): the mask and the output type
// are arguments, so a build holds 9 kernels
template <Kernel kKernel>
int launch_types(GenArgs& a, int B, int causal, int in_type, int out_type, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.causal = causal != 0;
  a.out_f32 = out_type == kF32;
  cudaError_t err;
  if (in_type == kBf16) {
    err = launch<kKernel, bf16>(a, B, s);
  } else if (in_type == kF16) {
    err = launch<kKernel, f16>(a, B, s);
  } else {
    err = launch<kKernel, float>(a, B, s);
  }
  return static_cast<int>(err);
}

// the shapes and types every entry point takes: D any positive multiple of
// 8, the output in the input type or f32
bool bad_args(int B, int T, int H, int H_kv, int D, int in_type, int out_type) {
  return B <= 0 || T <= 0 || H_kv <= 0 || H % H_kv != 0 || D < 8 || D % 8 != 0 ||
         in_type < kBf16 || in_type > kF32 || (out_type != in_type && out_type != kF32);
}

GenArgs base_args(const void* q, const void* k, const void* v, int T, int H, int H_kv, int D,
                  Strides sq, Strides sk, Strides sv) {
  GenArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.T = T;
  a.H = H;
  a.H_kv = H_kv;
  a.group = H / H_kv;
  a.D = D;
  a.n_panels = (D + kPanel - 1) / kPanel;
  a.sq = sq;
  a.sk = sk;
  a.sv = sv;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  return a;
}

}  // namespace

// K1. q [B, T, H, D], k/v [B, T, H_kv, D] of in_type (0 bf16, 1 fp16, 2 f32),
// o [B, T, H, D] of out_type (in_type, or 2 for f32), addressed through the
// given element strides (D contiguous, every row 16-byte aligned); lse
// [B*H, T] f32. Returns 0 or the cudaError_t of the launch.
extern "C" int hived_flash_generic_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int T, int H, int H_kv, int D,
                                       int causal, int in_type, int out_type, int64_t q_sb,
                                       int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
                                       int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
                                       int64_t o_sb, int64_t o_st, int64_t o_sh, void* stream) {
  if (bad_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GenArgs a = base_args(q, k, v, T, H, H_kv, D, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
                        {v_sb, v_st, v_sh});
  a.out0 = o;
  a.s0 = {o_sb, o_st, o_sh};
  a.lse_out = static_cast<float*>(lse);
  return launch_types<kFwd>(a, B, causal, in_type, out_type, stream);
}

// K2. q, o, do [B, T, H, D] and k/v [B, T, H_kv, D] of in_type, dq of
// out_type, through their element strides; lse [B*H, T] f32 from the
// forward; delta [B*H, T] f32 is written for K3.
extern "C" int hived_flash_generic_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int T, int H, int H_kv, int D, int causal,
    int in_type, int out_type, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
    int64_t o_st, int64_t o_sh, int64_t do_sb, int64_t do_st, int64_t do_sh, int64_t dq_sb,
    int64_t dq_st, int64_t dq_sh, void* stream) {
  if (bad_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GenArgs a = base_args(q, k, v, T, H, H_kv, D, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
                        {v_sb, v_st, v_sh});
  a.o = o;
  a.so = {o_sb, o_st, o_sh};
  a.dout = dout;
  a.sdo = {do_sb, do_st, do_sh};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.out0 = dq;
  a.s0 = {dq_sb, dq_st, dq_sh};
  return launch_types<kDq>(a, B, causal, in_type, out_type, stream);
}

// K3. q, do [B, T, H, D] and k/v [B, T, H_kv, D] of in_type, dk/dv [B, T,
// H_kv, D] of out_type, through their element strides; lse and delta
// [B*H, T] f32 (delta from K2). The GQA group sum is inside the kernel.
extern "C" int hived_flash_generic_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int T, int H, int H_kv, int D, int causal,
    int in_type, int out_type, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t do_sb,
    int64_t do_st, int64_t do_sh, int64_t dk_sb, int64_t dk_st, int64_t dk_sh, int64_t dv_sb,
    int64_t dv_st, int64_t dv_sh, void* stream) {
  if (bad_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GenArgs a = base_args(q, k, v, T, H, H_kv, D, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
                        {v_sb, v_st, v_sh});
  a.dout = dout;
  a.sdo = {do_sb, do_st, do_sh};
  a.lse = static_cast<const float*>(lse);
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.out0 = dk;
  a.s0 = {dk_sb, dk_st, dk_sh};
  a.out1 = dv;
  a.s1 = {dv_sb, dv_st, dv_sh};
  return launch_types<kDkv>(a, B, causal, in_type, out_type, stream);
}
