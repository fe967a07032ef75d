// Flash-attention forward (K1) for Hopper (sm_90a) past D 256: bf16 and fp16
// inputs at 256 < D <= 1024, on wgmma, each tile's scores formed once by a
// thread-block cluster.
//
// Replaces hivedscheduler_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_forward) at those inputs. The function is flash_fwd.cu's: o =
// softmax(scale * q k^T [causal mask]) v with scale = 1/sqrt(D), the running
// max m, the running sum l and the output accumulator in f32, NEG_INF = -1e30
// for causal keys, the m_safe clamp at -0.5e30, the l == 0 guard and lse =
// m_safe + log(l); GQA read in place; o stored in the input type or in f32
// (the ring's per-hop form), lse [B*H, T] f32 either way. f32 inputs, and
// 16-bit inputs past D 1024, stay on the CUDA-core family (flash_generic.cu).
//
// Bound on an H100: two products of 2*D flops per (row, key) pair the mask
// leaves; at the D 512 CLI shape (q [8,2048,4,512], k/v [8,2048,2,512],
// causal) 137.5 GFLOP, 0.139 ms at 989 TFLOP/s, against 0.060 ms for its
// 201.6 MB at 3.35 TB/s: the tensor cores bound it.
//
// Why one block cannot hold a tile. At D 512 a 128-row q tile's o
// accumulator is 128 x 512 f32 = 256 KB, the whole register file of an SM,
// and q with one K/V stage is 3 x 64 KB of 16-bit, past the 227 KB a block
// may have. So o is split by 128-column panel across the P = ceil(D / 128)
// blocks of a cluster, as flash_bwd_wide.cu splits dq, dk and dv (and with
// its helpers, flash_cluster.cuh); the CUDA-core family splits it the same
// way but has each panel form the scores again (2.5x the real work at D
// 512).
//
// Plan: one cluster of P blocks per (b*h, 128-row q tile), heaviest causal
// tiles first; block `rank` owns o's columns [128 rank, 128 rank + 128).
// Each block is, in structure, flash_fwd.cu's D 128 kernel on its panel: a
// producer warpgroup loads the q panel once and streams the K and V panels of
// 64-key tiles through a three-stage TMA ring; two consumer warpgroups under
// setmaxnreg own q rows [64c, 64c + 64). TMA zero-fills a panel's columns at
// or past D.
// - Per tile each block forms its panel's PARTIAL s = q k^T (SS wgmma
//   m64n64k16, 8 k-steps). The softmax needs every row's max over the whole
//   tile, so the partials are dealt out by ROWS, not by columns as in K2: the
//   8 groups of 8 rows of a consumer's 64 (group n: rows 16 (n % 4) + 8 (n /
//   4) + [0, 8), held by warp n % 4 in the accumulator layout) go to their
//   owners (block o owns groups [ceil(8o / P), ceil(8(o + 1) / P))), each
//   thread's 16 values of a row as four float4 through the owner's receive
//   buffer, the owner's own by plain stores, the others' by st.async, whose
//   bytes complete on the owner's mbarrier. At P >= 3 no block owns both
//   groups of one warp, so an owning warp does one row a thread.
// - An owner adds the P partials in rank order and does for its whole rows
//   what _fwd_kernel's loop body does: scale; mask (only on the consumer's
//   last tile: the causal diagonal and keys past a ragged T); the row max
//   over the quad of lanes that holds the row; m, m_safe, corr; p =
//   exp(s - m_safe); l. It packs p to the input type (in fp16 too, p lies in
//   [0, 1] and packs unscaled, as in flash_fwd.cu) as the pieces of the A
//   operand that its thread holds, and sends them with the row's f32 corr to
//   the same thread of every block.
// - Every block then rescales its o rows by corr and does o += p v_panel
//   (RS wgmma m64n128k16 from the V panel, MN-major). At the end of the row
//   the owner writes lse (one writer an element) and sends 1 / l_safe to
//   every block, which scales and stores its columns below D.
// - Each receive and operand buffer is written once a tile and read before
//   its readers send what its writers wait for next (partials after the last
//   p tile, p tiles after the partials they are formed from), so one of each
//   suffices, as in flash_bwd_wide.cu. 1 / l goes to buffers and a barrier of
//   its own: its senders hear nothing more from the readers after the last
//   partials, so it must not land on the p barrier's next phase.
// - Each p is formed once, from the same partials in the same order, so every
//   block multiplies the same operand and two runs are bit-identical. Every
//   output element is stored by one block, with no atomics.
// - Work: 1x the products plus the exchange. A block sends (P - 1) / P of 2 x
//   16 KB of f32 partials a 64-key tile and, from its owned rows, p and corr
//   to P - 1 blocks (at P = 4 ~24 KB and ~7 KB); at ~15.5 bytes a cycle out
//   of an SM (ops/dsmem_rate.py) that is ~2,000 cycles against ~1,000 of
//   products, so the exchange sets the pace, as in K2. Consumer 1 starts once
//   consumer 0 has sent its first partials, so that their sends take turns.
//   Measured at the D 512 CLI shape on an H100 (PERF.md): 1.155 ms, 12% of
//   the bound, where the CUDA-core K1 took 15.3 ms.
//
// Shared memory: q 32 KB + 3 x (16 + 16) KB of K/V stages, the receive
// buffers (2 consumers x P blocks x the groups owned x 2 KB: 36 KB at P = 3,
// 32 at P = 4 and 8), 2 x 8 KB of p tiles and 4 KB of corr and 1 / l: at
// most 185 KB. P = 7 runs as 8 (wide_panels), whose eighth panel is all zero
// columns.
//
// A cluster that cannot be scheduled, or a launch that fails, returns its
// CUDA error; nothing falls back.

#include "flash_cluster.cuh"

namespace {

using namespace hived;

constexpr int kStages = 3;  // K/V ring depth

struct FwdWideArgs {
  CUtensorMap tq, tk, tv;
  void* o;     // the input type or f32, the kernel's OutT
  float* lse;  // [B*H, T]
  int T, H, group, D, P, causal;
  Strides so;
  float scale;
};

// shared-memory layout at P blocks a cluster, byte offsets from a
// 1024-aligned base
struct FwdLayout {
  int q, k, v;
  int recv;  // [consumer][block][owned group][k-step][32 lanes] float4: partial s
  int p;     // [consumer][half][k-step pair][128 threads] uint4: packed p
  int corr;  // [consumer][half][128 threads] f32: the rows' rescale of o
  int inv;   // [consumer][half][128 threads] f32: the rows' 1 / l_safe
  int bars;  // q_full, kv_full[3], kv_empty[3], xfull[2], pfull[2], lfull[2]
  int bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int P) {
  constexpr int kQTile = kRowsQ * kPanel * 2, kKTile = kKeys * kPanel * 2;
  FwdLayout L;
  L.q = 0;
  L.k = L.q + kQTile;
  L.v = L.k + kStages * kKTile;
  L.recv = L.v + kStages * kKTile;
  L.p = L.recv + 2 * P * max_owned(P) * kGroupBytes;
  L.corr = L.p + 2 * 2 * 2 * 128 * 16;
  L.inv = L.corr + 2 * 2 * 128 * 4;
  L.bars = L.inv + 2 * 2 * 128 * 4;
  L.bytes = L.bars + (1 + 2 * kStages + 6) * 8 + 1024;  // + alignment slack
  return L;
}

// bytes a block receives a tile from each other owner's group: p (two uint4)
// and corr (one f32) from each of its 32 threads
constexpr int kPGroupBytes = 32 * (2 * 16 + 4);

template <typename In, typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
    wide_fwd_kernel(const __grid_constant__ FwdWideArgs a) {
  const int P = a.P;
  const FwdLayout L = fwd_layout(P);
  const int G = max_owned(P);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  In* sQ = reinterpret_cast<In*>(smem + L.q);
  In* sK = reinterpret_cast<In*>(smem + L.k);
  In* sV = reinterpret_cast<In*>(smem + L.v);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kStages;
  uint64_t* xfull = kv_empty + kStages;  // [consumer]: the other senders' partials landed
  uint64_t* pfull = xfull + 2;           // [consumer]: the other owners' p and corr landed
  uint64_t* lfull = pfull + 2;           // [consumer]: the other owners' 1 / l landed

  const int rank = static_cast<int>(cluster_rank());  // the panel
  const int col0 = rank * kPanel;
  const int T = a.T;
  const int n_q_tiles = (T + kRowsQ - 1) / kRowsQ;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.z);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * kRowsQ;
  const int n_k_tiles = (T + kKeys - 1) / kKeys;
  // consumer c's rows meet keys up to their diagonal, tile 2 q_tile + c
  const int n_kv = a.causal ? min(n_k_tiles, 2 * q_tile + 2) : n_k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], kWsConsumerThreads);
    }
    for (int c = 0; c < 2; ++c) {  // each arrival is an arrive.expect_tx of the phase's bytes
      mbar_init(&xfull[c], 1);
      mbar_init(&pfull[c], 1);
      mbar_init(&lfull[c], 1);
    }
    mbar_init_fence();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread starts every load
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int h_kv = h / a.group;
      mbar_expect_tx(q_full, kRowsQ * kPanel * 2);
      tma_load_panel<kRowsQ>(sQ, &a.tq, q_full, col0, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int stage = j % kStages;
        if (j >= kStages) mbar_wait(&kv_empty[stage], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&kv_full[stage], 2 * kKeys * kPanel * 2);
        tma_load_panel<kKeys>(sK + stage * kKeys * kPanel, &a.tk, &kv_full[stage], col0, h_kv,
                              j * kKeys, b);
        tma_load_panel<kKeys>(sV + stage * kKeys * kPanel, &a.tv, &kv_full[stage], col0, h_kv,
                              j * kKeys, b);
      }
    }
  } else {
    // consumer c owns q rows [64c, 64c + 64) of the tile and o's columns of
    // the panel
    regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int row_a = q0 + 64 * c + 16 * warp + g;  // rows of the accumulators' e = 0, 1
    const int row_b = row_a + 8;                    // and e = 2, 3: half 1
    const int n_kv_c = a.causal ? min(n_k_tiles, 2 * q_tile + 1 + c) : n_k_tiles;
    const int own0 = first_group(rank, P);
    const int n_own = first_group(rank + 1, P) - own0;
    // the half of the warp's rows (group warp + 4 half) this block owns, or -1
    const int own_h = owner_of(warp, P) == rank ? 0 : owner_of(warp + 4, P) == rank ? 1 : -1;
    const int own_row = own_h == 1 ? row_b : row_a;

    // K-major descriptors of this consumer's q rows and of stage 0's K panel;
    // MN-major of stage 0's V panel (LBO: its column blocks)
    const uint64_t dQ = desc_sw128(sQ + 64 * c * 64, 16);
    const uint64_t dK = desc_sw128(sK, 16);
    const uint64_t dVn = desc_sw128(sV, kKeys * 128);
    // this consumer's receive buffer, p tile, corr and 1 / l
    float4* recv = reinterpret_cast<float4*>(smem + L.recv) + c * P * G * 4 * 32;
    uint4* p_tile = reinterpret_cast<uint4*>(smem + L.p) + c * 4 * 128;
    float* corr_tile = reinterpret_cast<float*>(smem + L.corr) + c * 2 * 128;
    float* inv_tile = reinterpret_cast<float*>(smem + L.inv) + c * 2 * 128;

    float o[kPanel / 2];
#pragma unroll
    for (int i = 0; i < kPanel / 2; ++i) o[i] = 0.f;
    float m = kNegInf, l = 0.f;  // the owned row's running max, this thread's share of its sum

    if (tid == 0) mbar_expect_tx(&lfull[c], (kGroups - n_own) * 32 * 4);
    mbar_wait(q_full, 0);
    // consumer 1 starts once consumer 0 has sent its first partials, so that
    // the two consumers' sends take turns on the SM's port to the cluster
    if (c == 1) named_barrier(4, kWsConsumerThreads);

    for (int j = 0; j < n_kv_c; ++j) {
      const int stage = j % kStages;
      const uint32_t stage_off = stage * kKeys * kPanel * 2;
      if (tid == 0) {  // the last tile's waits are done: arm this tile's
        mbar_expect_tx(&xfull[c], (P - 1) * n_own * kGroupBytes);
        mbar_expect_tx(&pfull[c], (kGroups - n_own) * kPGroupBytes);
      }

      // the panel's partial s = q k^T
      float s[kKeys / 2];
      mbar_wait(&kv_full[stage], (j / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPanel / 16; ++kk) {
        const uint32_t qcol = (kk / 4) * kRowsQ * 128 + (kk % 4) * 32;
        const uint32_t kcol = stage_off + (kk / 4) * kKeys * 128 + (kk % 4) * 32;
        wgmma_ss<kKeys, In>(s, desc_add(dQ, qcol), desc_add(dK, kcol), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // both of this thread's rows to their owners, this block's own too: for
      // k-step kk, columns 16kk + 2 t4 + (0, 1) and 16kk + 8 + 2 t4 + (0, 1)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = warp + 4 * hf;
        const int o_n = owner_of(n, P);
        float4* slot = recv + (rank * G + n - first_group(o_n, P)) * 4 * 32 + lane;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int i = 8 * kk + 2 * hf;
          send(slot + kk * 32, &xfull[c], make_float4(s[i], s[i + 1], s[i + 4], s[i + 5]), o_n,
               rank);
        }
      }
      if (c == 0 && j == 0) named_arrive(4, kWsConsumerThreads);

      // the owned row: the partials added in rank order, then the online
      // softmax step; p and corr to every block
      mbar_wait_cluster(&xfull[c], j & 1);
      if (own_h >= 0) {
        const float4* gr = recv + (warp + 4 * own_h - own0) * 4 * 32 + lane;
        float x[16];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = sum_partials(gr + kk * 32, G * 4 * 32, P);
          x[4 * kk] = v.x;
          x[4 * kk + 1] = v.y;
          x[4 * kk + 2] = v.z;
          x[4 * kk + 3] = v.w;
        }
        const bool mask = j == n_kv_c - 1;
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float v = x[i] * a.scale;
          if (mask) {  // keys past T to -inf, causal keys past the row to NEG_INF
            const int col = j * kKeys + 16 * (i / 4) + 8 * ((i / 2) & 1) + 2 * t4 + (i & 1);
            if (col >= T) {
              v = -CUDART_INF_F;
            } else if (a.causal && col > own_row) {
              v = kNegInf;
            }
          }
          x[i] = v;
          mx = fmaxf(mx, v);
        }
        mx = quad_max(mx);
        const float mn = fmaxf(m, mx);
        const float ms = fmaxf(mn, kClamp);
        const float corr = exp2f((fmaxf(m, kClamp) - ms) * kLog2e);
        m = mn;
        const float mb = ms * kLog2e;
        float sum = 0.f;
        // the row's A registers of k-step kk: pk[2kk] (columns 16kk + 2 t4
        // and the next), pk[2kk + 1] (8 columns on)
        uint32_t pk[8];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float e[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) e[i] = exp2f(fmaf(x[4 * kk + i], kLog2e, -mb));
          sum += e[0] + e[1] + e[2] + e[3];
          pk[2 * kk] = pack_f32<In>(e[0], e[1]);
          pk[2 * kk + 1] = pack_f32<In>(e[2], e[3]);
        }
        l = l * corr + sum;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          broadcast(reinterpret_cast<unsigned char*>(p_tile + (own_h * 2 + jj) * 128 + tid),
                    &pfull[c], make_uint4(pk[4 * jj], pk[4 * jj + 1], pk[4 * jj + 2],
                                          pk[4 * jj + 3]), P, rank);
        }
        broadcast(reinterpret_cast<unsigned char*>(corr_tile + own_h * 128 + tid), &pfull[c], corr,
                  P, rank);
      }
      // the other owners' rows; this thread's own stores need no barrier
      mbar_wait_cluster(&pfull[c], j & 1);

      // the whole tile's p as the A operand: half hf's pieces of k-steps 2jj
      // and 2jj + 1 are registers hf and 2 + hf of each
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const uint4 v = p_tile[(hf * 2 + jj) * 128 + tid];
          pa[2 * jj][hf] = v.x;
          pa[2 * jj][2 + hf] = v.y;
          pa[2 * jj + 1][hf] = v.z;
          pa[2 * jj + 1][2 + hf] = v.w;
        }
      }
      const float corr_a = corr_tile[tid];
      const float corr_b = corr_tile[128 + tid];
#pragma unroll
      for (int n = 0; n < kPanel / 8; ++n) {
        o[4 * n] *= corr_a;
        o[4 * n + 1] *= corr_a;
        o[4 * n + 2] *= corr_b;
        o[4 * n + 3] *= corr_b;
      }

      // o += p v: k-step kk reads keys [16kk, 16kk + 16) of the V panel
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_rs<kPanel, In>(o, pa[kk], desc_add(dVn, stage_off + kk * 2048), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&kv_empty[stage]);
    }

    // the owned row's lse, and its 1 / l_safe to every block
    if (own_h >= 0) {
      const float lt = quad_sum(l);
      const float ls = lt == 0.f ? 1.f : lt;
      if (t4 == 0 && own_row < T) {
        a.lse[static_cast<int64_t>(bh) * T + own_row] = fmaxf(m, kClamp) + logf(ls);
      }
      broadcast(reinterpret_cast<unsigned char*>(inv_tile + own_h * 128 + tid), &lfull[c],
                1.f / ls, P, rank);
    }
    mbar_wait_cluster(&lfull[c], 0);
    const float inv_a = inv_tile[tid];
    const float inv_b = inv_tile[128 + tid];
    OutT* op = at(static_cast<OutT*>(a.o), a.so, b, h);
#pragma unroll
    for (int n = 0; n < kPanel / 8; ++n) {
      const bool live = col0 + n * 8 < a.D;  // columns past the real D: not stored
      const int col = col0 + n * 8 + 2 * t4;
      if (live && row_a < T) {
        store_out2(op + row_a * a.so.t + col, o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
      }
      if (live && row_b < T) {
        store_out2(op + row_b * a.so.t + col, o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
      }
    }
  }
  cluster_sync();
}

template <typename In, typename OutT>
cudaError_t launch(const FwdWideArgs& a, int B, cudaStream_t stream) {
  static bool attr_set = false;
  // the panels along x, one cluster of them; q tiles along z, heaviest first
  const dim3 grid(a.P, B * a.H, (a.T + kRowsQ - 1) / kRowsQ);
  return launch_clusters(wide_fwd_kernel<In, OutT>, a, grid, a.P, fwd_layout(a.P).bytes, stream,
                         attr_set);
}

// the three tensor maps: q boxes of 128 rows, k and v of 64 (s: the element
// strides of q, k, v)
template <typename In>
int tile_maps(FwdWideArgs& a, const void* q, const void* k, const void* v, int B, int T, int H,
              int H_kv, int D, const int64_t* s) {
  int err = make_tile_map<In>(&a.tq, q, B, T, H, D, s[0], s[1], s[2], kRowsQ);
  if (err == 0) err = make_tile_map<In>(&a.tk, k, B, T, H_kv, D, s[3], s[4], s[5], kKeys);
  if (err == 0) err = make_tile_map<In>(&a.tv, v, B, T, H_kv, D, s[6], s[7], s[8], kKeys);
  return err;
}

}  // namespace

// K1. q [B, T, H, D] and k/v [B, T, H_kv, D] of in_type (0 bf16, 1 fp16), o
// [B, T, H, D] of out_type (in_type, or 2 for f32), addressed through the
// given element strides (D contiguous, every row 16-byte aligned, strides
// positive), 256 < D <= 1024; lse [B*H, T] f32. Returns 0, the CUresult of a
// tensor map that could not be encoded, or the cudaError_t of the launch.
extern "C" int hived_flash_wide_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int T, int H, int H_kv, int D, int causal,
                                    int in_type, int out_type, int64_t q_sb, int64_t q_st,
                                    int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
                                    int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
                                    int64_t o_st, int64_t o_sh, void* stream) {
  if (bad_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t s[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  FwdWideArgs a = {};
  const int err = in_type == kBf16 ? tile_maps<bf16>(a, q, k, v, B, T, H, H_kv, D, s)
                                   : tile_maps<f16>(a, q, k, v, B, T, H, H_kv, D, s);
  if (err != 0) return err;
  a.o = o;
  a.so = {o_sb, o_st, o_sh};
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.P = wide_panels(D);
  a.causal = causal != 0;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = out_type == kF32;
  cudaError_t launched;
  if (in_type == kBf16) {
    launched = f32 ? launch<bf16, float>(a, B, st) : launch<bf16, bf16>(a, B, st);
  } else {
    launched = f32 ? launch<f16, float>(a, B, st) : launch<f16, f16>(a, B, st);
  }
  return static_cast<int>(launched);
}

// The clusters of K1 on bf16 inputs at head dim D that the card holds at
// once, or -1 - the cudaError_t of the query.
extern "C" int hived_flash_wide_fwd_clusters(int D) {
  const int P = wide_panels(D);
  static bool attr_set = false;
  return max_clusters(wide_fwd_kernel<bf16, bf16>, P, fwd_layout(P).bytes, attr_set);
}
