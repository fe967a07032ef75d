// Flash-attention forward (K1) for Hopper (sm_90a) at f32 inputs past D 128:
// 128 < D <= 1024 on the tensor cores in 3xTF32, each tile's scores formed
// once by a thread-block cluster.
//
// Replaces hivedscheduler_tpu/ops/attention.py::_fwd_kernel (launched by
// _flash_forward) at those inputs, to f32 accuracy. For every (batch, q head)
// and query row it computes what _fwd_kernel computes: q scaled by 1/sqrt(D)
// (the real D) in f32 before any product, s = q k^T under the causal mask
// (NEG_INF = -1e30), an online softmax with the running max m, the m_safe
// clamp at -0.5e30 and the l == 0 guard, o = (sum p v) / l and lse = m_safe +
// log(l), stored [B*H, T]; o in f32 in both output forms. GQA is read in
// place; any T works: TMA zero-fills rows at or past T and columns at or past
// D, keys at or past T get -inf, and the epilogue stores only rows < T and
// columns < D. Every product is 3xTF32 (flash_tf32.cuh): big big + big small
// + small big of the operands' tf32 parts, in f32 accumulators, each tile's
// part promoted into the f32 sum by plain arithmetic.
//
// Bound on an H100: two products of 2*D flops per (row, key) pair the mask
// leaves, each at 3xTF32, a third of TF32's 495 TFLOP/s: 165 TFLOP/s. At
// Gemma-2B's width in f32 (q [8,2048,8,256], k/v [8,2048,1,256], causal)
// that is 137.5 GFLOP, 0.8334 ms, against 0.09 ms for its bytes at 3.35
// TB/s: the tensor cores bound it.
//
// Why a cluster. The 3xTF32 K1 at D <= 128 (flash_fwd_tf32.cu) takes 194 of
// a block's 227 KB at Dp 128, and its o^T accumulator 64 registers a thread:
// a wider tile fits in neither. So o is split into 128-column panels, one
// block each, P = ceil(D / 128) blocks a cluster (7 run as 8, whose eighth
// panel is all zero columns: wide_panels), and each block is that kernel on
// its panel. The scores are formed once, as in the 16-bit cluster K1
// (flash_fwd_wide.cu): each block forms its panel's partial s, and the
// partials are summed through distributed shared memory (flash_cluster.cuh),
// where the CUDA-core family formed the scores again in every panel.
//
// Plan. One cluster of P blocks per (b*h, 128-row q tile), heaviest causal
// tiles first; block `rank` owns o's columns [128 rank, 128 rank + 128).
// Each block is flash_fwd_tf32.cu's: a producer warpgroup (warp 0 loads the
// q panel once, then 32-key K and V panels into two stages by TMA; warps 1-3
// split each K panel into big and small planes in place) and two consumers
// of 64 rows under setmaxnreg sharing every stage.
// - Per tile each consumer forms its panel's PARTIAL s = q k^T (q from
//   ld.shared, split in registers; 16 k-steps of 8 on the K planes). The
//   softmax needs each row's max over the whole s, so the partials are dealt
//   out by ROWS, as in flash_fwd_wide.cu: the 8 groups of 8 rows of a
//   consumer's 64 (group n: rows 16 (n % 4) + 8 (n / 4) + [0, 8), held by
//   warp n % 4) go to their owners (block o owns groups [ceil(8o / P),
//   ceil(8(o + 1) / P))), each thread's 8 values of a row as two float4
//   through the owner's receive buffer, the owner's own by plain stores, the
//   others' by st.async, whose bytes complete on the owner's mbarrier. No
//   block owns both groups of one warp, so an owning thread does one row.
// - The owner adds the P partials in rank order and does for its row what
//   _fwd_kernel's loop body does: mask (only on the consumer's causal
//   diagonal tiles and a ragged last tile), the row max over the quad, m,
//   m_safe, corr, p = exp(s - m_safe), l. It splits p into its own block's
//   p^T planes (the B operand of o^T = v^T p^T, [row][key]) and sends the f32
//   p to the same offset of every other block's big plane, and the row's
//   corr to every block's row buffer (where flash_fwd_tf32.cu's o^T layout
//   reads it anyway: a row of o^T is spread over the warpgroup). A thread
//   then splits, in place, the received p of its rows that other blocks own,
//   so every p plane is written by this block's own threads before the
//   proxy fence and the barrier that wgmma reads behind (as
//   flash_bwd_tf32_wide.cu does for ds).
// - Every block then forms its panel's o^T = o^T corr + v^T p^T (v^T read
//   down the f32 V panel and split in registers; each tile's part in a fresh
//   accumulator, folded in as o corr + part). At the end each owner writes
//   lse (one writer an element) and sends l_safe to every block, which
//   divides and stores its columns below D.
// - Each receive buffer is written once a tile and read before its readers
//   send what its writers wait for next: partials (tile j + 1) after the
//   sender has the whole p of tile j, which its owners send after reading
//   the partials of tile j; p of tile j + 1 after the owner has every
//   block's partials of it, which each block sends after its consumer's
//   barrier behind the products of tile j + 1, so behind every read of the
//   p planes and of corr for tile j. l goes to a buffer and a barrier of its
//   own: its senders hear nothing more from the readers after the last
//   partials, so it must not land on the p barrier's next phase. A consumer
//   skips the tiles wholly past its rows in every block alike, and waits on
//   its exchange barriers once a tile it takes, each armed for the next tile
//   only after its armer's wait on the last. A cluster barrier after the
//   barriers' initialisation keeps every store from landing before them, and
//   one at the end keeps every block resident until all have finished.
// - Each p is formed once, from the same partials in the same order, so
//   every block multiplies the same operand, two runs are bit-identical, and
//   every output element is stored by one block, with no atomics.
//
// Why 128-row blocks, with p sent in f32 (the other way: 64-row blocks, as
// K2 at these D). The producer's big/small split paces the 3xTF32 kernels
// (timing variants of flash_bwd_tf32_wide.cu), and a 128-row block splits
// each K panel once per 128 rows, not once per 64. A received p needs no
// buffer of its own: it lands in the big plane it is split in, so the block
// fits. Shared memory: q 64 KB; two stages of K big and small and V in f32,
// 96 KB; the two consumers' p planes, 32 KB; the partials' receive buffers
// (2 consumers x P blocks x the groups owned x 1 KB: 16 KB at P = 2, 4 and
// 8, 18 at 3, 20 at 5, 24 at 6); the row buffers 1 KB: at most 219 KB.
// Registers a consumer thread: o^T 64 (two 64-column M blocks), a tile's
// part 32, s 16 and the A fragments of two k-steps, as flash_fwd_tf32.cu's
// (ptxas gives this 384-thread launch 168: flash_bwd_tf32.cu).
//
// A cluster that cannot be scheduled, or a launch that fails, returns its
// CUDA error; nothing falls back.

#include "flash_cluster.cuh"
#include "flash_tf32.cuh"

namespace {

using namespace hived;

constexpr int kTileKeys = 32;   // keys a K/V tile (the N of s, the K of o^T)
constexpr int kConsRows = 64;   // q rows of a consumer (the M of s, the N of o^T)
constexpr int kPlane = kTileKeys * kPanel * 4;       // one f32 plane of a K or V panel: 16 KB
constexpr int kQPanel = kRowsQ * kPanel * 4;         // the q panel: 64 KB
constexpr int kPPlane = kConsRows * kTileKeys * 4;   // one p^T plane of a consumer: 8 KB
constexpr int kGroupF32 = 32 * 2 * 16;   // one 8-row group of a consumer's partial s: 1 KB
constexpr int kRowBytes = 8 * 4;         // a group's 8 rows' corr, or l
constexpr int kFwdBars = 13;  // q_full, raw[2], full[2], empty[2], xfull[2], pfull[2], lfull[2]

struct FwdArgs {
  CUtensorMap tq, tk, tv;
  float* o;
  float* lse;  // [B*H, T]
  int T, H, group, D, P, causal;
  Strides so;
  float scale;
};

// shared-memory layout at P blocks a cluster, byte offsets from a 1024-aligned
// base
struct FwdLayout {
  int q;
  int stage;  // [stage]: K big, K small, V (f32)
  int p;      // [consumer]: p^T big, small ([64 rows][32 keys])
  int recv;   // [consumer][block][owned group][2][32 lanes] float4: partial s
  int corr;   // [consumer][64 rows] f32: a tile's rescale of o
  int l;      // [consumer][64 rows] f32: l_safe
  int bars;
  int bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int P) {
  FwdLayout L;
  L.q = 0;
  L.stage = L.q + kQPanel;
  L.p = L.stage + 2 * 3 * kPlane;
  L.recv = L.p + 2 * 2 * kPPlane;
  L.corr = L.recv + 2 * P * max_owned(P) * kGroupF32;
  L.l = L.corr + 2 * kConsRows * 4;
  L.bars = L.l + 2 * kConsRows * 4;
  L.bytes = L.bars + kFwdBars * 8 + 1024;  // + alignment slack
  return L;
}

__global__ void __launch_bounds__(kWsThreads, 1)
    tf32_wide_fwd_kernel(const __grid_constant__ FwdArgs a) {
  const int P = a.P;
  const FwdLayout L = fwd_layout(P);
  const int G = max_owned(P);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* sQ = reinterpret_cast<float*>(smem + L.q);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* raw = q_full + 1;
  uint64_t* full = raw + 2;
  uint64_t* empty = full + 2;
  uint64_t* xfull = empty + 2;  // [consumer]: the other blocks' partials of the owned groups landed
  uint64_t* pfull = xfull + 2;  // [consumer]: the other owners' p and corr landed
  uint64_t* lfull = pfull + 2;  // [consumer]: the other owners' l landed

  const int rank = static_cast<int>(cluster_rank());  // the panel
  const int col0 = rank * kPanel;
  const int T = a.T;
  const int n_q_tiles = (T + kRowsQ - 1) / kRowsQ;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.z);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = q_tile * kRowsQ;
  const int n_k_tiles = (T + kTileKeys - 1) / kTileKeys;
  // the rows meet keys up to q0 + 127: tiles up to 4 q_tile + 3
  const int n_kv = a.causal ? min(n_k_tiles, 4 * q_tile + 4) : n_k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&raw[s], 1);
      mbar_init(&full[s], kSplitThreads);        // the split warps, K split
      mbar_init(&empty[s], kWsConsumerThreads);  // both consumers' threads, stage done
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
    // producer: tile j goes to stage j % 2; thread 0 loads each tile as soon
    // as its stage is free, warps 1-3 split each K panel as it lands
    regs_dec<kProdRegs>();
    const int ptid = threadIdx.x;
    if (ptid == 0) {
      mbar_expect_tx(q_full, kQPanel);
      tma_tile<kPanel, kRowsQ>(sQ, &a.tq, q_full, h, q0, b, col0);
      const int h_kv = h / a.group;
      for (int j = 0; j < n_kv; ++j) {
        const int stage = j & 1;
        float* kb = reinterpret_cast<float*>(smem + L.stage + stage * 3 * kPlane);
        if (j >= 2) mbar_wait(&empty[stage], ((j >> 1) - 1) & 1);
        mbar_expect_tx(&raw[stage], 2 * kPlane);
        tma_tile<kPanel, kTileKeys>(kb, &a.tk, &raw[stage], h_kv, j * kTileKeys, b, col0);
        tma_tile<kPanel, kTileKeys>(kb + 2 * kPlane / 4, &a.tv, &raw[stage], h_kv,
                                    j * kTileKeys, b, col0);
      }
    } else if (ptid >= 32) {
      for (int j = 0; j < n_kv; ++j) {
        const int stage = j & 1;
        float* kb = reinterpret_cast<float*>(smem + L.stage + stage * 3 * kPlane);
        mbar_wait(&raw[stage], (j >> 1) & 1);
        split_planes(kb, kb + kPlane / 4, kTileKeys * kPanel, ptid - 32);
        fence_async_shared();  // the planes, visible to wgmma
        mbar_arrive(&full[stage]);
      }
    }
  } else {
    // consumer c owns q rows [64c, 64c + 64) of the tile and o's columns of
    // the panel
    regs_inc<kConsRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int m_a = 16 * warp + g;  // rows of the s accumulator in the consumer's 64: m_a, m_a + 8
    const int r0 = q0 + kConsRows * c;  // the consumer's first row
    const int own0 = first_group(rank, P);
    const int n_own = first_group(rank + 1, P) - own0;
    // the half of the warp's rows (group warp + 4 half) this block owns, or -1
    const int own_h = owner_of(warp, P) == rank ? 0 : owner_of(warp + 4, P) == rank ? 1 : -1;
    const int m_own = m_a + 8 * own_h;  // the owned row in the consumer's 64
    const int own_row = r0 + m_own;

    float* pb = reinterpret_cast<float*>(smem + L.p + c * 2 * kPPlane);
    float* ps = pb + kPPlane / 4;
    float4* recv = reinterpret_cast<float4*>(smem + L.recv) + c * P * G * 64;
    float* corr = reinterpret_cast<float*>(smem + L.corr) + c * kConsRows;
    float* sL = reinterpret_cast<float*>(smem + L.l) + c * kConsRows;
    const uint64_t dPb = desc_sw128(pb, 16), dPs = desc_sw128(ps, 16);

    if (tid == 0) mbar_expect_tx(&lfull[c], (kGroups - n_own) * kRowBytes);

    // q scaled by 1/sqrt(D) in f32 in place, as _fwd_kernel scales it: the
    // consumer's 64 rows are 8 KB at the same offset of every column block
    mbar_wait(q_full, 0);
#pragma unroll
    for (int blk = 0; blk < kPanel / 32; ++blk) {
      float4* rows = reinterpret_cast<float4*>(sQ + (blk * kRowsQ + kConsRows * c) * 32);
#pragma unroll
      for (int i = tid; i < kConsRows * 32 / 4; i += 128) {
        const float4 x = rows[i];
        rows[i] = make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
      }
    }
    named_barrier(1 + c, 128);

    float acc[2][32];  // the panel's o^T by 64-column M block
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
    }
    float m_run = kNegInf, l_run = 0.f;  // the owned row's max, this thread's share of its sum
    int it = 0;                          // tiles this consumer has taken

    for (int j = 0; j < n_kv; ++j) {
      const int stage = j & 1;
      const uint32_t parity = (j >> 1) & 1;
      const int k0 = j * kTileKeys;
      float* kb = reinterpret_cast<float*>(smem + L.stage + stage * 3 * kPlane);
      float* ks = kb + kPlane / 4;
      const float* sV = ks + kPlane / 4;
      mbar_wait(&raw[stage], parity);   // V, as TMA wrote it
      mbar_wait(&full[stage], parity);  // K's planes
      if (a.causal && k0 > r0 + kConsRows - 1) {  // no key of the tile meets these rows
        mbar_arrive(&empty[stage]);
        continue;
      }
      if (tid == 0) {  // the last tile's waits are done: arm this tile's
        mbar_expect_tx(&xfull[c], (P - 1) * n_own * kGroupF32);
        mbar_expect_tx(&pfull[c], (kGroups - n_own) * (kGroupF32 + kRowBytes));
      }

      // the panel's partial s = q k^T over 16 k-steps, each k-step's q
      // fragment read while the last k-step's wgmmas run; element i: row m_a
      // (+8 if i & 2), key 8 (i >> 2) + 2 t4 + (i & 1)
      float s[16];
      {
        const uint64_t dKb = desc_sw128(kb, 16), dKs = desc_sw128(ks, 16);
        const int m = kConsRows * c + m_a;
        float x[4];
        frag_rows<kRowsQ>(x, sQ, m, t4);
#pragma unroll
        for (int kk = 0; kk < kPanel / 8; ++kk) {
          uint32_t xb[4], xs[4];
          split4(x, xb, xs);
          const uint32_t off = (kk / 4) * kTileKeys * 128 + (kk % 4) * 32;
          wgmma_fence();
          tf32x3<kTileKeys>(s, xb, xs, desc_add(dKb, off), desc_add(dKs, off), kk > 0);
          wgmma_commit();
          if (kk + 1 < kPanel / 8) frag_rows<kRowsQ>(x, sQ, m, 8 * (kk + 1) + t4);
          wgmma_wait<1>();
        }
        wgmma_wait<0>();
        fence_regs(s);
      }
      // every thread of the consumer is past the last tile's reads of the p
      // planes and corr before any block hears this tile's partials from it
      named_barrier(1 + c, 128);

      // both of this thread's rows to their owners, this block's own too:
      // half hf's values of keys 2 t4 + (0, 1, 8, 9) and 16 on
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = warp + 4 * hf;
        const int o_n = owner_of(n, P);
        float4* slot = recv + (rank * G + n - first_group(o_n, P)) * 64 + lane;
        send(slot, &xfull[c], make_float4(s[2 * hf], s[2 * hf + 1], s[4 + 2 * hf], s[5 + 2 * hf]),
             o_n, rank);
        send(slot + 32, &xfull[c],
             make_float4(s[8 + 2 * hf], s[9 + 2 * hf], s[12 + 2 * hf], s[13 + 2 * hf]), o_n, rank);
      }

      // the owned row: the partials added in rank order, then the online
      // softmax step of _fwd_kernel; p into this block's planes and in f32 to
      // every other block's, corr to every block
      mbar_wait_cluster(&xfull[c], it & 1);
      if (own_h >= 0) {
        const float4* gr = recv + (warp + 4 * own_h - own0) * 64 + lane;
        const float4 lo = sum_partials(gr, G * 64, P);
        const float4 hi = sum_partials(gr + 32, G * 64, P);
        // x[e]: key k0 + 8 (e >> 1) + 2 t4 + (e & 1)
        float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (k0 + kTileKeys > T || (a.causal && k0 + kTileKeys - 1 > r0)) {
          // keys at or past T to -inf, causal keys past the row to NEG_INF
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int col = k0 + 8 * (e >> 1) + 2 * t4 + (e & 1);
            if (col >= T) {
              x[e] = -CUDART_INF_F;
            } else if (a.causal && col > own_row) {
              x[e] = kNegInf;
            }
          }
        }
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < 8; ++e) mx = fmaxf(mx, x[e]);
        const float mn = fmaxf(m_run, quad_max(mx));
        const float ms = fmaxf(mn, kClamp);
        const float cr = expf(fmaxf(m_run, kClamp) - ms);
        m_run = mn;
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          x[e] = expf(x[e] - ms);
          sum += x[e];
        }
        l_run = l_run * cr + sum;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int off = sw<kConsRows>(m_own, 8 * jj + 2 * t4);
          send_others(reinterpret_cast<const uint2*>(pb + off), &pfull[c],
                      make_uint2(__float_as_uint(x[2 * jj]), __float_as_uint(x[2 * jj + 1])), P,
                      rank);
          store_split2<kConsRows>(pb, ps, m_own, 8 * jj + 2 * t4, x[2 * jj], x[2 * jj + 1]);
        }
        if (t4 == 0) {
          broadcast(reinterpret_cast<unsigned char*>(corr + m_own), &pfull[c], cr, P, rank);
        }
      }

      // the thread's rows other blocks own: their f32 p, split in place
      mbar_wait_cluster(&pfull[c], it & 1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (hf == own_h) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float2 v = *reinterpret_cast<const float2*>(
              pb + sw<kConsRows>(m_a + 8 * hf, 8 * jj + 2 * t4));
          store_split2<kConsRows>(pb, ps, m_a + 8 * hf, 8 * jj + 2 * t4, v.x, v.y);
        }
      }
      fence_async_shared();
      named_barrier(1 + c, 128);  // this consumer's p planes and rescales complete

      // o^T = o^T corr + v^T p^T: M = the panel's columns (block mb: [64mb,
      // 64mb + 64) of the V panel), N = the 64 rows, k-step kk = keys [8kk,
      // 8kk + 8)
      uint32_t u[4];
      frag_cols<kTileKeys>(u, sV, m_a, t4);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        float part[32];
#pragma unroll
        for (int kk = 0; kk < kTileKeys / 8; ++kk) {
          uint32_t xb[4], xs[4];
          const float x[4] = {__uint_as_float(u[0]), __uint_as_float(u[1]), __uint_as_float(u[2]),
                              __uint_as_float(u[3])};
          split4(x, xb, xs);
          wgmma_fence();
          tf32x3<64>(part, xb, xs, desc_add(dPb, kk * 32), desc_add(dPs, kk * 32), kk > 0);
          wgmma_commit();
          // the next k-step's v^T fragment, read while these wgmmas run
          if (kk + 1 < kTileKeys / 8) {
            frag_cols<kTileKeys>(u, sV, 64 * mb + m_a, 8 * (kk + 1) + t4);
          } else if (mb + 1 < 2) {
            frag_cols<kTileKeys>(u, sV, 64 * (mb + 1) + m_a, t4);
          }
          wgmma_wait<1>();
        }
        wgmma_wait<0>();
        fence_regs(part);
        // the rows' rescales, read here to keep registers: element 4jj + e
        // is row 8jj + 2 t4 + (e & 1)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 c2 = *reinterpret_cast<const float2*>(corr + 8 * jj + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e;
            acc[mb][i] = fmaf(acc[mb][i], (e & 1) ? c2.y : c2.x, part[i]);
          }
        }
      }
      mbar_arrive(&empty[stage]);
      ++it;
    }

    // the owned row's l over the quad, guarded; lse = m_safe + log(l); l to
    // every block's row buffer
    if (own_h >= 0) {
      const float lt = quad_sum(l_run);
      const float ls = lt == 0.f ? 1.f : lt;
      if (t4 == 0) {
        if (own_row < T) {
          a.lse[static_cast<int64_t>(bh) * T + own_row] = fmaxf(m_run, kClamp) + logf(ls);
        }
        broadcast(reinterpret_cast<unsigned char*>(sL + m_own), &lfull[c], ls, P, rank);
      }
    }
    named_barrier(1 + c, 128);  // this block's owners' l stored
    mbar_wait_cluster(&lfull[c], 0);

    // o = o^T / l, stored transposed: element 4jj + e of block mb is D column
    // col0 + 64mb + m_a (+8 if e & 2), row 8jj + 2 t4 + (e & 1)
    float* op = at(a.o, a.so, b, h);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * jj + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * jj + 2 * t4 + (e & 1);
        const float l = (e & 1) ? l2.y : l2.x;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          const int col = col0 + 64 * mb + m_a + ((e & 2) ? 8 : 0);
          if (col < a.D && row < T) op[row * a.so.t + col] = acc[mb][4 * jj + e] / l;
        }
      }
    }
  }
  cluster_sync();
}

}  // namespace

// K1. q [B, T, H, D] and k/v [B, T, H_kv, D] in f32, o [B, T, H, D] in f32,
// addressed through the given element strides (D contiguous, every row
// 16-byte aligned, strides positive), 128 < D <= 1024; lse [B*H, T] f32.
// in_type and out_type are the generic family's codes and must both be 2
// (f32): the CUDA-core K1's signature. Returns 0, the CUresult of a tensor
// map that could not be encoded, or the cudaError_t of the launch.
extern "C" int hived_flash_tf32_wide_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int B, int T, int H, int H_kv, int D,
                                         int causal, int in_type, int out_type, int64_t q_sb,
                                         int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
                                         int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
                                         int64_t o_sb, int64_t o_st, int64_t o_sh, void* stream) {
  if (bad_f32_args(B, T, H, H_kv, D, in_type, out_type)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs a = {};
  int err = make_f32_map(&a.tq, q, B, T, H, D, q_sb, q_st, q_sh, kRowsQ);
  if (err == 0) err = make_f32_map(&a.tk, k, B, T, H_kv, D, k_sb, k_st, k_sh, kTileKeys);
  if (err == 0) err = make_f32_map(&a.tv, v, B, T, H_kv, D, v_sb, v_st, v_sh, kTileKeys);
  if (err != 0) return err;
  a.o = static_cast<float*>(o);
  a.so = {o_sb, o_st, o_sh};
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.H = H;
  a.group = H / H_kv;
  a.D = D;
  a.P = wide_panels(D);
  a.causal = causal != 0;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  static bool attr_set = false;
  // the panels along x, one cluster of them; q tiles along z, heaviest first
  const dim3 grid(a.P, B * H, (T + kRowsQ - 1) / kRowsQ);
  return static_cast<int>(launch_clusters(tf32_wide_fwd_kernel, a, grid, a.P,
                                          fwd_layout(a.P).bytes,
                                          static_cast<cudaStream_t>(stream), attr_set));
}

// The clusters of K1 at head dim D that the card holds at once, or -1 - the
// cudaError_t of the query.
extern "C" int hived_flash_tf32_wide_fwd_clusters(int D) {
  const int P = wide_panels(D);
  static bool attr_set = false;
  return max_clusters(tf32_wide_fwd_kernel, P, fwd_layout(P).bytes, attr_set);
}
