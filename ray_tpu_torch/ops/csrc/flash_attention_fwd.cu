// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd). Same function: causal (top-left, row >= col) or
// full attention over q [B, Lq, H, D] and k/v [B, Lk, H, D] with an online
// softmax, returning O in the input dtype and LSE = m + log(l) in f32 as
// [B, H, Lq]. Two kernels, chosen by the dtype alone:
// - fwd_bf16_kernel, bf16 inputs: every product on the tensor cores (wgmma),
//   a TMA producer warpgroup feeding two consumer warpgroups;
// - fwd_kernel, f32 inputs: every product an f32 FMA, so f32 keeps IEEE f32
//   parity (2e-5) with the dense reference.
//
// What bounds it on an H100. The training shapes (B=2, H=32, D=128, causal)
// are bound by operations: 4 B H D x kept pairs is 0.275 TFLOP at L=4097
// and 4.40 TFLOP at L=16385, 0.28 and 4.45 ms at the 989 TFLOP/s bf16
// tensor-core rate, against 0.08 and 0.32 ms to read Q, K, V and write O at
// 3.35 TB/s. So the kernel has to keep the tensor cores busy: the softmax
// between the two products (scale, mask, row max, one exp2f per score, row
// sum) must run while a product does, and no thread that issues wgmma may
// spend its time on loads. The serving buckets (B=1..8, L=128..4096) are
// bound by bytes at the short end and by operations from L=1024 on.
//
// It replaces a bf16 design of one warpgroup per 64-row Q tile: all 128
// threads issued cp.async copies of 64-row K/V tiles into a 2-stage ring
// behind a __syncthreads a tile, and waited for S = QK^T before the softmax,
// so the exponentials ran with the tensor cores idle (24% of their peak a
// launch at L=16385).
//
// bf16 design (FlashAttention-3's shape).
// - One block per (b*h, Q tile of 128 rows): two consumer warpgroups and
//   one producer warpgroup, 384 threads, at every shape. (A one-consumer
//   form of 64-row tiles, meant to spread short serving batches over more
//   SMs, measured slower than this one at every shape tried on an H100,
//   down to B=1, H=32, L=128.)
//   The grid is (Q tile, b*h), last Q tile first: the longest causal rows
//   of a head start first, and the blocks on the card at one time share one
//   or two heads' K and V through L2 (a head's K and V are 8 MB at
//   L=16385; the 64 heads of a training step are 0.5 GB).
// - Producer: gives its registers back (setmaxnreg down to 24); one
//   thread issues TMA loads: the block's Q tile once, then K_j and V_j into
//   a ring of 2 stages, each with a full and an empty mbarrier for K and for
//   V. K_j is released as soon as S_j is in registers, V_j once P_j V_j is
//   done, so each load has a whole step to land. The tensor maps are built
//   on the host for each launch (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so the build stays plain nvcc) over [B, L, H,
//   D] with the wrapper's strides, in boxes of SWE columns swizzled as
//   hopper.cuh's SwTile; rows past L arrive as zeros, which gives the zeroed
//   pad rows of _fwd_kernel:64-69.
// - Consumers: take registers (setmaxnreg up to 240); each owns 64 rows of
//   the Q tile and both read the same K/V stage, which halves shared-memory
//   and L2 traffic per Q row against 64-row blocks. K/V tiles are BKV = 128
//   rows at every head dim: at D=128, Q 32 KB + 2 x (K 32 KB + V
//   32 KB) = 160 KB of shared memory, one block an SM.
// - Overlap inside a consumer. Step j issues S_j = Q K_j^T (wgmma
//   m64n128k16, A and B from shared memory, K-major), rescales O by the
//   factor of step j - 1, issues O += P_{j-1} V_{j-1} (m64nDk16, P as bf16
//   A fragments straight from the score registers, V MN-major), and waits
//   with wgmma.wait_group 1 for S_j alone: the softmax of S_j runs while
//   P_{j-1} V_{j-1} is on the tensor cores.
// - Ping-pong between the consumers: named barriers 1 and 2 pass the turn
//   to issue products back and forth (bar.sync on one's own, bar.arrive on
//   the other's), so while one consumer's products run, the other runs its
//   softmax.
// - Online softmax on the accumulator fragment: each row lives in 4 lanes,
//   so row max is two shuffles; row sums stay per thread until the end. The
//   mask is applied only on tiles that cross the diagonal or the ragged
//   edge, with the TPU's semantics: masked scores count as -1e30 in the row
//   max (softmax_step holds them as -inf, which gives the same max) with
//   probability exactly 0, m starting at -1e30, l clamped at 1e-30 before
//   the division and the log. O is rescaled only where a row's max moved.
// - Precision: QK^T from bf16 operands accumulates exactly what the TPU's
//   f32 upcast computes (a bf16 x bf16 product is exact in f32). Only P is
//   rounded, to bf16 (2^-9 relative) before PV; every accumulator is f32;
//   the exponential is exp2f with LOG2E. O is written in bf16 from
//   registers, LSE as m + log(l) in f32.
// - f32 inputs: the FMA kernel below, 256 threads as a 16 x 16 grid over a
//   64 x 64 score tile, f32 tiles in shared memory.
// - The kernels allocate nothing: the caller passes O and LSE. They launch
//   on the caller's stream and the entry point returns cudaGetLastError(),
//   or TMAP_ERROR (+ the CUresult) when a tensor map cannot be built.

#include <cuda.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // f32 kernel: Q rows per block
constexpr int BK = 64;        // f32 kernel: K/V rows per inner tile
constexpr int BKV = 128;      // bf16 kernel: K/V rows per tile
constexpr int STAGES = 2;     // bf16 kernel: K/V tiles in flight
constexpr int TMAP_ERROR = 10000;
constexpr int THREADS = 256;  // f32 kernel: 16 x 16
constexpr int TM = 4;         // f32 kernel: rows per thread
constexpr int TN = 4;         // f32 kernel: score columns per thread
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Lq]
  int H, Lq, Lk, causal;
  float scale;
  // Element strides of the batch, sequence and head dims; D is contiguous.
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
};

template <int D>
constexpr size_t smem_bytes() {
  // q_s [BQ][D+1], k_s [BK][D+1], v_s [BK][D], p_s [BQ][BK+1], all f32.
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// f32 inputs: every product an f32 FMA.
template <int D>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Params p) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int QS = D + 1;   // padded row stride of q_s and k_s
  constexpr int PS = BK + 1;  // padded row stride of p_s
  constexpr int TD = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * QS;
  float* v_s = k_s + BK * QS;
  float* p_s = v_s + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = iq * BQ;

  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Q tile; rows past Lq load as 0 and are never stored.
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    q_s[r * QS + c] = row < p.Lq ? qp[row * p.q_sl + c] : 0.f;
  }

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  int nk = (p.Lk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the previous tile's readers are done with k_s/v_s/p_s
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int col = k0 + r;
      const bool ok = col < p.Lk;
      k_s[r * QS + c] = ok ? kp[col * p.k_sl + c] : 0.f;
      v_s[r * D + c] = ok ? vp[col * p.v_sl + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 scores.
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = q_s[(ty * TM + i) * QS + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, online-softmax update, P into shared memory.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty * TM + i;
      bool ok[TN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < p.Lk && (!p.causal || row >= col);
        s[i][j] = ok[j] ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float pv = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * TM + i) * PS + tx + 16 * j] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[TM], vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = p_s[(ty * TM + i) * PS + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = v_s[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row >= p.Lq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      op[row * p.o_sl + tx + 16 * j] = acc[i][j] / li;
    if (tx == 0) p.lse[(long long)bh * p.Lq + row] = m[i] + logf(li);
  }
}

// bf16 inputs: both products on the tensor cores (design in the header).
template <int D>
struct Bf16Fwd {
  static constexpr int BQ = 128;  // Q rows of a block, 64 a consumer
  using QTile = hopper::SwTile<BQ, D>;
  using KTile = hopper::SwTile<BKV, D>;
  static constexpr int THREADS = 3 * hopper::WG_THREADS;
  // Q, then STAGES K tiles and STAGES V tiles; 1024 bytes of slack to align
  // the base.
  static constexpr size_t SMEM =
      1024 + QTile::BYTES + 2 * STAGES * KTile::BYTES;
};

// Online-softmax step over one 64 x BKV score tile held as wgmma
// accumulators (layout in hopper.cuh): scale and mask the scores, fold
// their row maxima into m, rescale l, and turn s into P = exp(s - m), zero
// where masked. corr gets each row's factor for O.
//
// A masked score is held as -inf, not as -1e30: the row max is the same
// (m starts at -1e30 and a stored row has a real score in its first tile),
// and its P is exp2f(-inf) = 0 exactly, so no mask has to be kept for the
// exponentials.
template <int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool need_mask, int row_a,
                                             int k0, int lane,
                                             const Params& p) {
  float mx[2] = {NEG_INF, NEG_INF};
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const int row = row_a + 8 * r;
      const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool ok = col < p.Lk && (!p.causal || row >= col);
      s[i] = ok ? s[i] * p.scale : -INFINITY;
      mx[r] = fmaxf(mx[r], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] *= p.scale;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
    mb[r] = m_new * LOG2E;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2f(fmaf(s[i], LOG2E, -mb[r]));
    l[r] += s[i];
  }
}

// Bounded for 3 warpgroups, so a thread starts with at most 168 registers
// and setmaxnreg moves them from producer to consumers.
template <int D>
__global__ void __launch_bounds__(3 * hopper::WG_THREADS, 1)
    fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, Params p) {
  using namespace hopper;
  using F = Bf16Fwd<D>;
  using QT = typename F::QTile;
  using KT = typename F::KTile;
  constexpr int NS = BKV / 2;  // score accumulators a thread
  constexpr int NO = D / 2;    // output accumulators a thread
  constexpr int CB = D / KT::SWE;  // column blocks of a tile: TMA boxes

  extern __shared__ unsigned char smem_raw[];
  __shared__ alignas(8) uint64_t bars[1 + 4 * STAGES];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + QT::BYTES;  // stage t at + t * KT::BYTES
  const uint32_t v_s = k_s + STAGES * KT::BYTES;
  // mbarriers: Q full; then, one a stage each, K full, K empty, V full,
  // V empty.
  const uint32_t q_full = smem_u32(bars);
  const uint32_t k_full = q_full + 8, k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES, v_empty = v_full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F::BQ;
  int nk = (p.Lk + BKV - 1) / BKV;
  if (p.causal) nk = min(nk, (q0 + F::BQ + BKV - 1) / BKV);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int t = 0; t < STAGES; ++t) {
      mbar_init(k_full + 8 * t, 1);
      mbar_init(v_full + 8 * t, 1);
      mbar_init(k_empty + 8 * t, 8);  // one arrival a consumer warp
      mbar_init(v_empty + 8 * t, 8);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (tid < WG_THREADS) {
    // Producer warpgroup: one thread keeps the loads in flight.
    regs_dec<24>();
    if (tid == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      mbar_expect_tx(q_full, QT::BYTES);
      for (int c = 0; c < CB; ++c)
        tma_load_4d(q_s + c * QT::BLOCK, &tm_q, q_full, c * KT::SWE, q0, h,
                    b);
      for (int j = 0; j < nk; ++j) {
        const int t = j % STAGES;
        const uint32_t free_parity = ((j / STAGES) & 1) ^ 1;
        const uint32_t kt = k_s + t * KT::BYTES, vt = v_s + t * KT::BYTES;
        mbar_wait(k_empty + 8 * t, free_parity);
        mbar_expect_tx(k_full + 8 * t, KT::BYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(kt + c * KT::BLOCK, &tm_k, k_full + 8 * t,
                      c * KT::SWE, j * BKV, h, b);
        mbar_wait(v_empty + 8 * t, free_parity);
        mbar_expect_tx(v_full + 8 * t, KT::BYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(vt + c * KT::BLOCK, &tm_v, v_full + 8 * t,
                      c * KT::SWE, j * BKV, h, b);
      }
    }
    return;
  }

  // Consumer warpgroup c: rows q0 + 64c .. q0 + 64c + 63 of the tile.
  regs_inc<240>();
  const int c = tid / WG_THREADS - 1;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const uint32_t q_c = q_s + c * 64 * QT::SWB;
  const int q0c = q0 + 64 * c;
  // This thread's rows: row_a for accumulators with (i & 2) == 0, else +8.
  const int row_a = q0c + warp * 16 + lane / 4;

  // The turn to issue products: consumer c waits on named barrier 1 + c
  // and passes the turn with an arrival on the other's. Consumer 1 passes
  // first, so consumer 0 starts, and skips its last pass so that every
  // barrier ends with as many arrivals as waits.
  auto take_turn = [&] { named_sync(1 + c, 2 * WG_THREADS); };
  auto pass_turn = [&](bool last) {
    if (!(last && c == 1)) named_arrive(2 - c, 2 * WG_THREADS);
  };
  // One arrival a warp, once the warp's wgmma reads of the stage are done.
  auto release = [&](uint32_t bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  auto need_mask = [&](int k0) {
    return k0 + BKV > p.Lk || (p.causal && k0 + BKV - 1 > q0c);
  };

  float o[NO], s[NS], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};
  uint32_t pa[BKV / 16][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;

  auto issue_s = [&](int j) {  // S = Q K_j^T
    const uint32_t kt = k_s + (j % STAGES) * KT::BYTES;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV>(s, QT::kmajor(q_c, kk), KT::kmajor(kt, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {  // O += P V_j
    const uint32_t vt = v_s + (j % STAGES) * KT::BYTES;
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], KT::mnmajor(vt, kk), 1);
    wgmma_commit();
  };
  // O *= corr, skipped where every row of the warp kept its max (corr is
  // then exactly 1).
  auto rescale_o = [&] {
    if (__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) return;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
  };

  if (c == 1) named_arrive(1, 2 * WG_THREADS);
  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  take_turn();
  issue_s(0);
  pass_turn(false);
  wgmma_wait<0>();
  fence_regs(s);
  release(k_empty);
  softmax_step(s, m, l, corr, need_mask(0), row_a, 0, lane, p);
  to_a_fragments<BKV>(s, pa);

  for (int j = 1; j < nk; ++j) {
    const int t = j % STAGES, u = (j - 1) % STAGES;
    mbar_wait(k_full + 8 * t, (j / STAGES) & 1);
    mbar_wait(v_full + 8 * u, ((j - 1) / STAGES) & 1);
    take_turn();
    issue_s(j);
    rescale_o();
    issue_pv(j - 1);
    pass_turn(false);
    wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
    fence_regs(s);
    release(k_empty + 8 * t);
    softmax_step(s, m, l, corr, need_mask(j * BKV), row_a, j * BKV, lane, p);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(v_empty + 8 * u);
    to_a_fragments<BKV>(s, pa);
  }
  {
    const int u = (nk - 1) % STAGES;
    mbar_wait(v_full + 8 * u, ((nk - 1) / STAGES) & 1);
    take_turn();
    rescale_o();
    issue_pv(nk - 1);
    pass_turn(true);
    wgmma_wait<0>();
    fence_regs(o);
  }

  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  float li[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    li[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = row_a + 8 * r;
    if (row >= p.Lq) continue;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(op + row * p.o_sl + col) =
        __floats2bfloat162_rn(o[i] / li[r], o[i + 1] / li[r]);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row < p.Lq) p.lse[(long long)bh * p.Lq + row] = m[r] + logf(li[r]);
    }
  }
}

// cuTensorMapEncodeTiled, from the CUDA library the runtime loaded (null
// where it has none).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a [B, L, H, D] bf16 tensor (D contiguous; element strides
// sb, sl, sh) read in boxes of `rows` x SWE elements, swizzled as
// SwTile<rows, D> lays out one column block. Returns 0 or a TMAP_ERROR code.
template <int D>
int tensor_map(CUtensorMap* map, const void* base, int B, int L, int H,
               long long sb, long long sl, long long sh, int rows) {
  constexpr int SWE = hopper::SwTile<64, D>::SWE;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return TMAP_ERROR;
  // A dim of one index is never stepped over: give it a stride TMA takes.
  const cuuint64_t any = 2ull * D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {L > 1 ? 2ull * sl : any,
                                 H > 1 ? 2ull * sh : any,
                                 B > 1 ? 2ull * sb : any};
  const cuuint32_t box[4] = {(cuuint32_t)SWE, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      SWE == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (SWE == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TMAP_ERROR + (int)res;
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static hopper::SmemLimit limit;
  cudaError_t err = limit.raise((const void*)fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, B * p.H);
  fwd_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  using F = Bf16Fwd<D>;
  CUtensorMap tq, tk, tv;
  int err = tensor_map<D>(&tq, p.q, B, p.Lq, p.H, p.q_sb, p.q_sl, p.q_sh,
                          F::BQ);
  if (err == 0)
    err = tensor_map<D>(&tk, p.k, B, p.Lk, p.H, p.k_sb, p.k_sl, p.k_sh, BKV);
  if (err == 0)
    err = tensor_map<D>(&tv, p.v, B, p.Lk, p.H, p.v_sb, p.v_sl, p.v_sh, BKV);
  if (err != 0) return err;
  static hopper::SmemLimit limit;
  const cudaError_t raised =
      limit.raise((const void*)fwd_bf16_kernel<D>, F::SMEM);
  if (raised != cudaSuccess) return raised;
  const dim3 grid((p.Lq + F::BQ - 1) / F::BQ, B * p.H);
  fwd_bf16_kernel<D><<<grid, F::THREADS, F::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int D>
int launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(p, B, stream);
  if (dtype == 1) return launch_bf16<D>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t, or TMAP_ERROR (+ the
// encoder's CUresult) when a tensor map cannot be built; 0 means the kernel
// was launched.
extern "C" int ray_tpu_torch_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int device, int B, int H, int Lq, int Lk, int D, int dtype, int causal,
    float scale,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.scale = scale;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, dtype, s);
    case 32: return launch<32>(p, B, dtype, s);
    case 64: return launch<64>(p, B, dtype, s);
    case 128: return launch<128>(p, B, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
