// Flash-attention backward for Hopper (sm_90a), CUDA C++: dQ, and dK with dV.
//
// Replaces the two Pallas TPU kernels that ray_tpu/ops/flash_attention.py's
// _flash_bwd launches: _dq_kernel (dq_bf16_kernel for bf16 inputs, dq_kernel
// for f32) and _dkv_kernel (dkv_bf16_kernel for bf16, dkv_kernel for f32);
// the dtype alone chooses. Same function: from q [B, Lq, H, D], k/v
// [B, Lk, H, D], the output gradient dO [B, Lq, H, D], and the f32 rows LSE
// and Delta = rowsum(dO * O), both [B, H, Lq] and both computed before the
// launch, each kernel recomputes S = scale * Q K^T and P = exp(S - LSE)
// under the forward's mask (top-left causal, row >= col; pad columns
// masked), then
//   dP = dO V^T,   dS = P * (dP - Delta) * scale,
//   dQ = dS K                        (dq_bf16_kernel, dq_kernel),
//   dV = P^T dO,   dK = dS^T Q       (dkv_bf16_kernel, dkv_kernel).
//
// What bounds them on an H100: at the training shape (B=8, L=1024, H=16,
// D=64, bf16, causal: 524,800 kept (row, col) pairs a head) dq does three
// dots, 25.8 GFLOP (26 us at the 989 TFLOP/s bf16 tensor-core rate), and
// moves ~85 MB (25 us at 3.35 TB/s); dkv does four dots, 34.4 GFLOP (35 us),
// and moves ~102 MB (30 us). Both are bound by operations, and no kernel on
// the f32 FMA units (67 TFLOP/s) can do dq's work in under 0.385 ms or
// dkv's in under 0.513 ms, so for bf16 every dot of both runs on the tensor
// cores (wgmma) and the loads overlap the products.
//
// dq_bf16_kernel (bf16, tensor cores): the forward's loop, with dO beside Q
// and dS in P's place.
// - One block of one warpgroup (128 threads) per (b*h, 64-row Q tile), Q
//   tiles launched last-first so the longest causal rows start first. Q and
//   dO are loaded once; each thread reads the LSE and Delta of its two
//   accumulator rows into registers once, never past Lq.
// - K and V stream in through 16-byte cp.async copies in two stages, so
//   tile j+1 arrives while tile j is computed; rows past Lk are zero-filled
//   by the copy. The loop stops at the causal diagonal (ik*BK < (iq+1)*BQ,
//   the TPU's `run`).
// - S = Q K^T and dP = dO V^T: wgmma m64nBKk16, A = Q or dO and B = K or V
//   from shared memory, both K-major, in one commit group.
// - P and dS in registers from the accumulator fragments, masked by select
//   as _dq_kernel masks them, only on tiles that cross the diagonal or a
//   ragged edge; dS rounded to bf16.
// - dQ += dS K: wgmma m64nDk16 with A = dS from registers and B = K from
//   shared memory, MN-major: the copy of K that S read K-major.
// - Registers: dQ takes D/2 f32 registers a thread (64 at D = 128), so the
//   K/V tile is 32 rows at D = 128 (64 below), which keeps S and dP at 16
//   registers each there and ptxas free of spills.
// - Precision: S and dP from bf16 operands accumulate in f32 exactly what
//   the TPU's f32 upcast computes; only dS is rounded to bf16 before dS K,
//   by at most 2^-9 relative (the TPU keeps it in f32).
//
// dkv_bf16_kernel (bf16, tensor cores).
// - One block of one warpgroup (128 threads) per (b*h, 64-row K tile). K
//   and V are loaded once; the loop over Q tiles starts at the first tile
//   the causal rule lets through (iq0 = k0 / BQ), so a K tile no query
//   reaches (causal, Lk > Lq) runs no iteration and stores exact zeros.
// - Q, dO and the LSE and Delta rows of each Q tile stream in through
//   16-byte (and 4-byte) cp.async copies in two stages, so tile i+1 arrives
//   while tile i is computed. Tiles stay bf16 in shared memory in wgmma's
//   swizzled layout (hopper.cuh); rows past Lq are zero-filled by the copy
//   and LSE and Delta are never read past Lq.
// - S^T = K Q^T and dP^T = V dO^T: wgmma m64nBQk16, A = K or V and B = Q or
//   dO from shared memory, both K-major.
// - P^T and dS^T in registers from the accumulator fragments, masked by
//   select as _dkv_kernel masks them (pad Q rows included), only on tiles
//   that cross the diagonal or a ragged edge; both rounded to bf16.
// - dV += P^T dO and dK += dS^T Q: wgmma with A from registers (the
//   accumulator fragment of the previous product is the A fragment of the
//   next) and B = dO or Q from shared memory, MN-major: the same shared
//   copy serves both reads. N = D.
// - Registers: dK and dV take D/2 f32 registers each a thread (64 + 64 at
//   D = 128), so the Q tile is 32 rows at D = 128 (64 below), which keeps
//   S^T and dP^T at 16 registers each and ptxas free of spills.
// - Precision: S^T and dP^T from bf16 operands accumulate in f32 exactly
//   what the TPU's f32 upcast computes; only P^T (before P^T dO) and dS^T
//   (before dS^T Q) are rounded to bf16, each by at most 2^-9 relative.
//
// dq_kernel and dkv_kernel (f32 inputs), every product an f32 FMA so that
// f32 gradients keep the reference's 2e-4 tolerance.
// - dq_kernel: one block per (b*h, 64-row Q tile), as the bf16 kernel, with
//   64-row K/V tiles.
// - dkv_kernel: one block per (b*h, 64-row K tile), as the bf16 kernel.
// - 256 threads as a 16 x 16 grid: thread (ty, tx) owns rows ty*4 .. ty*4+3
//   of its block's tile and score columns tx + 16*j (j < 4) of the other
//   tile; P or dS goes through shared memory once for the last dot(s).
// - Tiles are f32 in shared memory; row strides are padded by one word
//   against bank conflicts. Pad K/V rows of a last K tile and pad Q and dO
//   rows of a last Q tile load as 0, their LSE and Delta as 0, and the mask
//   drops their scores with a select.
//
// Two kernels, as on the TPU, so that neither needs atomics and both are
// deterministic. The TPU carried dQ (and dK, dV) in VMEM scratch across
// sequential grid steps; Hopper blocks run in no order, so each block owns
// one output tile and loops over the other operand's tiles itself, with
// the sums in registers. The kernels allocate nothing: the caller passes
// every output. They launch on the caller's stream and each entry point
// returns cudaGetLastError().

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // Q rows per tile
constexpr int BK = 64;        // K/V rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TM = 4;         // tile rows per thread
constexpr int TN = 4;         // score columns per thread

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // dO
  const float* lse;    // [B, H, Lq]
  const float* delta;  // [B, H, Lq]
  void* dq;
  void* dk;
  void* dv;
  int H, Lq, Lk, causal;
  float scale;
  // Element strides of the batch, sequence and head dims; D is contiguous.
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long do_sb, do_sl, do_sh;
  long long dq_sb, dq_sl, dq_sh;
  long long dk_sb, dk_sl, dk_sh;
  long long dv_sb, dv_sl, dv_sh;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  // q_s, do_s [BQ][D+1]; k_s, v_s [BK][D+1]; ds_s [BQ][BK+1]; all f32.
  return sizeof(float) *
         (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k_s, v_s [BK][D+1]; q_s, do_s [BQ][D+1]; p_s, ds_s [BK][BQ+1];
  // lse_s, delta_s [BQ]; all f32.
  return sizeof(float) * (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * BK * (BQ + 1) + 2 * BQ);
}

// dQ for one (b*h, 64-row Q tile), f32 inputs.
template <int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  using T = float;
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int QS = D + 1;   // padded row stride of the Q, dO, K, V tiles
  constexpr int PS = BK + 1;  // padded row stride of ds_s
  constexpr int TD = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * QS;
  float* k_s = do_s + BQ * QS;
  float* v_s = k_s + BK * QS;
  float* ds_s = v_s + BK * QS;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = iq * BQ;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const float* lsep = p.lse + (long long)bh * p.Lq;
  const float* deltap = p.delta + (long long)bh * p.Lq;

  // Q and dO tiles; rows past Lq load as 0 and are never stored.
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    const bool ok = row < p.Lq;
    q_s[r * QS + c] = ok ? qp[row * p.q_sl + c] : 0.f;
    do_s[r * QS + c] = ok ? dop[row * p.do_sl + c] : 0.f;
  }

  float lse[TM], delta[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    lse[i] = row < p.Lq ? lsep[row] : 0.f;
    delta[i] = row < p.Lq ? deltap[row] : 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  int nk = (p.Lk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the previous tile's readers are done with k_s/v_s/ds_s
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int col = k0 + r;
      const bool ok = col < p.Lk;
      k_s[r * QS + c] = ok ? kp[col * p.k_sl + c] : 0.f;
      v_s[r * QS + c] = ok ? vp[col * p.v_sl + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's 4 x 4 scores.
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TM], dov[TM], kv[TN], vv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        qv[i] = q_s[(ty * TM + i) * QS + d];
        dov[i] = do_s[(ty * TM + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        kv[j] = k_s[(tx + 16 * j) * QS + d];
        vv[j] = v_s[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

    // P = exp(S - LSE) and dS = P (dP - Delta) scale under the mask.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < p.Lk && (!p.causal || row >= col);
        const float pv = ok ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        ds_s[(ty * TM + i) * PS + tx + 16 * j] =
            ok ? pv * (dp[i][j] - delta[i]) * p.scale : 0.f;
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[TM], kv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsv[i] = ds_s[(ty * TM + i) * PS + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) kv[j] = k_s[c * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row >= p.Lq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j)
      dqp[row * p.dq_sl + tx + 16 * j] = acc[i][j];
  }
}

// dK and dV for one (b*h, 64-row K tile), f32 inputs.
template <int D>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Params p) {
  using T = float;
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int QS = D + 1;   // padded row stride of the K, V, Q, dO tiles
  constexpr int PS = BQ + 1;  // padded row stride of p_s and ds_s
  constexpr int TD = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * QS;
  float* q_s = v_s + BK * QS;
  float* do_s = q_s + BQ * QS;
  float* p_s = do_s + BQ * QS;   // P^T  [BK][BQ+1]
  float* ds_s = p_s + BK * PS;   // dS^T [BK][BQ+1]
  float* lse_s = ds_s + BK * PS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int ik = blockIdx.x;  // low K tiles see the most Q tiles: start first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = ik * BK;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const float* lsep = p.lse + (long long)bh * p.Lq;
  const float* deltap = p.delta + (long long)bh * p.Lq;

  // K and V tiles; rows past Lk load as 0 and are never stored.
  for (int i = tid; i < BK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int col = k0 + r;
    const bool ok = col < p.Lk;
    k_s[r * QS + c] = ok ? kp[col * p.k_sl + c] : 0.f;
    v_s[r * QS + c] = ok ? vp[col * p.v_sl + c] : 0.f;
  }

  float dk[TM][TD], dv[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (p.Lq + BQ - 1) / BQ;
  // Causal: Q tile iq reaches this K tile iff k0 < (iq+1)*BQ.
  const int iq0 = p.causal ? k0 / BQ : 0;

  for (int iq = iq0; iq < nq; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();  // the previous tile's readers are done with the tiles
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int row = q0 + r;
      const bool ok = row < p.Lq;
      q_s[r * QS + c] = ok ? qp[row * p.q_sl + c] : 0.f;
      do_s[r * QS + c] = ok ? dop[row * p.do_sl + c] : 0.f;
    }
    if (tid < BQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < p.Lq ? lsep[row] : 0.f;
      delta_s[tid] = row < p.Lq ? deltap[row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this thread's 4 x 4 scores.
    float st[TM][TN], dpt[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[TM], vv[TM], qv[TN], dov[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        kv[i] = k_s[(ty * TM + i) * QS + d];
        vv[i] = v_s[(ty * TM + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        qv[j] = q_s[(tx + 16 * j) * QS + d];
        dov[j] = do_s[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(dov[j], vv[i], dpt[i][j]);
        }
    }

    // P^T and dS^T under the mask; pad Q rows (row >= Lq) are masked too.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int col = k0 + ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = tx + 16 * j;
        const int row = q0 + r;
        const bool ok = col < p.Lk && row < p.Lq && (!p.causal || row >= col);
        const float pv = ok ? expf(st[i][j] * p.scale - lse_s[r]) : 0.f;
        p_s[(ty * TM + i) * PS + r] = pv;
        ds_s[(ty * TM + i) * PS + r] =
            ok ? pv * (dpt[i][j] - delta_s[r]) * p.scale : 0.f;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pv[TM], dsv[TM], dov[TD], qv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pv[i] = p_s[(ty * TM + i) * PS + c];
        dsv[i] = ds_s[(ty * TM + i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        dov[j] = do_s[c * QS + tx + 16 * j];
        qv[j] = q_s[c * QS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) {
          dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int col = k0 + ty * TM + i;
    if (col >= p.Lk) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      dkp[col * p.dk_sl + tx + 16 * j] = dk[i][j];
      dvp[col * p.dv_sl + tx + 16 * j] = dv[i][j];
    }
  }
}

// dQ for bf16 inputs on the tensor cores (design in the header).
template <int D>
struct Bf16Dq {
  // 64 Q rows (one warpgroup); K/V tiles of 64 rows, 32 at D = 128 so that
  // dQ (64 f32 registers there) leaves room for S and dP.
  static constexpr int BK = D == 128 ? 32 : 64;
  using QTile = hopper::SwTile<BQ, D>;
  using KTile = hopper::SwTile<BK, D>;
  // Q, dO, then two stages of (K, V); 1024 bytes of slack to align the base.
  static constexpr size_t SMEM = 1024 + 2 * QTile::BYTES + 2 * 2 * KTile::BYTES;
};

template <int D>
__global__ void __launch_bounds__(hopper::WG_THREADS)
    dq_bf16_kernel(Params p) {
  using namespace hopper;
  using QT = typename Bf16Dq<D>::QTile;
  using KT = typename Bf16Dq<D>::KTile;
  constexpr int BK2 = Bf16Dq<D>::BK;  // K/V rows per tile
  constexpr int NS = BK2 / 2;  // S (and dP) accumulators a thread
  constexpr int NO = D / 2;    // dQ accumulators a thread
  constexpr float LOG2E = 1.4426950408889634f;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + QT::BYTES;
  const uint32_t kv_s = do_s + QT::BYTES;  // stage s: K, then V
  constexpr uint32_t STAGE = 2 * KT::BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = iq * BQ;

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dop =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  __nv_bfloat16* dqp =
      static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const float* lsep = p.lse + (long long)bh * p.Lq;
  const float* deltap = p.delta + (long long)bh * p.Lq;

  int nk = (p.Lk + BK2 - 1) / BK2;
  if (p.causal) nk = min(nk, (q0 + BQ + BK2 - 1) / BK2);

  load_tile<BQ, D>(q_s, qp, p.q_sl, q0, p.Lq, tid);
  load_tile<BQ, D>(do_s, dop, p.do_sl, q0, p.Lq, tid);
  load_tile<BK2, D>(kv_s, kp, p.k_sl, 0, p.Lk, tid);
  load_tile<BK2, D>(kv_s + KT::BYTES, vp, p.v_sl, 0, p.Lk, tid);
  cp_async_commit();

  // This thread's rows: row_a for accumulators with (i & 2) == 0, else +8;
  // their LSE (pre-scaled by log2 e) and Delta, 0 past Lq.
  const int row_a = q0 + warp * 16 + lane / 4;
  const float scale2 = p.scale * LOG2E;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < p.Lq ? lsep[row] * LOG2E : 0.f;
    delta[r] = row < p.Lq ? deltap[row] : 0.f;
  }
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK2;
    const uint32_t k_s = kv_s + (j & 1) * STAGE;
    const uint32_t v_s = k_s + KT::BYTES;
    if (j + 1 < nk) {  // tile j + 1 into the other stage, freed at j - 1
      const uint32_t next = kv_s + ((j + 1) & 1) * STAGE;
      load_tile<BK2, D>(next, kp, p.k_sl, k0 + BK2, p.Lk, tid);
      load_tile<BK2, D>(next + KT::BYTES, vp, p.v_sl, k0 + BK2, p.Lk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile j (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T
    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK2>(s, QT::kmajor(q_s, kk), KT::kmajor(k_s, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK2>(dp, QT::kmajor(do_s, kk), KT::kmajor(v_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(scale S - LSE), dS = P (dP - Delta) scale into s, masked by
    // select where the tile crosses the diagonal or the ragged edge.
    const bool need_mask = k0 + BK2 > p.Lk || (p.causal && k0 + BK2 - 1 > q0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const float pv = exp2f(fmaf(s[i], scale2, -lse2[r]));
      const float ds = pv * (dp[i] - delta[r]) * p.scale;
      bool ok = true;
      if (need_mask) {
        const int row = row_a + 8 * r;
        const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        ok = col < p.Lk && (!p.causal || row >= col);
      }
      s[i] = ok ? ds : 0.f;
    }

    // dQ += dS K, dS bf16 in registers, K read MN-major.
    uint32_t dsa[BK2 / 16][4];
    to_a_fragments<BK2>(s, dsa);
    fence_regs(dq);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK2 / 16; ++kk)
      wgmma_rs<D>(dq, dsa[kk], KT::mnmajor(k_s, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    __syncthreads();  // every thread is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int row = row_a + 8 * ((i >> 1) & 1);
    if (row >= p.Lq) continue;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(dqp + row * p.dq_sl + col) =
        __floats2bfloat162_rn(dq[i], dq[i + 1]);
  }
}

// dK and dV for bf16 inputs on the tensor cores (design in the header).
template <int D>
struct Bf16Dkv {
  // 64 K rows (one warpgroup); Q tiles of 64 rows, 32 at D = 128 so that
  // dK and dV (64 f32 registers each there) leave room for S^T and dP^T.
  static constexpr int BQ = D == 128 ? 32 : 64;
  using KTile = hopper::SwTile<BK, D>;
  using QTile = hopper::SwTile<BQ, D>;
  // One stage: Q, dO, then LSE and Delta rows (f32), rounded up to 1024.
  static constexpr int STAGE = (2 * QTile::BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  // K, V, two stages; 1024 bytes of slack to align the base.
  static constexpr size_t SMEM = 1024 + 2 * KTile::BYTES + 2 * STAGE;
};

template <int D>
__global__ void __launch_bounds__(hopper::WG_THREADS)
    dkv_bf16_kernel(Params p) {
  using namespace hopper;
  using KT = typename Bf16Dkv<D>::KTile;
  using QT = typename Bf16Dkv<D>::QTile;
  constexpr int BQ2 = Bf16Dkv<D>::BQ;  // Q rows per tile
  constexpr int STAGE = Bf16Dkv<D>::STAGE;
  constexpr int NS = BQ2 / 2;  // S^T (and dP^T) accumulators a thread
  constexpr int NO = D / 2;    // dK (and dV) accumulators a thread
  constexpr float LOG2E = 1.4426950408889634f;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + KT::BYTES;
  const uint32_t st_s = v_s + KT::BYTES;  // stage s: Q, dO, LSE, Delta
  const float* st_f = reinterpret_cast<const float*>(
      smem_raw + (st_s - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ik = blockIdx.x;  // low K tiles see the most Q tiles: start first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = ik * BK;

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dop =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  __nv_bfloat16* dkp =
      static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvp =
      static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const float* lsep = p.lse + (long long)bh * p.Lq;
  const float* deltap = p.delta + (long long)bh * p.Lq;

  // Stage s of Q tile iq: Q, dO, then LSE and Delta; rows past Lq are zeros.
  auto load_stage = [&](int s, int iq) {
    const uint32_t base = st_s + s * STAGE;
    const int q0 = iq * BQ2;
    load_tile<BQ2, D>(base, qp, p.q_sl, q0, p.Lq, tid);
    load_tile<BQ2, D>(base + QT::BYTES, dop, p.do_sl, q0, p.Lq, tid);
    if (tid < 2 * BQ2) {
      const int r = tid % BQ2;
      const bool ok = q0 + r < p.Lq;
      const float* src = tid < BQ2 ? lsep : deltap;
      cp_async4(base + 2 * QT::BYTES + 4 * tid, ok ? src + q0 + r : src, ok);
    }
  };

  const int nq = (p.Lq + BQ2 - 1) / BQ2;
  // Causal: Q tile iq reaches this K tile iff k0 < (iq+1)*BQ.
  const int iq0 = p.causal ? k0 / BQ2 : 0;
  load_tile<BK, D>(k_s, kp, p.k_sl, k0, p.Lk, tid);
  load_tile<BK, D>(v_s, vp, p.v_sl, k0, p.Lk, tid);
  if (iq0 < nq) load_stage(0, iq0);
  cp_async_commit();

  // This thread's K rows: krow_a for accumulators with (i & 2) == 0, else +8.
  const int krow_a = k0 + warp * 16 + lane / 4;
  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;

  for (int iq = iq0; iq < nq; ++iq) {
    const int j = iq - iq0;
    const int q0 = iq * BQ2;
    const uint32_t q_s = st_s + (j & 1) * STAGE;
    const uint32_t do_s = q_s + QT::BYTES;
    const float* lse_s = st_f + (j & 1) * (STAGE / 4) + 2 * QT::BYTES / 4;
    const float* delta_s = lse_s + BQ2;
    if (iq + 1 < nq) load_stage((j + 1) & 1, iq + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T
    float st[NS], dpt[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ2>(st, KT::kmajor(k_s, kk), QT::kmajor(q_s, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ2>(dpt, KT::kmajor(v_s, kk), QT::kmajor(do_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(scale S^T - LSE), dS^T = P^T (dP^T - Delta) scale, masked
    // by select (pad Q rows too) where the tile needs it.
    const bool need_mask = q0 + BQ2 > p.Lq || k0 + BK > p.Lk ||
                           (p.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);  // Q row in tile
      const float pv = exp2f((st[i] * p.scale - lse_s[c]) * LOG2E);
      const float ds = pv * (dpt[i] - delta_s[c]) * p.scale;
      bool ok = true;
      if (need_mask) {
        const int krow = krow_a + 8 * ((i >> 1) & 1);
        const int qrow = q0 + c;
        ok = krow < p.Lk && qrow < p.Lq && (!p.causal || qrow >= krow);
      }
      st[i] = ok ? pv : 0.f;
      dpt[i] = ok ? ds : 0.f;
    }

    // dV += P^T dO and dK += dS^T Q, A operands bf16 in registers.
    uint32_t pa[BQ2 / 16][4], dsa[BQ2 / 16][4];
    to_a_fragments<BQ2>(st, pa);
    to_a_fragments<BQ2>(dpt, dsa);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], QT::mnmajor(do_s, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk)
      wgmma_rs<D>(dk, dsa[kk], QT::mnmajor(q_s, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // every thread is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int krow = krow_a + 8 * ((i >> 1) & 1);
    if (krow >= p.Lk) continue;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(dkp + krow * p.dk_sl + col) =
        __floats2bfloat162_rn(dk[i], dk[i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dvp + krow * p.dv_sl + col) =
        __floats2bfloat162_rn(dv[i], dv[i + 1]);
  }
}

template <int D>
cudaError_t launch_dq_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static hopper::SmemLimit limit;
  cudaError_t err = limit.raise((const void*)dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, B * p.H);
  dq_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Bf16Dq<D>::SMEM;
  static hopper::SmemLimit limit;
  cudaError_t err = limit.raise((const void*)dq_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, B * p.H);
  dq_bf16_kernel<D><<<grid, hopper::WG_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static hopper::SmemLimit limit;
  cudaError_t err = limit.raise((const void*)dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + BK - 1) / BK, B * p.H);
  dkv_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Bf16Dkv<D>::SMEM;
  static hopper::SmemLimit limit;
  cudaError_t err = limit.raise((const void*)dkv_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + BK - 1) / BK, B * p.H);
  dkv_bf16_kernel<D><<<grid, hopper::WG_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// which: 0 = dq (f32: dq_kernel, bf16: dq_bf16_kernel), 1 = dkv (f32:
// dkv_kernel, bf16: dkv_bf16_kernel).
template <int D>
cudaError_t launch(const Params& p, int B, int dtype, int which,
                   cudaStream_t stream) {
  switch (2 * dtype + which) {
    case 0: return launch_dq_f32<D>(p, B, stream);
    case 1: return launch_dkv_f32<D>(p, B, stream);
    case 2: return launch_dq_bf16<D>(p, B, stream);
    case 3: return launch_dkv_bf16<D>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Params& p, int device, int B, int D, int dtype, int which,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, dtype, which, s);
    case 32: return launch<32>(p, B, dtype, which, s);
    case 64: return launch<64>(p, B, dtype, which, s);
    case 128: return launch<128>(p, B, dtype, which, s);
    default: return cudaErrorInvalidValue;
  }
}

Params common(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, int H, int Lq, int Lk,
              int causal, float scale, long long q_sb, long long q_sl,
              long long q_sh, long long k_sb, long long k_sl, long long k_sh,
              long long v_sb, long long v_sl, long long v_sh,
              long long do_sb, long long do_sl, long long do_sh) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.scale = scale;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_sl = do_sl; p.do_sh = do_sh;
  return p;
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each returns a cudaError_t; 0 means the kernel was launched.

// dQ [B, Lq, H, D] in q's dtype.
extern "C" int ray_tpu_torch_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int device, int B, int H, int Lq, int Lk, int D, int dtype, int causal,
    float scale,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long do_sb, long long do_sl, long long do_sh,
    long long dq_sb, long long dq_sl, long long dq_sh,
    void* stream) {
  Params p = common(q, k, v, dout, lse, delta, H, Lq, Lk, causal, scale,
                    q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                    do_sb, do_sl, do_sh);
  p.dq = dq;
  p.dq_sb = dq_sb; p.dq_sl = dq_sl; p.dq_sh = dq_sh;
  return run(p, device, B, D, dtype, 0, stream);
}

// dK and dV [B, Lk, H, D] in k's (= v's) dtype.
extern "C" int ray_tpu_torch_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int device, int B, int H, int Lq, int Lk, int D, int dtype, int causal,
    float scale,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long do_sb, long long do_sl, long long do_sh,
    long long dk_sb, long long dk_sl, long long dk_sh,
    long long dv_sb, long long dv_sl, long long dv_sh,
    void* stream) {
  Params p = common(q, k, v, dout, lse, delta, H, Lq, Lk, causal, scale,
                    q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                    do_sb, do_sl, do_sh);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = dk_sb; p.dk_sl = dk_sl; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_sl = dv_sl; p.dv_sh = dv_sh;
  return run(p, device, B, D, dtype, 1, stream);
}
