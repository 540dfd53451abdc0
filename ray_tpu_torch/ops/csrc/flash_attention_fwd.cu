// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd). Same function: causal (top-left, row >= col) or
// full attention over q [B, Lq, H, D] and k/v [B, Lk, H, D] with an online
// softmax, returning O in the input dtype and LSE = m + log(l) in f32 as
// [B, H, Lq]. Two kernels, chosen by the dtype alone:
// - fwd_bf16_kernel, bf16 inputs: every product on the tensor cores (wgmma);
// - fwd_kernel, f32 inputs: every product an f32 FMA, so f32 keeps IEEE f32
//   parity (2e-5) with the dense reference.
//
// What bounds it on an H100: at the serving shape (B=8, L=1024, H=16, D=64,
// bf16, causal) the data is ~67 MB (Q, K, V read once, O written once:
// ~20 us at 3.35 TB/s) and the causal work 17.2 GFLOP (~17 us at the 989
// TFLOP/s bf16 tensor-core rate), so the least time is set by the bytes, and
// the two are close. No kernel on the f32 FMA units (67 TFLOP/s) can come
// under 0.257 ms for that work, so the bf16 kernel puts both dots on the
// tensor cores and overlaps its loads with them.
//
// bf16 design (FlashAttention-3's shape, kept simple).
// - One block of one warpgroup (128 threads) per (b*h, 64-row Q tile), Q
//   tiles issued last-first so the longest causal rows start first; the
//   block loops over 64-row K/V tiles up to the causal diagonal, skipping
//   the tiles _fwd_kernel skips (ik*BK >= (iq+1)*BQ). The TPU carried m, l
//   and the accumulator in VMEM across sequential grid steps; here they
//   live in registers.
// - Q, K and V stay bf16 in shared memory in wgmma's swizzled layout
//   (hopper.cuh), loaded with 16-byte cp.async copies in two stages, so K/V
//   tile j+1 arrives while tile j is computed; rows past L are zero-filled
//   by the copy, which gives the zeroed pad rows of _fwd_kernel:64-69.
// - S = Q K^T: wgmma m64n64k16, A = Q and B = K from shared memory, both
//   K-major, D/16 k-steps, f32 accumulators.
// - Online softmax on the accumulator fragment: each row lives in 4 lanes,
//   so row max is two shuffles; row sums stay per thread until the end. The
//   mask is applied only on tiles that cross the diagonal or the ragged
//   edge, with the TPU's semantics: masked scores -1e30 with probability
//   exactly 0, m starting at -1e30, l clamped at 1e-30 before the division
//   and the log.
// - O += P V: P rounded to bf16 in registers is wgmma's A operand straight
//   from the accumulator fragment (no shared-memory round trip); B = V from
//   shared memory, MN-major, N = D.
// - Precision: QK^T from bf16 operands accumulates exactly what the TPU's
//   f32 upcast computes (a bf16 x bf16 product is exact in f32). Only P is
//   rounded, to bf16 (2^-9 relative) before PV; the tolerance is unchanged.
// - f32 inputs: the FMA kernel below, 256 threads as a 16 x 16 grid over a
//   64 x 64 score tile, f32 tiles in shared memory.
// - The kernels allocate nothing: the caller passes O and LSE. They launch
//   on the caller's stream and the entry point returns cudaGetLastError().

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // Q rows per block
constexpr int BK = 64;        // K/V rows per inner tile
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
  using QTile = hopper::SwTile<BQ, D>;
  using KTile = hopper::SwTile<BK, D>;
  // Q, then two stages of (K, V); 1024 bytes of slack to align the base.
  static constexpr size_t SMEM = 1024 + QTile::BYTES + 2 * 2 * KTile::BYTES;
};

template <int D>
__global__ void __launch_bounds__(hopper::WG_THREADS)
    fwd_bf16_kernel(Params p) {
  using namespace hopper;
  using QT = typename Bf16Fwd<D>::QTile;
  using KT = typename Bf16Fwd<D>::KTile;
  constexpr int NS = BK / 2;  // score accumulators a thread
  constexpr int NO = D / 2;   // output accumulators a thread
  static_assert(NS <= 32, "mask bits fit one word");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + QT::BYTES;  // stage s: K, then V
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
  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  int nk = (p.Lk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ + BK - 1) / BK);

  load_tile<BQ, D>(q_s, qp, p.q_sl, q0, p.Lq, tid);
  load_tile<BK, D>(kv_s, kp, p.k_sl, 0, p.Lk, tid);
  load_tile<BK, D>(kv_s + KT::BYTES, vp, p.v_sl, 0, p.Lk, tid);
  cp_async_commit();

  // This thread's rows: row_a for accumulators with (i & 2) == 0, else +8.
  const int row_a = q0 + warp * 16 + lane / 4;
  float o[NO], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    const uint32_t k_s = kv_s + (j & 1) * STAGE;
    const uint32_t v_s = k_s + KT::BYTES;
    if (j + 1 < nk) {  // tile j + 1 into the other stage, freed at j - 1
      const uint32_t next = kv_s + ((j + 1) & 1) * STAGE;
      load_tile<BK, D>(next, kp, p.k_sl, k0 + BK, p.Lk, tid);
      load_tile<BK, D>(next + KT::BYTES, vp, p.v_sl, k0 + BK, p.Lk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile j (and Q) landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(s, QT::kmajor(q_s, kk), KT::kmajor(k_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Mask (only where the tile crosses the diagonal or the ragged edge),
    // online-softmax update.
    const bool need_mask = k0 + BK > p.Lk || (p.causal && k0 + BK - 1 > q0);
    uint32_t ok_bits = 0xffffffffu;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      if (need_mask) {
        const int row = row_a + 8 * r;
        const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool ok = col < p.Lk && (!p.causal || row >= col);
        if (!ok) ok_bits &= ~(1u << i);
        s[i] = ok ? s[i] * p.scale : NEG_INF;
      } else {
        s[i] *= p.scale;
      }
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float mb[2], corr[2];
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
      const float pv = exp2f(fmaf(s[i], LOG2E, -mb[r]));
      s[i] = (ok_bits >> i) & 1u ? pv : 0.f;
      l[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V, P as bf16 A fragments in registers.
    uint32_t pa[BK / 16][4];
    to_a_fragments<BK>(s, pa);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], KT::mnmajor(v_s, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // every thread is done with this stage
  }
  cp_async_wait<0>();

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
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Bf16Fwd<D>::SMEM;
  static hopper::SmemLimit limit;
  cudaError_t err = limit.raise((const void*)fwd_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, B * p.H);
  fwd_bf16_kernel<D><<<grid, hopper::WG_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<D>(p, B, stream);
    case 1: return launch_bf16<D>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t; 0 means the kernel was launched.
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
