// AdamW and each leaf's sum of squared gradients in one pass, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses optax.adamw and
// optax.global_norm into the jitted training step (ray_tpu/train/step.py).
// In eager PyTorch the same work ran as torch.optim.AdamW's foreach passes
// (mul, lerp, mul, addcmul, sqrt, div, add, addcdiv: eight passes, the sqrt
// one writing a full f32 copy of exp_avg_sq) after a separate square-and-sum
// of every gradient for the norm: about 92 bytes moved per parameter.
//
// What bounds it on an H100: memory. Per f32 parameter it reads p, g, m and
// v and writes p, m and v, 28 bytes, and does about 15 flops; at 3.35 TB/s
// a 2.46 B-parameter step cannot take less than 20.5 ms. So the kernel
// touches each byte once and keeps enough of them in flight:
// - One launch steps every leaf. The leaves come as a table (pointers,
//   length, each leaf's coefficients) in one __grid_constant__ parameter,
//   so nothing is copied to the card before the launch. Each leaf is cut
//   into chunks of kChunk elements; a leaf's chunks are numbered from its
//   chunk_begin, so a chunk never spans two leaves.
// - A persistent grid (as many blocks as fit on the card) walks the chunks
//   in a grid-stride loop; a block finds its chunk's leaf by a binary
//   search of the table.
// - Each thread keeps kUnroll independent float4s of each of the four
//   streams in flight (256 bytes a thread), with streaming loads and stores
//   (ld.global.cs / st.global.cs): nothing is read twice.
// - A leaf whose four pointers are not all 16-byte aligned takes a scalar
//   loop, as does the ragged tail (numel mod 4) of an aligned one. That
//   choice is made from the input alone, on the host, per leaf.
//
// The arithmetic is torch.optim.AdamW's (foreach, not capturable) in f32
// and in its order: p *= 1 - lr*wd; m = lerp(m, g, 1 - b1); v *= b2;
// v += (1 - b2) * g*g; denom = sqrt(v) / sqrt(1 - b2^t) + eps;
// p += -(lr / (1 - b1^t)) * m / denom. The host computes the coefficients in
// double from the leaf's step count and passes them rounded to f32, as
// torch passes its scalars. sqrt and division are IEEE (no fast math); the
// compiler may fuse a multiply and an add into one FMA where torch rounds
// between them, which moves a result by about one unit in the last place.
//
// The gradient norm: while a chunk reads g it sums g*g in f32 per thread,
// then over the block in a fixed order, and writes the sum to its own slot
// of an f32 scratch buffer (one slot a chunk). A second kernel, one block a
// leaf, adds its leaf's slots in double in a fixed order and writes the
// leaf's f32 sum. No atomics: the result does not depend on the schedule.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxLeaves = 40;  // leaves a launch takes; the wrapper splits
constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // float4s of each stream in flight a thread
constexpr int kChunk = 16384;   // elements; a multiple of kThreads*kUnroll*4

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long numel;
  int chunk_begin;  // first chunk of this leaf in the launch's numbering
  int out;          // slot of leaf_sums for this leaf's sum of g*g
  int vec;          // 1: p, g, m and v all start on a 16-byte boundary
  float decay;      // 1 - lr * weight_decay
  float w1;         // 1 - beta1, lerp's weight
  float b2;         // beta2
  float omb2;       // 1 - beta2
  float neg_step;   // -(lr / (1 - beta1^t))
  float bc2_sqrt;   // sqrt(1 - beta2^t)
  float eps;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
  int n_chunks;
  float* chunk_sums;  // [n_chunks]
  float* leaf_sums;   // indexed by Leaf::out
};

// The wrapper's ctypes mirror checks this size at load.
static_assert(sizeof(Leaf) == 80, "Leaf layout");
static_assert(sizeof(Table) == 3224, "Table layout");
static_assert(kChunk % (kThreads * kUnroll * 4) == 0, "chunk size");

// torch's lerp (ATen/native/Lerp.h), weight a scalar.
__device__ __forceinline__ float lerp(float self, float end, float w) {
  return fabsf(w) < 0.5f ? self + w * (end - self)
                         : end - (end - self) * (1.0f - w);
}

// One element; returns g*g for the norm.
__device__ __forceinline__ float adamw_element(float& p, float g, float& m,
                                               float& v, const Leaf& L) {
  p = __fmul_rn(p, L.decay);  // rounded, as torch's own pass stores it
  m = lerp(m, g, L.w1);
  const float gg = g * g;
  v = __fmul_rn(v, L.b2) + L.omb2 * gg;
  const float denom = sqrtf(v) / L.bc2_sqrt + L.eps;
  p = p + L.neg_step * (m / denom);
  return gg;
}

__device__ __forceinline__ float adamw4(float4& p, const float4& g, float4& m,
                                        float4& v, const Leaf& L) {
  float s = adamw_element(p.x, g.x, m.x, v.x, L);
  s += adamw_element(p.y, g.y, m.y, v.y, L);
  s += adamw_element(p.z, g.z, m.z, v.z, L);
  s += adamw_element(p.w, g.w, m.w, v.w, L);
  return s;
}

// Elements [begin, end) of leaf L, one at a time, strided over the block.
__device__ __forceinline__ float scalar_range(const Leaf& L, long long begin,
                                              long long end) {
  float sq = 0.0f;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    float p = __ldcs(L.p + i), m = __ldcs(L.m + i), v = __ldcs(L.v + i);
    sq += adamw_element(p, __ldcs(L.g + i), m, v, L);
    __stcs(L.p + i, p);
    __stcs(L.m + i, m);
    __stcs(L.v + i, v);
  }
  return sq;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's sum of x, in a fixed order, valid in thread 0. `slots` holds
// one value a warp; the block must call this together.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) slots[warp] = x;
  __syncthreads();
  T total = T(0);
  if (warp == 0) {
    total = lane < kThreads / 32 ? slots[lane] : T(0);
    total = warp_sum(total);
  }
  __syncthreads();  // slots may be written again by the next call
  return total;
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Table t) {
  __shared__ float slots[kThreads / 32];
  for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    // The leaf that holds chunk c: the last one whose chunk_begin <= c.
    int lo = 0, hi = t.n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.leaf[mid].chunk_begin <= c) lo = mid; else hi = mid - 1;
    }
    const Leaf& L = t.leaf[lo];
    const long long begin = static_cast<long long>(c - L.chunk_begin) * kChunk;
    const long long end = min(begin + kChunk, L.numel);
    float sq = 0.0f;
    if (L.vec) {
      // float4 index range of this chunk; the tail past the last whole
      // float4 goes through the scalar loop.
      const int n4 = static_cast<int>((end - begin) >> 2);
      float4* p4 = reinterpret_cast<float4*>(L.p + begin);
      const float4* g4 = reinterpret_cast<const float4*>(L.g + begin);
      float4* m4 = reinterpret_cast<float4*>(L.m + begin);
      float4* v4 = reinterpret_cast<float4*>(L.v + begin);
      for (int base = threadIdx.x; base < n4; base += kThreads * kUnroll) {
        float4 p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = base + u * kThreads;
          if (i < n4) {
            g[u] = __ldcs(g4 + i);
            p[u] = __ldcs(p4 + i);
            m[u] = __ldcs(m4 + i);
            v[u] = __ldcs(v4 + i);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = base + u * kThreads;
          if (i < n4) {
            sq += adamw4(p[u], g[u], m[u], v[u], L);
            __stcs(p4 + i, p[u]);
            __stcs(m4 + i, m[u]);
            __stcs(v4 + i, v[u]);
          }
        }
      }
      sq += scalar_range(L, begin + 4LL * n4, end);
    } else {
      sq += scalar_range(L, begin, end);
    }
    const float total = block_sum(sq, slots);
    if (threadIdx.x == 0) t.chunk_sums[c] = total;
  }
}

// One block a leaf: the sum of its chunks' slots, in double, in a fixed
// order.
__global__ void __launch_bounds__(kThreads)
leaf_sums_kernel(const __grid_constant__ Table t) {
  __shared__ double slots[kThreads / 32];
  const Leaf& L = t.leaf[blockIdx.x];
  const int next = static_cast<int>(blockIdx.x) + 1;
  const int end = next < t.n_leaves ? t.leaf[next].chunk_begin : t.n_chunks;
  double s = 0.0;
  for (int c = L.chunk_begin + threadIdx.x; c < end; c += kThreads)
    s += t.chunk_sums[c];
  const double total = block_sum(s, slots);
  if (threadIdx.x == 0) t.leaf_sums[L.out] = static_cast<float>(total);
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t; 0 means
// the kernels were launched.

// sizeof(Table), for the wrapper's check of its mirror of the layout.
extern "C" int ray_tpu_torch_adamw_table_bytes() {
  return static_cast<int>(sizeof(Table));
}

// Leaves a launch takes, and elements a chunk.
extern "C" int ray_tpu_torch_adamw_max_leaves() { return kMaxLeaves; }
extern "C" int ray_tpu_torch_adamw_chunk() { return kChunk; }

// Step every leaf of *table on `stream`, then write each leaf's sum of g*g
// to table->leaf_sums[out]. The table is copied into the launch.
extern "C" int ray_tpu_torch_adamw(const void* table, int device,
                                   void* stream) {
  const Table& t = *static_cast<const Table*>(table);
  if (t.n_leaves < 1 || t.n_leaves > kMaxLeaves || t.n_chunks < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // Blocks that fit on the card at once, asked once per device.
  static int resident[64] = {};
  int blocks = device >= 0 && device < 64 ? resident[device] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    blocks = sms * std::max(per_sm, 1);
    if (device >= 0 && device < 64) resident[device] = blocks;
  }
  const int grid = std::min(t.n_chunks, blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  adamw_kernel<<<grid, kThreads, 0, s>>>(t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  leaf_sums_kernel<<<t.n_leaves, kThreads, 0, s>>>(t);
  return cudaGetLastError();
}
