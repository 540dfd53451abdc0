// Hopper (sm_90a) building blocks for the bf16 tensor-core attention
// kernels: 16-byte cp.async copies into 128/64/32-byte swizzled shared
// tiles, TMA tile loads into the same tiles with mbarrier completion,
// named barriers and register reallocation for warp-specialised kernels,
// wgmma shared-memory descriptors for those tiles, and warpgroup matrix
// multiplies m64nNk16 (bf16 inputs, f32 accumulators) with A read from
// shared memory or from registers.
//
// Register layouts (PTX ISA, "wgmma register fragments"). In a warpgroup of
// 128 threads, warp w = tid / 32 owns accumulator rows 16w .. 16w + 15; lane
// l holds, for each 8-column chunk j < N / 8, the four values
//   d[4j + 0], d[4j + 1]  at row 16w + l/4,     columns 8j + 2(l%4) + {0, 1}
//   d[4j + 2], d[4j + 3]  at row 16w + l/4 + 8, the same columns.
// The A fragment of an m64nNk16 product from registers is four b32 words of
// bf16 pairs: a0 = (row l/4, k 2(l%4) + {0,1}), a1 = (row l/4 + 8, same k),
// a2 = (row l/4, k 8 + 2(l%4) + {0,1}), a3 = (row l/4 + 8, same k). So the
// accumulator values d[8s .. 8s + 7] of one product, rounded pairwise to
// bf16, are exactly the A fragment of k-slice s of the next product
// (to_a_fragments below): P or dS never leaves registers.
//
// Shared tiles. A [R][D] bf16 tile is stored as D / SWE column blocks of
// [R][SWE] elements, SWE = min(D, 64), each row SWE * 2 bytes (128, 64 or
// 32) with the matching swizzle: 16-byte chunk c of row r sits at chunk
// c ^ ((r >> (7 - log2(row bytes))) & (chunks a row - 1)), i.e. address
// bits [4, 4 + b) are XORed with bits [7, 7 + b). wgmma reads such a tile
// either K-major (rows are M or N, D is the reduced dimension) or MN-major
// (rows are the reduced dimension, D is N), so one copy of Q, K, V or dO in
// shared memory feeds both kinds of product. Every tile starts on a
// 1024-byte boundary, as the swizzle patterns assume. A TMA load with
// CU_TENSOR_MAP_SWIZZLE_{128,64,32}B and a box of [R][SWE] elements writes
// one column block in exactly this layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

constexpr int WG_THREADS = 128;  // one warpgroup

// Raises a kernel's dynamic shared-memory limit once per device: each
// launcher keeps one as a static, so the attribute is set at the first
// launch on a device and not again.
struct SmemLimit {
  std::atomic<uint64_t> done{0};  // bit d: set on device d
  cudaError_t raise(const void* kernel, size_t bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = 1ull << (dev & 63);
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return err;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; copies zeros when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte asynchronous copy global -> shared; zeros when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy. Each thread fences after its copies landed and
// before the barrier that precedes the wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all in 16-byte units) and the swizzle mode in bits 62-63
// (1 = 128-byte, 2 = 64-byte, 3 = 32-byte).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// A [R][D] bf16 tile in shared memory (layout in the header comment).
template <int R, int D>
struct SwTile {
  static_assert(D % 16 == 0 && (D <= 64 || D % 64 == 0), "head dim");
  static constexpr int SWE = D < 64 ? D : 64;  // elements in a swizzled row
  static constexpr int SWB = 2 * SWE;          // its bytes: 32, 64 or 128
  static constexpr int CPR = SWE / 8;          // 16-byte chunks in it
  static constexpr int BLOCK = R * SWB;        // bytes of one column block
  static constexpr int BYTES = (D / SWE) * BLOCK;
  static constexpr uint64_t MODE = SWB == 128 ? 1 : (SWB == 64 ? 2 : 3);
  static_assert(BLOCK % 1024 == 0, "tile blocks must keep 1024-byte alignment");

  // Byte offset of 16-byte chunk c (c < D / 8) of row r.
  __device__ static __forceinline__ uint32_t chunk(int r, int c) {
    const uint32_t off = r * SWB + (c % CPR) * 16;
    return (c / CPR) * BLOCK + (off ^ (((off >> 7) & (CPR - 1)) << 4));
  }
  // Descriptor of k-slice kk (columns 16kk .. 16kk + 15), read K-major:
  // 8-row groups SWB * 8 bytes apart; a k-slice is 32 bytes into its row.
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    return make_desc(base + (kk * 16 / SWE) * BLOCK + (kk * 16 % SWE) * 2, 16,
                     8 * SWB, MODE);
  }
  // Descriptor of rows 16kk .. 16kk + 15 as the reduced dimension, read
  // MN-major (D is N): 8-row groups SWB * 8 bytes apart (stride offset),
  // column blocks BLOCK bytes apart (leading offset).
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return make_desc(base + kk * 16 * SWB, BLOCK, 8 * SWB, MODE);
  }
};

// Copy rows r0 .. r0 + R - 1 of a [L][D] bf16 matrix (row stride `stride`
// elements, D contiguous, every row 16-byte aligned) into a SwTile; rows at
// or past L are filled with zeros. All 128 threads of the warpgroup take
// part; the copies join the thread's current cp.async group.
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int L,
                                          int tid) {
  constexpr int CH = D / 8;
  static_assert(R * CH % WG_THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < R * CH / WG_THREADS; ++it) {
    const int i = tid + it * WG_THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < L;
    const __nv_bfloat16* g = ok ? src + (long long)(r0 + r) * stride + c * 8
                                : src;
    cp_async16(dst + SwTile<R, D>::chunk(r, c), g, ok);
  }
}

// mbarrier in shared memory: init (one thread, then fence_mbarrier_init
// and a block barrier), arrive, arrive with an expected transaction byte
// count (the TMA loads that complete on it bring those bytes), and a wait
// for the phase of the given parity to complete. A fresh barrier is in
// phase 0, so a wait on parity 1 returns at once.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copy the box at element coordinates (c0, c1, c2, c3), innermost
// first, of the tensor map `map` (a __grid_constant__ kernel parameter)
// into shared memory at dst; the bytes complete on mbarrier bar. Elements
// outside the tensor are written as zeros and count as bytes all the same.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Named barriers 1..15 (0 is __syncthreads'): `count` threads, a multiple
// of 32, take part; sync waits, arrive does not.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Register reallocation between warpgroups (all 128 threads of the
// warpgroup execute it): a producer gives registers back, a consumer takes
// them. R is a multiple of 8 in [24, 256].
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are in
// flight (the newest N).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wgmma's issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f32 accumulator of an m64nNk16 product -> A fragments of the N / 16
// k-slices of the next product, rounded to bf16 (round to nearest even).
template <int N>
__device__ __forceinline__ void to_a_fragments(const float (&d)[N / 2],
                                               uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int s = 0; s < N / 16; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[s][j] = pack_bf16(d[8 * s + 2 * j], d[8 * s + 2 * j + 1]);
}

// D (64 x N, f32) = or += A (64 x 16, shared, K-major) * B (16 x N, shared,
// K-major, i.e. stored N x 16). accumulate = 0 overwrites D. N = 32, 64 or
// 128: the score tiles' widths.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int accumulate);

// D (64 x N, f32) = or += A (64 x 16, registers) * B (16 x N, shared,
// MN-major, i.e. stored 16 x N with N contiguous). N = D: 16, 32, 64, 128.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

}  // namespace hopper
