// The bf16 path of K1 and K2 on Hopper: a producer warp that loads K and V
// with the Tensor Memory Accelerator into a ring of shared-memory stages,
// and consumer warpgroups that run both products on wgmma and the online
// softmax in registers (above head dim 128, with -DFLASH_WIDE: the wide
// kernel, wgmma fed by TMA). Both replace the TPU kernel
// vainplex_openclaw_tpu/ops/flash_attention.py:130 (_flash_kernel). At the
// served shapes the bound is the exponentials and the instructions issued
// around them per score, not the products or the bytes;
// flash_attention.cu's design note says so in numbers and what this body
// does about it. This header holds the kernels and their launchers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the mask value: finite, never -inf

// Keys a causal query tile [q0, q0 + tile_rows) walks: up to its last row,
// so key tiles wholly after it are skipped. When a row of the tile sees no
// valid key, every key instead: such a row scores -1e30 everywhere and
// averages V over all Lk keys, as the plain version does, and the extra
// keys give every other row of the tile p = 0. Row q0 sees the fewest keys
// (0..q0), so the tile holds such a row exactly when row q0 is one. Every
// thread of the block calls this (it votes with __syncthreads_or). The
// Pallas kernel skips those tiles all the same, so there such a row
// averages only the keys up to the end of its query block; the port keeps
// the value of the JAX package's dense reference (_dense_stats_ref) instead.
// No served configuration is causal.
__device__ __forceinline__ int causal_kv_end(const float* __restrict__ bp, int Lk, int q0,
                                             int tile_rows) {
  for (int j0 = 0; j0 <= q0; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    if (__syncthreads_or(j <= q0 && bp[j] > 0.5f * kNegInf)) return min(Lk, q0 + tile_rows);
  }
  return Lk;
}

// The tiles are compile-time constants, set by -D flags (ops/_build.py
// tile_defines): FLASH_WARPS consumer warps of 16 query rows each, four to
// a warpgroup (4 or 8: block_q 64 or 128), and FLASH_BN keys per tile (a
// multiple of 16 up to 128: wgmma's N of q . k^T). Without them, one
// warpgroup (64 rows) and 64 keys. Every tile computes the same function;
// the kernel search (ops/kernel_search.py) times each candidate and the
// block table names the one a length runs.
#ifndef FLASH_WARPS
#define FLASH_WARPS 4
#endif
#ifndef FLASH_BN
#define FLASH_BN 64
#endif

namespace mma {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; when !live nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to nearest even into one bf16x2 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ── wgmma, mbarriers and TMA: shared by the narrow and the wide kernels ──

// A wgmma shared-memory descriptor of an operand at `addr` whose rows of
// `swizzle` bytes (128, 64 or 32) carry that swizzle, the layout TMA
// writes with the same mode (16-byte unit u of row r at u ^ (r % 8) for
// 128, u ^ ((r / 2) % 4) for 64, u ^ ((r / 4) % 2) for 32): lbo is the
// byte stride between swizzle atoms along an MN-major operand's N (unused
// K-major), sbo between 8-row groups (8 * swizzle when rows are packed).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               int swizzle = 128) {
  const uint64_t layout = swizzle == 128 ? 1 : (swizzle == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  wgmma_commit();
  wgmma_wait<0>();
}

// Orders the registers of an in-flight wgmma's accumulator or A fragment
// after the wait before it: their later reads and writes cannot move above
// it, and their registers are not reused before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival of a phase that also expects `bytes` from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival once every cp.async this thread issued before it has landed
// (counted in the barrier's arrivals: .noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of `parity` to complete; traps rather than hang if
// it never does (a fault, not a wait: a tile lands in microseconds).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1ll << 22)) __trap();
  }
}

// One box of a 3-D tensor map at (column c0, row c1, slab c2) into shared
// memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A 3-D tensor map over a [n_bh, rows, cols] bf16 tensor for boxes of
// box_cols x box_rows with the `swizzle`-byte swizzle (box_cols * 2 bytes
// wide, at most the swizzle); rows past `rows` load as zeros. The encoder
// is looked up through the CUDA runtime, so the library links no libcuda.
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int n_bh, int rows, int cols,
                              int box_cols, int box_rows, int swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n_bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle mode = swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, mode,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// wgmma m64nNk16, bf16 in, fp32 accumulate: ss with both operands in shared
// memory (K-major), rs with A from registers and B in shared memory
// (MN-major). d holds the warpgroup's 64 x N tile in 16-row slices, one a
// warp: warp w rows 16w + g and 16w + g + 8 (g = lane / 4),
// d[4n .. 4n+3] columns 8n + 2t, 8n + 2t + 1 of them (t = lane % 4).
template <int N>
struct Wgmma;

// Reduces the scores of rows g and g + 8 of an accumulator fragment of N
// 8-column tiles (s[4n], s[4n + 1] and s[4n + 2], s[4n + 3]) with op, as a
// tree: a dependent chain of log2(2N) steps, not 2N.
template <int N, typename Op>
__device__ __forceinline__ void row_reduce(const float* s, float& r0, float& r1, Op op) {
  float a[N], b[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = op(s[4 * n], s[4 * n + 1]);
    b[n] = op(s[4 * n + 2], s[4 * n + 3]);
  }
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int n = 0; n + w < N; n += 2 * w) {
      a[n] = op(a[n], a[n + w]);
      b[n] = op(b[n], b[n + w]);
    }
  }
  r0 = a[0];
  r1 = b[0];
}

template <>
struct Wgmma<16> {
  // d (64 x 16, fp32) = (scale_d ? d : 0) + A (64 x 16, shared memory, K-major) * B (16 x 16,
  // shared memory, K-major)
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d[0 .. 7] (64 x 16, fp32) += A (64 x 16 bf16, registers) * B (16 x 16, shared
  // memory, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32, fp32) = (scale_d ? d : 0) + A (64 x 16, shared memory, K-major) * B (16 x 32,
  // shared memory, K-major)
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d[0 .. 15] (64 x 32, fp32) += A (64 x 16 bf16, registers) * B (16 x 32, shared
  // memory, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  // d (64 x 48, fp32) = (scale_d ? d : 0) + A (64 x 16, shared memory, K-major) * B (16 x 48,
  // shared memory, K-major)
  static __device__ __forceinline__ void ss(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64, fp32) = (scale_d ? d : 0) + A (64 x 16, shared memory, K-major) * B (16 x 64,
  // shared memory, K-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d[0 .. 31] (64 x 64, fp32) += A (64 x 16 bf16, registers) * B (16 x 64, shared
  // memory, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  // d (64 x 80, fp32) = (scale_d ? d : 0) + A (64 x 16, shared memory, K-major) * B (16 x 80,
  // shared memory, K-major)
  static __device__ __forceinline__ void ss(float (&d)[40], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  // d (64 x 96, fp32) = (scale_d ? d : 0) + A (64 x 16, shared memory, K-major) * B (16 x 96,
  // shared memory, K-major)
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<112> {
  // d (64 x 112, fp32) = (scale_d ? d : 0) + A (64 x 16, shared memory, K-major) * B (16 x 112,
  // shared memory, K-major)
  static __device__ __forceinline__ void ss(float (&d)[56], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, %56, %57, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128, fp32) = (scale_d ? d : 0) + A (64 x 16, shared memory, K-major) * B (16 x 128,
  // shared memory, K-major)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d[0 .. 63] (64 x 128, fp32) += A (64 x 16 bf16, registers) * B (16 x 128, shared
  // memory, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // d[0 .. 127] (64 x 256, fp32) += A (64 x 16 bf16, registers) * B (16 x 256, shared
  // memory, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
// ── the bf16 body at head dims 16, 32, 64 and 128 ──

constexpr int kWG = FLASH_WARPS / 4;   // consumer warpgroups
constexpr int kBM = 16 * FLASH_WARPS;  // query rows per block, 64 per consumer warpgroup
constexpr int kBN = FLASH_BN;          // keys per tile
constexpr int kThreads = 128 * kWG + 32;  // the consumers, then the producer warp
static_assert(FLASH_WARPS == 4 || FLASH_WARPS == 8,
              "FLASH_WARPS must be 4 or 8 (block_q 64 or 128: one or two warpgroups)");
static_assert(kBN >= 16 && kBN <= 128 && kBN % 16 == 0,
              "FLASH_BN must be a multiple of 16 up to 128");

// Shared memory: Q, the ring of K and V stages, the stages' bias rows and
// the mbarriers, from a 1024-byte boundary (ops/_build.py flash_smem_bytes
// mirrors it). A row of Dh bf16 columns is one swizzled row when it is 32,
// 64 or 128 bytes; at Dh 128 the columns are two 64-column regions of
// 128-byte rows. Each region is rows x kSwizzle bytes, a whole number of
// the swizzle's 8-row atoms, so every region starts on its atom.
template <int DH>
struct Tiles {
  static_assert(DH == 16 || DH == 32 || DH == 64 || DH == 128,
                "the bf16 body compiles head dims 16, 32, 64 and 128");
  static constexpr int kSwizzle = DH * 2 < 128 ? DH * 2 : 128;  // bytes of a swizzled row
  static constexpr int kRegionCols = kSwizzle / 2;
  static constexpr int kRegions = DH / kRegionCols;  // 1, or 2 at Dh 128
  static constexpr int kQBytes = kBM * DH * 2;
  static constexpr int kKVBytes = kBN * DH * 2;  // K or V of one stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  // as many stages as fit in 100 KB beside Q, 2 to 4: at Dh 128 and 64 x
  // 64 tiles two blocks share an SM
  static constexpr int kFit = (100 * 1024 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit > 4 ? 4 : (kFit < 2 ? 2 : kFit);
  static constexpr int kSmemBytes =
      1024 + kQBytes + kStages * (kStageBytes + kBN * 4) + 8 * (2 * kStages + 1);
  static_assert(kSmemBytes <= 227 * 1024,
                "tiles exceed the 227 KB of shared memory a block may opt in to");
};

// One block per (batch*head, kBM-row query tile): kWG consumer warpgroups
// of 64 rows each, then one producer warp. The producer's lane 0 loads Q
// once and K and V per key tile by TMA (rows past L zero-filled) into
// stage j % kStages, its 32 lanes the tile's bias row by cp.async; the
// stage's "full" barrier completes on both. Consumers release a stage on
// its "empty" barrier, one arrival a warp, once their P . V of it is done;
// no barrier of the whole block sits in the key loop. A consumer
// warpgroup issues tile j+1's q . k^T and tile j's P . V together and runs
// tile j+1's softmax while P . V is in flight.
template <int DH, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_mma(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
                  void* __restrict__ out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int H, int Lq, int Lk, int n_qtiles,
                  float scale) {
  using T = Tiles<DH>;
  constexpr int kS = T::kStages;
  constexpr int kSw = T::kSwizzle;
  constexpr int kSTiles = kBN / 8;  // 8-key column tiles of the scores
  constexpr int kOTiles = DH / 8;   // 8-wide column tiles of the output
  constexpr int kPRegs = kBN / 4;   // bf16x2 registers of p: 4 per 16 keys

  extern __shared__ __align__(128) unsigned char smem[];
  // the swizzle repeats every 1024 bytes at most: regions start on such a boundary
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* const smem_base = smem + (base - smem_u32(smem));
  const uint32_t q_s = base;
  const uint32_t ring = base + T::kQBytes;
  float* const bias_s = reinterpret_cast<float*>(smem_base + T::kQBytes + kS * T::kStageBytes);
  // the mbarriers: stage st's "full" at bars + 8 st, its "empty" at bars +
  // 8 (kS + st), Q's at bars + 16 kS
  const uint32_t bars = smem_u32(bias_s + kS * kBN);
  const uint32_t q_bar = bars + 16 * kS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBM;
  const int b = bh / H;
  const float* bp = bias + static_cast<size_t>(b) * Lk;

  const int kv_end = CAUSAL ? causal_kv_end(bp, Lk, q0, kBM) : Lk;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  // consumer warpgroups with a row before Lq; the others leave at once
  const int n_wg = min(kWG, (Lq - q0 + 63) / 64);

  if (tid == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(bars + 8 * st, 1 + 32);          // the TMA arrival, then each lane's bias
      mbar_init(bars + 8 * (kS + st), 4 * n_wg);  // each working consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWG) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_bar, T::kQBytes);
      for (int r = 0; r < T::kRegions; ++r)
        tma_load(q_s + r * kBM * kSw, &tm_q, r * T::kRegionCols, q0, bh, q_bar);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kS;
      const uint32_t full = bars + 8 * st;
      if (j >= kS) mbar_wait(bars + 8 * (kS + st), (j / kS - 1) & 1);  // tile j - kS is done
      const int kv0 = j * kBN;
      if (lane == 0) {
        const uint32_t ks = ring + st * T::kStageBytes;
        mbar_expect_tx(full, T::kStageBytes);
        for (int r = 0; r < T::kRegions; ++r) {
          tma_load(ks + r * kBN * kSw, &tm_k, r * T::kRegionCols, kv0, bh, full);
          tma_load(ks + T::kKVBytes + r * kBN * kSw, &tm_v, r * T::kRegionCols, kv0, bh, full);
        }
      }
      float* bs = bias_s + st * kBN;
#pragma unroll
      for (int i0 = 0; i0 < kBN; i0 += 32) {
        const int i = i0 + lane;
        if (i < kBN) cp_async_4(smem_u32(bs + i), bp + min(kv0 + i, Lk - 1), kv0 + i < Lk);
      }
      cp_async_mbar_arrive(full);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // A consumer: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile,
  // its warp w rows 16 w .. 16 w + 15 of those (lane: rows g and g + 8).
  const int wg = warp >> 2;
  if (wg >= n_wg) return;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = q0 + 64 * wg + 16 * (warp & 3);  // the warp's first row
  const int row0 = wrow + g;
  const int row1 = row0 + 8;
  const uint32_t qa = q_s + 64 * wg * kSw;
  const float sl2 = scale * kLog2e;

  float o[4 * kOTiles];
#pragma unroll
  for (int i = 0; i < 4 * kOTiles; ++i) o[i] = 0.f;
  float s[4 * kSTiles];              // the raw scores of one key tile, then its p
  uint32_t p[kPRegs];                // p of the tile in P . V, bf16
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows g and g + 8, natural units
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the running sums

  // s = q . k^T of the tile in stage st: Dh / 16 k-steps of 32 bytes of a
  // row, stepping within a swizzled row and then across regions.
  auto qk = [&](int st) {
    const uint32_t ks = ring + st * T::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int r = kk * 32 / kSw;
      const int off = kk * 32 % kSw;
      Wgmma<kBN>::ss(s, wgmma_desc(qa + r * kBM * kSw + off, 16, 8 * kSw, kSw),
                     wgmma_desc(ks + r * kBN * kSw + off, 16, 8 * kSw, kSw), kk > 0);
    }
  };
  // o += bf16(p) . v of the tile in stage st: V read N-major, 16 keys (two
  // 8-row groups) a k-step, its column regions kBN rows apart.
  auto pv = [&](int st) {
    const uint32_t vs = ring + st * T::kStageBytes + T::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      Wgmma<DH>::rs(o, p + 4 * kk, wgmma_desc(vs + 16 * kk * kSw, kBN * kSw, 8 * kSw, kSw));
  };
  // The online softmax of key tile jt, whose raw scores are in s: m and l
  // move on, s gets p in fp32, and when a row max of the warp moved, c0
  // and c1 get the rows' corrections of o (returns whether one moved; else
  // o and l need none: 2^0 = 1).
  auto softmax = [&](int jt, float& c0, float& c1) -> bool {
    const int kv0 = jt * kBN;
    const float* bs = bias_s + (jt % kS) * kBN;
    // A tile that ends before Lk, holds no causal key after the warp's
    // first row and whose bias row is all zero takes the raw scores as
    // they are: the max over raw q . k times the scale is the max of the
    // scaled scores (rounding is monotone), and p is one FMA and one ex2.
    bool plain = kv0 + kBN <= Lk && !(CAUSAL && kv0 + kBN - 1 > wrow);
    if (plain) {
      bool zero = true;
#pragma unroll
      for (int i0 = 0; i0 < kBN; i0 += 32)
        if (i0 + lane < kBN) zero = zero && bs[i0 + lane] == 0.f;
      plain = __all_sync(0xffffffffu, zero);
    }
    float mn0, mn1;
    if (plain) {
      float mx0, mx1;
      row_reduce<kSTiles>(s, mx0, mx1, [](float a, float b) { return fmaxf(a, b); });
      mn0 = fmaxf(m0, quad_max(mx0) * scale);
      mn1 = fmaxf(m1, quad_max(mx1) * scale);
    } else {
      // Natural units, as the plain version: s * scale + bias; keys past Lk
      // count nothing (p = 0), a causal key after the query scores -1e30.
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          const int key = kv0 + c;
          float& x = s[4 * n + e];
          x = fmaf(x, scale, bs[c]);
          if (key >= Lk) {
            x = -INFINITY;
          } else if (CAUSAL && key > (e < 2 ? row0 : row1)) {
            x = kNegInf;
          }
        }
      }
      float mx0, mx1;
      row_reduce<kSTiles>(s, mx0, mx1, [](float a, float b) { return fmaxf(a, b); });
      mn0 = fmaxf(m0, quad_max(mx0));
      mn1 = fmaxf(m1, quad_max(mx1));
    }
    const bool moved = __any_sync(0xffffffffu, mn0 != m0 || mn1 != m1);
    if (moved) {
      c0 = ex2((m0 - mn0) * kLog2e);
      c1 = ex2((m1 - mn1) * kLog2e);
      l0 *= c0;
      l1 *= c1;
    }
    m0 = mn0;
    m1 = mn1;
    // p = 2^(s log2 e - m log2 e), l sums p before its rounding. A row with
    // no valid key yet has s == m == -1e30 and needs p exactly 1, which the
    // rounding of m log2 e would break: a warp that holds such a row takes
    // the difference first.
    const float o0 = -m0 * kLog2e;
    const float o1 = -m1 * kLog2e;
    auto exp_scores = [&](auto arg) {
#pragma unroll
      for (int i = 0; i < 4 * kSTiles; ++i) s[i] = ex2(arg(s[i], (i >> 1) & 1));
    };
    if (plain) {
      exp_scores([&](float x, int r) { return fmaf(x, sl2, r ? o1 : o0); });
    } else if (__all_sync(0xffffffffu, m0 > kNegInf && m1 > kNegInf)) {
      exp_scores([&](float x, int r) { return fmaf(x, kLog2e, r ? o1 : o0); });
    } else {
      exp_scores([&](float x, int r) { return (x - (r ? m1 : m0)) * kLog2e; });
    }
    float sum0, sum1;
    row_reduce<kSTiles>(s, sum0, sum1, [](float a, float b) { return a + b; });
    l0 += sum0;
    l1 += sum1;
    return moved;
  };
  // p = s rounded to bf16 (the A fragment of P . V): keys 16 kk .. 16 kk +
  // 15 are 8-key tiles 2 kk and 2 kk + 1. Only after the wait that ends
  // the last P . V, so no instruction writes p while a product reads it.
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      p[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Each product is a wgmma group of its own, between a fence and a
  // commit, with its accumulator (and P . V's A fragment) fenced on both
  // sides: no other instruction touches them while the group runs, so
  // ptxas keeps the two groups in flight together.
  auto issue_qk = [&](int st) {
    fence_regs(s);
    wgmma_fence();
    qk(st);
    wgmma_commit();
    fence_regs(s);
  };
  auto issue_pv = [&](int st) {
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    pv(st);
    wgmma_commit();
    fence_regs(o);
  };

  // Tile 0: its scores, then its softmax (o is still 0: nothing to correct).
  mbar_wait(q_bar, 0);
  mbar_wait(bars, 0);
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(s);
  {
    float c0, c1;
    softmax(0, c0, c1);
  }
  pack_p();
  // Tiles 0 .. n_tiles - 2: tile j+1's q . k^T, then tile j's P . V, and
  // tile j+1's softmax while P . V runs. The last tile's P . V follows.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int st = j % kS;
    mbar_wait(bars + 8 * ((j + 1) % kS), ((j + 1) / kS) & 1);  // tile j+1 has landed
    issue_qk((j + 1) % kS);
    issue_pv(st);
    wgmma_wait<1>();  // tile j+1's scores
    fence_regs(s);
    float c0 = 1.f, c1 = 1.f;
    const bool moved = softmax(j + 1, c0, c1);
    wgmma_wait<0>();  // tile j's P . V
    fence_regs(o);
    fence_regs(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kS + st));  // the warp is done with stage st
    if (moved) {
#pragma unroll
      for (int d = 0; d < kOTiles; ++d) {
        o[4 * d] *= c0;
        o[4 * d + 1] *= c0;
        o[4 * d + 2] *= c1;
        o[4 * d + 3] *= c1;
      }
    }
    pack_p();
  }
  issue_pv((n_tiles - 1) % kS);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p);

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t orow0 = static_cast<size_t>(bh) * Lq + row0;
  const size_t orow1 = orow0 + 8;
  if constexpr (STATS) {
    float* acc = static_cast<float*>(out);
#pragma unroll
    for (int d = 0; d < kOTiles; ++d) {
      if (row0 < Lq)
        *reinterpret_cast<float2*>(acc + orow0 * DH + 8 * d + 2 * t) =
            make_float2(o[4 * d], o[4 * d + 1]);
      if (row1 < Lq)
        *reinterpret_cast<float2*>(acc + orow1 * DH + 8 * d + 2 * t) =
            make_float2(o[4 * d + 2], o[4 * d + 3]);
    }
    if (t == 0) {
      if (row0 < Lq) {
        m_out[orow0] = m0;
        l_out[orow0] = l0;
      }
      if (row1 < Lq) {
        m_out[orow1] = m1;
        l_out[orow1] = l1;
      }
    }
  } else {
    __nv_bfloat16* o_ptr = static_cast<__nv_bfloat16*>(out);
    const float lc0 = fmaxf(l0, 1e-30f);
    const float lc1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int d = 0; d < kOTiles; ++d) {
      if (row0 < Lq)
        *reinterpret_cast<uint32_t*>(o_ptr + orow0 * DH + 8 * d + 2 * t) =
            pack_bf16(o[4 * d] / lc0, o[4 * d + 1] / lc0);
      if (row1 < Lq)
        *reinterpret_cast<uint32_t*>(o_ptr + orow1 * DH + 8 * d + 2 * t) =
            pack_bf16(o[4 * d + 2] / lc1, o[4 * d + 3] / lc1);
    }
  }
}

// scale: the softmax scale, 1/sqrt of the caller's head dim, which is not
// DH when the wrapper zero-pads a head dim up to a compiled width. The
// tensor maps are encoded per call (a host cost of microseconds, measured
// in PERF.md against the launch it rides on).
template <int DH, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   float* m_out, float* l_out, int B, int H, int Lq, int Lk, int causal,
                   float scale, cudaStream_t stream) {
  using T = Tiles<DH>;
  const int n_qtiles = (Lq + kBM - 1) / kBM;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t e;
  if ((e = tensor_map(&tm_q, q, B * H, Lq, DH, T::kRegionCols, kBM, T::kSwizzle)) !=
          cudaSuccess ||
      (e = tensor_map(&tm_k, k, B * H, Lk, DH, T::kRegionCols, kBN, T::kSwizzle)) !=
          cudaSuccess ||
      (e = tensor_map(&tm_v, v, B * H, Lk, DH, T::kRegionCols, kBN, T::kSwizzle)) != cudaSuccess)
    return e;
  auto kernel = causal ? flash_fwd_mma<DH, true, STATS> : flash_fwd_mma<DH, false, STATS>;
  if (T::kSmemBytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, T::kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(bias), out, m_out, l_out, H, Lq, Lk, n_qtiles,
      scale);
  return cudaGetLastError();
}

#ifdef FLASH_WIDE
// Head dims above 128 in bf16 (a library built with -DFLASH_WIDE, which
// holds only these kernels and none of the above). Replaces the same TPU
// kernel, vainplex_openclaw_tpu/ops/flash_attention.py::_flash_kernel, in
// both modes; the wrapper zero-pads Dh to Dp, a multiple of 128.
//
// Bound at B=2 H=2 L=2048 Dh=256: 1.72e10 tensor-core operations (0.0174
// ms at 989 TFLOP/s) against K1's 16.8 MB of q, k, v and out (0.0050 ms):
// operations.
//
// Design. A block of two warpgroups owns a 64-row query tile and up to
// kWideSlice = 256 output columns (blockIdx.y walks ceil(Dp / 256)
// slices). Warpgroup h takes keys 32h .. 32h+31 of every key tile, with
// its own online softmax and a 64 x 256 fp32 accumulator in registers
// (128 a thread); the two merge (m, l, acc) once, at the end, as ring
// attention merges its rotations.
// - Products on wgmma: s (64 x 32) = Q . K^T with both operands read from
//   shared memory (m64n32k16), acc (64 x 256) += P . V with P from
//   registers, the score fragment rounded to bf16 (m64n256k16, V read
//   N-major). Each operand is read from shared memory once per
//   warpgroup, where mma.sync reads it once per warp.
// - Q lands in shared memory once per block (up to kWideQResMax; above it
//   each K unit carries its Q chunk, as no 64 x Dp tile fits).
// - K and V stream through one ring of kWideStages stages of "units": per
//   key tile, ceil(Dp / 256) K chunks of 64 keys x 256 dims, then the 64 x
//   256 V slice of the block's output columns. Units g+1 and g+2 are in
//   flight while unit g is multiplied. One thread loads a unit with the
//   Tensor Memory Accelerator (64 x 64 boxes of 3-D tensor maps over
//   [B*H, L, Dp], rows past L zero-filled), which signals the stage's
//   mbarrier; cp.async alone kept too few bytes in flight an SM.
// - Every tile sits in shared memory in 64-column regions of 128-byte
//   rows with the 128-byte swizzle (16-byte unit u of row r at u ^ (r %
//   8)): the layout TMA writes and the wgmma descriptors name.
// - q . k^T is computed once per (query tile, key tile) for Dp <= 256 (one
//   K unit); above 256 once per slice, as every slice needs the same
//   scores, m and l (K2 writes m and l from slice 0).
// Why one block takes all 256 columns: a block a 128-wide slice would
// recompute q . k^T in each slice (1.5x the products at Dp=256).
constexpr int kWideSlice = 256;   // output columns per block, and per unit
constexpr int kWideBM = 64;       // query rows per block, 16 per warp of a warpgroup
constexpr int kWideBN = 64;       // keys per tile, 32 per warpgroup
constexpr int kWideThreads = 256;  // two warpgroups
constexpr int kWideStages = 3;
constexpr int kWideQResMax = 896;  // Dp up to which Q stays resident
constexpr int kRegion = 64 * 128;  // bytes of a 64-row x 64-column bf16 region: one TMA box

__host__ __device__ constexpr bool wide_q_resident(int Dp) { return Dp <= kWideQResMax; }
__host__ __device__ constexpr int wide_q_bytes(int Dp) {
  return wide_q_resident(Dp) ? Dp / 64 * kRegion : 0;
}
__host__ __device__ constexpr int wide_stage_bytes(int Dp) {  // K or V, and Q if not resident
  return (wide_q_resident(Dp) ? 1 : 2) * (kWideSlice / 64) * kRegion;
}
// Q, the ring, the stages' bias rows, the mbarriers (one a stage, one for
// Q), and room to align the start to the 1024 bytes the swizzle needs
__host__ __device__ constexpr int wide_smem_bytes(int Dp) {
  return wide_q_bytes(Dp) + kWideStages * (wide_stage_bytes(Dp) + kWideBN * 4) +
         8 * (kWideStages + 1) + 1024;
}
static_assert(wide_smem_bytes(kWideQResMax) <= 227 * 1024 &&
                  wide_smem_bytes(kWideQResMax + 128) <= 227 * 1024,
              "the wide tiles exceed 227 KB of shared memory");

template <int W, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_mma_wide(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
                       void* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int H, int Lq, int Lk, int Dp, int n_qtiles,
                       float scale) {
  static_assert(W == kWideSlice, "one output slice is one unit wide");
  constexpr int kSTiles = kWideBN / 16;  // 8-key column tiles of a warpgroup's half tile
  constexpr int kOTiles = W / 8;         // 8-wide column tiles of the output slice

  extern __shared__ __align__(128) unsigned char smem_wide[];
  // the swizzle repeats every 1024 bytes: regions start on such a boundary
  const uint32_t base = (smem_u32(smem_wide) + 1023) & ~1023u;
  unsigned char* const smem_base = smem_wide + (base - smem_u32(smem_wide));

  const int tid = threadIdx.x;
  const int rw = (tid >> 5) & 3;  // the warp's rows within the tile: 16 rw .. 16 rw + 15
  const int kh = tid >> 7;        // its warpgroup's keys: 32 kh .. 32 kh + 31 of a tile
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kWideBM;
  const int slice = blockIdx.y;
  const int b = bh / H;
  const bool q_res = wide_q_resident(Dp);
  const int stage_bytes = wide_stage_bytes(Dp);
  const uint32_t ring = base + wide_q_bytes(Dp);
  float* const bias_s = reinterpret_cast<float*>(smem_base + wide_q_bytes(Dp) +
                                                 kWideStages * stage_bytes);
  // the mbarriers: stage st's at bars + 8 st, Q's at bars + 8 kWideStages
  const uint32_t bars = smem_u32(bias_s + kWideStages * kWideBN);
  const int n_k = (Dp + W - 1) / W;           // K units per key tile
  const int v_cols = min(W, Dp - slice * W);  // this slice's columns: 128 or 256
  const int units = n_k + 1;                  // the K units, then the V unit
  const float* bp = bias + static_cast<size_t>(b) * Lk;

  const int kv_end = CAUSAL ? causal_kv_end(bp, Lk, q0, kWideBM) : Lk;
  const int n_tiles = (kv_end + kWideBN - 1) / kWideBN;
  const int total = n_tiles * units;

  // cols / 64 boxes of 64 rows from row c1 of slab bh, columns from c0,
  // into consecutive regions at dst (thread 0 only).
  auto boxes = [&](uint32_t dst, const CUtensorMap* map, int c0, int c1, int cols,
                   uint32_t bar) {
    for (int c = 0; c < cols / 64; ++c) tma_load(dst + c * kRegion, map, c0 + 64 * c, c1, bh, bar);
  };
  // Unit u of key tile j: K chunk u (with its Q chunk when Q is not
  // resident; the tile's bias rides with its last K chunk, by cp.async),
  // or the V slice.
  auto load_unit = [&](int gu) {
    const int j = gu / units;
    const int u = gu - j * units;
    const int kv0 = j * kWideBN;
    const int st = gu % kWideStages;
    const uint32_t dst = ring + st * stage_bytes;
    const uint32_t bar = bars + 8 * st;
    if (u < n_k) {
      const int cols = min(W, Dp - u * W);
      if (tid == 0) {
        mbar_expect_tx(bar, (q_res ? 1 : 2) * cols / 64 * kRegion);
        boxes(dst, &tm_k, u * W, kv0, cols, bar);
        if (!q_res) boxes(dst + (W / 64) * kRegion, &tm_q, u * W, q0, cols, bar);
      }
      if (u == n_k - 1) {
        float* bs = bias_s + st * kWideBN;
        for (int i = tid; i < kWideBN; i += kWideThreads)
          cp_async_4(smem_u32(bs + i), bp + min(kv0 + i, Lk - 1), kv0 + i < Lk);
      }
    } else if (tid == 0) {
      mbar_expect_tx(bar, v_cols / 64 * kRegion);
      boxes(dst, &tm_v, slice * W, kv0, v_cols, bar);
    }
  };

  // Prologue: the barriers; the resident Q, then units 0 and 1 (their
  // bias rows in one cp.async group each).
  if (tid == 0) {
    for (int i = 0; i <= kWideStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (q_res && tid == 0) {
    const uint32_t bar = bars + 8 * kWideStages;
    mbar_expect_tx(bar, Dp / 64 * kRegion);
    for (int c0 = 0; c0 < Dp; c0 += W)
      boxes(base + c0 / 64 * kRegion, &tm_q, c0, q0, min(W, Dp - c0), bar);
  }
#pragma unroll
  for (int i = 0; i < kWideStages - 1; ++i) {
    if (i < total) load_unit(i);
    cp_async_commit();
  }
  if (q_res) mbar_wait(bars + 8 * kWideStages, 0);

  float o[4 * kOTiles];  // o[4d + e]: 8-column tile d, in the mma.sync C fragment's layout
#pragma unroll
  for (int i = 0; i < 4 * kOTiles; ++i) o[i] = 0.f;
  float s[4 * kSTiles];  // s[4n + e], likewise for 8-key tile n
#pragma unroll
  for (int i = 0; i < 4 * kSTiles; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the running sums
  const int row0 = q0 + rw * 16 + g;
  const int row1 = row0 + 8;
  const int k0 = 32 * kh;  // the warpgroup's first key within a tile

  int gu = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kWideBN;
    for (int u = 0; u < units; ++u, ++gu) {
      mbar_wait(bars + 8 * (gu % kWideStages), (gu / kWideStages) & 1);  // unit gu has landed
      cp_async_wait<kWideStages - 2>();  // and its bias row
      __syncthreads();                   // for every thread; all are done with unit gu-1
      // Refill the stage unit gu-1 used; always commit, so that the group
      // count stays one per unit.
      if (gu + kWideStages - 1 < total) load_unit(gu + kWideStages - 1);
      cp_async_commit();
      const int st = gu % kWideStages;
      const uint32_t unit = ring + st * stage_bytes;
      if (u < n_k) {
        // s (+)= q . k^T over this chunk's columns, one k16 step per 32
        // bytes of a swizzled row; the step count is a constant of each
        // branch (a full chunk or the 128-wide last one)
        const uint32_t qa = q_res ? base + u * (W / 64) * kRegion : unit + (W / 64) * kRegion;
        const uint32_t ka = unit + k0 * 128;
        auto qk = [&](auto n_steps) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < decltype(n_steps)::value; ++kk) {
            const int off = (kk >> 2) * kRegion + (kk & 3) * 32;
            Wgmma<32>::ss(s, wgmma_desc(qa + off, 16, 1024), wgmma_desc(ka + off, 16, 1024),
                            u > 0 || kk > 0);
          }
          wgmma_commit_and_wait();
        };
        if (Dp - u * W >= W) {
          qk(std::integral_constant<int, W / 16>{});
        } else {
          qk(std::integral_constant<int, W / 32>{});
        }
        if (u < n_k - 1) continue;
        // The tile's scores are whole. Natural units: s * 1/sqrt(Dh) +
        // bias; keys past Lk count nothing, a causal key after the query
        // scores -1e30.
        const float* bs = bias_s + st * kWideBN;
#pragma unroll
        for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kv0 + k0 + 8 * n + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            float& x = s[4 * n + e];
            x = fmaf(x, scale, bs[k0 + 8 * n + 2 * t + (e & 1)]);
            if (key >= Lk) {
              x = -INFINITY;
            } else if (CAUSAL && key > row) {
              x = kNegInf;
            }
          }
        }
        // Online softmax over the warpgroup's keys, as the narrow kernel:
        // m in natural units, p = 2^((s - m) log2 e), the difference first
        // so a row with no valid key yet (s == m == -1e30) gets p exactly 1.
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int n = 0; n < kSTiles; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float c0 = ex2((m0 - mx0) * kLog2e);
        const float c1 = ex2((m1 - mx1) * kLog2e);
        m0 = mx0;
        m1 = mx1;
        l0 *= c0;
        l1 *= c1;
#pragma unroll
        for (int d = 0; d < kOTiles; ++d) {
          o[4 * d] *= c0;
          o[4 * d + 1] *= c0;
          o[4 * d + 2] *= c1;
          o[4 * d + 3] *= c1;
        }
#pragma unroll
        for (int n = 0; n < kSTiles; ++n) {
          s[4 * n] = ex2((s[4 * n] - m0) * kLog2e);
          s[4 * n + 1] = ex2((s[4 * n + 1] - m0) * kLog2e);
          s[4 * n + 2] = ex2((s[4 * n + 2] - m1) * kLog2e);
          s[4 * n + 3] = ex2((s[4 * n + 3] - m1) * kLog2e);
          l0 += s[4 * n] + s[4 * n + 1];
          l1 += s[4 * n + 2] + s[4 * n + 3];
        }
      } else {
        // acc += bf16(p) . v over the warpgroup's keys and the block's
        // slice of v (256 columns, or the 128 of a last slice), V read
        // N-major: 64-column regions lbo = kRegion apart, 8-key groups
        // sbo = 1024 apart
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSTiles / 2; ++kk) {
          const uint32_t pa[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                                  pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                                  pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                                  pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
          const uint64_t vd = wgmma_desc(unit + (k0 + 16 * kk) * 128, kRegion, 1024);
          if (v_cols == W) {
            Wgmma<256>::rs(o, pa, vd);
          } else {
            Wgmma<128>::rs(o, pa, vd);
          }
        }
        wgmma_commit_and_wait();
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain

  // Merge the key halves: warpgroup 1 hands its m, l and acc to warpgroup
  // 0 through the ring's shared memory (each lane its own fragment), which
  // rescales both by 2^((m_half - m) log2 e) with m the max of the two.
  __syncthreads();  // every warp is done with the ring
  float4* xs = reinterpret_cast<float4*>(smem_base + wide_q_bytes(Dp)) +
               rw * (kOTiles + 1) * 32 + lane;
  static_assert(4 * (kOTiles + 1) * 32 * 16 <= kWideStages * wide_stage_bytes(0),
                "the merge does not fit in the ring");
  if (kh == 1) {
#pragma unroll
    for (int d = 0; d < kOTiles; ++d)
      xs[d * 32] = make_float4(o[4 * d], o[4 * d + 1], o[4 * d + 2], o[4 * d + 3]);
    xs[kOTiles * 32] = make_float4(m0, m1, l0, l1);
  }
  __syncthreads();
  if (kh == 1) return;
  {
    const float4 ml = xs[kOTiles * 32];
    const float mm0 = fmaxf(m0, ml.x);
    const float mm1 = fmaxf(m1, ml.y);
    const float a0 = ex2((m0 - mm0) * kLog2e), b0 = ex2((ml.x - mm0) * kLog2e);
    const float a1 = ex2((m1 - mm1) * kLog2e), b1 = ex2((ml.y - mm1) * kLog2e);
    m0 = mm0;
    m1 = mm1;
    l0 = l0 * a0 + ml.z * b0;
    l1 = l1 * a1 + ml.w * b1;
#pragma unroll
    for (int d = 0; d < kOTiles; ++d) {
      const float4 x = xs[d * 32];
      o[4 * d] = o[4 * d] * a0 + x.x * b0;
      o[4 * d + 1] = o[4 * d + 1] * a0 + x.y * b0;
      o[4 * d + 2] = o[4 * d + 2] * a1 + x.z * b1;
      o[4 * d + 3] = o[4 * d + 3] * a1 + x.w * b1;
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t orow0 = static_cast<size_t>(bh) * Lq + row0;
  const size_t orow1 = orow0 + 8;
  const int col = slice * W + 2 * t;
  if constexpr (STATS) {
    float* acc = static_cast<float*>(out);
#pragma unroll
    for (int d = 0; d < kOTiles; ++d) {
      if (8 * d >= v_cols) continue;
      if (row0 < Lq)
        *reinterpret_cast<float2*>(acc + orow0 * Dp + col + 8 * d) =
            make_float2(o[4 * d], o[4 * d + 1]);
      if (row1 < Lq)
        *reinterpret_cast<float2*>(acc + orow1 * Dp + col + 8 * d) =
            make_float2(o[4 * d + 2], o[4 * d + 3]);
    }
    if (slice == 0 && t == 0) {
      if (row0 < Lq) {
        m_out[orow0] = m0;
        l_out[orow0] = l0;
      }
      if (row1 < Lq) {
        m_out[orow1] = m1;
        l_out[orow1] = l1;
      }
    }
  } else {
    __nv_bfloat16* o_ptr = static_cast<__nv_bfloat16*>(out);
    const float lc0 = fmaxf(l0, 1e-30f);
    const float lc1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int d = 0; d < kOTiles; ++d) {
      if (8 * d >= v_cols) continue;
      if (row0 < Lq)
        *reinterpret_cast<uint32_t*>(o_ptr + orow0 * Dp + col + 8 * d) =
            pack_bf16(o[4 * d] / lc0, o[4 * d + 1] / lc0);
      if (row1 < Lq)
        *reinterpret_cast<uint32_t*>(o_ptr + orow1 * Dp + col + 8 * d) =
            pack_bf16(o[4 * d + 2] / lc1, o[4 * d + 3] / lc1);
    }
  }
}

// Dp: the zero-padded head dim, a multiple of 128; scale: 1/sqrt of the
// caller's head dim.
template <bool STATS>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* bias, void* out,
                        float* m_out, float* l_out, int B, int H, int Lq, int Lk, int Dp,
                        int causal, float scale, cudaStream_t stream) {
  const int n_qtiles = (Lq + kWideBM - 1) / kWideBM;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  const int slices = (Dp + kWideSlice - 1) / kWideSlice;
  if (blocks <= 0 || blocks > INT_MAX || Dp % 128 != 0 || slices > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t e;
  if ((e = tensor_map(&tm_q, q, B * H, Lq, Dp, 64, 64, 128)) != cudaSuccess ||
      (e = tensor_map(&tm_k, k, B * H, Lk, Dp, 64, 64, 128)) != cudaSuccess ||
      (e = tensor_map(&tm_v, v, B * H, Lk, Dp, 64, 64, 128)) != cudaSuccess)
    return e;
  auto kernel = causal ? flash_fwd_mma_wide<kWideSlice, true, STATS>
                       : flash_fwd_mma_wide<kWideSlice, false, STATS>;
  const int smem = wide_smem_bytes(Dp);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slices));
  kernel<<<grid, kWideThreads, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<const float*>(bias),
                                               out, m_out, l_out, H, Lq, Lk, Dp, n_qtiles, scale);
  return cudaGetLastError();
}
#endif  // FLASH_WIDE

}  // namespace mma
}  // namespace
