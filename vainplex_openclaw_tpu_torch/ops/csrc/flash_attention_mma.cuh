// The bf16 path of K1 and K2 on the tensor cores: mma.sync products, a
// cp.async ring of K/V tiles in shared memory and the online softmax in
// registers (above head dim 128, with -DFLASH_WIDE: wgmma products fed by
// TMA). flash_attention.cu says what it computes and why it is built this
// way; this header holds the kernels and their launchers.

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
// tile_defines): FLASH_WARPS warps of 16 query rows each and FLASH_BN keys
// per tile. Without them, 4 warps (64 rows) and 64 keys. Every tile
// computes the same function; the kernel search (ops/kernel_search.py)
// times each candidate and the block table names the one a length runs.
#ifndef FLASH_WARPS
#define FLASH_WARPS 4
#endif
#ifndef FLASH_BN
#define FLASH_BN 64
#endif

namespace mma {

constexpr int kWarps = FLASH_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBN = FLASH_BN;     // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kWarps >= 1 && kWarps <= 8, "FLASH_WARPS must be 1..8 (at most 256 threads)");
static_assert(kBN >= 16 && kBN % 16 == 0, "FLASH_BN must be a positive multiple of 16");

template <int DH>
struct Tiles {
  // Row pitch in bf16: a 16-byte pad puts the 8 rows that one ldmatrix
  // phase reads on 8 distinct 16-byte bank groups. A Dh=8 row takes the
  // Dh=16 pitch (48 bytes): at 32 bytes, rows r and r + 4 would share banks.
  static constexpr int kPitch = (DH < 16 ? 16 : DH) + 8;
  // Three tiles in flight; two at Dh=128 to keep two blocks on an SM.
  static constexpr int kStages = DH >= 128 ? 2 : 3;
  static constexpr int kTileElems = kBN * kPitch;
  static constexpr int kQBytes = kBM * kPitch * 2;
  static constexpr int kStageBytes = 2 * kTileElems * 2 + kBN * 4;  // K, V, bias
  static constexpr int kSmemBytes = kQBytes + kStages * kStageBytes;
  static_assert(kSmemBytes <= 227 * 1024, "tiles exceed the 227 KB of shared memory a block may opt in to");
};

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8 bf16, row) * b (8x8 bf16, col), fp32 accumulate: the
// q . k^T product at Dh=8, one k-step of 8.
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
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

// One block per (batch*head, kBM-row query tile), kWarps warps of 16 rows each.
// In the mma fragments a lane holds rows g and g + 8 of its warp's 16
// (g = lane / 4) and columns 2t, 2t + 1 of every 8-wide tile (t = lane % 4).
template <int DH, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                  void* __restrict__ out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int H, int Lq, int Lk, int n_qtiles,
                  float scale) {
  using T = Tiles<DH>;
  // Dh=8: q . k^T is one m16n8k8 step on 16-byte rows (ldmatrix .x2), and
  // P . V one n8 output tile; every other width steps k by 16.
  constexpr bool kK8 = DH == 8;
  constexpr int kSteps = kK8 ? 1 : DH / 16;  // k-steps of q . k^T
  constexpr int kSTiles = kBN / 8;   // 8-key column tiles of the scores
  constexpr int kOTiles = DH / 8;    // 8-wide column tiles of the output
  constexpr int kChunks = DH / 8;    // 16-byte chunks in a row
  constexpr int kPitch = T::kPitch;
  static_assert(DH == 8 || DH % 16 == 0, "Dh must be 8 or a multiple of 16");

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBM;
  const int b = bh / H;
  const __nv_bfloat16* qp = q + static_cast<size_t>(bh) * Lq * DH;
  const __nv_bfloat16* kp = k + static_cast<size_t>(bh) * Lk * DH;
  const __nv_bfloat16* vp = v + static_cast<size_t>(bh) * Lk * DH;
  const float* bp = bias + static_cast<size_t>(b) * Lk;

  const int kv_end = CAUSAL ? causal_kv_end(bp, Lk, q0, kBM) : Lk;
  const int n_tiles = (kv_end + kBN - 1) / kBN;

  auto stage_k = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + T::kQBytes + st * T::kStageBytes);
  };
  // Keys at or past Lk are zero-filled; their scores are set to -inf below.
  auto load_tile = [&](int tile, int st) {
    const int kv0 = tile * kBN;
    __nv_bfloat16* ks = stage_k(st);
    __nv_bfloat16* vs = ks + T::kTileElems;
    float* bs = reinterpret_cast<float*>(vs + T::kTileElems);
    for (int i = tid; i < kBN * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool live = kv0 + r < Lk;
      const size_t src = static_cast<size_t>(live ? kv0 + r : 0) * DH + c;
      cp_async_16(smem_u32(ks + r * kPitch + c), kp + src, live);
      cp_async_16(smem_u32(vs + r * kPitch + c), vp + src, live);
    }
    for (int i = tid; i < kBN; i += kThreads)
      cp_async_4(smem_u32(bs + i), bp + min(kv0 + i, Lk - 1), kv0 + i < Lk);
  };

  // Prologue: q and tile 0 in the first group, then tiles 1 .. kStages-2.
  for (int i = tid; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool live = q0 + r < Lq;
    cp_async_16(smem_u32(q_s + r * kPitch + c),
                qp + static_cast<size_t>(live ? q0 + r : 0) * DH + c, live);
  }
  load_tile(0, 0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < T::kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  uint32_t qf[kSteps][4];
  float o[kOTiles][4];
#pragma unroll
  for (int d = 0; d < kOTiles; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the running sums
  const int wrow = q0 + warp * 16;   // the warp's first row
  const int row0 = wrow + g;
  const int row1 = row0 + 8;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<T::kStages - 2>();  // tile j has landed
    __syncthreads();                  // for every thread; all are done with tile j-1
    {
      // Refill the stage that tile j-1 used; always commit, so that the
      // group count stays one per tile.
      const int next = j + T::kStages - 1;
      if (next < n_tiles) load_tile(next, next % T::kStages);
      cp_async_commit();
    }
    if (j == 0) {
      if constexpr (kK8) {
        // lanes 0-15 address rows 0-15: qf[0][0] holds row g, qf[0][1] row g + 8
        ldsm_x2(qf[0][0], qf[0][1], smem_u32(q_s + (warp * 16 + (lane & 15)) * kPitch));
      } else {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          ldsm_x4(qf[kk], smem_u32(q_s + (warp * 16 + (lane & 15)) * kPitch + kk * 16 +
                                   (lane >> 4) * 8));
      }
    }
    const int st = j % T::kStages;
    const __nv_bfloat16* ks = stage_k(st);
    const __nv_bfloat16* vs = ks + T::kTileElems;
    const float* bs = reinterpret_cast<const float*>(vs + T::kTileElems);
    const int kv0 = j * kBN;

    // s = q . k^T on the tensor cores, fp32.
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (kK8) {
#pragma unroll
      for (int p = 0; p < kSTiles / 2; ++p) {
        // keys 16p .. 16p+7 and 16p+8 .. 16p+15: the B fragments of two
        // 8-key score tiles
        uint32_t kb0, kb1;
        ldsm_x2(kb0, kb1, smem_u32(ks + (16 * p + (lane & 15)) * kPitch));
        mma_bf16_k8(s[2 * p], qf[0][0], qf[0][1], kb0);
        mma_bf16_k8(s[2 * p + 1], qf[0][0], qf[0][1], kb1);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int p = 0; p < kSTiles / 2; ++p) {
          uint32_t kb[4];
          ldsm_x4(kb, smem_u32(ks + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * kPitch +
                               kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * p], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * p + 1], qf[kk], kb[2], kb[3]);
        }
      }
    }
    // Natural units, as the plain version: s * 1/sqrt(Dh) + bias.
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * n + 2 * t);
      s[n][0] = fmaf(s[n][0], scale, bb.x);
      s[n][1] = fmaf(s[n][1], scale, bb.y);
      s[n][2] = fmaf(s[n][2], scale, bb.x);
      s[n][3] = fmaf(s[n][3], scale, bb.y);
    }
    // The ragged last tile and, under causality, tiles that reach past the
    // warp's first row: keys past Lk count nothing (p = 0), a causal key
    // after the query scores -1e30.
    if (kv0 + kBN > Lk || (CAUSAL && kv0 + kBN - 1 > wrow)) {
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + 8 * n + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (key >= Lk) {
            s[n][e] = -INFINITY;
          } else if (CAUSAL && key > row) {
            s[n][e] = kNegInf;
          }
        }
      }
    }

    // Online softmax. m is the max of the scores in natural units, so it
    // is the plain version's m; it starts at -1e30 and stays finite.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
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
      o[d][0] *= c0;
      o[d][1] *= c0;
      o[d][2] *= c1;
      o[d][3] *= c1;
    }
    // p = 2^(s log2 e - m log2 e): one FMA and one ex2 per score, and l
    // sums p before its rounding. A row with no valid key yet has s == m ==
    // -1e30 and needs p exactly 1, which the rounding of m log2 e would
    // break: a warp that holds such a row takes the difference first.
    auto exp_scores = [&](auto arg) {
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
        s[n][0] = ex2(arg(s[n][0], 0));
        s[n][1] = ex2(arg(s[n][1], 0));
        s[n][2] = ex2(arg(s[n][2], 1));
        s[n][3] = ex2(arg(s[n][3], 1));
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
    };
    if (__all_sync(0xffffffffu, m0 > kNegInf && m1 > kNegInf)) {
      const float o0 = -m0 * kLog2e;
      const float o1 = -m1 * kLog2e;
      exp_scores([&](float x, int r) { return fmaf(x, kLog2e, r ? o1 : o0); });
    } else {
      exp_scores([&](float x, int r) { return (x - (r ? m1 : m0)) * kLog2e; });
    }

    // acc += bf16(p) . v: the score fragment is the A fragment of the
    // product, rounded in registers.
#pragma unroll
    for (int kk = 0; kk < kSTiles / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      if constexpr (kK8) {
        // keys 16kk .. 16kk+15 of the 8 columns: b0 and b1 of one n8 tile
        uint32_t vb0, vb1;
        ldsm_x2_trans(vb0, vb1, smem_u32(vs + (16 * kk + (lane & 15)) * kPitch));
        mma_bf16(o[0], pa, vb0, vb1);
      } else {
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, smem_u32(vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                              kPitch +
                                     dp * 16 + (lane >> 4) * 8));
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain

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
            make_float2(o[d][0], o[d][1]);
      if (row1 < Lq)
        *reinterpret_cast<float2*>(acc + orow1 * DH + 8 * d + 2 * t) =
            make_float2(o[d][2], o[d][3]);
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
            pack_bf16(o[d][0] / lc0, o[d][1] / lc0);
      if (row1 < Lq)
        *reinterpret_cast<uint32_t*>(o_ptr + orow1 * DH + 8 * d + 2 * t) =
            pack_bf16(o[d][2] / lc1, o[d][3] / lc1);
    }
  }
}

// scale: the softmax scale, 1/sqrt of the caller's head dim, which is not
// DH when the wrapper zero-pads a head dim up to a compiled width.
template <int DH, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   float* m_out, float* l_out, int B, int H, int Lq, int Lk, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int kSmem = Tiles<DH>::kSmemBytes;
  const int n_qtiles = (Lq + kBM - 1) / kBM;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = causal ? flash_fwd_mma<DH, true, STATS> : flash_fwd_mma<DH, false, STATS>;
  if (kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias), out, m_out, l_out,
      H, Lq, Lk, n_qtiles, scale);
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

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// `addr` (1024-byte aligned regions): lbo is the byte stride between
// 64-column regions along an N-major operand's N (unused K-major), sbo
// between 8-row groups.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// The one arrival of a stage's phase, expecting `bytes` from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete; traps rather than hang if
// it never does (a fault, not a wait: a unit lands in microseconds).
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

// One 64 x 64 box of a 3-D tensor map at (column c0, row c1, slab c2) into
// shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// d (64 x 32, fp32) = (scale_d ? d : 0) + A (64 x 16, shared memory,
// K-major) * B (16 x 32, shared memory, K-major)
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0 .. 63] (64 x 128, fp32) += A (64 x 16 bf16, registers) * B (16 x 128, shared
// memory, MN-major)
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16 bf16, registers) * B (16 x 256, shared
// memory, MN-major)
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

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
    for (int i = 0; i <= kWideStages; ++i) mbar_init(bars + 8 * i);
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
            wgmma_m64n32_ss(s, wgmma_desc(qa + off, 16, 1024), wgmma_desc(ka + off, 16, 1024),
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
            wgmma_m64n256_rs(o, pa, vd);
          } else {
            wgmma_m64n128_rs(o, pa, vd);
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

// A 3-D tensor map over a [n_bh, rows, Dp] bf16 tensor for 64 x 64 boxes
// with the 128-byte swizzle; rows past `rows` load as zeros. The encoder
// is looked up through the CUDA runtime, so the library links no libcuda.
inline cudaError_t wide_tensor_map(CUtensorMap* map, const void* ptr, int n_bh, int rows, int Dp) {
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
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n_bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Dp) * 2,
                                 static_cast<cuuint64_t>(rows) * Dp * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  if ((e = wide_tensor_map(&tm_q, q, B * H, Lq, Dp)) != cudaSuccess ||
      (e = wide_tensor_map(&tm_k, k, B * H, Lk, Dp)) != cudaSuccess ||
      (e = wide_tensor_map(&tm_v, v, B * H, Lk, Dp)) != cudaSuccess)
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
