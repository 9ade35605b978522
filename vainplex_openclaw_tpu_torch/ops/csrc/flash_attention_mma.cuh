// The bf16 path of K1 and K2 on the tensor cores: mma.sync products, a
// cp.async ring of K/V tiles in shared memory and the online softmax in
// registers. flash_attention.cu says what it computes and why it is built
// this way; this header holds the kernel and its launcher.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

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
  // phase reads on 8 distinct 16-byte bank groups.
  static constexpr int kPitch = DH + 8;
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
  constexpr int kSteps = DH / 16;    // k-steps of q . k^T
  constexpr int kSTiles = kBN / 8;   // 8-key column tiles of the scores
  constexpr int kOTiles = DH / 8;    // 8-wide column tiles of the output
  constexpr int kChunks = DH / 8;    // 16-byte chunks in a row
  constexpr int kPitch = T::kPitch;
  static_assert(DH % 16 == 0, "Dh must be a multiple of 16");

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
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        ldsm_x4(qf[kk], smem_u32(q_s + (warp * 16 + (lane & 15)) * kPitch + kk * 16 +
                                 (lane >> 4) * 8));
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
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, smem_u32(vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                                   dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
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

template <int DH, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   float* m_out, float* l_out, int B, int H, int Lq, int Lk, int causal,
                   cudaStream_t stream) {
  constexpr int kSmem = Tiles<DH>::kSmemBytes;
  const int n_qtiles = (Lq + kBM - 1) / kBM;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
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

}  // namespace mma
}  // namespace
