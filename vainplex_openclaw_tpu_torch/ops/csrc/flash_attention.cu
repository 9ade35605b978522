// Exact attention forward on Hopper (sm_90a): the normalized output (K1)
// and the stats mode that ring attention merges (K2).
//
// Replaces the TPU kernel vainplex_openclaw_tpu/ops/flash_attention.py:130
// (_flash_kernel) in both of its modes. Same arithmetic: per key tile,
// s = (q . k^T in fp32) * 1/sqrt(Dh) + bias[b, key], a causal key after
// the query gets -1e30 in place of its score, an online softmax keeps m, l
// and acc in fp32, and p is rounded to the input dtype before the PV
// product. K1 (return_stats=False) writes out = acc / max(l, 1e-30) in the
// input dtype. K2 (return_stats=True) writes the unnormalized fp32 acc
// [B,H,Lq,Dh] and the running max m and unclamped sum l [B,H,Lq] in fp32;
// the TPU kernel's 128-lane broadcast of m and l is a layout of its VMEM
// scratch and has no counterpart here. The two modes share one template
// per dtype and differ only in the epilogue (the STATS flag). The kernel
// masks its own ragged edge instead of the TPU's padding: keys at or past
// Lk contribute exactly 0 and query rows at or past Lq are not stored. So
// in K2 a row whose every key is masked has m = -1e30 (finite) and l = the
// number of real keys, where the TPU kernel counts its padded keys too.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s, 132 SMs).
// Each score costs 4*Dh tensor-core operations (q . k and p . v) and one
// exponential. At the long serve shape (B=8, H=2, L=16384, Dh=16, bf16)
// that is 2.75e11 operations (0.278 ms), ~44.6 MB of q, k, v, acc, m, l
// and bias (0.013 ms), and B*H*L^2 = 4.29e9 exponentials. The special
// function units do 16 ex2 per clock per SM, ~3.9e12 a second as Shah et
// al. (FlashAttention-3, 2024) give it: 1.10 ms, four times the
// tensor-core bound. sfu_probe.cu measures the card's own rate: 4.20e12 a
// second on an H100 80GB HBM3 at 700 W (1.02 ms), with cvt.rn.bf16x2 at
// four times that on a unit of its own. So at Dh=16 the exponentials set
// the floor, and what keeps a kernel above it is the issue and latency of
// the instructions around each one on the same warps: the scale and bias,
// the max, the ex2's argument, the sum, the bf16 pack, and a chain per
// key tile (wait for the tile, q . k^T, the row max across the quad, the
// correction, p . v) that nothing overlaps when the tile's steps run one
// after another on synchronized warps. At the short serve shape (B=32,
// H=4, L=64) the ~1.06 MB of bytes bound it (0.3 us), in practice the
// launch.
//
// What the bf16 design (flash_attention_mma.cuh, head dims 16 to 128) does
// about each.
// - A producer warp and consumer warpgroups. One thread of the producer
//   warp loads Q once and K and V of each key tile with TMA into a ring of
//   stages (rows past L zero-filled by the tensor map), its lanes the
//   tile's bias row by cp.async; each stage completes on an mbarrier and
//   is released by the consumers' arrivals on another. No barrier of the
//   block sits in the key loop, and the consumers issue no load.
// - Products on wgmma: s (64 x block_k) = Q . K^T with both operands in
//   shared memory, acc (64 x Dh) += P . V with P from registers (the score
//   fragment rounded to bf16) and V read N-major. Rows of 32, 64 or 128
//   bytes carry the TMA swizzle of that width (Dh 128: two 64-column
//   regions), which the descriptors name.
// - Overlap: a warpgroup issues tile j+1's Q . K^T, then tile j's P . V,
//   and runs tile j+1's softmax while P . V runs on the tensor cores;
//   block_q 128 puts two warpgroups on one stream of K/V tiles. The ring
//   is 2 to 4 stages deep (as fits 100 KB beside Q).
// - Fewer instructions per score: a tile that ends before Lk, has no
//   causal key after the warp's rows and whose bias row is all zero (the
//   producer's row, one vote a warp) takes its row max over the raw q . k
//   (times the scale after the max: rounding is monotone, so m is the
//   plain version's max) and p = 2^(s * scale * log2 e - m * log2 e), one
//   FMA and one ex2.approx. Other tiles add the bias and the masks in
//   natural units first. o and l are rescaled only when a row max of the
//   warp moved (exact: the correction is 2^0 = 1 otherwise). A warp
//   holding a row with no valid key yet (s == m == -1e30, where p must be
//   exactly 1 and the rounding of m * log2 e would break that) takes the
//   difference s - m first.
// - Causal: key tiles wholly after a query tile are skipped, unless a row
//   of the tile sees no valid key (causal_kv_end).
// What the card then shows (H100, PERF.md §6): at Dh 64 and 128 this body
// is 1.3-1.6x the mma.sync one it replaced and faster than SDPA; at Dh 16
// and L=16384 it is 6-9% faster and still ~2.1x the exponential floor. A
// consumer warp's 64-key tile there takes ~1,600 cycles, ~1,160 of them
// the softmax: the blocks of an SM run in step, so the four warps of a
// scheduler take their 32 ex2 each at once (4 x 256 cycles of the unit)
// and leave it idle through the ~450 cycles of loads, wgmma issue and
// bf16 pack. None of 8 stages, 128- or 256-row tiles, FlashAttention-3's
// ping-pong or a share of the exponentials on the FMA pipe made it more
// than 6% faster (the last two were slower and are not kept).
// One 64-key tile a block (L=64, B*H = 65,536) runs slower than in the
// old body, cause not isolated: there the barriers' set-up and the first
// TMA round trip are paid once for a single tile.
//
// Head dims. The JAX kernel takes any Dh. The compiled widths here are 16,
// 32, 64 and 128 in both dtypes and both modes, and 8 in fp32 (wgmma's
// k-depth is 16 bf16 values, so a bf16 launch at Dh 8 runs padded to 16).
// The wrapper (ops/flash_attention.py) zero-pads any other Dh <= 128 to the
// next compiled width of its dtype: zero columns add nothing to q . k^T,
// and the output columns that v's zero columns give are sliced away. So
// the softmax scale is an argument (1/sqrt of the caller's Dh), not the
// template's width.
// Dh > 128 runs in a library of its own, built with -DFLASH_WIDE (the
// compiled widths above are then left out, and the kernel search never
// builds it): the wrapper zero-pads Dh to Dp, a multiple of 128, and a
// second grid axis walks 256-wide slices of the output's head dim, one for
// Dp = 256. A block computes the whole q . k^T of its key tile over Dp
// once and adds p . v for up to 256 output columns, so every slice of a
// query tile sees the same scores, m and l (K2 writes m and l from slice
// 0), in one launch per call. Both wide kernels keep Q in shared memory
// and stream K and V through a ring: flash_fwd_fp32_wide below on
// register-tiled FMA fed by cp.async, flash_fwd_mma_wide in the header on
// wgmma fed by TMA. Their notes give the bounds.
//
// fp32 inputs at the compiled widths (the fp32 parity legs: no served
// configuration runs them) take flash_fwd_fp32 below: register-tiled FMA
// on the CUDA cores, since a tensor-core fp32 path would be TF32. The
// dispatch chooses by dtype alone.

#include "flash_attention_mma.cuh"

namespace {

namespace simt {  // fp32 on the CUDA cores

// Head dims 8 to 128 in fp32. Replaces _flash_kernel in both modes, as the
// bf16 kernel does.
//
// Bound at B=2 H=2 L=2048: 4 * B*H*L^2 * Dh operations at the CUDA cores'
// 67 TFLOP/s, 0.128 ms at Dh=128 and 0.064 ms at Dh=64, against K1's 33.6
// and 16.8 MB of q, k, v and out (0.010 and 0.005 ms): operations. At Dh=16
// (the ring's shard B=8 H=2 L=4096: 0.256 ms) a score's 32 FMAs come with
// about 8 more instructions of softmax (scale and bias, max, the
// exponential, its sum and the store of p).
//
// Design. A block of 256 threads (16 row groups x 16 lanes) owns a 64-row
// query tile; lane tx of row group ty owns rows 4ty .. 4ty+3.
// - Q lands in shared memory once per block. K, V and the tile's bias row
//   stream through a cp.async ring of key tiles (kStages, kBN keys each),
//   so the next tile loads while this one is multiplied. 128-key tiles at
//   Dh=16 and 64 halve the barriers, row maxima and corrections a key;
//   at Dh=64 that takes 191 KB, one block an SM (at B=2 H=2 L=2048 the
//   grid is 128 blocks, one an SM either way). Dh=128 keeps 64 keys and
//   2 stages (186 KB; 3 would take 254).
// - q . k^T: the thread's 4 x kKeys micro-tile of the score tile, keys
//   tx + 16 jj; per 4 columns, four float4 reads of q (a broadcast across
//   the row group) and kKeys of k from shared memory feed 16 kKeys FMAs.
// - The online softmax runs once per key tile on the micro-tile: the row
//   max over the 16 lanes of a row by warp shuffles, one expf correction a
//   row and tile, p = __expf(s - m) (exactly 1 where s == m == -1e30, 0 past
//   Lk); p goes through shared memory to the P . V product. A tile with no
//   key past Lk and no causal mask skips the per-key tests.
// - P . V: the thread keeps its 4 rows and 4 * kCols output columns (four
//   float4 reads of p and 4 * kCols of v feed 64 * kCols FMAs). Below Dh=64
//   a row group's 16 lanes outnumber the float4 column groups, so the lanes
//   also split the tile's keys into kKeyGroups interleaved 4-key chunks;
//   their partial sums share m and are added by warp shuffles once, at the
//   end. At Dh=8 that is 8 key groups of 2 columns.
// - Both products are unrolled whole (Dh=128: 166-182 registers, no
//   spill); below Dh=64 two blocks fit an SM at 128 registers.
// The wide fp32 kernel below has the same micro-tiles but its own body: its
// 128-column ring units, 256-wide output slices and streamed Q have no use
// at these widths, and the key groups none above them.
constexpr int kFp32Threads = 256;
constexpr int kFp32BM = 64;  // query rows per block

template <int DH>
struct Fp32Tiles {
  static constexpr int kBN = DH == 16 || DH == 64 ? 128 : 64;  // keys per tile
  static constexpr int kKeys = kBN / 16;     // keys of a tile a lane scores
  static constexpr int kPPitch = kBN + 4;    // floats per row of p
  static constexpr int kPitch = DH + 4;  // floats per row of Q, K and V: no bank conflicts
  static constexpr int kStages = DH >= 64 ? 2 : 3;
  static constexpr int kCols = DH >= 64 ? DH / 64 : 1;  // float4 column groups a thread owns
  static constexpr int kColLanes = DH / (4 * kCols);    // lanes of a row across the columns
  static constexpr int kKeyGroups = 16 / kColLanes;     // lanes of a row across a tile's keys
  static constexpr int kChunks = kBN / (4 * kKeyGroups);  // 4-key chunks a key group takes
  static constexpr int kStageFloats = 2 * kBN * kPitch + kBN;  // K, V, bias
  static constexpr int kSmemBytes =
      4 * (kFp32BM * kPitch + kFp32BM * kPPitch + kStages * kStageFloats);
  static_assert(DH % 8 == 0 && DH <= 128 && kColLanes * kKeyGroups == 16,
                "a compiled fp32 width is 8, 16, 32, 64 or 128");
  static_assert(kBN % 16 == 0 && kChunks >= 1, "a tile is whole 4-key chunks of each key group");
  static_assert(kSmemBytes <= 227 * 1024, "the fp32 tiles exceed 227 KB of shared memory");
};

__device__ __forceinline__ float row_max16(float x) {  // over the 16 lanes of a row
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& x) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

// out is fp32 [B,H,Lq,Dh], normalized (K1) or the unnormalized acc (K2);
// m_out and l_out are fp32 [B,H,Lq] in K2 and unused in K1.
template <int DH, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(kFp32Threads, DH < 64 ? 2 : 1)
    flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int H, int Lq, int Lk, int n_qtiles,
                   float scale) {
  using T = Fp32Tiles<DH>;
  constexpr int P = T::kPitch;
  constexpr int BN = T::kBN;
  constexpr int PP = T::kPPitch;
  constexpr int JJ = T::kKeys;
  constexpr int kRowVecs = DH / 4;  // float4 per row

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + kFp32BM * P;
  float* ring = p_s + kFp32BM * PP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int kg = tx / T::kColLanes;  // key group in P . V
  const int cg = tx % T::kColLanes;  // column group in P . V
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kFp32BM;
  const int b = bh / H;
  const float* qp = q + static_cast<size_t>(bh) * Lq * DH;
  const float* kp = k + static_cast<size_t>(bh) * Lk * DH;
  const float* vp = v + static_cast<size_t>(bh) * Lk * DH;
  const float* bp = bias + static_cast<size_t>(b) * Lk;

  const int kv_end = CAUSAL ? causal_kv_end(bp, Lk, q0, kFp32BM) : Lk;
  const int n_tiles = (kv_end + BN - 1) / BN;

  // K, V and bias of key tile j into its stage; keys at or past Lk are
  // zero-filled.
  auto load_tile = [&](int j) {
    const int kv0 = j * BN;
    float* ks = ring + (j % T::kStages) * T::kStageFloats;
    float* vs = ks + BN * P;
    float* bs = vs + BN * P;
    for (int i = tid; i < BN * kRowVecs; i += kFp32Threads) {
      const int r = i / kRowVecs;
      const int c = (i - r * kRowVecs) * 4;
      const bool live = kv0 + r < Lk;
      const size_t src = static_cast<size_t>(live ? kv0 + r : 0) * DH + c;
      mma::cp_async_16(mma::smem_u32(ks + r * P + c), kp + src, live);
      mma::cp_async_16(mma::smem_u32(vs + r * P + c), vp + src, live);
    }
    for (int i = tid; i < BN; i += kFp32Threads)
      mma::cp_async_4(mma::smem_u32(bs + i), bp + min(kv0 + i, Lk - 1), kv0 + i < Lk);
  };

  // Prologue: Q and tile 0 in the first group, then the next stages'.
  for (int i = tid; i < kFp32BM * kRowVecs; i += kFp32Threads) {
    const int r = i / kRowVecs;
    const int c = (i - r * kRowVecs) * 4;
    const bool live = q0 + r < Lq;
    mma::cp_async_16(mma::smem_u32(q_s + r * P + c),
                     qp + static_cast<size_t>(live ? q0 + r : 0) * DH + c, live);
  }
#pragma unroll
  for (int i = 0; i < T::kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    mma::cp_async_commit();
  }

  float4 acc[4][T::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < T::kCols; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m[4], l[4];  // per row: the running max, and this lane's share of the sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BN;
    mma::cp_async_wait<T::kStages - 2>();  // tile j has landed
    __syncthreads();                       // all are done with tile j-1 and its p
    if (j + T::kStages - 1 < n_tiles) load_tile(j + T::kStages - 1);
    mma::cp_async_commit();
    const float* ks = ring + (j % T::kStages) * T::kStageFloats;
    const float* vs = ks + BN * P;
    const float* bs = vs + BN * P;

    // s = q . k^T on the micro-tile
    float s[4][JJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) s[i][jj] = 0.f;
    const float* qr = q_s + 4 * ty * P;
    const float* kr = ks + tx * P;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], c[JJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qr + i * P + d);
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj)
        c[jj] = *reinterpret_cast<const float4*>(kr + 16 * jj * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < JJ; ++jj) {
          float x = s[i][jj];
          x = fmaf(a[i].x, c[jj].x, x);
          x = fmaf(a[i].y, c[jj].y, x);
          x = fmaf(a[i].z, c[jj].z, x);
          s[i][jj] = fmaf(a[i].w, c[jj].w, x);
        }
      }
    }
    // s * scale + bias, keys past Lk count nothing, a causal key after the
    // query scores -1e30; then the online softmax, and p into shared memory.
    float bb[JJ];
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) bb[jj] = bs[tx + 16 * jj];
    // a tile with no key past Lk and, causal, none after its first row's
    // skips the per-key tests (the same for every thread of the block)
    const bool edge = kv0 + BN > Lk || (CAUSAL && kv0 + BN - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
        float sv = s[i][jj] * scale + bb[jj];
        if (edge) {
          const int key = kv0 + tx + 16 * jj;
          if (key >= Lk) {
            sv = -INFINITY;  // p is exactly 0
          } else if (CAUSAL && key > row) {
            sv = kNegInf;
          }
        }
        s[i][jj] = sv;
        mx = fmaxf(mx, sv);
      }
      // the tile holds a key before Lk, so m_new is finite
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < T::kCols; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
        const float p = __expf(s[i][jj] - m_new);
        l[i] += p;
        p_s[(4 * ty + i) * PP + tx + 16 * jj] = p;
      }
    }
    __syncthreads();  // the tile's p is whole

    // acc += p . v over this key group's chunks: keys 4 (kg + kKeyGroups ch)
    // .. +3, columns 4 cg + 64 c
    const float* pr = p_s + 4 * ty * PP;
#pragma unroll
    for (int ch = 0; ch < T::kChunks; ++ch) {
      const int key0 = 4 * (kg + T::kKeyGroups * ch);
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(pr + i * PP + key0);
        pv[i][0] = x.x;
        pv[i][1] = x.y;
        pv[i][2] = x.z;
        pv[i][3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < T::kCols; ++c) {
          const float4 x =
              *reinterpret_cast<const float4*>(vs + (key0 + e) * P + 4 * cg + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[i][c], pv[i][e], x);
        }
      }
    }
  }
  mma::cp_async_wait<0>();  // only empty groups remain

  // Every lane takes part in the shuffles before any row is left out: a
  // warp holds two row groups, and rows past Lq may be in one of them.
  float lr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = row_sum16(l[i]);
#pragma unroll
    for (int o = T::kColLanes; o < 16; o <<= 1) {  // add the key groups' sums
#pragma unroll
      for (int c = 0; c < T::kCols; ++c) {
        acc[i][c].x += __shfl_xor_sync(0xffffffffu, acc[i][c].x, o);
        acc[i][c].y += __shfl_xor_sync(0xffffffffu, acc[i][c].y, o);
        acc[i][c].z += __shfl_xor_sync(0xffffffffu, acc[i][c].z, o);
        acc[i][c].w += __shfl_xor_sync(0xffffffffu, acc[i][c].w, o);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Lq) continue;
    const size_t orow = static_cast<size_t>(bh) * Lq + row;
    if (kg == 0) {
      const float lc = STATS ? 1.f : fmaxf(lr[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < T::kCols; ++c) {
        const float4 a = acc[i][c];
        *reinterpret_cast<float4*>(out + orow * DH + 4 * cg + 64 * c) =
            STATS ? a : make_float4(a.x / lc, a.y / lc, a.z / lc, a.w / lc);
      }
    }
    if constexpr (STATS) {
      if (tx == 0) {
        m_out[orow] = m[i];
        l_out[orow] = lr[i];
      }
    }
  }
}

template <int DH, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   float* m_out, float* l_out, int B, int H, int Lq, int Lk, int causal,
                   float scale, cudaStream_t stream) {
  using T = Fp32Tiles<DH>;
  const int n_qtiles = (Lq + kFp32BM - 1) / kFp32BM;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = causal ? flash_fwd_fp32<DH, true, STATS> : flash_fwd_fp32<DH, false, STATS>;
  if (T::kSmemBytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kFp32Threads, T::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), m_out, l_out, H, Lq, Lk,
      n_qtiles, scale);
  return cudaGetLastError();
}

#ifdef FLASH_WIDE
// Head dims above 128 in fp32: register-tiled FMA on the CUDA cores (no
// TF32). Replaces _flash_kernel in both modes, as the kernels above.
//
// Bound at B=2 H=2 L=2048 Dh=256: 1.72e10 operations at the CUDA cores'
// 67 TFLOP/s, 0.256 ms, against K1's 33.6 MB of q, k, v and out (0.010
// ms): operations.
//
// Design. A block of 256 threads (16 x 16) owns a 64-row query tile and up
// to kWideSlice = 256 output columns (blockIdx.y walks ceil(Dp / 256)
// slices). Thread (ty, tx) owns rows 4ty .. 4ty+3: of the 64 x 64 score
// tile, keys tx + 16 jj (a 4 x 4 micro-tile); of the output, 16 columns
// (four float4 groups, 64 apart, so that a half-warp reads 256 contiguous
// bytes of a V row).
// - Q lands in shared memory once per block (up to kWideQResMax; above it
//   each K unit carries its Q chunk).
// - K and V stream through one cp.async ring of kWideStages stages of
//   128-column units: per key tile the Dp / 128 K chunks, then the slice's
//   one or two V chunks. The next units load while this one is multiplied.
// - q . k^T is computed once per (query tile, key tile) for Dp <= 256, once
//   per slice above it: eight float4 reads of q and k from shared memory
//   feed 64 FMAs of the micro-tile.
// - The online softmax runs on the micro-tile: the row max over the 16
//   threads of a row by warp shuffles; p goes through shared memory (64 x
//   64) to the P . V product, where twelve float4 reads of p and v feed
//   128 FMAs.
// Why one block takes all 256 columns: with a slice of columns a block,
// each slice would recompute q . k^T over all of Dp (2.5x the FMA work at
// Dp=256 for 64-wide slices), and one query row a thread would read
// shared memory once an FMA and leave the card idle at small Lq.
constexpr int kWideThreads = 256;
constexpr int kWideBM = 64;      // query rows per block
constexpr int kWideBN = 64;      // keys per tile
constexpr int kWideUnit = 128;   // columns of a ring unit
constexpr int kWideSlice = 256;  // output columns per block
constexpr int kWideStages = 3;
constexpr int kWidePitch = kWideUnit + 4;  // floats per row of a unit
constexpr int kWidePPitch = kWideBN + 4;   // floats per row of p
constexpr int kWideQResMax = 384;          // Dp up to which Q stays resident

__host__ __device__ constexpr bool wide_q_resident(int Dp) { return Dp <= kWideQResMax; }
__host__ __device__ constexpr int wide_q_floats(int Dp) {
  return wide_q_resident(Dp) ? kWideBM * (Dp + 4) : 0;
}
__host__ __device__ constexpr int wide_stage_rows(int Dp) {
  return kWideBN + (wide_q_resident(Dp) ? 0 : kWideBM);
}
__host__ __device__ constexpr int wide_stage_floats(int Dp) {
  return wide_stage_rows(Dp) * kWidePitch + kWideBN;  // rows, bias
}
__host__ __device__ constexpr int wide_smem_bytes(int Dp) {
  return 4 * (wide_q_floats(Dp) + kWideBM * kWidePPitch + kWideStages * wide_stage_floats(Dp));
}
static_assert(wide_smem_bytes(kWideQResMax) <= 227 * 1024 &&
                  wide_smem_bytes(kWideQResMax + 128) <= 227 * 1024,
              "the wide tiles exceed 227 KB of shared memory");

template <int W, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_fp32_wide(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int H, int Lq, int Lk, int Dp,
                        int n_qtiles, float scale) {
  static_assert(W == kWideSlice, "the output slice is two units wide");
  constexpr int kGroups = W / 64;  // float4 column groups a thread owns

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + wide_q_floats(Dp);
  float* ring = p_s + kWideBM * kWidePPitch;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kWideBM;
  const int slice = blockIdx.y;
  const int b = bh / H;
  const bool q_res = wide_q_resident(Dp);
  const int q_pitch = q_res ? Dp + 4 : kWidePitch;
  const int stage_rows = wide_stage_rows(Dp);
  const int stage_floats = wide_stage_floats(Dp);
  const int n_k = Dp / kWideUnit;                           // K units per key tile
  const int n_v = min(W, Dp - slice * W) / kWideUnit;       // V units: 1 or 2
  const int units = n_k + n_v;
  const float* qp = q + static_cast<size_t>(bh) * Lq * Dp;
  const float* kp = k + static_cast<size_t>(bh) * Lk * Dp;
  const float* vp = v + static_cast<size_t>(bh) * Lk * Dp + slice * W;
  const float* bp = bias + static_cast<size_t>(b) * Lk;

  const int kv_end = CAUSAL ? causal_kv_end(bp, Lk, q0, kWideBM) : Lk;
  const int n_tiles = (kv_end + kWideBN - 1) / kWideBN;
  const int total = n_tiles * units;

  // n_rows rows of kWideUnit columns from a [*, Dp] source, rows from row0;
  // a row at or past live_rows is zero-filled.
  auto copy_rows = [&](float* dst, const float* src, int row0, int live_rows, int n_rows) {
    for (int i = tid; i < n_rows * (kWideUnit / 4); i += kWideThreads) {
      const int r = i / (kWideUnit / 4);
      const int c = (i % (kWideUnit / 4)) * 4;
      const bool live = row0 + r < live_rows;
      mma::cp_async_16(mma::smem_u32(dst + r * kWidePitch + c),
                       src + static_cast<size_t>(live ? row0 + r : 0) * Dp + c, live);
    }
  };
  // Unit u of key tile j: K chunk u (with its Q chunk when Q is not
  // resident; the tile's bias rides with its last K chunk), else V chunk
  // u - n_k of the slice.
  auto load_unit = [&](int gu) {
    const int j = gu / units;
    const int u = gu - j * units;
    const int kv0 = j * kWideBN;
    float* st = ring + (gu % kWideStages) * stage_floats;
    if (u < n_k) {
      copy_rows(st, kp + u * kWideUnit, kv0, Lk, kWideBN);
      if (!q_res) copy_rows(st + kWideBN * kWidePitch, qp + u * kWideUnit, q0, Lq, kWideBM);
      if (u == n_k - 1) {
        float* bs = st + stage_rows * kWidePitch;
        for (int i = tid; i < kWideBN; i += kWideThreads)
          mma::cp_async_4(mma::smem_u32(bs + i), bp + min(kv0 + i, Lk - 1), kv0 + i < Lk);
      }
    } else {
      copy_rows(st, vp + (u - n_k) * kWideUnit, kv0, Lk, kWideBN);
    }
  };

  // Prologue: the resident Q and unit 0 in the first group, then unit 1.
  if (q_res) {
    const int chunks = Dp / 4;
    for (int i = tid; i < kWideBM * chunks; i += kWideThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 4;
      const bool live = q0 + r < Lq;
      mma::cp_async_16(mma::smem_u32(q_s + r * q_pitch + c),
                       qp + static_cast<size_t>(live ? q0 + r : 0) * Dp + c, live);
    }
  }
#pragma unroll
  for (int i = 0; i < kWideStages - 1; ++i) {
    if (i < total) load_unit(i);
    mma::cp_async_commit();
  }

  float4 acc[4][kGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kGroups; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float s[4][4];
  float m[4], l[4];  // per row: the running max, and this thread's share of the sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  int gu = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kWideBN;
    for (int u = 0; u < units; ++u, ++gu) {
      mma::cp_async_wait<kWideStages - 2>();  // unit gu has landed
      __syncthreads();                        // all are done with unit gu-1 (and p)
      if (gu + kWideStages - 1 < total) load_unit(gu + kWideStages - 1);
      mma::cp_async_commit();
      const float* st = ring + (gu % kWideStages) * stage_floats;
      if (u < n_k) {
        if (u == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
        }
        // s += q . k^T over this chunk's 128 columns
        const float* qr = (q_res ? q_s + u * kWideUnit : st + kWideBN * kWidePitch) +
                          4 * ty * q_pitch;
        const float* kr = st + tx * kWidePitch;
#pragma unroll 4
        for (int d = 0; d < kWideUnit; d += 4) {
          float4 a[4], c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(qr + i * q_pitch + d);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            c[jj] = *reinterpret_cast<const float4*>(kr + 16 * jj * kWidePitch + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float x = s[i][jj];
              x = fmaf(a[i].x, c[jj].x, x);
              x = fmaf(a[i].y, c[jj].y, x);
              x = fmaf(a[i].z, c[jj].z, x);
              s[i][jj] = fmaf(a[i].w, c[jj].w, x);
            }
          }
        }
        if (u < n_k - 1) continue;
        // The tile's scores are whole: s * scale + bias, keys past Lk count
        // nothing, a causal key after the query scores -1e30; then the
        // online softmax, and p into shared memory.
        const float* bs = st + stage_rows * kWidePitch;
        float bb[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bb[jj] = bs[tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + 4 * ty + i;
          float mx = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int key = kv0 + tx + 16 * jj;
            float sv = s[i][jj] * scale + bb[jj];
            if (key >= Lk) {
              sv = -INFINITY;  // p is exactly 0
            } else if (CAUSAL && key > row) {
              sv = kNegInf;
            }
            s[i][jj] = sv;
            mx = fmaxf(mx, sv);
          }
          // the tile holds a key before Lk, so m_new is finite
          const float m_new = fmaxf(m[i], row_max16(mx));
          const float corr = expf(m[i] - m_new);
          m[i] = m_new;
          l[i] *= corr;
#pragma unroll
          for (int c = 0; c < kGroups; ++c) {
            acc[i][c].x *= corr;
            acc[i][c].y *= corr;
            acc[i][c].z *= corr;
            acc[i][c].w *= corr;
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float p = expf(s[i][jj] - m_new);
            l[i] += p;
            p_s[(4 * ty + i) * kWidePPitch + tx + 16 * jj] = p;
          }
        }
      } else {
        // acc += p . v over V chunk u - n_k of the slice: the thread's
        // columns tx * 4 + 64 ci of it, groups 2 (u - n_k) + ci.
        const int vu = u - n_k;
        const float* pr = p_s + 4 * ty * kWidePPitch;
        const float* vr = st + 4 * tx;
#pragma unroll
        for (int h = 0; h < W / kWideUnit; ++h) {
          if (h != vu) continue;  // h is a constant: acc stays in registers
#pragma unroll 2
          for (int j0 = 0; j0 < kWideBN; j0 += 4) {
            float p[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 x = *reinterpret_cast<const float4*>(pr + i * kWidePPitch + j0);
              p[i][0] = x.x;
              p[i][1] = x.y;
              p[i][2] = x.z;
              p[i][3] = x.w;
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
              for (int ci = 0; ci < 2; ++ci) {
                const float4 x =
                    *reinterpret_cast<const float4*>(vr + (j0 + jj) * kWidePitch + 64 * ci);
#pragma unroll
                for (int i = 0; i < 4; ++i) fma4(acc[i][2 * h + ci], p[i][jj], x);
              }
            }
          }
        }
      }
    }
  }
  mma::cp_async_wait<0>();  // only empty groups remain

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = row_sum16(l[i]);
    const int row = q0 + 4 * ty + i;
    if (row >= Lq) continue;
    const size_t orow = static_cast<size_t>(bh) * Lq + row;
    const float lc = STATS ? 1.f : fmaxf(li, 1e-30f);
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      if (c / 2 >= n_v) continue;
      const int col = slice * W + (c / 2) * kWideUnit + (c % 2) * 64 + 4 * tx;
      const float4 a = acc[i][c];
      *reinterpret_cast<float4*>(out + orow * Dp + col) =
          STATS ? a : make_float4(a.x / lc, a.y / lc, a.z / lc, a.w / lc);
    }
    if constexpr (STATS) {
      if (slice == 0 && tx == 0) {
        m_out[orow] = m[i];
        l_out[orow] = li;
      }
    }
  }
}

template <bool STATS>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* bias, void* out,
                        float* m_out, float* l_out, int B, int H, int Lq, int Lk, int Dp,
                        int causal, float scale, cudaStream_t stream) {
  const int n_qtiles = (Lq + kWideBM - 1) / kWideBM;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  const int slices = (Dp + kWideSlice - 1) / kWideSlice;
  if (blocks <= 0 || blocks > INT_MAX || Dp % kWideUnit != 0 || slices > 65535)
    return cudaErrorInvalidValue;
  auto kernel = causal ? flash_fwd_fp32_wide<kWideSlice, true, STATS>
                       : flash_fwd_fp32_wide<kWideSlice, false, STATS>;
  const int smem = wide_smem_bytes(Dp);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slices));
  kernel<<<grid, kWideThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), m_out, l_out, H, Lq, Lk, Dp,
      n_qtiles, scale);
  return cudaGetLastError();
}
#endif  // FLASH_WIDE

}  // namespace simt

// dtype 0 = fp32 (register-tiled FMA), 1 = bf16 (the tensor-core kernel,
// which compiles no Dh 8: the wrapper pads bf16 Dh 8 to 16).
template <int DH, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   float* m_out, float* l_out, int B, int H, int Lq, int Lk, int dtype,
                   int causal, float scale, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return simt::launch<DH, STATS>(q, k, v, bias, out, m_out, l_out, B, H, Lq, Lk, causal,
                                       scale, stream);
    case 1:
      if constexpr (DH == 8) {
        return cudaErrorInvalidValue;
      } else {
        return mma::launch<DH, STATS>(q, k, v, bias, out, m_out, l_out, B, H, Lq, Lk, causal,
                                      scale, stream);
      }
    default:
      return cudaErrorInvalidValue;
  }
}

// The compiled head dims: 16, 32, 64 and 128 in both dtypes, and 8 in fp32.
// The wrapper zero-pads any other Dh <= 128 to the next of them and passes
// the real Dh's scale.
template <bool STATS>
int dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
             void* m_out, void* l_out, int B, int H, int Lq, int Lk, int Dh, int dtype,
             int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  if (causal && Lq != Lk) return cudaErrorInvalidValue;
  if (!(scale > 0.f) || !std::isfinite(scale)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
#ifdef FLASH_WIDE
  // Dh: the padded head dim, a multiple of 128 above 128.
  if (Dh <= 128 || Dh % 128 != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return simt::launch_wide<STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, Dh, causal,
                                        scale, s);
    case 1:
      return mma::launch_wide<STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, Dh, causal, scale,
                                     s);
    default:
      return cudaErrorInvalidValue;
  }
#else
  switch (Dh) {
    case 8:
      return launch<8, STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, dtype, causal, scale, s);
    case 16:
      return launch<16, STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, dtype, causal, scale, s);
    case 32:
      return launch<32, STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, dtype, causal, scale, s);
    case 64:
      return launch<64, STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, dtype, causal, scale, s);
    case 128:
      return launch<128, STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, dtype, causal, scale,
                                s);
    default:
      return cudaErrorInvalidValue;
  }
#endif
}

}  // namespace

// K1. q, out: [B, H, Lq, Dh]; k, v: [B, H, Lk, Dh], all contiguous, in one
// dtype (0 = fp32, 1 = bf16); bias: [B, Lk] fp32; Dh one of the compiled
// widths (with -DFLASH_WIDE: a multiple of 128 above 128); scale the
// softmax scale (1/sqrt of the unpadded head dim).
// Launches on `stream` and returns cudaGetLastError() after the launch (0
// on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int B, int H, int Lq,
                                   int Lk, int Dh, int dtype, int causal, float scale,
                                   void* stream) {
  return dispatch<false>(q, k, v, bias, out, nullptr, nullptr, B, H, Lq, Lk, Dh, dtype,
                         causal, scale, stream);
}

// K2. As K1, but writes acc: [B, H, Lq, Dh] fp32 (unnormalized) and m, l:
// [B, H, Lq] fp32, all contiguous.
extern "C" int flash_attention_stats_fwd(const void* q, const void* k, const void* v,
                                         const void* bias, void* acc, void* m, void* l,
                                         int B, int H, int Lq, int Lk, int Dh, int dtype,
                                         int causal, float scale, void* stream) {
  return dispatch<true>(q, k, v, bias, acc, m, l, B, H, Lq, Lk, Dh, dtype, causal, scale,
                        stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
