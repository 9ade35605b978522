// Exact attention forward on Hopper (sm_90a): the normalized output (K1)
// and the stats mode that ring attention merges (K2).
//
// Replaces the TPU kernel vainplex_openclaw_tpu/ops/flash_attention.py::
// _flash_kernel in both of its modes. Same arithmetic: per key tile,
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
// four times that on a unit of its own. At Dh=16 the exponentials, and the
// fp32 softmax arithmetic around them on the CUDA cores, set the floor,
// not the products. At the short serve shape
// (B=32, H=4, L=64) the ~1.06 MB of bytes bound it (0.3 us), in practice
// the launch.
//
// What the bf16 design (flash_attention_mma.cuh) does about each.
// - Products: both run on mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//   Each warp owns 16 query rows; its q fragments are loaded once with
//   ldmatrix, k fragments with ldmatrix and v fragments with ldmatrix.trans.
//   The fp32 score fragment is rounded to bf16 in registers and is the A
//   fragment of the PV product: scores never touch shared memory. At
//   Dh=16 a key tile's q . k^T is one k-step, so mma.sync is enough to
//   keep the products under the exponential floor; wgmma is not needed.
// - Bytes: K, V and the tile's bias row move by cp.async (16-byte copies,
//   zero-filled past Lk) into a ring of 3 shared-memory stages (2 at
//   Dh=128), so the next tiles load while this one computes; rows are
//   padded by 16 bytes so that ldmatrix has no bank conflicts. Each input
//   byte is read once per query tile and each output written once.
//   The tiles (64 query rows, 64 keys) are -D defines; the block table
//   (ops/flash_block_table.json) may name others per length bucket.
// - Exponentials: one fused multiply-add and one ex2.approx per score,
//   p = 2^(s * log2 e - m * log2 e), and one ex2 per row and tile for the
//   correction. The row max is taken over s in natural units across the
//   quad of lanes that shares a row, so m is the plain version's max of
//   the same scores. A warp holding a row with no valid key yet (s == m ==
//   -1e30, where p must be exactly 1 and the rounding of m * log2 e would
//   break that) takes the difference s - m first: one fp32 op more.
// - Causal: key tiles wholly after a query tile are skipped, unless a row
//   of the tile sees no valid key (causal_kv_end).
//
// Head dims. The JAX kernel takes any Dh. The compiled widths here are 8,
// 16, 32, 64 and 128 in both dtypes and both modes; at Dh=8 the bf16
// kernel takes q . k^T on mma.sync m16n8k8 and P . V on one n8 tile. The
// wrapper (ops/flash_attention.py) zero-pads any other Dh <= 128 to the
// next compiled width: zero columns add nothing to q . k^T, and the output
// columns that v's zero columns give are sliced away. So the softmax scale
// is an argument (1/sqrt of the caller's Dh), not the template's width.
// Dh > 128 runs in a library of its own, built with -DFLASH_WIDE (the
// compiled widths above are then left out, and the kernel search never
// builds it): the wrapper zero-pads Dh to Dp, a multiple of 128, and a
// second grid axis walks slices of the output's head dim. Each block
// computes the whole q . k^T of its key tile over Dp in chunks and adds p . v
// for its own slice, so every slice of a query tile sees the same scores,
// m and l (K2 writes m and l from slice 0), in one launch per call. Those
// kernels (flash_fwd_fp32_wide below, flash_fwd_mma_wide in the header) load
// their tiles without a ring: right first, not yet fast.
//
// fp32 inputs (the parity paths: no served configuration runs them) take
// the scalar walk below: one thread per query row, the dot products on the
// CUDA cores, since a tensor-core fp32 path would be TF32. The dispatch
// chooses by dtype alone. At Dh=128 in fp32, q and acc take 256 registers
// and spill; no path of the repo runs that shape.

#include "flash_attention_mma.cuh"

namespace {

namespace scalar {

constexpr int kBlockM = 64;  // query rows per block, one per thread
constexpr int kChunk = 16;   // keys per online-softmax step

// out is fp32 [B,H,Lq,Dh], normalized (K1) or the unnormalized acc (K2);
// m_out and l_out are fp32 [B,H,Lq] in K2 and unused in K1.
template <int DH, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(kBlockM)
    flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int H, int Lq, int Lk, int n_qtiles,
                   float scale) {
  constexpr int BN = DH <= 64 ? 64 : 32;  // keys per tile: K and V stay at 32 KB
  constexpr int kRowVecs = DH / 4;  // float4 per row

  __shared__ __align__(16) float k_s[BN * DH];
  __shared__ __align__(16) float v_s[BN * DH];
  __shared__ float b_s[BN];

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockM;
  const int b = bh / H;
  const int row = q0 + threadIdx.x;
  const bool active = row < Lq;

  const float* kp = k + static_cast<size_t>(bh) * Lk * DH;
  const float* vp = v + static_cast<size_t>(bh) * Lk * DH;
  const float* bp = bias + static_cast<size_t>(b) * Lk;

  float qr[DH];
  float acc[DH];
  {
    const float* src = q + (static_cast<size_t>(bh) * Lq + (active ? row : 0)) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qr[d] = active ? src[d] : 0.f;
      acc[d] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  const int kv_end = CAUSAL ? causal_kv_end(bp, Lk, q0, kBlockM) : Lk;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BN) {
    const int n = min(BN, kv_end - kv0);
    __syncthreads();  // every thread is done with the previous tile
    {
      const float4* kg = reinterpret_cast<const float4*>(kp + static_cast<size_t>(kv0) * DH);
      const float4* vg = reinterpret_cast<const float4*>(vp + static_cast<size_t>(kv0) * DH);
      float4* ks4 = reinterpret_cast<float4*>(k_s);
      float4* vs4 = reinterpret_cast<float4*>(v_s);
      const int live = n * kRowVecs;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = threadIdx.x; i < BN * kRowVecs; i += kBlockM) {
        ks4[i] = i < live ? kg[i] : zero;
        vs4[i] = i < live ? vg[i] : zero;
      }
      for (int j = threadIdx.x; j < BN; j += kBlockM) b_s[j] = j < n ? bp[kv0 + j] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    for (int c = 0; c < n; c += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c + jj;
        float sv = -INFINITY;  // past the tile's end: p is exactly 0
        if (j < n) {
          const float* kr = k_s + j * DH;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
          sv = dot * scale + b_s[j];
          if (CAUSAL && kv0 + j > row) sv = kNegInf;
        }
        s[jj] = sv;
        cmax = fmaxf(cmax, sv);
      }
      // c < n, so the chunk holds a live key and m_new is finite.
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c + jj;
        if (j < n) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float* vr = v_s + j * DH;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
        }
      }
      m = m_new;
    }
  }

  if (!active) return;
  const size_t orow = static_cast<size_t>(bh) * Lq + row;
  float4* dst = reinterpret_cast<float4*>(out + orow * DH);
  const float lc = STATS ? 1.f : fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    if constexpr (STATS) {
      dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    } else {
      dst[i] = make_float4(acc[4 * i] / lc, acc[4 * i + 1] / lc, acc[4 * i + 2] / lc,
                           acc[4 * i + 3] / lc);
    }
  }
  if constexpr (STATS) {
    m_out[orow] = m;
    l_out[orow] = l;
  }
}

template <int DH, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   float* m_out, float* l_out, int B, int H, int Lq, int Lk, int causal,
                   float scale, cudaStream_t stream) {
  const int n_qtiles = (Lq + kBlockM - 1) / kBlockM;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = causal ? flash_fwd_fp32<DH, true, STATS> : flash_fwd_fp32<DH, false, STATS>;
  kernel<<<static_cast<unsigned>(blocks), kBlockM, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), m_out, l_out, H, Lq, Lk,
      n_qtiles, scale);
  return cudaGetLastError();
}

#ifdef FLASH_WIDE
constexpr int kWideBN = 32;  // keys per tile
constexpr int kWideW = 64;   // head-dim chunk of q . k^T and output slice

// One thread per query row as above, a slice of kWideW output columns per
// block (blockIdx.y): acc holds the slice only, and q . k^T sums over Dp in
// kWideW-wide chunks of q (from global memory) and k (in shared memory),
// so no row of Dp values sits in registers.
template <int W, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(kBlockM)
    flash_fwd_fp32_wide(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int H, int Lq, int Lk, int Dp,
                        int n_qtiles, float scale) {
  constexpr int kRowVecs = W / 4;  // float4 per row of a chunk

  __shared__ __align__(16) float k_s[kWideBN * W];
  __shared__ __align__(16) float v_s[kWideBN * W];
  __shared__ float b_s[kWideBN];

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockM;
  const int slice = blockIdx.y;
  const int b = bh / H;
  const int row = q0 + threadIdx.x;
  const bool active = row < Lq;
  const int n_chunks = Dp / W;

  const float* kp = k + static_cast<size_t>(bh) * Lk * Dp;
  const float* vp = v + static_cast<size_t>(bh) * Lk * Dp + slice * W;
  const float* bp = bias + static_cast<size_t>(b) * Lk;
  const float* qrow = q + (static_cast<size_t>(bh) * Lq + (active ? row : 0)) * Dp;

  float acc[W];
#pragma unroll
  for (int d = 0; d < W; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int kv_end = CAUSAL ? causal_kv_end(bp, Lk, q0, kBlockM) : Lk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kv0 = 0; kv0 < kv_end; kv0 += kWideBN) {
    const int n = min(kWideBN, kv_end - kv0);
    float s[kWideBN];
#pragma unroll
    for (int j = 0; j < kWideBN; ++j) s[j] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // every thread is done with the last chunk (and tile)
      float4* ks4 = reinterpret_cast<float4*>(k_s);
      float4* vs4 = reinterpret_cast<float4*>(v_s);
      for (int i = threadIdx.x; i < kWideBN * kRowVecs; i += kBlockM) {
        const int r = i / kRowVecs;
        const size_t src = static_cast<size_t>(kv0 + r) * Dp + (i % kRowVecs) * 4;
        ks4[i] = r < n ? *reinterpret_cast<const float4*>(kp + src + c * W) : zero;
        if (c == 0) vs4[i] = r < n ? *reinterpret_cast<const float4*>(vp + src) : zero;
      }
      if (c == 0) {
        for (int j = threadIdx.x; j < kWideBN; j += kBlockM) b_s[j] = j < n ? bp[kv0 + j] : 0.f;
      }
      __syncthreads();
      if (active) {
        float qr[W];
        const float4* qsrc = reinterpret_cast<const float4*>(qrow + c * W);
#pragma unroll
        for (int i = 0; i < kRowVecs; ++i) {
          const float4 x = qsrc[i];
          qr[4 * i] = x.x;
          qr[4 * i + 1] = x.y;
          qr[4 * i + 2] = x.z;
          qr[4 * i + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < kWideBN; ++j) {  // unrolled: s stays in registers
          const float* kr = k_s + j * W;
          float dot = s[j];
#pragma unroll
          for (int d = 0; d < W; ++d) dot = fmaf(qr[d], kr[d], dot);
          s[j] = dot;
        }
      }
    }
    if (!active) continue;  // the next tile's loads wait at __syncthreads above
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kWideBN; ++j) {
      float sv = -INFINITY;  // past the tile's end: p is exactly 0
      if (j < n) {
        sv = s[j] * scale + b_s[j];
        if (CAUSAL && kv0 + j > row) sv = kNegInf;
      }
      s[j] = sv;
      cmax = fmaxf(cmax, sv);
    }
    // n >= 1, so the tile holds a live key and m_new is finite.
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < W; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kWideBN; ++j) {
      if (j < n) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float* vr = v_s + j * W;
#pragma unroll
        for (int d = 0; d < W; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
    }
    m = m_new;
  }

  if (!active) return;
  const size_t orow = static_cast<size_t>(bh) * Lq + row;
  float4* dst = reinterpret_cast<float4*>(out + orow * Dp + slice * W);
  const float lc = STATS ? 1.f : fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    dst[i] = make_float4(acc[4 * i] / lc, acc[4 * i + 1] / lc, acc[4 * i + 2] / lc,
                         acc[4 * i + 3] / lc);
  }
  if constexpr (STATS) {
    if (slice == 0) {
      m_out[orow] = m;
      l_out[orow] = l;
    }
  }
}

template <bool STATS>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* bias, void* out,
                        float* m_out, float* l_out, int B, int H, int Lq, int Lk, int Dp,
                        int causal, float scale, cudaStream_t stream) {
  const int n_qtiles = (Lq + kBlockM - 1) / kBlockM;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX || Dp % kWideW != 0 || Dp / kWideW > 65535)
    return cudaErrorInvalidValue;
  auto kernel = causal ? flash_fwd_fp32_wide<kWideW, true, STATS>
                       : flash_fwd_fp32_wide<kWideW, false, STATS>;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(Dp / kWideW));
  kernel<<<grid, kBlockM, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), m_out, l_out, H, Lq, Lk, Dp,
      n_qtiles, scale);
  return cudaGetLastError();
}
#endif  // FLASH_WIDE

}  // namespace scalar

// dtype 0 = fp32 (the scalar walk), 1 = bf16 (the tensor-core kernel).
template <int DH, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   float* m_out, float* l_out, int B, int H, int Lq, int Lk, int dtype,
                   int causal, float scale, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return scalar::launch<DH, STATS>(q, k, v, bias, out, m_out, l_out, B, H, Lq, Lk, causal,
                                       scale, stream);
    case 1:
      return mma::launch<DH, STATS>(q, k, v, bias, out, m_out, l_out, B, H, Lq, Lk, causal,
                                    scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The compiled head dims: 8, 16, 32, 64 and 128. The wrapper zero-pads any
// other Dh <= 128 to the next of them and passes the real Dh's scale.
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
      return scalar::launch_wide<STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, Dh, causal,
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
