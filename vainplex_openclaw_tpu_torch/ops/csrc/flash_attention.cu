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
// and differ only in the epilogue (the STATS flag).
//
// Bound on an H100. K1 at the short serve path's shape (B=32, H=4, L=64,
// Dh=16, bf16) must move q, k, v and out once, 4*B*H*L*Dh*2 bytes
// (~1.05 MB) plus the fp32 bias row (8 KB): ~0.32 us at 3.35 TB/s. Its
// 4*B*H*L*L*Dh operations (~33.5 MFLOP) take ~0.03 us at the bf16 tensor
// rate. So K1 there is bound by bytes, and in practice by the launch. K2
// at the long serve path's shape (B=8, H=2, L=16384, Dh=16, bf16) does
// 4*B*H*L*L*Dh = 2.75e11 operations, 0.278 ms at 989 TFLOP/s, against
// ~44.6 MB of q, k, v, acc, m, l and bias (0.013 ms): bound by operations.
//
// What the design does about it. One thread block per (batch*head,
// 64-row query tile); each of its 64 threads owns one query row, with q
// and the fp32 accumulator in registers (Dh is a template parameter, so
// both arrays are fully unrolled). K and V tiles are staged in shared
// memory in their input dtype by 16-byte copies, and every thread reads
// the same key at the same time (a broadcast, no bank conflict). Each
// input byte is read from device memory once per query tile (once in all
// when Lq <= 64, as on the short path) and each output byte is written
// once; the scores never leave registers. The dot products run on the
// CUDA cores, not the tensor cores: right for K1's byte-bound shape, and
// the reason K2, whose shape is bound by operations, runs far from its
// bound (mma/wgmma is the later redesign). The kernel masks its own ragged
// edge (keys at or past Lk contribute exactly 0, query rows at or past Lq
// idle) instead of the TPU's padding, and skips key tiles wholly after a
// causal query tile. So in K2 a row whose every key is masked has m = -1e30
// (finite) and l = the number of real keys it walked, where the TPU kernel
// counts its padded keys too. At Dh=128 in fp32, q and acc take 256
// registers and spill; no path of the repo runs that shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlockM = 64;  // query rows per block, one per thread
constexpr int kChunk = 16;   // keys per online-softmax step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Keys per shared-memory tile: K and V tiles together stay at 32 KB.
template <typename T, int DH>
__host__ __device__ constexpr int block_n() {
  return DH * static_cast<int>(sizeof(T)) <= 256 ? 64 : 32;
}

// out is T [B,H,Lq,Dh] (K1) or fp32 acc [B,H,Lq,Dh] (K2); m_out and l_out
// are fp32 [B,H,Lq] in K2 and unused in K1.
template <typename T, int DH, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(kBlockM)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     void* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int H, int Lq, int Lk,
                     int n_qtiles, float scale) {
  constexpr int BN = block_n<T, DH>();
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16 B
  constexpr int kRowVecs = DH / kVec;
  static_assert(DH % kVec == 0, "a row must be a whole number of 16 B");

  __shared__ __align__(16) unsigned char k_raw[BN * DH * sizeof(T)];
  __shared__ __align__(16) unsigned char v_raw[BN * DH * sizeof(T)];
  __shared__ float b_s[BN];
  T* k_s = reinterpret_cast<T*>(k_raw);
  T* v_s = reinterpret_cast<T*>(v_raw);

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockM;
  const int b = bh / H;
  const int row = q0 + threadIdx.x;
  const bool active = row < Lq;

  const T* kp = k + static_cast<size_t>(bh) * Lk * DH;
  const T* vp = v + static_cast<size_t>(bh) * Lk * DH;
  const float* bp = bias + static_cast<size_t>(b) * Lk;

  float qr[DH];
  float acc[DH];
  {
    __align__(16) T qt[DH];
    if (active) {
      const uint4* src = reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(bh) * Lq + row) * DH);
#pragma unroll
      for (int i = 0; i < kRowVecs; ++i) reinterpret_cast<uint4*>(qt)[i] = src[i];
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qr[d] = active ? to_float(qt[d]) : 0.f;
      acc[d] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // Under causality no key at or past the tile's last row + 1 can count.
  const int kv_end = CAUSAL ? min(Lk, q0 + kBlockM) : Lk;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BN) {
    const int n = min(BN, kv_end - kv0);
    __syncthreads();  // every thread is done with the previous tile
    {
      const uint4* kg = reinterpret_cast<const uint4*>(kp + static_cast<size_t>(kv0) * DH);
      const uint4* vg = reinterpret_cast<const uint4*>(vp + static_cast<size_t>(kv0) * DH);
      uint4* ks4 = reinterpret_cast<uint4*>(k_s);
      uint4* vs4 = reinterpret_cast<uint4*>(v_s);
      const int live = n * kRowVecs;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
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
          const T* kr = k_s + j * DH;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], to_float(kr[d]), dot);
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
          const float pr = to_float(from_float<T>(p));
          const T* vr = v_s + j * DH;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] = fmaf(pr, to_float(vr[d]), acc[d]);
        }
      }
      m = m_new;
    }
  }

  if (!active) return;
  const size_t orow = static_cast<size_t>(bh) * Lq + row;
  if constexpr (STATS) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + orow * DH);
#pragma unroll
    for (int i = 0; i < DH / 4; ++i)
      dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    m_out[orow] = m;
    l_out[orow] = l;
  } else {
    const float lc = fmaxf(l, 1e-30f);
    __align__(16) T o[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = from_float<T>(acc[d] / lc);
    uint4* dst = reinterpret_cast<uint4*>(static_cast<T*>(out) + orow * DH);
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) dst[i] = reinterpret_cast<const uint4*>(o)[i];
  }
}

template <typename T, int DH, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, float* m_out, float* l_out, int B, int H, int Lq,
                   int Lk, int causal, cudaStream_t stream) {
  const int n_qtiles = (Lq + kBlockM - 1) / kBlockM;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kBlockM);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* bt = static_cast<const float*>(bias);
  if (causal) {
    flash_fwd_kernel<T, DH, true, STATS><<<grid, block, 0, stream>>>(
        qt, kt, vt, bt, out, m_out, l_out, H, Lq, Lk, n_qtiles, scale);
  } else {
    flash_fwd_kernel<T, DH, false, STATS><<<grid, block, 0, stream>>>(
        qt, kt, vt, bt, out, m_out, l_out, H, Lq, Lk, n_qtiles, scale);
  }
  return cudaGetLastError();
}

template <typename T, bool STATS>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, const void* bias,
                        void* out, float* m_out, float* l_out, int B, int H, int Lq,
                        int Lk, int Dh, int causal, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<T, 16, STATS>(q, k, v, bias, out, m_out, l_out, B, H, Lq, Lk, causal, stream);
    case 32:
      return launch<T, 32, STATS>(q, k, v, bias, out, m_out, l_out, B, H, Lq, Lk, causal, stream);
    case 64:
      return launch<T, 64, STATS>(q, k, v, bias, out, m_out, l_out, B, H, Lq, Lk, causal, stream);
    case 128:
      return launch<T, 128, STATS>(q, k, v, bias, out, m_out, l_out, B, H, Lq, Lk, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool STATS>
int dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
             void* m_out, void* l_out, int B, int H, int Lq, int Lk, int Dh, int dtype,
             int causal, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  if (causal && Lq != Lk) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
  switch (dtype) {
    case 0:
      return dispatch_dh<float, STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, Dh, causal, s);
    case 1:
      return dispatch_dh<__nv_bfloat16, STATS>(q, k, v, bias, out, m, l, B, H, Lq, Lk, Dh,
                                               causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K1. q, out: [B, H, Lq, Dh]; k, v: [B, H, Lk, Dh], all contiguous, in one
// dtype (0 = fp32, 1 = bf16); bias: [B, Lk] fp32. Launches on `stream` and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int B, int H, int Lq,
                                   int Lk, int Dh, int dtype, int causal, void* stream) {
  return dispatch<false>(q, k, v, bias, out, nullptr, nullptr, B, H, Lq, Lk, Dh, dtype,
                         causal, stream);
}

// K2. As K1, but writes acc: [B, H, Lq, Dh] fp32 (unnormalized) and m, l:
// [B, H, Lq] fp32, all contiguous.
extern "C" int flash_attention_stats_fwd(const void* q, const void* k, const void* v,
                                         const void* bias, void* acc, void* m, void* l,
                                         int B, int H, int Lq, int Lk, int Dh, int dtype,
                                         int causal, void* stream) {
  return dispatch<true>(q, k, v, bias, acc, m, l, B, H, Lq, Lk, Dh, dtype, causal, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
