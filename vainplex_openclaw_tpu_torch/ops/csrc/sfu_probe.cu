// Throughput probe of the two per-score instructions of the bf16 attention
// kernel (flash_attention_mma.cuh) that do not run on the FMA pipes:
// ex2.approx.ftz.f32 (p = 2^x, one per score) and cvt.rn.bf16x2.f32 (p
// rounded to bf16 for the PV product, one per two scores). chip_smoke.py
// times it on every SM at full occupancy: the card's own exponential rate
// sets the floor of attention at Dh=16, and the interleaved mode shows
// whether the two instructions share one unit. No path of the port calls it.
// On an H100 80GB HBM3 at 700 W it read 4.20e12 ex2 a second (16 per clock
// per SM at ~1.99 GHz) and 1.60e13 cvt a second, and the two interleaved
// ran at the ex2 rate: the conversion has a unit of its own.
//
// op 0: ex2 alone; op 1: cvt alone; op 2: one ex2 and one cvt per step.
// Each thread runs kChains independent chains of `iters` steps, so one
// launch does blocks * threads * iters * kChains steps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChains = 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to bf16 twice into one bf16x2, read back as an fp32 close to x.
__device__ __forceinline__ float cvt_bf16x2(float x) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = 2^-x converges to ~0.64, so every chain stays finite.
template <int OP>
__global__ void __launch_bounds__(1024) sfu_loop(float* __restrict__ out, int iters) {
  float x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = 0.5f + 1e-3f * c + 1e-6f * threadIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (OP != 1) x[c] = ex2(-x[c]);
      if (OP != 0) x[c] = cvt_bf16x2(x[c]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += x[c];
  out[static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// out: fp32 [blocks * threads]. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int sfu_probe(int op, int blocks, int threads, int iters, void* out, void* stream) {
  if (op < 0 || op > 2 || blocks <= 0 || threads <= 0 || threads > 1024 || iters <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (op == 0)
    sfu_loop<0><<<blocks, threads, 0, s>>>(o, iters);
  else if (op == 1)
    sfu_loop<1><<<blocks, threads, 0, s>>>(o, iters);
  else
    sfu_loop<2><<<blocks, threads, 0, s>>>(o, iters);
  return static_cast<int>(cudaGetLastError());
}
