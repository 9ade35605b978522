// K3: the batched Levenshtein DP, one thread per string pair.
//
// Replaces the batched DP of vainplex_openclaw_tpu/ops/similarity.py
// (_batch_levenshtein_jax, a lax.scan over DP rows vmapped over pairs; an
// XLA program, not a Pallas kernel). Its plain version,
// ops/similarity.py::levenshtein_rows_reference, is the vectorized row DP
// with a cummin prefix minimum: about 11 small tensor operations per DP row,
// ~1400 launches a call at L=128, which on an H100 took 10.8-12.1 ms at 32,
// 256 and 4096 pairs alike: bound by the host's launches, not by the card.
//
// The work is integer and tiny: each pair needs len_a * len_b DP cells of a
// few integer operations, and reads its two token rows once, so the card's
// bound is microseconds. This first kernel is the straightforward DP: one
// thread walks its pair's rows (b) and columns (a) in order, with its DP
// row kept in shared memory as uint16 (distances are at most L <= 512) and
// its string a staged there as int32, both laid out [column][thread] so the
// 32 threads of a block (one warp) touch consecutive addresses. One launch
// replaces the ~1400. Its time is one thread's serial chain of
// len_a * len_b dependent steps; a warp per pair along anti-diagonals, or
// the bit-parallel form, would shorten it.
//
// Semantics: the padded DP of the reference. Tokens are bytes + 1 with 0 as
// padding, a and b are [n, L] int32 row-major with their tokens as a
// prefix of len_a / len_b; the distance of pair p is the Levenshtein
// distance of a[p, :len_a[p]] and b[p, :len_b[p]]. (The padded DP reads
// column len_a after rows 1..len_b; columns past len_a and rows past len_b
// never reach that cell, so it is this distance exactly.)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxL = 512;

__global__ void __launch_bounds__(kThreads)
levenshtein_rows(const int* __restrict__ a, const int* __restrict__ b,
                 const int* __restrict__ len_a, const int* __restrict__ len_b,
                 int* __restrict__ out, int n, int L) {
  extern __shared__ int smem[];
  int* as = smem;                                               // [L][kThreads]
  uint16_t* row = reinterpret_cast<uint16_t*>(smem + L * kThreads);  // [L + 1][kThreads]
  const int t = threadIdx.x;
  const int first = blockIdx.x * kThreads;
  const int count = min(kThreads, n - first);
  // stage the block's a rows, coalesced, transposed to [column][thread]
  for (int idx = t; idx < count * L; idx += kThreads) {
    const int who = idx / L, col = idx % L;
    as[col * kThreads + who] = a[(size_t)(first + who) * L + col];
  }
  __syncthreads();
  const int p = first + t;
  if (p >= n) return;
  const int la = min(max(len_a[p], 0), L), lb = min(max(len_b[p], 0), L);
  for (int j = 0; j <= la; ++j) row[j * kThreads + t] = static_cast<uint16_t>(j);
  const int* bp = b + (size_t)p * L;
  for (int i = 1; i <= lb; ++i) {
    const int cb = bp[i - 1];
    int diag = row[t];                          // prev[0] = i - 1
    int left = i;
    row[t] = static_cast<uint16_t>(i);
    for (int j = 1; j <= la; ++j) {
      const int up = row[j * kThreads + t];
      const int cost = as[(j - 1) * kThreads + t] != cb;
      const int val = min(min(up + 1, left + 1), diag + cost);
      row[j * kThreads + t] = static_cast<uint16_t>(val);
      diag = up;
      left = val;
    }
  }
  out[p] = row[la * kThreads + t];
}

}  // namespace

// a, b: int32 [n, L]; len_a, len_b: int32 [n]; out: int32 [n]; all
// contiguous on the card. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int levenshtein_fwd(const void* a, const void* b, const void* len_a,
                               const void* len_b, void* out, int n, int L, void* stream) {
  if (n <= 0 || L <= 0 || L > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (sizeof(int) * L + sizeof(uint16_t) * (L + 1)) * kThreads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(levenshtein_rows,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  levenshtein_rows<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b), static_cast<const int*>(len_a),
      static_cast<const int*>(len_b), static_cast<int*>(out), n, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* levenshtein_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
