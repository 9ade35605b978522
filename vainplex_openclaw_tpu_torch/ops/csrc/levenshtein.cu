// K3: the batched Levenshtein distance, bit-parallel, one warp per pair.
//
// Stands in for the batched DP of vainplex_openclaw_tpu/ops/similarity.py
// (_batch_levenshtein_jax, :273, a lax.scan over DP rows vmapped over pairs;
// an XLA program, not a Pallas kernel). Its plain version,
// ops/similarity.py::levenshtein_rows_reference, is the vectorized row DP
// with a cummin prefix minimum: ~11 small tensor operations per DP row,
// bound on the card by the host's launches.
//
// Semantics: a and b are [n, L] int32 row-major, any int32 tokens, the
// lengths clamped to [0, L]; the distance of pair p is the Levenshtein
// distance of a[p, :len_a[p]] and b[p, :len_b[p]], which is what the
// reference's padded DP reads at column len_a after row len_b. Tokens past
// the lengths change nothing. Any L: L only sets the row stride.
//
// What bounds it. The work is integer with no matrix product, so wgmma and
// the tensor cores do not apply; the card's bound is the bytes of the two
// token rows (microseconds). What held the first, one-thread-per-pair
// kernel far above that was one serial chain of len_a * len_b shared-memory
// steps per pair, with only n threads running (4096 pairs are 128 warps on
// a card that holds 8448). What bounds this one is the issue rate of the
// integer pipe (64 lanes an SM a clock, half the rate of the other pipes):
// every column step is a few dozen warp instructions, and at 4096 pairs
// the SMs' schedulers are full. The resources that matter are warps in
// flight, registers, shared memory, and warp votes and shuffles.
//
// The design: Myers' bit-vector algorithm (1999) in Hyyro's form for the
// global distance. The column of vertical deltas D[i][j] - D[i-1][j] over
// a's positions is kept as two bit-vectors, VP (+1) and VN (-1), W =
// ceil(len_a / 32) words of 32 bits. Each token c of b is one word step per
// word:
//   Eq = the positions i with a[i] == c
//   Xv = Eq | VN;  Xh = (((Eq & VP) + VP) ^ VP) | Eq
//   HP = VN | ~(Xh | VP);  HN = VP & Xh
//   HP = HP << 1 | 1;  HN = HN << 1           (the 1: D[0][j] = j)
//   VP = HN | ~(Xv | HP);  VN = HP & Xv
// where the add and the shifts run over the whole W-word vector: the add's
// carry and the shifts' top bits pass from word k to word k + 1. Carries
// and shifts only move bits up, so bits at len_a and above (padding in the
// last word, idle lanes) never reach a bit below. The distance is read once
// at the end, down the last column: D[len_a][len_b] = len_b + popc(VP) -
// popc(VN) over the bits below len_a, summed over the lanes; no step keeps
// a score. The work is len_b * W word steps instead of len_a * len_b cells,
// and a pair's dependent chain is len_b steps.
//
// Mapping. One warp per pair, lane k holding word k of VP and VN; pairs do
// not share a warp (at L=128, W <= 4 leaves lanes idle, but 4096 pairs are
// still only 4096 warps). The add's carry crosses lanes as a carry-lookahead
// over two ballots: each lane forms its word's sum without carry-in, g =
// its carry out and p = (sum == ~0); the carries into the lanes are the
// bits of ((G | P) + G + carry_in) ^ P over the ballots G and P. The
// shifts' top bits cross lanes as two more ballots, taken in by a funnel
// shift. Eq for the next column is fetched while this one is computed.
//
// Eq is option (b), a per-pair Peq table in shared memory over the byte
// alphabet that tokenize_fixed produces (tokens 0..256; any other token of
// b reads a row of zeros): one shared load a column. It was measured
// against option (a), W ballots a column over a's tokens in registers,
// which takes any int32 token: at L=512 the table was 2.2x faster at 32
// pairs and 1.8x at 4096, though its 16.4 KB a warp at L=512 leaves 12
// warps an SM. The table does not limit the domain: a band of a whose
// tokens leave 0..256 takes option (a)'s ballots instead, decided per warp,
// so the kernel keeps the semantics above for every int32 token and the
// wrapper needs no check. a's tokens are read once from global memory in
// coalesced 128-byte lines, b's 32 at a time, one token a column by
// shuffle.
//
// Any length. A warp holds kWords <= 32 words (1024 tokens of a) at a time.
// A longer a is taken in bands of kWords words, band by band over all of
// b: the state of word k at column j depends only on word k at column j - 1
// and on the carry and shifted bits from word k - 1 at column j, so the
// band order computes the same vector. Between bands each column's carry
// out and top bits of HP and HN (3 bits) go through `edge`, scratch the
// wrapper allocates (levenshtein_edge_words), read back by the next band.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxWords = 32;  // a band: one word per lane
// Peq rows: tokens 0..256 (tokenize_fixed's bytes + 1, 0 for padding), and
// one row of zeros that every other token of b reads
constexpr int kRows = 257;
constexpr unsigned kFull = 0xffffffffu;

// One band of a (lane k holding word k) against all of b; returns the
// band's share of the distance, the sum over its words of VP's bits less
// VN's bits below len_a in the last column (D[len_a][len_b] = len_b + the
// vertical deltas down that column). With kTable, a column's Eq is one
// shared load from the band's Peq table; without, kWords ballots over ar.
// Without kFirst, each column's carry into word 0 and bits shifted into HP
// and HN come from `ep`, which the band below wrote; without kLast, the
// band writes its own there.
template <int kWords, bool kTable, bool kFirst, bool kLast>
__device__ __forceinline__ int walk_band(const int* __restrict__ bp, int lb,
                                         const int (&ar)[kWords], const unsigned* peq,
                                         unsigned* ep, int edge_stride, int lane,
                                         unsigned valid) {
  const int up = 31 - lane;  // moves bit `lane` of a ballot to bit 31
  const unsigned* row = peq + lane;
  unsigned vp = kFull, vn = 0;
  for (int j0 = 0; j0 < lb; j0 += 32) {
    const int bt = j0 + lane < lb ? bp[j0 + lane] : 0;
    // this lane's token's row: a token outside the table reads the zero row
    const int bt_row = min(static_cast<unsigned>(bt), static_cast<unsigned>(kRows)) * kWords;
    auto eq_of = [&](int jj) -> unsigned {
      if constexpr (kTable) {
        // a row holds kWords words: lanes past them would read the next
        // row's, or past the warp's table, so they take 0
        const int at = __shfl_sync(kFull, bt_row, jj);
        return lane < kWords ? row[at] : 0u;
      }
      const int c = __shfl_sync(kFull, bt, jj);
      unsigned eq = 0;
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const unsigned m = __ballot_sync(kFull, ar[k] == c);
        if (lane == k) eq = m;
      }
      return eq;
    };
    // the chunk's inputs from the band below, one bit a column, shifted out
    // as the columns pass (the first band: 0, 1, 0)
    unsigned in_c = 0, in_hp = kFull, in_hn = 0;
    if (!kFirst) {
      const unsigned v = lane < 3 ? ep[lane * edge_stride + (j0 >> 5)] : 0u;
      in_c = __shfl_sync(kFull, v, 0);
      in_hp = __shfl_sync(kFull, v, 1);
      in_hn = __shfl_sync(kFull, v, 2);
    }
    unsigned out_c = 0, out_hp = 0, out_hn = 0;
    const int steps = min(32, lb - j0);
    unsigned eq_next = eq_of(0);  // one column ahead
    for (int jj = 0; jj < steps; ++jj) {
      const unsigned eq = eq_next;
      eq_next = eq_of((jj + 1) & 31);
      const unsigned xv = eq | vn;
      const unsigned lo = (eq & vp) + vp;  // the word's sum without carry-in
      const unsigned g = __ballot_sync(kFull, lo < vp);
      const unsigned pr = __ballot_sync(kFull, lo == kFull);
      unsigned carries;  // bit k: the carry into word k
      if constexpr (kLast) {
        carries = ((g | pr) + g + (in_c & 1u)) ^ pr;
      } else {
        const unsigned long long c =
            (static_cast<unsigned long long>(g | pr) + g + (in_c & 1u)) ^ pr;
        carries = static_cast<unsigned>(c);
        out_c |= static_cast<unsigned>((c >> kWords) & 1u) << jj;
      }
      const unsigned xh = ((lo + ((carries >> lane) & 1u)) ^ vp) | eq;
      unsigned hp = vn | ~(xh | vp);
      unsigned hn = vp & xh;
      const unsigned tp = __ballot_sync(kFull, hp >> 31);
      const unsigned tn = __ballot_sync(kFull, hn >> 31);
      if constexpr (!kLast) {
        out_hp |= ((tp >> (kWords - 1)) & 1u) << jj;
        out_hn |= ((tn >> (kWords - 1)) & 1u) << jj;
      }
      // shift by one across the words: lane k takes bit 31 of word k - 1,
      // lane 0 the band below's bit
      hp = __funnelshift_l(((tp << 1) | (in_hp & 1u)) << up, hp, 1);
      hn = __funnelshift_l(((tn << 1) | (in_hn & 1u)) << up, hn, 1);
      vp = hn | ~(xv | hp);
      vn = hp & xv;
      if constexpr (!kFirst) {
        in_c >>= 1;
        in_hp >>= 1;
        in_hn >>= 1;
      }
    }
    if (!kLast && lane < 3)
      ep[lane * edge_stride + (j0 >> 5)] = lane == 0 ? out_c : lane == 1 ? out_hp : out_hn;
  }
  int d = __popc(vp & valid) - __popc(vn & valid);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
  return d;
}

template <int kWords, bool kTable>
__device__ __forceinline__ int walk(const int* __restrict__ bp, int lb, const int (&ar)[kWords],
                                    const unsigned* peq, unsigned* ep, int edge_stride,
                                    int band, int bands, int lane, unsigned valid) {
  if (bands == 1)
    return walk_band<kWords, kTable, true, true>(bp, lb, ar, peq, ep, edge_stride, lane, valid);
  if constexpr (kWords == kMaxWords) {  // only a row past one band has more
    if (band == 0)
      return walk_band<kWords, kTable, true, false>(bp, lb, ar, peq, ep, edge_stride, lane,
                                                    valid);
    if (band < bands - 1)
      return walk_band<kWords, kTable, false, false>(bp, lb, ar, peq, ep, edge_stride, lane,
                                                     valid);
    return walk_band<kWords, kTable, false, true>(bp, lb, ar, peq, ep, edge_stride, lane, valid);
  }
  return 0;
}

template <int kWords>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
levenshtein_bits(const int* __restrict__ a, const int* __restrict__ b,
                 const int* __restrict__ len_a, const int* __restrict__ len_b,
                 int* __restrict__ out, unsigned* __restrict__ edge, int n, int L) {
  extern __shared__ unsigned peq_all[];  // [warp][kRows + 1][kWords]
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  unsigned* peq = peq_all + (threadIdx.x >> 5) * (kRows + 1) * kWords;
  if (p >= n) return;  // the whole warp
  const int la = min(max(len_a[p], 0), L), lb = min(max(len_b[p], 0), L);
  if (la == 0 || lb == 0) {
    if (lane == 0) out[p] = la + lb;
    return;
  }
  const int* ap = a + static_cast<size_t>(p) * L;
  const int* bp = b + static_cast<size_t>(p) * L;
  const int words = (la + 31) >> 5;
  const int bands = (words + kWords - 1) / kWords;
  const int edge_stride = (L + 31) >> 5;  // one word per 32 columns of b
  unsigned* ep = edge + static_cast<size_t>(p) * 3 * edge_stride;  // bands > 1 only
  int score = lb;
  for (int band = 0; band < bands; ++band) {
    const int w0 = band * kWords;
    // this lane's word's positions below len_a (none past the band's words)
    const int below = la - (w0 + lane) * 32;
    const unsigned valid = lane >= kWords || below <= 0 ? 0u
                           : below >= 32 ? kFull : (1u << below) - 1u;
    int ar[kWords];
    bool in_table = true;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int pos = (w0 + k) * 32 + lane;
      ar[k] = pos < la ? ap[pos] : 0;
      in_table &= static_cast<unsigned>(ar[k]) < kRows;
    }
    if (__all_sync(kFull, in_table)) {
      // Peq: bit i of row t, word k, is set where a[32 (w0 + k) + i] == t;
      // positions past len_a read 0 and only set bits that `valid` drops
      for (int i = lane; i < (kRows + 1) * kWords; i += 32) peq[i] = 0u;
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        if (w0 + k < words) atomicOr(&peq[ar[k] * kWords + k], 1u << lane);
      __syncwarp();
      score += walk<kWords, true>(bp, lb, ar, peq, ep, edge_stride, band, bands, lane, valid);
      __syncwarp();  // every lane's last read before the next band's table
    } else {
      score += walk<kWords, false>(bp, lb, ar, peq, ep, edge_stride, band, bands, lane, valid);
    }
  }
  if (lane == 0) out[p] = score;
}

// Words of a band: the fewest of 4, 16 and 32 that hold a row of L tokens
// (a's tokens in registers and the Peq table scale with it); past 1024
// tokens, bands of 32.
int band_words(int L) {
  const int words = (L + 31) / 32;
  return words <= 4 ? 4 : words <= 16 ? 16 : kMaxWords;
}

template <int kWords>
int launch(const void* a, const void* b, const void* len_a, const void* len_b, void* out,
           void* edge, int n, int L, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int smem = static_cast<int>(sizeof(unsigned)) * (kRows + 1) * kWords * kWarpsPerBlock;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        levenshtein_bits<kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  levenshtein_bits<kWords><<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      static_cast<const int*>(a), static_cast<const int*>(b), static_cast<const int*>(len_a),
      static_cast<const int*>(len_b), static_cast<int*>(out), static_cast<unsigned*>(edge), n,
      L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The uint32 words of scratch `edge` that levenshtein_fwd needs for n rows
// of L tokens: 3 bits per column of b between bands, 0 when a row fits one
// band (L <= 1024).
extern "C" long long levenshtein_edge_words(int n, int L) {
  if (n <= 0 || L <= 32 * kMaxWords) return 0;
  return 3LL * n * ((L + 31) / 32);
}

// a, b: int32 [n, L]; len_a, len_b: int32 [n]; out: int32 [n]; edge:
// levenshtein_edge_words(n, L) uint32 words (may be null when that is 0);
// all contiguous on the card. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int levenshtein_fwd(const void* a, const void* b, const void* len_a,
                               const void* len_b, void* out, void* edge, int n, int L,
                               void* stream) {
  if (n <= 0 || L <= 0 || (levenshtein_edge_words(n, L) > 0 && edge == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (band_words(L)) {
    case 4: return launch<4>(a, b, len_a, len_b, out, edge, n, L, s);
    case 16: return launch<16>(a, b, len_a, len_b, out, edge, n, L, s);
    default: return launch<kMaxWords>(a, b, len_a, len_b, out, edge, n, L, s);
  }
}

extern "C" const char* levenshtein_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
