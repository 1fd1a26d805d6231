// Batched global Needleman-Wunsch with in-kernel traceback, for Hopper
// (sm_90a). Built with nvcc into a plain C library and bound with ctypes
// (mapcaller_tpu_torch/ops/nw_device.py::nw_ops).
//
// Replaces mapcaller_tpu/ops/nw_device.py::build_nw_kernel (the Pallas
// TPU kernel, pallas_call at :136, row math _row_sweep :54-80) and its
// XLA partner build_nw_traceback (:186-214). Same function: x2-scaled
// integer scoring (match +2, mismatch -2, OPEN -2, EXTEND -1, NEW -3),
// ties resolved s==r (left) first, then s==t (up), else diagonal; the
// traceback from (m, n) emits 2-bit ops, 3 once both indices reach 0,
// packed 16 per 32-bit word, little end first; score at (m, n), or
// MAXPEN when m == 0 (the Pallas kernel never writes a row-0 score).
//
// Design. One thread walks one pair, row by row, over the (m+1) x (n+1)
// cells the traceback can reach (a cell depends only on cells above and
// left of it, so the padded tier M x N beyond (m, n) is never computed).
// The current row of s and t lives in the thread's local memory and is
// updated in place; the horizontal-gap state is one running max, as in
// the Pallas kernel's cummax collapse. Directions are packed 16 to a word
// into a scratch buffer the wrapper allocates, laid out [row][word][pair]
// so neighbouring threads write neighbouring words. The traceback runs in
// the same thread, so only the op words and the score leave the kernel:
// the Pallas kernel's unpacked int32 direction matrix (which Mosaic
// forced) and the separate traceback dispatch are gone.
//
// Bound on this card: about 10 integer operations per DP cell (two adds
// and a max for t, an add and a compare for the diagonal, a max for c,
// an add for r, a max for s, two compares for the direction, the running
// max), so ops = 10 * sum over pairs of (m+1)(n+1) — at most
// 10 * B*(M+1)*(N+1) for a full tier — against the H100's int32 issue
// rate (64 INT32 lanes per SM, half the FP32 lanes: 16.7 T ops/s);
// bytes = the inputs (B*M + B*N codes, 8 B of lengths per pair) plus the
// outputs (B*(M+N)/16 words and B scores) over 3.35 TB/s. The operations
// bound. chip_smoke.py computes it from each run's own lengths. The
// kernel is far from either: each thread's serial row walk leaves most
// lanes of the card idle at these batch sizes and its rows sit in local
// memory. A faster design — a warp per pair sweeping anti-diagonals or
// the cummax form across lanes, with direction tiles in shared memory —
// is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXPEN = -131072;
constexpr int OPENG = -2;
constexpr int EXTG = -1;
constexpr int NEWG = -3;
constexpr int MAX_N = 256;          // longest second side a thread holds
constexpr int THREADS = 128;

__global__ void nw_ops_kernel(const uint8_t* __restrict__ c1,
                              const uint8_t* __restrict__ c2,
                              const int32_t* __restrict__ mlen,
                              const int32_t* __restrict__ nlen,
                              int B, int M, int N,
                              uint32_t* __restrict__ dirs,
                              uint32_t* __restrict__ words,
                              int32_t* __restrict__ score) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int m = min(max(mlen[b], 0), M);
  const int n = min(max(nlen[b], 0), N);
  const int wpr = (N + 16) >> 4;     // direction words per DP row
  const size_t Bs = (size_t)B;
  auto dir_at = [&](int i, int w) -> uint32_t& {
    return dirs[((size_t)i * wpr + w) * Bs + b];
  };

  int s[MAX_N + 1];
  int t[MAX_N + 1];
  uint8_t q[MAX_N];
  for (int j = 0; j < n; ++j) q[j] = c2[(size_t)b * N + j];

  // row 0: s = OPEN + j*EXT, t = MAXPEN; every j > 0 is "left" (1)
  s[0] = 0;
  t[0] = 0;
  for (int j = 1; j <= n; ++j) {
    s[j] = OPENG + j * EXTG;
    t[j] = MAXPEN;
  }
  for (int w = 0; w <= (n >> 4); ++w) dir_at(0, w) = w ? 0x55555555u : 0x55555554u;

  int sc = MAXPEN;
  for (int i = 1; i <= m; ++i) {
    const uint8_t a = c1[(size_t)b * M + i - 1];
    const int s_b0 = OPENG + i * EXTG;   // column-0 boundary
    int sp_left = s[0];                  // s of the previous row, column j-1
    s[0] = s_b0;
    t[0] = s_b0;
    int run = s_b0;                      // max over k < j of c[k] - k*EXT
    uint32_t word = 2u;                  // column 0 resolves to "up" (s == t)
    for (int j = 1; j <= n; ++j) {
      const int sp = s[j];
      const int tc = max(t[j] + EXTG, sp + NEWG);
      const int diag = sp_left + (a == q[j - 1] ? 2 : -2);
      const int c = max(diag, tc);
      const int r = NEWG + (j - 1) * EXTG + run;
      const int sv = max(r, c);
      const uint32_t d = sv == r ? 1u : (sv == tc ? 2u : 0u);
      word |= d << ((j & 15) * 2);
      if ((j & 15) == 15) {
        dir_at(i, j >> 4) = word;
        word = 0u;
      }
      run = max(run, c - j * EXTG);
      s[j] = sv;
      t[j] = tc;
      sp_left = sp;
    }
    if ((n & 15) != 15) dir_at(i, n >> 4) = word;
    if (i == m) sc = s[n];
  }

  // traceback from (m, n): diag/up step i, diag/left step j
  int i = m;
  int j = n;
  const int nwords = (M + N) >> 4;
  for (int w = 0; w < nwords; ++w) {
    uint32_t out = 0u;
    for (int k = 0; k < 16; ++k) {
      uint32_t d = 3u;
      if (i > 0 || j > 0) {
        d = (dir_at(i, j >> 4) >> ((j & 15) * 2)) & 3u;
        if (d != 1u) --i;
        if (d != 2u) --j;
      }
      out |= d << (k * 2);
    }
    words[(size_t)b * nwords + w] = out;
  }
  score[b] = sc;
}

}  // namespace

// c1 uint8[B, M], c2 uint8[B, N], m/n int32[B]; dirs: scratch of
// (M+1) * ceil((N+1)/16) * B words; words uint32[B, (M+N)/16];
// score int32[B]. Launches on `stream`; returns cudaGetLastError().
extern "C" int mc_nw_ops(const void* c1, const void* c2, const void* m,
                         const void* n, int B, int M, int N, void* dirs,
                         void* words, void* score, void* stream) {
  if (B <= 0) return 0;
  if (M < 0 || N < 0 || N > MAX_N || (M + N) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + THREADS - 1) / THREADS;
  nw_ops_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)c1, (const uint8_t*)c2, (const int32_t*)m,
      (const int32_t*)n, B, M, N, (uint32_t*)dirs, (uint32_t*)words,
      (int32_t*)score);
  return (int)cudaGetLastError();
}
