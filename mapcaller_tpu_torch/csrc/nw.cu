// Batched global Needleman-Wunsch with in-kernel traceback, for Hopper
// (sm_90a). Built with nvcc into a plain C library and bound with ctypes
// (mapcaller_tpu_torch/ops/nw_device.py::nw_ops, which also computes the
// launch geometry: nw_geometry).
//
// Replaces mapcaller_tpu/ops/nw_device.py::build_nw_kernel (:84-163, the
// Pallas TPU kernel, pallas_call at :136, row math _row_sweep :54-80) and
// its XLA partner build_nw_traceback (:186-214). Same function: x2-scaled
// integer scoring (match +2, mismatch -2, OPEN -2, EXTEND -1, NEW -3),
// ties resolved s==r (left, 1) first, then s==t (up, 2), else diagonal
// (0); column 0 resolves to up and row 0 to left; the traceback from
// (m, n) emits 2-bit ops, 3 once both indices reach 0, packed 16 per
// 32-bit word, little end first; score at (m, n), or MAXPEN when m == 0
// (the Pallas kernel never writes a row-0 score).
//
// Design. A group of L lanes (8, 16 or 32; a warp holds 32/L groups)
// aligns one pair; a block holds P groups. Lane l owns columns
// [1 + l*C, 1 + l*C + C) of the DP row, C <= 8; column 0 is the boundary,
// a formula of the row. The lane keeps s, t and the s2 codes of its
// columns in registers and walks rows 1..m in the Pallas kernel's cummax
// form: with E = EXTEND > NEW the horizontal-gap recurrence collapses to
//     r[j] = NEW + (j-1)*E + max_{k<j} (c[k] - k*E),  c = max(diag, t),
// so one row is (1) the left neighbour's s of the previous row by one
// shuffle, (2) t, diag, c per column, (3) a local running max over the
// chunk, (4) an exclusive max-scan of the chunk maxima across the group
// (log2 L shuffles), (5) r, s and the direction per column. Scores are
// held shifted by their column (x - j*E), which takes the per-column
// term out of the scan and of r. Each lane writes its chunk's 2*C
// direction bits as one uint16 per row into dynamic shared memory, laid
// out [row][thread of the block] so a warp's stores are one conflict-free
// 64-byte line; no direction leaves the SM. After the sweep one lane of
// the group walks the traceback from (m, n) in shared memory, builds each
// op word in a register and stores it; the lane holding column n stores
// the score. nw_geometry picks the fewest lanes whose chunks of <= 8
// columns hold N, so the small tiers put 4 (N <= 64) or 2 (N <= 128)
// pairs in a warp.
//
// Bound on this card: about 10 integer operations per DP cell (two adds
// and a max for t, an add and a compare for the diagonal, a max for c,
// an add for r, a max for s, two compares for the direction, the running
// max), so ops = 10 * sum over pairs of (m+1)(n+1), against the H100's
// int32 issue rate (64 INT32 lanes per SM: 16.7 T ops/s); bytes = the
// inputs and outputs over 3.35 TB/s. The operations bound; chip_smoke.py
// computes it from each run's own lengths. What holds the kernel above
// it: a pair's critical path is m rows of dependent work (a shuffle for
// the diagonal, log2 L + 1 shuffle-and-max steps, a few dependent maxes)
// plus m + n dependent shared-memory loads of the traceback, which a few
// thousand pairs (some 16 warps per SM) cannot hide; each row also costs
// the group's scan and its store on top of the cells, and lanes past
// column n (rows past m, for the other groups of a warp) issue work that
// is thrown away. The design keeps every row in registers and shared
// memory, loads the row's s1 code one row ahead, and makes chunks as wide
// as the uint16 allows, which buys the fewest scan steps per cell.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXPEN = -131072;
constexpr int OPENG = -2;
constexpr int EXTG = -1;
constexpr int NEWG = -3;
constexpr int MAX_N = 256;          // longest second side (lanes * chunk)
constexpr int MAX_CHUNK = 8;        // columns a lane holds: 2 bits each in a uint16
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a block can use
constexpr unsigned FULL = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(256)
nw_ops_kernel(const uint8_t* __restrict__ c1, const uint8_t* __restrict__ c2,
              const int32_t* __restrict__ mlen,
              const int32_t* __restrict__ nlen, int B, int M, int N, int L,
              uint32_t* __restrict__ words, int32_t* __restrict__ score) {
  // Scores are held shifted by column, x' = x - j*EXTG: then row 0 is
  // flat, the diagonal gains -EXTG, and r' = NEWG - EXTG + max_{k<j} c'[k]
  // needs no per-column term. Comparisons, and so directions, are unchanged.
  constexpr int MATCH = 2 - EXTG;
  constexpr int MISMATCH = -2 - EXTG;
  constexpr int RBASE = NEWG - EXTG;
  extern __shared__ uint16_t dirs[];      // [row 1..M][thread of the block]
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & (L - 1);         // lane in its group
  const int b = blockIdx.x * (T / L) + tid / L;
  const bool valid = b < B;               // a ragged last block still shuffles
  const int m = valid ? min(max(mlen[b], 0), M) : 0;
  const int n = valid ? min(max(nlen[b], 0), N) : 0;
  const int j0 = 1 + lane * C;            // first column of this lane

  int q[C], s[C], t[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    q[k] = j <= n ? c2[(size_t)b * N + j - 1] : 4;
    s[k] = OPENG;                         // row 0: OPENG + j*EXTG, shifted
    t[k] = MAXPEN - j * EXTG;
  }

  const int rows = __reduce_max_sync(FULL, m);   // warp-uniform row count
  int a = m > 0 ? c1[(size_t)b * M] : 0;
  int sc = MAXPEN;
  for (int i = 1; i <= rows; ++i) {
    const int a_next = i < m ? c1[(size_t)b * M + i] : 0;
    const int sb0 = OPENG + i * EXTG;     // s at column 0 of row i
    // (1) s of the previous row at the column left of this chunk
    int left = __shfl_up_sync(FULL, s[C - 1], 1, L);
    if (lane == 0) left = i == 1 ? 0 : sb0 - EXTG;
    // (2) t, diagonal and c; (3) the chunk's running max of c
    int tc[C], c[C], run[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      tc[k] = max(t[k] + EXTG, s[k] + NEWG);
      c[k] = max(left + (a == q[k] ? MATCH : MISMATCH), tc[k]);
      left = s[k];
      run[k] = k ? max(run[k - 1], c[k]) : c[k];
    }
    // (4) exclusive max-scan of the chunk maxima over the group's lanes;
    // column 0 contributes c[0] = sb0 to every lane
    int x = run[C - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (d < L) {
        const int y = __shfl_up_sync(FULL, x, d, L);
        if (lane >= d) x = max(x, y);
      }
    }
    x = __shfl_up_sync(FULL, x, 1, L);
    const int ex = lane ? max(x, sb0) : sb0;
    // (5) r, s and the direction per column
    uint32_t bits = 0u;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int r = RBASE + (k ? max(ex, run[k - 1]) : ex);
      const int sv = max(r, c[k]);
      bits |= (sv == r ? 1u : (sv == tc[k] ? 2u : 0u)) << (2 * k);
      s[k] = sv;
      t[k] = tc[k];
    }
    dirs[(i - 1) * T + tid] = (uint16_t)bits;
    if (i == m) {
#pragma unroll
      for (int k = 0; k < C; ++k)
        if (j0 + k == n) sc = s[k] + n * EXTG;
    }
    a = a_next;
  }

  __syncwarp();                           // the group's direction stores
  if (!valid) return;
  if (lane == (n > 0 ? (n - 1) / C : 0))
    score[b] = m == 0 ? MAXPEN : (n == 0 ? OPENG + m * EXTG : sc);
  if (lane != 0) return;

  // traceback from (m, n): diag/up step i, diag/left step j. Column j's
  // bits are field (j-1) % C of lane (j-1) / C, tracked as j moves.
  const uint16_t* g = dirs + tid;         // lane 0: the group's first thread
  const int nwords = (M + N) >> 4;
  uint32_t* out = words + (size_t)b * nwords;
  int i = m;
  int j = n;
  int off = (m - 1) * T;                  // row i's offset
  int col = n > 0 ? (n - 1) / C : 0;
  int fld = n > 0 ? (n - 1) % C : 0;
  for (int w = 0; w < nwords; ++w) {
    if (i == 0 && j == 0) {               // past the start: all op 3
      out[w] = 0xffffffffu;
      continue;
    }
    uint32_t word = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      uint32_t d;
      if (i > 0 && j > 0) {
        d = (g[off + col] >> (2 * fld)) & 3u;
      } else {
        d = i > 0 ? 2u : (j > 0 ? 1u : 3u);
      }
      if (!(d & 1u)) {                    // 0 or 2
        --i;
        off -= T;
      }
      if (d <= 1u) {                      // 0 or 1
        --j;
        if (--fld < 0) {
          fld = C - 1;
          --col;
        }
      }
      word |= d << (2 * k);
    }
    out[w] = word;
  }
}

template <int C>
int launch(const void* c1, const void* c2, const void* m, const void* n,
           int B, int M, int N, int lanes, int pairs, int smem, void* words,
           void* score, cudaStream_t stream) {
  static int opted_in = 48 * 1024;        // dynamic shared memory allowed so far
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_ops_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const int blocks = (B + pairs - 1) / pairs;
  nw_ops_kernel<C><<<blocks, lanes * pairs, smem, stream>>>(
      (const uint8_t*)c1, (const uint8_t*)c2, (const int32_t*)m,
      (const int32_t*)n, B, M, N, lanes, (uint32_t*)words, (int32_t*)score);
  return (int)cudaGetLastError();
}

}  // namespace

// c1 uint8[B, M], c2 uint8[B, N], m/n int32[B]; words uint32[B, (M+N)/16];
// score int32[B]. Geometry from nw_device.py::nw_geometry: `lanes` per
// pair, `chunk` columns per lane, `pairs` per block and `smem` bytes of
// dynamic shared memory (M rows x lanes*pairs threads x 2 B); a geometry
// the kernel cannot take returns cudaErrorInvalidValue. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int mc_nw_ops(const void* c1, const void* c2, const void* m,
                         const void* n, int B, int M, int N, int lanes,
                         int chunk, int pairs, int smem, void* words,
                         void* score, void* stream) {
  if (B <= 0) return 0;
  const long threads = (long)lanes * pairs;
  if (M < 0 || N < 0 || N > MAX_N || (M + N) % 16 != 0 ||
      (lanes != 8 && lanes != 16 && lanes != 32) || chunk < 1 ||
      chunk > MAX_CHUNK || lanes * chunk < N || pairs < 1 ||
      threads % 32 != 0 || threads > 256 || smem != M * threads * 2 ||
      smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (chunk) {
    case 1: return launch<1>(c1, c2, m, n, B, M, N, lanes, pairs, smem, words, score, st);
    case 2: return launch<2>(c1, c2, m, n, B, M, N, lanes, pairs, smem, words, score, st);
    case 3: return launch<3>(c1, c2, m, n, B, M, N, lanes, pairs, smem, words, score, st);
    case 4: return launch<4>(c1, c2, m, n, B, M, N, lanes, pairs, smem, words, score, st);
    case 5: return launch<5>(c1, c2, m, n, B, M, N, lanes, pairs, smem, words, score, st);
    case 6: return launch<6>(c1, c2, m, n, B, M, N, lanes, pairs, smem, words, score, st);
    case 7: return launch<7>(c1, c2, m, n, B, M, N, lanes, pairs, smem, words, score, st);
    default: return launch<8>(c1, c2, m, n, B, M, N, lanes, pairs, smem, words, score, st);
  }
}
