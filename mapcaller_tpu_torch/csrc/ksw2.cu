// Batched ksw2 extz2 DP with in-kernel backtrack, for Hopper (sm_90a).
// Built with nvcc into a plain C library and bound with ctypes
// (mapcaller_tpu_torch/ops/ksw2_device.py::ksw2_ops, which also computes
// the launch geometry: ksw2_geometry; its plain PyTorch version
// ksw2_ops_plain computes the same words).
//
// Replaces mapcaller_tpu/ops/ksw2_device.py:49-229 (XLA, no Pallas
// kernel): build_ksw2_kernel, a lax.scan over the M+N-1 anti-diagonals,
// and build_ksw2_traceback, a lax.scan over the backtrack steps (ref:
// src/ksw2_alignment.cpp:25-248, ksw_extz2_sse and ksw_backtrack). Same
// function: int8 difference state u, v, x, y that wraps like the SSE
// code; per diagonal r a 16-aligned window [st, en] around the logical
// [st0, en0]; scores s8 written over st0-aligned 16-blocks and kept from
// diagonal to diagonal (cells in [st, st0) read stale scores, as in C);
// x1/v1 injected at column st from column st-1 of the previous diagonal
// when it lay in the previous window; the max of z and b taken on their
// uint8 bit patterns and capped at MAX_SC; code 4 scores 0 against
// anything. The backtrack emits 2-bit ops (0=M, 1=D, 2=I, 3 once both
// indices pass the start) packed 16 per 32-bit word, little end first.
//
// Design. A group of GROUP = 32 lanes (a warp) aligns one pair; a block
// holds `pairs` groups. Lane l owns the interleaved columns k*GROUP + l,
// k = 0..C-1, of the NC-wide state, C = ceil(NC/GROUP), and keeps u, v,
// x, y, s8 and the target codes of its columns in registers. A pair runs
// only its qlen+tlen-1 diagonals, and on diagonal r only the chunks
// [k*GROUP, k*GROUP+GROUP) that meet the live range [st, max(en,
// blk_end-1)] issue: the test is the same for the whole group, so a
// skipped chunk costs one branch. The range reaches blk_end-1 because the
// score update writes s8 over [st0, blk_end), which can pass en. The live
// chunks run right to left, each a block without branches that first
// shuffles the previous diagonal one column to the left: lane l-1's x and
// v of the chunk and, for lane 0, lane 31's of chunk k-1, live or not (it
// is not yet updated: it comes after chunk k). A diagonal's window is computed
// one diagonal ahead, off the state's chain of dependences. Direction
// flags go to the block's dynamic shared memory, a nibble a cell ((d & 3)
// and the two extension bits; two lanes' nibbles joined by a shuffle into
// one byte store), in rows relative to each diagonal's window: row r
// starts at its own st and holds its en-st+1 cells, back to back, with a
// table of each row's offset. A block's shared memory stays within the 48
// KB it gets without opting in (two pairs at tier 192). After the fill
// lane 0 of the group walks the backtrack over them in the same launch,
// builds each op word in a register and stores it once. The reversed
// query is staged in shared memory too; nothing is allocated on the
// device. ksw2_variants.py builds this source with 16 lanes a pair, fixed
// rows or byte flags by editing its text.
//
// Bound on this card: about 40 integer operations per in-window cell
// (the recurrence's 6 adds and subtracts with their int8 wraps, 4
// compares and 3 selects for the flags, 4 for the uint8 max and cap, 2
// clamps, the score's index clip, load and 4 compares, the window test
// and the flag store), so ops = 40 * the in-window cells of the pairs'
// own diagonals, over the H100's int32 issue rate (64 INT32 lanes per SM:
// 16.7 T ops/s); bytes = the inputs and the words over 3.35 TB/s. The
// operations bound; chip_smoke.py counts the cells from each run's
// lengths. The first design (a warp per pair, lane l owning the
// contiguous columns [l*C, l*C+C)) stepped every lane through all C of
// its columns on every diagonal, in the window or not, wrote a byte flag
// per cell to a scratch in device memory the wrapper allocated (42.9 MB
// for a main-path launch of 2,004 pairs at tier 96) and walked the
// backtrack as dependent loads from it, which the L2 served. A launch of
// the main path is one wave, so its time is its slowest pair's chain of
// diagonals and backtrack steps, which is latency: this design issues
// only the chunks a diagonal's window needs, without branches inside a
// chunk, and serves every backtrack step from shared memory; packed rows
// let an SM hold more pairs at the large tiers.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int Q = 2;                // gap open
constexpr int QE2 = 2 * (Q + 1);    // 2 * (open + extend)
constexpr int MAX_SC = 1 + QE2;     // cap of the uint8 max of z and b
constexpr int WILD = 4;             // N: scores 0
constexpr int GROUP = 32;           // lanes a pair
constexpr int MAX_CHUNK = 8;        // columns a lane: NC <= GROUP * MAX_CHUNK
constexpr int MAX_THREADS = 128;    // threads a block
constexpr int MAX_SMEM = 49152;     // dynamic shared memory a block (48 KB)
constexpr unsigned FULL = 0xffffffffu;

// Window cells of all diagonals of a pair; the most for any pair of the
// tier is that of the pair (M, N)
long packed_cells(int M, int N) {
  long cells = 0;
  for (int r = 0; r < M + N - 1; ++r) {
    const int st0 = std::max({0, r - M + 1, (r - std::max(M, N) + 1) >> 1});
    const int en0 = std::min({N - 1, r, (r + std::max(M, N)) >> 1});
    cells += ((en0 + 16) & ~15) - (st0 & ~15);
  }
  return cells;
}

// Shared memory of one pair, each part 16-aligned: the staged query, the
// flag rows (a nibble a cell; a row's cells are a multiple of 16) and the
// rows' offsets (a uint16 a diagonal)
struct Layout {
  int qbytes, fbytes, pbytes;
};

Layout layout(int M, int N) {
  Layout l;
  const long cells = packed_cells(M, N);
  l.qbytes = (M + 15) & ~15;
  l.fbytes = (int)((cells / 2 + 15) & ~15L);
  l.pbytes = l.qbytes + l.fbytes + ((2 * (M + N - 1) + 15) & ~15);
  return l;
}

struct Shape {
  int B, M, N, NC;
  Layout l;
};

// Diagonal r's window (ref: cpp:140-158): the logical [st0, en0], the
// 16-aligned [st, en] and the end of the score blocks from st0 (blk_end;
// st0 when the window is empty)
struct Win {
  int st0, st, en, blk_end;
};

__device__ __forceinline__ Win window(int r, int ql, int tl, int w) {
  const int st0 = max(max(0, r - ql + 1), (r - w + 1) >> 1);
  const int en0 = min(min(tl - 1, r), (r + w) >> 1);
  return Win{st0, st0 & ~15, ((en0 + 16) & ~15) - 1,
             st0 <= en0 ? st0 + (((en0 - st0) >> 4) + 1) * 16 : st0};
}

// two's-complement wrap to int8, as the SSE code's epi8 arithmetic
__device__ __forceinline__ int w8(int x) { return (int)(int8_t)x; }

// Store the flag d of the lane's column at `cell` of the pair's rows if
// `in`; every lane of the group calls it. The even lane joins its odd
// neighbour's nibble (cells st.. are pairs: st is even, en odd).
__device__ __forceinline__ void put_flag(uint8_t* fl, int cell, int d,
                                         bool in, unsigned gmask, int lane) {
  const int nib = (d & 3) | ((d >> 1) & 0xC);
  const int odd = __shfl_down_sync(gmask, nib, 1, GROUP);
  if (in && !(lane & 1)) fl[cell >> 1] = (uint8_t)(nib | (odd << 4));
}

// The flag at `cell`, as the fill computed it (bits 0-1, 3 and 4)
__device__ __forceinline__ int get_flag(const uint8_t* fl, int cell) {
  const int nib = (fl[cell >> 1] >> ((cell & 1) << 2)) & 15;
  return (nib & 3) | ((nib << 1) & 0x18);
}

// At least 4 blocks an SM (<= 128 registers): without the minimum,
// ptxas spills 8 bytes at 5 and 6 chunks a lane
template <int C>
__global__ void __launch_bounds__(MAX_THREADS, 4)
ksw2_ops_kernel(const uint8_t* __restrict__ qbuf,
                const uint8_t* __restrict__ target,
                const int32_t* __restrict__ qlen,
                const int32_t* __restrict__ tlen, const Shape sh,
                uint32_t* __restrict__ words) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int grp = threadIdx.x / GROUP;
  const int lane = threadIdx.x % GROUP;
  const unsigned gmask = FULL;            // the group's lanes
  const int b = blockIdx.x * (blockDim.x / GROUP) + grp;
  if (b >= sh.B) return;                  // the whole group
  const int M = sh.M, N = sh.N, NC = sh.NC;
  const int ql = min(max(qlen[b], 0), M);
  const int tl = min(max(tlen[b], 0), N);
  const int w = max(ql, tl);
  uint8_t* q = smem + (size_t)grp * sh.l.pbytes;
  uint8_t* fl = q + sh.l.qbytes;
  uint16_t* rows = (uint16_t*)(fl + sh.l.fbytes);  // a row's first cell / 16
  for (int k = lane; k < M; k += GROUP) q[k] = qbuf[(size_t)b * M + k];

  int u[C], v[C], x[C], y[C], s8[C], tg[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int t = k * GROUP + lane;
    u[k] = v[k] = x[k] = y[k] = s8[k] = 0;
    tg[k] = t < NC ? target[(size_t)b * NC + t] : 0;
  }
  __syncwarp(gmask);                      // the staged query

  const int nd = ql > 0 && tl > 0 ? ql + tl - 1 : 0;
  int last_st = -1, last_en = -1, row = 0;
  Win cur = window(0, ql, tl, w);
  for (int r = 0; r < nd; ++r) {
    // this diagonal's window; the next one's computed ahead, off the
    // state's chain of dependences
    const Win wn = cur;
    cur = window(r + 1, ql, tl, w);
    const int st = wn.st, en = wn.en;
    const bool fresh = !(st > 0 && last_st <= st - 1 && st - 1 <= last_en);
    const int v1 = st > 0 ? 0 : (r > 0 ? Q : 0);    // ref: cpp:159-165
    const int u0 = r > 0 ? Q : 0;                    // ref: cpp:163-165
    const int reset = en >= r ? r : -1;
    // the live chunks [klo, khi]: every column this diagonal changes
    const int klo = st / GROUP;
    const int khi = max(en, wn.blk_end - 1) / GROUP;
    const int base = row - st;            // cell of column 0
    if (lane == 0) rows[r] = (uint16_t)(row >> 4);
    row += en - st + 1;
    // the live chunks right to left, each without a branch inside. Chunk
    // k first shuffles the previous diagonal one column to the left:
    // lane l-1's x, v of chunk k, and for lane 0 lane 31's of chunk k-1,
    // live or not, which is updated only after chunk k
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
      if (k < klo || k > khi) continue;
      const int t = k * GROUP + lane;
      const int qv = q[min(max(M - 1 - r + t, 0), M - 1)];
      const int xo = __shfl_sync(gmask, x[k], lane + GROUP - 1, GROUP);
      const int vo = __shfl_sync(gmask, v[k], lane + GROUP - 1, GROUP);
      const int xl =
          k ? __shfl_sync(gmask, x[k > 0 ? k - 1 : 0], GROUP - 1, GROUP) : 0;
      const int vl =
          k ? __shfl_sync(gmask, v[k > 0 ? k - 1 : 0], GROUP - 1, GROUP) : 0;
      int xt1 = lane ? xo : xl;
      int vt1 = lane ? vo : vl;
      xt1 = t == st && fresh ? 0 : xt1;             // x1, v1
      vt1 = t == st && fresh ? v1 : vt1;
      const int yk = t == reset ? 0 : y[k];
      const int uk = t == reset ? u0 : u[k];
      const int sc = tg[k] == WILD || qv == WILD ? 0 : (tg[k] == qv ? 1 : -1);
      s8[k] = t >= wn.st0 && t < wn.blk_end ? sc : s8[k];  // ref: cpp:167-176
      // ref: cpp:184-199, on every lane; kept inside [st, en]
      int z = s8[k] + QE2;
      int a = w8(xt1 + vt1);
      int bb = w8(yk + uk);
      int d = a > z ? 1 : 0;
      z = max(z, a);
      d = bb > z ? 2 : d;
      z = min(max(z & 255, bb & 255), MAX_SC);
      const int un = w8(z - vt1);
      const int vn = w8(z - uk);
      z -= Q;
      a = w8(a - z);
      bb = w8(bb - z);
      d |= (a > 0 ? 0x08 : 0) | (bb > 0 ? 0x10 : 0);
      const bool in = t >= st && t <= en;
      u[k] = in ? un : uk;
      v[k] = in ? vn : v[k];
      x[k] = in ? max(a, 0) : x[k];
      y[k] = in ? max(bb, 0) : yk;
      put_flag(fl, base + t, d, in, gmask, lane);
    }
    last_st = st;
    last_en = en;
  }

  __syncwarp(gmask);                      // the group's flag stores
  if (lane != 0) return;
  // ksw_backtrack (ref: cpp:25-68) from (tlen-1, qlen-1); past the
  // rectangle the remaining D's, then I's; then op 3
  const int nwords = (M + N + 15) >> 4;
  uint32_t* out = words + (size_t)b * nwords;
  int i = tl - 1, j = ql - 1, state = 0;
  for (int wd = 0; wd < nwords; ++wd) {
    if (i < 0 && j < 0) {
      out[wd] = 0xffffffffu;
      continue;
    }
    uint32_t word = 0u;
    for (int k = 0; k < 16; ++k) {
      int op;
      if (i >= 0 && j >= 0) {
        const int r = i + j;
        const int st0 = max(max(0, r - ql + 1), (r - w + 1) >> 1);
        const int en0 = min(min(tl - 1, r), (r + w) >> 1);
        const int st = st0 & ~15;
        int s;
        if (i < st) {
          s = 2;
        } else if (i > ((en0 + 16) & ~15) - 1) {
          s = 1;
        } else {
          const int tmp = get_flag(fl, ((int)rows[r] << 4) + i - st);
          s = state == 0 ? (tmp & 7)
                         : (((tmp >> (state + 2)) & 1) ? state : 0);
          if (s == 0) s = tmp & 7;
        }
        state = s;
        op = s == 0 ? 0 : (s == 1 || s == 3 ? 1 : 2);
      } else {
        op = i >= 0 ? 1 : (j >= 0 ? 2 : 3);
      }
      if (op == 0 || op == 1) --i;
      if (op == 0 || op == 2) --j;
      word |= (uint32_t)op << (2 * k);
    }
    out[wd] = word;
  }
}

template <int C>
int launch(const void* qbuf, const void* target, const void* qlen,
           const void* tlen, const Shape& sh, int pairs, int smem,
           void* words, cudaStream_t stream) {
  const int blocks = (sh.B + pairs - 1) / pairs;
  ksw2_ops_kernel<C><<<blocks, GROUP * pairs, smem, stream>>>(
      (const uint8_t*)qbuf, (const uint8_t*)target, (const int32_t*)qlen,
      (const int32_t*)tlen, sh, (uint32_t*)words);
  return (int)cudaGetLastError();
}

template <int C>
int resident(int pairs, int smem, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ksw2_ops_kernel<C>, GROUP * pairs, smem);
}

int occupancy(int chunk, int pairs, int smem, int* blocks) {
  switch (chunk) {
    case 1: return resident<1>(pairs, smem, blocks);
    case 2: return resident<2>(pairs, smem, blocks);
    case 3: return resident<3>(pairs, smem, blocks);
    case 4: return resident<4>(pairs, smem, blocks);
    case 5: return resident<5>(pairs, smem, blocks);
    case 6: return resident<6>(pairs, smem, blocks);
    case 7: return resident<7>(pairs, smem, blocks);
    default: return resident<8>(pairs, smem, blocks);
  }
}

int dispatch(int chunk, const void* qbuf, const void* target,
             const void* qlen, const void* tlen, const Shape& sh, int pairs,
             int smem, void* words, cudaStream_t st) {
  switch (chunk) {
    case 1: return launch<1>(qbuf, target, qlen, tlen, sh, pairs, smem, words, st);
    case 2: return launch<2>(qbuf, target, qlen, tlen, sh, pairs, smem, words, st);
    case 3: return launch<3>(qbuf, target, qlen, tlen, sh, pairs, smem, words, st);
    case 4: return launch<4>(qbuf, target, qlen, tlen, sh, pairs, smem, words, st);
    case 5: return launch<5>(qbuf, target, qlen, tlen, sh, pairs, smem, words, st);
    case 6: return launch<6>(qbuf, target, qlen, tlen, sh, pairs, smem, words, st);
    case 7: return launch<7>(qbuf, target, qlen, tlen, sh, pairs, smem, words, st);
    default: return launch<8>(qbuf, target, qlen, tlen, sh, pairs, smem, words, st);
  }
}

}  // namespace

// qbuf uint8[B, M] (reversed queries, right-aligned), target uint8[B, NC]
// with NC = N + 16 (N a multiple of 16), qlen/tlen int32[B]; words
// uint32[B, ceil16(M+N)/16]. Geometry from ksw2_device.py::ksw2_geometry:
// `chunk` = ceil(NC / GROUP) columns a lane, `pairs` groups a block and
// `smem` = pairs * the layout's bytes of dynamic shared memory, at most
// MAX_SMEM; any other geometry, or a shape the kernel cannot take,
// returns cudaErrorInvalidValue. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int mc_ksw2_ops(const void* qbuf, const void* target,
                           const void* qlen, const void* tlen, int B, int M,
                           int N, int NC, int chunk, int pairs, int smem,
                           void* words, void* stream) {
  if (B <= 0) return 0;
  if (M < 1 || M > MAX_SMEM || N < 16 || N % 16 != 0 || NC != N + 16 ||
      chunk < 1 || chunk > MAX_CHUNK || chunk != (NC + GROUP - 1) / GROUP ||
      pairs < 1 || GROUP * pairs > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, M, N, NC, layout(M, N)};
  if ((long)smem != (long)pairs * sh.l.pbytes || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  return dispatch(chunk, qbuf, target, qlen, tlen, sh, pairs, smem, words,
                  (cudaStream_t)stream);
}

// Blocks of a ksw2_geometry launch each SM holds at once, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); returns the error code.
extern "C" int mc_ksw2_resident(int chunk, int pairs, int smem, int* blocks) {
  if (chunk < 1 || chunk > MAX_CHUNK || pairs < 1 ||
      GROUP * pairs > MAX_THREADS || smem < 0 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  return occupancy(chunk, pairs, smem, blocks);
}
