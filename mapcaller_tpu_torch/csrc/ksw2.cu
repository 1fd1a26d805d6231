// Batched ksw2 extz2 DP with in-kernel backtrack, for Hopper (sm_90a).
// Built with nvcc into a plain C library and bound with ctypes
// (mapcaller_tpu_torch/ops/ksw2_device.py::ksw2_ops, whose plain PyTorch
// version ksw2_ops_plain computes the same words).
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
// Design. One warp aligns one pair; a block holds WARPS pairs. Lane l
// owns the columns [l*C, l*C + C) of the NC-wide state, C = ceil(NC/32)
// (2 at tiers 32 and 48, 4 at 96, 7 at 192), and keeps u, v, x, y, s8
// and the target codes of its columns in registers. A diagonal is one
// shuffle of the left neighbour's last x and v (the previous diagonal one
// column to the left) and then the lane's columns from right to left, so
// each reads its left column's previous value before it is overwritten.
// The reversed query sits in shared memory. A pair runs only its
// qlen+tlen-1 diagonals (the tier has M+N-1). Direction flags go to a
// scratch buffer the wrapper allocates, at (pair, diagonal, column), and
// only inside each diagonal's window: the backtrack reads nothing else,
// so nothing is cleared. After the fill one lane walks the backtrack over
// them in the same launch and stores the packed words; the flags never go
// to the host.
//
// Bound on this card: about 40 integer operations per in-window cell
// (the recurrence's 6 adds and subtracts with their int8 wraps, 4
// compares and 3 selects for the flags, 4 for the uint8 max and cap, 2
// clamps, the score's index clip, load and 4 compares, the window
// test and the flag store), so ops = 40 * the in-window cells of the
// pairs' own diagonals, over the H100's int32 issue rate (64 INT32 lanes
// per SM: 16.7 T ops/s); bytes = the inputs and the words over 3.35 TB/s.
// The operations bound; chip_smoke.py counts the cells from each run's
// lengths. What holds the kernel above it: every lane steps through all
// C of its columns on every diagonal, in the window or not (a diagonal's
// window is at most min(qlen, tlen) + 31 columns of the 32*C), a
// diagonal depends on the one before (shuffle, then the columns'
// dependent int8 chains), and the backtrack is qlen+tlen dependent loads
// from the scratch, which the L2 serves. The design keeps the state in
// registers, runs only the diagonals a pair needs and writes only the
// flags the backtrack can read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 2;                // gap open
constexpr int QE2 = 2 * (Q + 1);    // 2 * (open + extend)
constexpr int MAX_SC = 1 + QE2;     // cap of the uint8 max of z and b
constexpr int WILD = 4;             // N: scores 0
constexpr int MAX_CHUNK = 8;        // columns a lane holds: NC <= 32 * MAX_CHUNK
constexpr int MAX_M = 256;          // query bases a warp stages in shared memory
constexpr int WARPS = 4;            // pairs (one warp each) per block
constexpr unsigned FULL = 0xffffffffu;

// two's-complement wrap to int8, as the SSE code's epi8 arithmetic
__device__ __forceinline__ int w8(int x) { return (int)(int8_t)x; }

template <int C>
__global__ void __launch_bounds__(32 * WARPS)
ksw2_ops_kernel(const uint8_t* __restrict__ qbuf,
                const uint8_t* __restrict__ target,
                const int32_t* __restrict__ qlen,
                const int32_t* __restrict__ tlen, int B, int M, int N, int NC,
                uint8_t* __restrict__ flags, uint32_t* __restrict__ words) {
  __shared__ uint8_t qs[WARPS][MAX_M];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;                     // warp-uniform: the whole warp
  const int ql = min(max(qlen[b], 0), M);
  const int tl = min(max(tlen[b], 0), N);
  const int w = max(ql, tl);
  uint8_t* q = qs[warp];
  for (int k = lane; k < M; k += 32) q[k] = qbuf[(size_t)b * M + k];
  uint8_t* fl = flags + (size_t)b * (M + N - 1) * NC;

  const int t0 = lane * C;                // first column of this lane
  int u[C], v[C], x[C], y[C], s8[C], tg[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    u[k] = v[k] = x[k] = y[k] = s8[k] = 0;
    tg[k] = t0 + k < NC ? target[(size_t)b * NC + t0 + k] : 0;
  }
  __syncwarp();                           // the staged query

  const int nd = ql > 0 && tl > 0 ? ql + tl - 1 : 0;
  int last_st = -1, last_en = -1;
  for (int r = 0; r < nd; ++r) {
    const int st0 = max(max(0, r - ql + 1), (r - w + 1) >> 1);
    const int en0 = min(min(tl - 1, r), (r + w) >> 1);   // >= 0 here
    const int st = st0 & ~15;
    const int en = ((en0 + 16) & ~15) - 1;
    const bool inside = st > 0 && last_st <= st - 1 && st - 1 <= last_en;
    const int blk_end = st0 + (((en0 - st0) >> 4) + 1) * 16;
    const bool blk_on = st0 <= en0;
    // the previous diagonal one column to the left of this lane
    const int xl = __shfl_up_sync(FULL, x[C - 1], 1);
    const int vl = __shfl_up_sync(FULL, v[C - 1], 1);
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {    // x[k-1], v[k-1] still previous
      const int t = t0 + k;
      int xt1 = k ? x[k - 1] : (lane ? xl : 0);
      int vt1 = k ? v[k - 1] : (lane ? vl : 0);
      if (t == st) {                      // x1, v1 (ref: cpp:159-165)
        xt1 = inside ? xt1 : 0;
        vt1 = inside ? vt1 : (st > 0 ? 0 : (r > 0 ? Q : 0));
      }
      if (t == r && en >= r) {            // ref: cpp:163-165
        y[k] = 0;
        u[k] = r > 0 ? Q : 0;
      }
      if (blk_on && t >= st0 && t < blk_end) {   // ref: cpp:167-176
        const int qv = q[min(max(M - 1 - r + t, 0), M - 1)];
        s8[k] = tg[k] == WILD || qv == WILD ? 0 : (tg[k] == qv ? 1 : -1);
      }
      if (t >= st && t <= en) {           // ref: cpp:184-199
        int z = s8[k] + QE2;
        int a = w8(xt1 + vt1);
        int bb = w8(y[k] + u[k]);
        int d = a > z ? 1 : 0;
        z = max(z, a);
        d = bb > z ? 2 : d;
        z = min(max(z & 255, bb & 255), MAX_SC);
        const int un = w8(z - vt1);
        const int vn = w8(z - u[k]);
        z -= Q;
        a = w8(a - z);
        bb = w8(bb - z);
        d |= (a > 0 ? 0x08 : 0) | (bb > 0 ? 0x10 : 0);
        u[k] = un;
        v[k] = vn;
        x[k] = max(a, 0);
        y[k] = max(bb, 0);
        fl[(size_t)r * NC + t] = (uint8_t)d;
      }
    }
    last_st = st;
    last_en = en;
  }

  __syncwarp();                           // the warp's flag stores
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
        int s;
        if (i < (st0 & ~15)) {
          s = 2;
        } else if (i > ((en0 + 16) & ~15) - 1) {
          s = 1;
        } else {
          const int tmp = fl[(size_t)r * NC + i];
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
           const void* tlen, int B, int M, int N, int NC, void* flags,
           void* words, cudaStream_t stream) {
  const int blocks = (B + WARPS - 1) / WARPS;
  ksw2_ops_kernel<C><<<blocks, 32 * WARPS, 0, stream>>>(
      (const uint8_t*)qbuf, (const uint8_t*)target, (const int32_t*)qlen,
      (const int32_t*)tlen, B, M, N, NC, (uint8_t*)flags, (uint32_t*)words);
  return (int)cudaGetLastError();
}

}  // namespace

// qbuf uint8[B, M] (reversed queries, right-aligned), target uint8[B, NC]
// with NC = N + 16 (N a multiple of 16), qlen/tlen int32[B]; flags: uint8
// scratch of B * (M+N-1) * NC bytes, not read before written; words
// uint32[B, ceil16(M+N)/16]. `chunk` = ceil(NC / 32) columns per lane. A
// shape the kernel cannot take returns cudaErrorInvalidValue. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int mc_ksw2_ops(const void* qbuf, const void* target,
                           const void* qlen, const void* tlen, int B, int M,
                           int N, int NC, int chunk, void* flags, void* words,
                           void* stream) {
  if (B <= 0) return 0;
  if (M < 1 || M > MAX_M || N < 16 || N % 16 != 0 || NC != N + 16 ||
      chunk < 1 || chunk > MAX_CHUNK || chunk * 32 < NC ||
      (chunk - 1) * 32 >= NC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (chunk) {
    case 1: return launch<1>(qbuf, target, qlen, tlen, B, M, N, NC, flags, words, st);
    case 2: return launch<2>(qbuf, target, qlen, tlen, B, M, N, NC, flags, words, st);
    case 3: return launch<3>(qbuf, target, qlen, tlen, B, M, N, NC, flags, words, st);
    case 4: return launch<4>(qbuf, target, qlen, tlen, B, M, N, NC, flags, words, st);
    case 5: return launch<5>(qbuf, target, qlen, tlen, B, M, N, NC, flags, words, st);
    case 6: return launch<6>(qbuf, target, qlen, tlen, B, M, N, NC, flags, words, st);
    case 7: return launch<7>(qbuf, target, qlen, tlen, B, M, N, NC, flags, words, st);
    default: return launch<8>(qbuf, target, qlen, tlen, B, M, N, NC, flags, words, st);
  }
}
