// The calling phase's device programs, for Hopper (sm_90a). Built with nvcc
// into a plain C library and bound with ctypes
// (mapcaller_tpu_torch/ops/calling_kernels.py, which holds each kernel's
// plain PyTorch version beside its wrapper).
//
// Replaces XLA device programs of the reference package (no Pallas
// kernel):
//
//   evidence_finalize_kernel  A5's finalize fold, build_finalize_kernel
//     (mapcaller_tpu/pipeline/device_profile.py:169-189) with the reference
//     codes of _ref_codes_dev (:308-316), and, through its slice form, B4's
//     per-shard fold (mapcaller_tpu/pipeline/big_profile.py:291-361): in
//     one pass over tiles of FIN_TILE positions, the inclusive prefixes of
//     the exact, four orientation and multi diff rows (six int32 sums,
//     wrapping as the reference's int32 cumsum does), the capped allele
//     counts with the exact coverage credited to the reference base, the
//     capped multi counts, the coverage and its int64 prefix;
//   caller_scan_kernel        A6's caller scan, build_scan_kernel
//     (mapcaller_tpu/calling/scan_device.py:94-166), and B4's per-shard scan
//     (big_profile.py:363-530) through its slice form: in one pass over
//     tiles of SCAN_BLOCKS 100-base blocks, the block depths, the candidate
//     mask, the gap / CNV run states and their boundaries, the candidates
//     and run starts compacted in position order, and the counts;
//   caller_fetch_kernel       A6's column fetch, build_fetch_kernel
//     (scan_device.py:180-194), with the block depths the host asks for in
//     the same int64 buffer;
//   nor_blocks_kernel         A6's gVCF NOR blocks, build_nor_kernel
//     (scan_device.py:255-285): the per-segment minima of position and
//     coverage of the normal positions, read out with the coverage at each
//     segment's first position by the launch's last block.
//   caller_fetch_slice_kernel  the fetch's slice form, B4's fetch
//     (mapcaller_tpu/pipeline/big_profile.py:532-601): one launch a device
//     over every shard it holds, the elements in the caller's order, each
//     finding its shard by a search over the shards' first positions (the
//     fetch body is shared with the single-card form, one shard);
//   nor_blocks_slice_kernel   the NOR blocks' slice form, B4's NOR
//     (big_profile.py:603-667) a shard of the genome-sharded planes: over
//     a shard's valid positions, keyed by the global breaks at off + p,
//     its minima local positions (< 2^31) that the host turns into global
//     int64 ones and combines over the shards.
//
// Every one is bound by bytes: a few int32 reads and writes a genome
// position and a handful of integer operations on each (chip_smoke.py
// counts each kernel's bytes from the run's own inputs). The eager
// versions launch 20-60 kernels each and hold several int64 temporaries of
// genome length; these kernels keep every intermediate (the prefix sums,
// the masks, the compaction slots, the segment keys) in registers and
// shared memory and need O(tiles) scratch.
//
// The finalize reads ten int32 rows (the exact, four orientation and multi
// diffs, the four point-add rows) and the text words, and writes eleven
// int32 rows and the int64 coverage prefix: 92.5 bytes a position. The
// scan reads seven rows (coverage, codes, four allele rows, multi) and
// writes block depths and the compacted tables: 28 bytes a position. A
// thread owns ITEMS consecutive positions, so that its running prefixes
// are sequential, and so a row reaches it through shared memory. What held
// both back was staging one row at a time, two barriers a row: few loads
// in flight on an SM, none during a barrier or a look-back, and the
// finalize read its six diff rows twice. Here a tile's input rows are all
// copied into dynamic shared memory at once (cp.async), the block waits
// once, and each row is read from device memory once. A row's segment
// that lies on 16 bytes is copied 16 bytes a copy, past L1 (cp.async.cg);
// the planes' other rows start on any 4-byte boundary ([4][L + 1] and
// [4][L + 2]) and are copied 4 bytes a copy; either way zeros fill past the
// row's end. A row is staged unpadded: a finalize thread reads and writes
// its 10 positions as 8-byte words (twice an odd number: a half warp's
// accesses fall on 32 banks), a scan thread reads its 5 as words (an odd
// number: a warp's fall on 32 banks). The outputs are computed in place in
// the staged rows and stored in one pass of coalesced stores, 16 bytes a
// store where the output row lies on 16 bytes. A block is persistent and
// draws its tiles by ticket, two blocks an SM, so that one block's copies
// are in flight while the other computes or waits on a look-back.
//
// Without their look-backs the two kernels move their bytes near the
// card's rate (the scan at the rate of its staging alone), so the
// look-backs are what is left, and the design shortens them: each chain's
// aggregate is published as soon as it is known, the block then does work
// that needs no carry (the finalize its store pass before resolving the
// coverage chain; the scan the copies of its next tile, its staged rows
// read), and resolves the chain after; flags are written with release and
// polled with acquire, with no fence. A ring of STAGES = 2 tiles a block
// (the next tile's copies started before the current tile is processed)
// was slower: a block's staged next tile publishes nothing until the block
// has finished its current one, and every later tile's look-back waits on
// it. Only a scan tile's first position reads the state before it (staged
// too), or the seam.
//
// The finalize and the scan carry sums across tiles in one launch with a
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016), as chain_scan_kernel of
// csrc/chain.cu does. Their carries do not fit its one 64-bit status word
// (the finalize carries six int32 sums and then an int64 one, the scan
// three 64-bit sums), so a tile's slot in the scratch holds, for each
// chain, a flag word (epoch << 2 | flag) and the values: the tile writes
// its values, then the flag with release; a reader polls the flag with
// acquire, then reads the values. The values are stored and loaded relaxed
// at gpu scope (never cached in L1, where a line loaded for one tile's
// values could hold a neighbour's not yet written). A look-back step reads
// LOOKBACK predecessors, a lane of warp 0 each. The tile index is an atomic
// ticket, so every tile a block waits on belongs to a block that already
// runs (a block's staged next tile comes after its current one); every
// block draws one ticket past the last tile, and the block that draws the
// launch's last ticket resets the counter. The epoch, one a launch from
// the wrapper, makes the flags of earlier launches read as not ready. The
// coverage prefix depends on the exact-coverage prefix, so the finalize
// resolves its six-value chain first and its int64 chain after.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ALLELE = 4095;        // MAX_ALLELE_COUNT
constexpr int BLOCK_SIZE = 100;         // the caller's depth block
constexpr int CAND_CAP = 1 << 17;
constexpr int RUN_CAP = 1 << 20;
constexpr int I32_MAX = 0x7FFFFFFF;
constexpr unsigned int FULL = 0xFFFFFFFFu;

constexpr int FIN_THREADS = 256;        // a finalize tile: 10 positions
constexpr int FIN_ITEMS = 10;           // a thread, consecutive
constexpr int FIN_TILE = FIN_THREADS * FIN_ITEMS;
constexpr int FIN_STAGES = 1;           // tiles a block holds staged
constexpr int FIN_MIN_BLOCKS = 2;       // blocks an SM, launch bounds
constexpr int SCAN_BLOCKS = 32;         // 100-base blocks a scan tile
constexpr int SCAN_ITEMS = 5;           // positions a thread, consecutive
constexpr int SCAN_THREADS = SCAN_BLOCKS * BLOCK_SIZE / SCAN_ITEMS;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SCAN_STAGES = 1;
constexpr int SCAN_MIN_BLOCKS = 2;
constexpr int BLOCK_THREADS = BLOCK_SIZE / SCAN_ITEMS;   // threads a block
constexpr int FETCH_THREADS = 256;      // a fetch block: FETCH_TILE
constexpr int FETCH_TILE = FETCH_THREADS / 2;  // positions x 10 columns
constexpr int FETCH_PITCH = 11;         // (two warps a group of 32), or a
constexpr int FETCH_MAX_SHARDS = 16;    // point or block a thread; shards
                                        // a slice-form launch's table
static_assert(FETCH_THREADS % 64 == 0, "fetch: two warps a group of 32");
constexpr int NOR_THREADS = 256;        // a NOR tile: NOR_ITEMS
constexpr int NOR_ITEMS = 28;           // consecutive positions a thread
constexpr int NOR_TILE = NOR_THREADS * NOR_ITEMS;
constexpr int NOR_STAGE = 256;          // breaks staged a tile
constexpr int NOR_MIN_BLOCKS = 6;       // blocks an SM, launch bounds
constexpr int NOR_BULK = 0;             // the coverage by one bulk copy (1)
                                        // or by 16-byte cp.async (0)

// a tile's look-back slot: 16 words; chain A at word 0 (flag, 6 aggregate
// words, 6 inclusive words), chain B at word 13 (flag, 1 + 1)
constexpr int SLOT_WORDS = 16;
constexpr int CHAIN_A = 0, CHAIN_B = 13;
constexpr int LOOKBACK = 32;            // predecessors a look-back step reads
constexpr unsigned long long FLAG_AGG = 1, FLAG_PREFIX = 2;

// A stage holds a tile's rows, each TILE words, element j of the tile at
// word j. A finalize stage: eleven rows, each computed in place (exact
// diff -> coverage, the four orientation diffs -> F, multi diff -> multi,
// the four point-add rows -> allele counts, then the coverage prefix over
// the first two of them once stored; the codes, in or out), then the
// tile's text words
constexpr int FR_EXACT = 0, FR_F = 1, FR_MULTI = 5, FR_ACGT = 6,
              FR_CODES = 10, FIN_ROWS = 11;
constexpr int FIN_WORDS = FIN_TILE / 16;
constexpr int FIN_STAGE_INTS = FIN_ROWS * FIN_TILE + 2 * FIN_WORDS;
constexpr int FIN_SMEM = 4 * FIN_STAGES * FIN_STAGE_INTS;
// a scan stage: seven rows, then the coverage and multi count at the
// tile's first position - 1 (4 words)
constexpr int SR_COV = 0, SR_CODES = 1, SR_ACGT = 2, SR_MULTI = 6,
              SCAN_ROWS = 7;
constexpr int SCAN_STAGE_INTS = SCAN_ROWS * SCAN_TILE + 4;
constexpr int SCAN_SMEM = 4 * SCAN_STAGES * SCAN_STAGE_INTS;

static_assert(BLOCK_SIZE % SCAN_ITEMS == 0, "a thread inside one block");
static_assert(SCAN_THREADS % 32 == 0 && FIN_THREADS % 32 == 0,
              "whole warps");
static_assert(SCAN_BLOCKS <= SCAN_THREADS, "a thread a block sum");
static_assert(FIN_TILE % 32 == 0 && SCAN_TILE % 4 == 0,
              "a tile of whole text words, rows of 16-byte chunks");
static_assert(FIN_ITEMS % 4 == 2 && (SCAN_ITEMS % 2 == 1 ||
                                     SCAN_ITEMS % 4 == 2),
              "a thread's items free of bank conflicts: an odd number, or "
              "twice one as 8-byte words (the finalize's)");
static_assert(FIN_STAGES >= 1 && FIN_STAGES <= 2 && SCAN_STAGES >= 1 &&
              SCAN_STAGES <= 2, "one or two stages");
static_assert(FIN_SMEM <= 227 * 1024 && SCAN_SMEM <= 227 * 1024,
              "a block's shared memory");
static_assert(NOR_THREADS % 32 == 0 && NOR_THREADS >= 128,
              "whole warps, four of them for a tile's searches");
static_assert(NOR_ITEMS % 8 == 4,
              "a thread's positions as 16-byte words, a quarter warp's on "
              "32 banks");

struct LookBack {
  unsigned int* ticket;                 // tiles handed out this launch
  unsigned long long* slots;            // [tiles][SLOT_WORDS]
  unsigned long long epoch;             // this launch's tag, 1 .. 2^30 - 1
};

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// a slot's flag, polled with acquire (the values after it read in order)
// and written with release (the values before it visible first): no
// fence on either side
__device__ __forceinline__ unsigned long long ld_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_flag(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// B bytes (4 or 8) from global src into shared dst, asynchronously; zeros
// without a read when !ok (src is still a valid address).
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "n"(B), "r"(ok ? B : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// this thread's copies done, all but the newest `N` groups
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// 16 bytes into shared dst: the first `bytes` (0, 4, 8, 12 or 16) from
// global src, asynchronously, not through L1; zeros after them
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(bytes) : "memory");
}

// row[base + j] for j < TILE into dst[j] (16-byte aligned), 0 at or past
// lim: 16-byte copies where row + base lies on 16 bytes, else 4-byte ones
template <int NT, int TILE>
__device__ __forceinline__ void stage_row(int* dst, const int* row, int base,
                                          int lim) {
  const int* src = row + base;
  if (((uintptr_t)src & 15) == 0) {
#pragma unroll 2
    for (int q = threadIdx.x; q < TILE / 4; q += NT) {
      const int left = lim - base - 4 * q;      // elements of the chunk
      const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
      cp_async16(dst + 4 * q, bytes ? src + 4 * q : row, bytes);
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < TILE; j += NT) {
      const bool ok = base + j < lim;
      cp_async<4>(dst + j, ok ? src + j : row, ok);
    }
  }
}

// row[base + j] = src[j] (16-byte aligned shared) for j < TILE below n:
// coalesced, 16-byte stores where row + base lies on 16 bytes
template <int NT, int TILE>
__device__ __forceinline__ void store_row(int* row, const int* src, int base,
                                          int n) {
  int* dst = row + base;
  if (((uintptr_t)dst & 15) == 0) {
#pragma unroll 2
    for (int q = threadIdx.x; q < TILE / 4; q += NT) {
      const int left = n - base - 4 * q;
      const int4 v = reinterpret_cast<const int4*>(src)[q];
      if (left >= 4) {
        reinterpret_cast<int4*>(dst)[q] = v;
      } else {
        if (left > 0) dst[4 * q] = v.x;
        if (left > 1) dst[4 * q + 1] = v.y;
        if (left > 2) dst[4 * q + 2] = v.z;
      }
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < TILE; j += NT)
      if (base + j < n) dst[j] = src[j];
  }
}

// A thread's N consecutive words of a staged row: N odd, a warp's loads
// of word i fall on 32 different banks; N twice an odd number, as 8-byte
// loads and stores (p 8-byte aligned), a half warp's fall on 32 banks.
template <int N>
__device__ __forceinline__ void ld_items(const int* p, int (&x)[N]) {
  if constexpr (N % 2 == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int2 v = reinterpret_cast<const int2*>(p)[i];
      x[2 * i] = v.x;
      x[2 * i + 1] = v.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void st_items(int* p, const int (&x)[N]) {
  static_assert(N % 2 == 0, "8-byte stores");
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    reinterpret_cast<int2*>(p)[i] = make_int2(x[2 * i], x[2 * i + 1]);
}

// The block's next tile by an atomic ticket (ntiles or more: none left).
// Begins and ends with the block synchronised (every thread has read the
// draw before). Every block draws tickets until one past the last tile, so
// a launch draws ntiles + gridDim.x of them.
__device__ __forceinline__ int draw_ticket(const LookBack& lb, int ntiles,
                                           int* tile_s) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int k = (int)atomicAdd(lb.ticket, 1u);
    if (k == ntiles + (int)gridDim.x - 1) *lb.ticket = 0u;  // the last
    *tile_s = k;
  }
  __syncthreads();
  return *tile_s;
}

// One thread: the K values of chain `at` of tile `tile`, aggregate or
// inclusive by `flag`, then the flag.
template <int K>
__device__ __forceinline__ void publish(const LookBack& lb, int tile, int at,
                                        unsigned long long flag,
                                        const unsigned long long (&v)[K]) {
  unsigned long long* s = lb.slots + (size_t)tile * SLOT_WORDS + at;
  const int off = flag == FLAG_AGG ? 1 : 1 + K;
#pragma unroll
  for (int k = 0; k < K; ++k) st_relaxed(s + off + k, v[k]);
  st_flag(s, lb.epoch << 2 | flag);
}

// Warp 0 of tile `tile`: publish the tile's aggregate of chain `at` (unless
// PUBLISHED: done before, by publish_aggregate), look back to the nearest
// inclusive prefix, LOOKBACK predecessors a step, publish the tile's own;
// sets excl to the sum of the tiles before it (in every lane). Sums are
// modulo 2^64.
template <int K, bool PUBLISHED = false>
__device__ __forceinline__ void look_back(const LookBack& lb, int tile,
                                          int at,
                                          const unsigned long long (&agg)[K],
                                          unsigned long long (&excl)[K]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) excl[k] = 0;
  if (tile == 0) {
    if (lane == 0) publish<K>(lb, 0, at, FLAG_PREFIX, agg);
    return;
  }
  if (lane == 0 && !PUBLISHED) publish<K>(lb, tile, at, FLAG_AGG, agg);
  for (int top = tile - 1;; top -= LOOKBACK) {
    const int i = top - (LOOKBACK - 1) + lane;   // lane 31: the nearest
    const unsigned long long* s =
        lb.slots + (size_t)(i >= 0 ? i : 0) * SLOT_WORDS + at;
    unsigned long long st;
    for (;;) {                          // slots before tile 0 hold prefix 0
      st = i >= 0 ? ld_flag(s) : (lb.epoch << 2 | FLAG_PREFIX);
      if (__all_sync(FULL, (st >> 2) == lb.epoch)) break;
    }
    const bool prefix = (st & 3) == FLAG_PREFIX;
    const unsigned int pm = __ballot_sync(FULL, prefix);
    // from the nearest inclusive prefix on: it and the aggregates after it
    const int from = pm ? 31 - __clz(pm) : 0;
    const int off = prefix ? 1 + K : 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      unsigned long long v =
          lane >= from && i >= 0 ? ld_relaxed(s + off + k) : 0ull;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
      excl[k] += v;
    }
    if (pm) break;
  }
  if (lane == 0) {
    unsigned long long inc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) inc[k] = excl[k] + agg[k];
    publish<K>(lb, tile, at, FLAG_PREFIX, inc);
  }
}

// Thread 0: publish tile `tile`'s aggregate of chain `at` ahead of its
// look-back (look_back<K, true>), so that later tiles can read it while the
// block does work that needs no carry.
template <int K>
__device__ __forceinline__ void publish_aggregate(
    const LookBack& lb, int tile, int at,
    const unsigned long long (&agg)[K]) {
  if (threadIdx.x == 0 && tile > 0) publish<K>(lb, tile, at, FLAG_AGG, agg);
}

// Exclusive scan of K values a thread over a block of NT threads: v becomes
// the thread's exclusive prefixes, tot the block's totals (modulo 2^64).
// sm: K * NT / 32 words of shared memory; ends with the block synchronised.
template <int K, int NT>
__device__ __forceinline__ void block_scan(unsigned long long (&v)[K],
                                           unsigned long long (&tot)[K],
                                           unsigned long long* sm) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned long long inc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    inc[k] = v[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(FULL, inc[k], d);
      if (lane >= d) inc[k] += y;
    }
    if (lane == 31) sm[k * NW + w] = inc[k];
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      unsigned long long ws = lane < NW ? sm[k * NW + lane] : 0ull;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(FULL, ws, d);
        if (lane >= d) ws += y;
      }
      if (lane < NW) sm[k * NW + lane] = ws;   // inclusive over warps
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    tot[k] = sm[k * NW + NW - 1];
    const unsigned long long before = w > 0 ? sm[k * NW + w - 1] : 0ull;
    v[k] = before + inc[k] - v[k];
  }
  __syncthreads();                      // sm may be written again
}

// ---- evidence_finalize_kernel --------------------------------------------

struct FinIn {
  const int* acgt;                      // [4][sa] point adds
  const int* exact;                     // exact_diff [>= n]
  const int* fdiff;                     // [4][sf] orientation diffs
  const int* mdiff;                     // multi_diff [>= n]
  const int* rc;                        // reference codes [n], or nullptr
  const long long* words;               // text words (uint32 in int64), or
                                        // nullptr: codes from their crumbs
  const long long* carry;               // int64[7] coming in, or nullptr
  long long cov_in;                     // the coverage prefix coming in
  int sa, sf, n;
};

struct FinOut {
  int* acgt;                            // [4][n]
  int* F;                               // [4][n]
  int* multi;                           // [n]
  int* cov;                             // [n]
  long long* cpre;                      // [n]: cov_in + sum of cov[0..p]
  int* rc;                              // codes out [n] (with words), or
                                        // nullptr
  long long* carry;                     // int64[7] out
  int lead;                             // also cpre[-1] = cov_in
};

// Start the copies of tile `tile`'s input rows into the stage S.
__device__ __forceinline__ void fin_stage(const FinIn& in, int tile, int* S) {
  const int base = tile * FIN_TILE, n = in.n;
  stage_row<FIN_THREADS, FIN_TILE>(S + FR_EXACT * FIN_TILE, in.exact, base, n);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    stage_row<FIN_THREADS, FIN_TILE>(S + (FR_F + k) * FIN_TILE,
                                     in.fdiff + (size_t)k * in.sf, base, n);
    stage_row<FIN_THREADS, FIN_TILE>(S + (FR_ACGT + k) * FIN_TILE,
                                     in.acgt + (size_t)k * in.sa, base, n);
  }
  stage_row<FIN_THREADS, FIN_TILE>(S + FR_MULTI * FIN_TILE, in.mdiff, base, n);
  if (in.words != nullptr) {
    long long* W = reinterpret_cast<long long*>(S + FIN_ROWS * FIN_TILE);
    const int w0 = base >> 4, nw = (n + 15) >> 4;
    for (int j = threadIdx.x; j < FIN_WORDS; j += FIN_THREADS) {
      const bool ok = w0 + j < nw;
      cp_async<8>(W + j, ok ? in.words + w0 + j : in.words, ok);
    }
  } else {
    stage_row<FIN_THREADS, FIN_TILE>(S + FR_CODES * FIN_TILE, in.rc, base, n);
  }
}

// The staged tile `tile` of a launch of ntiles: its sums and chain A, the
// prefixes and counts in place, one pass of stores, chain B, the coverage
// prefix (over the stored allele rows) and its store.
__device__ __forceinline__ void fin_tile(const FinIn& in, const FinOut& out,
                                         const LookBack& lb, int tile,
                                         int ntiles, int* S,
                                         unsigned long long* sm,
                                         unsigned long long* exa_s,
                                         unsigned long long* exb_s) {
  const int t = threadIdx.x, n = in.n;
  const int base = tile * FIN_TILE, j0 = t * FIN_ITEMS, p0 = base + j0;
  int* const R = S + j0;                // row r's items at R + r * FIN_TILE
  int x[FIN_ITEMS];
  // the thread's sums of the six diff rows (rows 0-5)
  unsigned long long v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    ld_items(R + k * FIN_TILE, x);
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < FIN_ITEMS; ++i) s += (uint32_t)x[i];
    v[k] = s;
  }
  unsigned long long tot[6];
  block_scan<6, FIN_THREADS>(v, tot, sm);
  if (t < 32) {
    unsigned long long ex[6];
    look_back<6>(lb, tile, CHAIN_A, tot, ex);
    if (t == 0)
#pragma unroll
      for (int k = 0; k < 6; ++k) exa_s[k] = ex[k];
  }
  __syncthreads();
  // the thread's running prefix of a diff row (modulo 2^32) from the
  // carry, the tiles before and the threads before
#define RUN_FROM(k) (uint32_t)(exa_s[k] + v[k] + \
    (in.carry ? (unsigned long long)in.carry[k] : 0ull))
  uint32_t ex[FIN_ITEMS];
  {
    ld_items(R + FR_EXACT * FIN_TILE, x);
    uint32_t r = RUN_FROM(0);
#pragma unroll
    for (int i = 0; i < FIN_ITEMS; ++i) ex[i] = r += (uint32_t)x[i];
  }
  int cd[FIN_ITEMS];
  if (in.words != nullptr) {
    const long long* W =
        reinterpret_cast<const long long*>(S + FIN_ROWS * FIN_TILE);
#pragma unroll
    for (int i = 0; i < FIN_ITEMS; ++i) {
      const int j = j0 + i;             // the tile starts a text word
      cd[i] = (int)(((uint32_t)W[j >> 4] >> ((15 - (j & 15)) * 2)) & 3u);
    }
    st_items(R + FR_CODES * FIN_TILE, cd);
  } else {
    ld_items(R + FR_CODES * FIN_TILE, cd);
  }
  int cov[FIN_ITEMS] = {0};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ld_items(R + (FR_ACGT + c) * FIN_TILE, x);
#pragma unroll
    for (int i = 0; i < FIN_ITEMS; ++i) {
      x[i] = min((int)((uint32_t)x[i] + (c == cd[i] ? ex[i] : 0u)),
                 MAX_ALLELE);
      cov[i] = (int)((uint32_t)cov[i] + (uint32_t)x[i]);
    }
    st_items(R + (FR_ACGT + c) * FIN_TILE, x);
  }
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    ld_items(R + k * FIN_TILE, x);
    uint32_t r = RUN_FROM(k);
#pragma unroll
    for (int i = 0; i < FIN_ITEMS; ++i) {
      r += (uint32_t)x[i];
      x[i] = k < FR_MULTI ? (int)r : min((int)r, MAX_ALLELE);
    }
    st_items(R + k * FIN_TILE, x);
  }
#undef RUN_FROM
  st_items(R + FR_EXACT * FIN_TILE, cov);
  // the coverage prefix: chain B, once chain A has given the exact
  // prefix; its aggregate published before the stores, resolved after
  long long csum = 0;
#pragma unroll
  for (int i = 0; i < FIN_ITEMS; ++i) csum += p0 + i < n ? cov[i] : 0;
  unsigned long long cs[1] = {(unsigned long long)csum}, ctot[1];
  block_scan<1, FIN_THREADS>(cs, ctot, sm);   // past the rows' writes
  publish_aggregate<1>(lb, tile, CHAIN_B, ctot);
  // every int32 output row, coalesced
#pragma unroll
  for (int r = 0; r < FIN_ROWS; ++r) {
    int* dst = r == FR_EXACT ? out.cov
               : r < FR_MULTI ? out.F + (size_t)(r - FR_F) * n
               : r == FR_MULTI ? out.multi
               : r < FR_CODES ? out.acgt + (size_t)(r - FR_ACGT) * n
                              : out.rc;
    if (dst != nullptr)                 // (codes given: not written)
      store_row<FIN_THREADS, FIN_TILE>(dst, S + r * FIN_TILE, base, n);
  }
  if (t < 32) {
    unsigned long long ex1[1];
    look_back<1, true>(lb, tile, CHAIN_B, ctot, ex1);
    if (t == 0) *exb_s = ex1[0];
  }
  __syncthreads();                      // past the stores' reads
  // over the stored allele rows, a pair of positions a 16-byte store
  long long* const C = reinterpret_cast<long long*>(S + FR_ACGT * FIN_TILE);
  long long run = in.cov_in + (long long)(*exb_s + cs[0]);
#pragma unroll
  for (int i = 0; i < FIN_ITEMS; i += 2) {
    const long long a = run += cov[i];
    reinterpret_cast<longlong2*>(C + j0)[i / 2] = make_longlong2(
        a, run += cov[i + 1]);
  }
  __syncthreads();
#pragma unroll 4
  for (int j = t; j < FIN_TILE; j += FIN_THREADS)
    if (base + j < n) out.cpre[base + j] = C[j];
  if (out.lead && tile == 0 && t == 0) out.cpre[-1] = in.cov_in;
  if (tile == ntiles - 1 && t == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k)
      out.carry[k] = (long long)(int)(uint32_t)(
          exa_s[k] + tot[k] +
          (in.carry ? (unsigned long long)in.carry[k] : 0ull));
    out.carry[6] = in.cov_in + (long long)(*exb_s + ctot[0]);
  }
}

// A persistent block: tiles by ticket, each staged after the one before
// is processed (FIN_STAGES = 2: before it is processed).
__global__ void __launch_bounds__(FIN_THREADS, FIN_MIN_BLOCKS)
evidence_finalize_kernel(FinIn in, FinOut out, LookBack lb, int ntiles) {
  extern __shared__ __align__(16) int fin_smem[];
  __shared__ unsigned long long sm[6 * (FIN_THREADS / 32)];
  __shared__ unsigned long long exa_s[6], exb_s;
  __shared__ int tile_s;
  int tile = draw_ticket(lb, ntiles, &tile_s);
  if (tile < ntiles) fin_stage(in, tile, fin_smem);
  cp_commit();
  for (int s = 0; tile < ntiles; s ^= FIN_STAGES - 1) {
    int next = ntiles;
    if (FIN_STAGES > 1) {
      next = draw_ticket(lb, ntiles, &tile_s);
      if (next < ntiles)
        fin_stage(in, next, fin_smem + (s ^ 1) * FIN_STAGE_INTS);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                    // every thread's copies landed
    fin_tile(in, out, lb, tile, ntiles, fin_smem + s * FIN_STAGE_INTS, sm,
             exa_s, &exb_s);
    if (FIN_STAGES == 1) {
      next = draw_ticket(lb, ntiles, &tile_s);   // past the tile's reads
      if (next < ntiles) fin_stage(in, next, fin_smem);
      cp_commit();
    }
    tile = next;
  }
}

// ---- caller_scan_kernel --------------------------------------------------

struct ScanIn {
  const int* acgt;                      // [4][sa] finalized allele counts
  const int* multi;                     // [n]
  const int* cov;                       // [n]
  const int* rc;                        // [n]
  const int* seam;                      // the state at position -1, or
                                        // nullptr (position 0 starts a run)
  int sa, n, valid, nb, ad, somatic;
  float fb;                             // the frequency base, float32
};

struct ScanOut {
  int* bd;                              // [nb]
  int* cand;                            // [CAND_CAP], -1 filled
  int* run_start;                       // [RUN_CAP], -1 filled
  int* run_val;                         // [RUN_CAP], 0 filled
  long long* small;                     // [4]
  int* seam;                            // the state at position n - 1, or
                                        // nullptr
};

__device__ __forceinline__ int run_state(int cov, int multi) {
  return cov > 0 ? 2 : (multi > 0 ? 1 : 0);
}

// Start the copies of tile `tile`'s rows into the stage S, every row read
// below the valid length only (the coverage past it, and past n, counts
// as 0), and of the coverage and multi count at the tile's first position
// - 1.
__device__ __forceinline__ void scan_stage(const ScanIn& in, int tile,
                                           int* S) {
  const int base = tile * SCAN_TILE, v = in.valid;
  stage_row<SCAN_THREADS, SCAN_TILE>(S + SR_COV * SCAN_TILE, in.cov, base, v);
  stage_row<SCAN_THREADS, SCAN_TILE>(S + SR_CODES * SCAN_TILE, in.rc, base,
                                     v);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    stage_row<SCAN_THREADS, SCAN_TILE>(S + (SR_ACGT + k) * SCAN_TILE,
                                       in.acgt + (size_t)k * in.sa, base, v);
  stage_row<SCAN_THREADS, SCAN_TILE>(S + SR_MULTI * SCAN_TILE, in.multi, base,
                                     v);
  if (threadIdx.x == 0 && tile > 0) {
    const bool ok = base - 1 < v;
    int* const prev = S + SCAN_ROWS * SCAN_TILE;
    cp_async<4>(prev, ok ? in.cov + base - 1 : in.cov, ok);
    cp_async<4>(prev + 1, ok ? in.multi + base - 1 : in.multi, ok);
  }
}

// The staged tile `tile` of a launch of ntiles. With one stage, draws the
// block's next tile and stages it into S once the tile's rows are read and
// its aggregate published, so that its copies are in flight during the
// look-back -> the next tile (ntiles: none, or not drawn here).
__device__ __forceinline__ int scan_tile(const ScanIn& in, const ScanOut& out,
                                         const LookBack& lb, int tile,
                                         int ntiles, int* S, int* part,
                                         int* bdv, unsigned long long* sm,
                                         unsigned long long* ex_s,
                                         int* tile_s) {
  const int t = threadIdx.x;
  const int base = tile * SCAN_TILE, j0 = t * SCAN_ITEMS, p0 = base + j0;
  const int v = in.valid;
  const int* const R = S + j0;          // row r's items at R + r * SCAN_TILE
  int cv[SCAN_ITEMS];
  ld_items(R + SR_COV * SCAN_TILE, cv);
  int s = 0, al = 0;
  long long tc = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    s += cv[i];
    if (cv[i] > 0) {
      ++al;
      tc += cv[i];
    }
  }
  part[t] = s;
  __syncthreads();
  if (t < SCAN_BLOCKS) {
    int b = 0;
#pragma unroll
    for (int j = 0; j < BLOCK_THREADS; ++j) b += part[t * BLOCK_THREADS + j];
    const int d = b > 0 ? b / BLOCK_SIZE : 0;
    bdv[t] = d;
    const int blk = tile * SCAN_BLOCKS + t;
    if (blk < in.nb) out.bd[blk] = d;
  }
  // the largest count of a base other than the reference's, and the run
  // state of each position
  int cd[SCAN_ITEMS], nrm[SCAN_ITEMS], x[SCAN_ITEMS];
  ld_items(R + SR_CODES * SCAN_TILE, cd);
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) nrm[i] = -1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ld_items(R + (SR_ACGT + k) * SCAN_TILE, x);
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i)
      if (k != cd[i]) nrm[i] = max(nrm[i], x[i]);
  }
  ld_items(R + SR_MULTI * SCAN_TILE, x);
  // the run state before the thread's first position: staged, the tile's
  // first thread's too (0 at or past the valid length)
  int prev;
  if (t > 0)
    prev = run_state(R[SR_COV * SCAN_TILE - 1], R[SR_MULTI * SCAN_TILE - 1]);
  else if (tile > 0)
    prev = run_state(S[SCAN_ROWS * SCAN_TILE], S[SCAN_ROWS * SCAN_TILE + 1]);
  else
    prev = in.seam != nullptr ? *in.seam : -1;
  __syncthreads();                      // bdv
  const int cov_thr =
      in.somatic ? in.ad : max(bdv[t / BLOCK_THREADS] >> 1, in.ad);
  uint32_t cbits = 0, rbits = 0, sbits = 0;
  uint32_t nc = 0, nr = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    if (p0 + i < v) {
      const int c = cv[i];
      // the reference's float32 product, truncated toward zero
      const int sup =
          max(__float2int_rz(__fmul_rn((float)c, in.fb)) - 1, in.ad);
      if (c >= cov_thr && nrm[i] >= sup) {
        cbits |= 1u << i;
        ++nc;
      }
      const int st = run_state(c, x[i]);
      sbits |= (uint32_t)st << (2 * i);
      if (st != prev) {
        rbits |= 1u << i;
        ++nr;
      }
      prev = st;
    }
  }
  if (out.seam != nullptr && p0 <= in.n - 1 && in.n - 1 < p0 + SCAN_ITEMS)
    out.seam[0] = in.n - 1 < v
                      ? (int)((sbits >> (2 * (in.n - 1 - p0))) & 3u) : 0;
  // candidates in the low half, run starts in the high half: neither
  // count passes 2^32
  unsigned long long val[3] = {
      (unsigned long long)nc | (unsigned long long)nr << 32,
      (unsigned long long)al, (unsigned long long)tc};
  unsigned long long tot[3];
  block_scan<3, SCAN_THREADS>(val, tot, sm);
  publish_aggregate<3>(lb, tile, CHAIN_A, tot);
  int next = ntiles;
  if (SCAN_STAGES == 1) {
    next = draw_ticket(lb, ntiles, tile_s);   // past the rows' reads
    if (next < ntiles) scan_stage(in, next, S);
    cp_commit();
  }
  if (t < 32) {
    unsigned long long ex[3];
    look_back<3, true>(lb, tile, CHAIN_A, tot, ex);
    if (t == 0)
#pragma unroll
      for (int k = 0; k < 3; ++k) ex_s[k] = ex[k];
  }
  __syncthreads();
  const unsigned long long before = ex_s[0] + val[0];
  uint32_t dc = (uint32_t)before, dr = (uint32_t)(before >> 32);
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const int p = p0 + i;
    if ((cbits >> i) & 1u) {
      if (dc < (uint32_t)CAND_CAP) out.cand[dc] = p;
      ++dc;
    }
    if ((rbits >> i) & 1u) {
      if (dr < (uint32_t)RUN_CAP) {
        out.run_start[dr] = p;
        out.run_val[dr] = (int)((sbits >> (2 * i)) & 3u);
      }
      ++dr;
    }
  }
  if (tile == ntiles - 1 && t == 0) {
    const unsigned long long a = ex_s[0] + tot[0];
    out.small[0] = (long long)(a & 0xFFFFFFFFull);
    out.small[1] = (long long)(a >> 32);
    out.small[2] = (long long)(ex_s[1] + tot[1]);
    out.small[3] = (long long)(ex_s[2] + tot[2]);
  }
  return next;
}

// A persistent block, as evidence_finalize_kernel's.
__global__ void __launch_bounds__(SCAN_THREADS, SCAN_MIN_BLOCKS)
caller_scan_kernel(ScanIn in, ScanOut out, LookBack lb, int ntiles) {
  extern __shared__ __align__(16) int scan_smem[];
  __shared__ int part[SCAN_THREADS];
  __shared__ int bdv[SCAN_BLOCKS];
  __shared__ unsigned long long sm[3 * (SCAN_THREADS / 32)];
  __shared__ unsigned long long ex_s[3];
  __shared__ int tile_s;
  int tile = draw_ticket(lb, ntiles, &tile_s);
  if (tile < ntiles) scan_stage(in, tile, scan_smem);
  cp_commit();
  for (int s = 0; tile < ntiles; s ^= SCAN_STAGES - 1) {
    int next = ntiles;
    if (SCAN_STAGES > 1) {
      next = draw_ticket(lb, ntiles, &tile_s);
      if (next < ntiles)
        scan_stage(in, next, scan_smem + (s ^ 1) * SCAN_STAGE_INTS);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                    // every thread's copies landed
    const int early = scan_tile(in, out, lb, tile, ntiles,
                                scan_smem + s * SCAN_STAGE_INTS, part, bdv,
                                sm, ex_s, &tile_s);
    if (SCAN_STAGES == 1) next = early;
    tile = next;
  }
}

// ---- caller_fetch_kernel, caller_fetch_slice_kernel ------------------------

// One shard of a fetch's table: its finalized rows of `len` positions,
// genome positions off .. off + len - 1 (off a multiple of BLOCK_SIZE:
// its first block is off / BLOCK_SIZE). The single-card form is one
// shard at off 0, whose cpre is the exclusive prefix [len + 1]; a slice
// form shard's cpre is its inclusive prefix [len], after `before`, the
// coverage of the shards before it.
struct FetchShard {
  const int* acgt;                      // [4][len]
  const int* multi;                     // [len]
  const int* F;                         // [4][len]
  const int* cov;                       // [len]
  const long long* cpre;
  const int* bd;                        // block depths, or nullptr
  long long off, before;
  int len;
};

template <int NS>
struct FetchIn {
  FetchShard sh[NS];                    // in order of off (n of NS)
  const long long* idx;                 // [P positions | Q points | nbd]
  long long L;                          // positions clamp to [0, L - 1],
  int n, P, Q, nbd;                     // points to [0, L]
};

// The shard of x: the last whose first position (or block) is at or
// before x, shard 0 for an x before every shard; firsts sorted, n <= NS.
template <int NS>
__device__ __forceinline__ int fetch_shard(const long long* firsts, int n,
                                           long long x) {
  int s = 0;
#pragma unroll
  for (int step = NS / 2; step; step >>= 1)
    if (s + step < n && firsts[s + step] <= x) s += step;
  return s;
}

// The fetch (out int64[10 P + Q + nbd]) in one launch over every shard of
// the table. Blocks 0 .. ceil(P / FETCH_TILE) - 1 take FETCH_TILE
// positions each: two warps a group of 32 positions, each lane one
// position (clamped, its shard found by a search over the shards' first
// positions, the index local to the shard in 32 bits), each warp five of
// the ten columns, so a warp reads one column at 32 consecutive
// positions. The tile's columns meet in shared memory (a position's row
// of FETCH_PITCH words: an odd pitch, so a warp's writes of one column
// fall on 32 banks), and go out in the [P, 10] layout as 16-byte stores.
// The blocks after them take a point or a block a thread: a point's
// shard's prefix (single-card: cpre[q]; a slice: before + cpre[q - 1], or
// before at its local 0), a block's depth in the shard holding it. The
// shards' row addresses are staged in shared memory once a block.
template <bool SLICE, int NS>
__device__ __forceinline__ void fetch_body(const FetchIn<NS>& in,
                                           long long* __restrict__ out) {
  __shared__ const int* s_row[NS][10];
  __shared__ const long long* s_cpre[NS];
  __shared__ const int* s_bd[NS];
  __shared__ long long s_off[NS], s_boff[NS], s_before[NS];
  __shared__ int s_len[NS];
  __shared__ int s_tile[FETCH_TILE * FETCH_PITCH];
  const int t = threadIdx.x;
  const int ntile = (in.P + FETCH_TILE - 1) / FETCH_TILE;
  const bool tile = (int)blockIdx.x < ntile;
  const int t0 = blockIdx.x * FETCH_TILE;
  const int np = tile ? min(FETCH_TILE, in.P - t0) : 0;
  const int warp = t >> 5;
  const int j = (warp >> 1) * 32 + (t & 31);     // the tile's position
  const int c0 = (warp & 1) * 5;                 // the warp's columns
  const int i = (blockIdx.x - ntile) * FETCH_THREADS + t;
  // the element's index, read while the table is staged
  const bool have = tile ? j < np : i < in.Q + in.nbd;
  const long long x = have ? in.idx[tile ? t0 + j : in.P + i] : 0;
  // the table's fields at compile-time indices (a run-time index into the
  // parameters would copy them to local memory)
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (t == s && s < in.n) {
      const FetchShard& h = in.sh[s];
      for (int c = 0; c < 4; ++c) {
        s_row[s][c] = h.acgt + (size_t)c * h.len;
        s_row[s][5 + c] = h.F + (size_t)c * h.len;
      }
      s_row[s][4] = h.multi;
      s_row[s][9] = h.cov;
      s_cpre[s] = h.cpre;
      s_bd[s] = h.bd;
      s_off[s] = h.off;
      s_boff[s] = h.off / BLOCK_SIZE;
      s_before[s] = h.before;
      s_len[s] = h.len;
    }
  }
  __syncthreads();
  if (tile) {
    if (have) {
      const long long p = min(max(x, 0LL), in.L - 1);
      const int s = fetch_shard<NS>(s_off, in.n, p);
      const int lp = (int)min(max(p - s_off[s], 0LL),
                              (long long)s_len[s] - 1);
      int v[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) v[c] = __ldg(s_row[s][c0 + c] + lp);
#pragma unroll
      for (int c = 0; c < 5; ++c) s_tile[j * FETCH_PITCH + c0 + c] = v[c];
    }
    __syncthreads();
    // 16 bytes a store: out + 10 t0 lies on 16 bytes (t0 even), and each
    // pair of words (2i, 2i + 1) is one position's (10 is even)
    longlong2* o = reinterpret_cast<longlong2*>(out + 10LL * t0);
    for (int i = t; i < 5 * np; i += FETCH_THREADS) {
      const int a = i / 5, b = 2 * (i - a * 5);
      o[i] = make_longlong2(s_tile[a * FETCH_PITCH + b],
                            s_tile[a * FETCH_PITCH + b + 1]);
    }
    return;
  }
  if (!have) return;
  long long r;
  if (i < in.Q) {
    const long long q = min(max(x, 0LL), in.L);
    const int s = fetch_shard<NS>(s_off, in.n, q);
    const int lq = (int)min(max(q - s_off[s], 0LL), (long long)s_len[s]);
    if (SLICE)
      r = s_before[s] + (lq == 0 ? 0LL : s_cpre[s][lq - 1]);
    else
      r = s_cpre[s][lq];
  } else {
    const int s = fetch_shard<NS>(s_boff, in.n, x);
    r = s_bd[s][(int)(x - s_boff[s])];
  }
  out[10LL * in.P + i] = r;
}

// The single-card form's table holds its one shard (a small parameter
// block); the slice form's up to FETCH_MAX_SHARDS.
__global__ void __launch_bounds__(FETCH_THREADS)
caller_fetch_kernel(FetchIn<1> in, long long* __restrict__ out) {
  fetch_body<false>(in, out);
}

__global__ void __launch_bounds__(FETCH_THREADS)
caller_fetch_slice_kernel(FetchIn<FETCH_MAX_SHARDS> in,
                          long long* __restrict__ out) {
  fetch_body<true>(in, out);
}

// ---- nor_blocks_kernel, nor_blocks_slice_kernel ---------------------------
//
// key(p), the breaks at or before p, is non-decreasing in p, so a segment
// (key clamped to nseg - 1) is a range of positions, and a tile of
// NOR_TILE positions holds a range of segments sb .. se. Those strictly
// between lie inside the tile, and the tile writes their output itself.
// Its edges, sb (when it holds a position here) and se, may reach into
// other tiles: each tile adds its minima of an edge to the launch's words
// and counts its arrival; the arrival that completes the edge's tiles
// writes its output. Tile 0 writes the segments before its first, the
// last tile those after its last (empty: no position of [0, L) has their
// keys). So one launch writes every output word with no pass after it,
// and nothing is cleared between launches: each word carries the launch's
// epoch, and one of an earlier launch reads as empty.
//
// What bounds it is latency and the fold's instructions, not its bytes
// (4 a position; PERF.md has the cut-off timings): a tile's coverage
// copies are issued first, all at once, and its four searches (32-ary, a
// warp each: 3 dependent loads for 6,484 breaks) run under them; the
// fold takes a thread's 28 positions with no branch; an edge costs its
// last tile three round trips (its adds, its count, the words). Blocks
// are persistent, NOR_MIN_BLOCKS an SM, so that on a bacterial genome
// every tile is in flight in one wave.

struct NorIn {
  const int* cov;                       // [L]
  const long long* em;                  // [E] excluded positions, sorted
  const long long* brk;                 // [K] breaks, sorted
  int L, E, K, nseg;
  long long off;                        // slice form: position 0's global
};

// A launch's words and output: acc [3][nseg] = first position, minimum
// coverage (each epoch << 32 | INT32_MAX - minimum, combined by atomicMax,
// so that a word of an earlier launch, of a smaller epoch, loses to any
// of this one) and an edge's arrivals (epoch << 32 | count).
struct NorAcc {
  unsigned long long* acc;
  unsigned long long tag;               // epoch << 32
  int* out;                             // [3][nseg]
};

// In every lane: the entries of the sorted a[0..n) whose value clamped to
// [lo, hi] is below x. A 32-ary search: each step a lane reads one entry,
// the last of its 1/32 of the range, and the ballot of those below keeps
// one part: ceil(log32(n + 1)) dependent loads.
__device__ __forceinline__ int warp_count_below(const long long* a, int n,
                                                long long x, long long lo,
                                                long long hi) {
  const int lane = threadIdx.x & 31;
  long long l = 0, r = n;               // the count lies in [l, r]
  while (l < r) {
    const long long step = (r - l + 31) >> 5;
    const long long i = l + (lane + 1) * step - 1;
    const bool below = i < r && min(max(a[i], lo), hi) < x;
    const int c = __popc(__ballot_sync(FULL, below));
    r = min(l + (c + 1) * step - 1, r);
    l += c * step;
  }
  return (int)l;
}

// Entries j < n of a sorted sequence v(j) that are at most x: a binary
// search.
template <typename V>
__device__ __forceinline__ int count_to(V v, int n, int x) {
  int l = 0, r = n;
  while (l < r) {
    const int m = (l + r) >> 1;
    if (v(m) <= x)
      l = m + 1;
    else
      r = m;
  }
  return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Segment s's output: first position, minimum coverage, coverage at the
// first position clamped to [0, L).
__device__ __forceinline__ void nor_put(const NorIn& in, const NorAcc& acc,
                                        int s, int first, int mn, int cf) {
  acc.out[s] = first;
  acc.out[in.nseg + s] = mn;
  acc.out[2 * in.nseg + s] = cf;
}

// Segment s's output from the launch's words (read at L2, past L1); its
// first position and the coverage there only when they lie outside tile
// `head`, whose tile wrote them.
__device__ __forceinline__ void nor_put_words(const NorIn& in,
                                              const NorAcc& acc, int s,
                                              int head) {
  const unsigned long long epoch = acc.tag >> 32;
  const unsigned long long w0 = __ldcg(acc.acc + s);
  const unsigned long long w1 = __ldcg(acc.acc + in.nseg + s);
  const int first = w0 >> 32 == epoch ? I32_MAX - (int)(unsigned)w0
                                      : I32_MAX;
  acc.out[in.nseg + s] = w1 >> 32 == epoch ? I32_MAX - (int)(unsigned)w1
                                           : I32_MAX;
  if (first == I32_MAX || first / NOR_TILE != head) {
    acc.out[s] = first;
    acc.out[2 * in.nseg + s] = __ldg(in.cov + min(max(first, 0), in.L - 1));
  }
}

// The first and the last tile that segment s's positions span: [st, en)
// of the local positions, from lo = brk[s - 1] (s >= 1) and hi = brk[s]
// (s below K and nseg - 1; else the segment runs to L).
__device__ __forceinline__ int2 nor_tiles(const NorIn& in, int s,
                                          long long lo, long long hi,
                                          long long gb) {
  const long long st = s == 0 ? 0 : min(max(lo - gb, 0LL), (long long)in.L);
  const long long en = s >= in.K || s == in.nseg - 1
                           ? in.L
                           : min(max(hi - gb, 0LL), (long long)in.L);
  return make_int2((int)(st / NOR_TILE), (int)((en - 1) / NOR_TILE));
}

// One tile. The coverage copies go out first; meanwhile warps 0-3 find the
// tile's breaks and excluded positions (a search each). The breaks are
// staged relative to the tile when at most NOR_STAGE; the excluded
// positions are zeroed in the staged coverage (an excluded position is
// not normal, as an uncovered one). A thread folds its NOR_ITEMS
// consecutive positions into runs of equal segment (with at most one
// break position among them, nearly always, two runs read as 16-byte
// words with no branch): a run wholly
// inside the thread is done; its first run may continue the thread before
// it and its last the thread after. Lane i - 1's last run joins lane i's
// first of the same segment, else it is done; a segmented reduction over
// the lanes' first runs leaves each run of equal segment's minima in its
// first lane. A done run goes to the tile's slot of its segment in shared
// memory; past NOR_STAGE breaks, straight to the launch's words. Then the
// segments inside the tile are written, and threads 0 and 32 take the
// edges.
template <bool SLICE>
__device__ __forceinline__ void nor_tile(const NorIn& in, const NorAcc& acc,
                                         int tile, int ntiles,
                                         unsigned phase, int* s_cov,
                                         int* s_brk, int* s_first, int* s_min,
                                         int* s_rng,
                                         unsigned long long* s_bar) {
  const int t = threadIdx.x, lane = t & 31;
  const int base = tile * NOR_TILE;
  const int n = min(NOR_TILE, in.L - base);   // the tile's positions
  const long long NONE = (long long)1 << 62;
  // the global value of a break or an excluded position at local 0
  const long long gb = SLICE ? in.off : 0LL;
  const bool bulk = NOR_BULK && ((uintptr_t)in.cov & 15) == 0;
  __syncthreads();                      // the tile before is read
  if (bulk) {
    if (t == 0) {
      const int nb = 16 * (n >> 2);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (nb) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(smem_addr(s_bar)), "r"(nb) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            :: "r"(smem_addr(s_cov)), "l"(in.cov + base), "r"(nb),
               "r"(smem_addr(s_bar)) : "memory");
      } else {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     :: "r"(smem_addr(s_bar)) : "memory");
      }
    }
    for (int j = 4 * (n >> 2) + t; j < n; j += NOR_THREADS)
      s_cov[j] = in.cov[base + j];
  } else {
    stage_row<NOR_THREADS, NOR_TILE>(s_cov, in.cov, base, in.L);
    cp_commit();
  }
  const int w = t >> 5;
  if (w < 4) {                          // breaks below base, below the end;
    const long long x = gb + base + (w & 1 ? n : 0);   // exclusions alike
    const int c = w < 2 ? warp_count_below(in.brk, in.K, x, -NONE, NONE)
                        : warp_count_below(in.em, in.E, x, gb,
                                           gb + in.L - 1);
    if (lane == 0) s_rng[w] = c;
  }
  __syncthreads();
  const int kb = s_rng[0], nk = s_rng[1] - kb;
  const int eb = s_rng[2], ne = s_rng[3] - eb;
  const bool staged_b = nk <= NOR_STAGE;
  // the tile's segments sb .. se; thread 0 takes sb, thread 32 se
  const int sb = min(kb, in.nseg - 1), se = min(kb + nk, in.nseg - 1);
  const int es = t == 0 ? sb : se;
  long long lo = 0, hi = 0;             // brk[es - 1], brk[es]
  if (t == 0 || t == 32) {
    if (es >= 1) lo = in.brk[es - 1];
    if (es < in.K && es < in.nseg - 1) hi = in.brk[es];
  }
  // a break relative to the tile
  auto brel = [&](int j) {
    return staged_b ? s_brk[j] : (int)(in.brk[kb + j] - gb - base);
  };
  // an excluded position relative to the tile: it reads as uncovered
  auto erel = [&](int j) {
    return (int)(min(max(in.em[eb + j] - gb, 0LL), (long long)in.L - 1) -
                 base);
  };
  const int ex = t < ne ? erel(t) : -1;
  if (staged_b) {
    for (int j = t; j < nk; j += NOR_THREADS)
      s_brk[j] = (int)(in.brk[kb + j] - gb - base);
    for (int j = t; j <= nk; j += NOR_THREADS)
      s_first[j] = s_min[j] = I32_MAX;
  }
  if (bulk) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" :: "r"(smem_addr(s_bar)), "r"(phase) : "memory");
  } else {
    cp_wait<0>();
  }
  __syncthreads();                      // coverage and stages landed
  if (ex >= 0) s_cov[ex] = 0;
  for (int j = t + NOR_THREADS; j < ne; j += NOR_THREADS) s_cov[erel(j)] = 0;
  __syncthreads();
  auto emit = [&](int seg, int a, int c) {
    if (staged_b) {
      atomicMin(&s_first[seg - sb], a);
      atomicMin(&s_min[seg - sb], c);
    } else {
      atomicMax(&acc.acc[seg], acc.tag | (unsigned)(I32_MAX - a));
      atomicMax(&acc.acc[in.nseg + seg], acc.tag | (unsigned)(I32_MAX - c));
    }
  };
  // the thread's first run (fs, fa, fc) and, with two or more, its last
  // (ls >= 0): segment, first normal position, least coverage
  int fs = I32_MAX, fa = I32_MAX, fc = I32_MAX;
  int ls = -1, la = I32_MAX, lc = I32_MAX;
  const int q0 = t * NOR_ITEMS;
  if (q0 < n) {
    int ki = count_to(brel, nk, q0);            // breaks at or before q0
    int nb = ki < nk ? brel(ki) : I32_MAX;      // the next break
    int s = min(kb + ki, in.nseg - 1), a = I32_MAX, c = I32_MAX;
    if (t == 0) s_rng[4] = s;                   // the tile's first segment
    bool first = true;
    const int m = min(NOR_ITEMS, n - q0);
    // the break position after nb (past nb's duplicates), when nb is the
    // thread's
    int k2 = ki, n2 = nb;
    if (nb < q0 + NOR_ITEMS) {
      do {
        ++k2;
        n2 = k2 < nk ? brel(k2) : I32_MAX;
      } while (n2 <= nb);
    }
    if (m == NOR_ITEMS && n2 >= q0 + NOR_ITEMS) {
      // at most one break position among the thread's positions, nb: two
      // runs, [q0, nb) of s and [nb, ..) of s2, folded with no branch
      // from 16-byte shared-memory words, from the last to the first (a
      // run's first normal position is the last one seen)
      const int s2 = min(kb + k2, in.nseg - 1);
      int a2 = I32_MAX, c2 = I32_MAX;
#pragma unroll
      for (int i = NOR_ITEMS - 4; i >= 0; i -= 4) {
        const int4 v = *reinterpret_cast<const int4*>(s_cov + q0 + i);
        const int x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          const int q = q0 + i + j, cv = x[j];
          const bool late = q >= nb;
          if (cv > 0 && late) a2 = base + q;
          if (cv > 0 && !late) a = base + q;
          c2 = min(c2, cv > 0 && late ? cv : I32_MAX);
          c = min(c, cv > 0 && !late ? cv : I32_MAX);
        }
      }
      if (s2 == s) {
        a = min(a, a2);
        c = min(c, c2);
      } else {
        fs = s, fa = a, fc = c;
        first = false;
        s = s2, a = a2, c = c2;
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < m; ++i) {
        const int q = q0 + i;
        if (q >= nb) {                  // a break at q
          do {
            ++ki;
            nb = ki < nk ? brel(ki) : I32_MAX;
          } while (nb <= q);
          const int s2 = min(kb + ki, in.nseg - 1);
          if (s2 != s) {
            if (first) {
              fs = s, fa = a, fc = c;
              first = false;
            } else if (a != I32_MAX) {
              emit(s, a, c);            // a run inside the thread
            }
            s = s2, a = I32_MAX, c = I32_MAX;
          }
        }
        const int cv = s_cov[q];
        if (cv > 0) {
          a = min(a, base + q);
          c = min(c, cv);
        }
      }
    }
    if (first)
      fs = s, fa = a, fc = c;
    else
      ls = s, la = a, lc = c;
  }
  // lane - 1's last run: the head of this lane's first, or done
  const int pls = __shfl_up_sync(FULL, ls, 1);
  const int pla = __shfl_up_sync(FULL, la, 1);
  const int plc = __shfl_up_sync(FULL, lc, 1);
  if (lane > 0 && pls >= 0) {
    if (pls == fs) {
      fa = min(fa, pla);
      fc = min(fc, plc);
    } else if (pla != I32_MAX) {
      emit(pls, pla, plc);
    }
  }
  if (lane == 31 && ls >= 0 && la != I32_MAX) emit(ls, la, lc);
  // segmented minima over the lanes' first runs (fs non-decreasing)
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int s2 = __shfl_down_sync(FULL, fs, d);
    const int a2 = __shfl_down_sync(FULL, fa, d);
    const int c2 = __shfl_down_sync(FULL, fc, d);
    if (lane + d < 32 && s2 == fs) {
      fa = min(fa, a2);
      fc = min(fc, c2);
    }
  }
  const int sp = __shfl_up_sync(FULL, fs, 1);
  if ((lane == 0 || sp != fs) && fa != I32_MAX) emit(fs, fa, fc);
  if (!staged_b) __threadfence();       // the words, before the edges
  __syncthreads();
  const int sf = s_rng[4];              // sb, or above it: a break at base
  // the segments inside the tile
  for (int s = sb + 1 + t; s < se; s += NOR_THREADS) {
    if (staged_b) {
      const int f = s_first[s - sb];
      nor_put(in, acc, s, f, s_min[s - sb],
              f != I32_MAX ? s_cov[f - base] : __ldg(in.cov + in.L - 1));
    } else {
      nor_put_words(in, acc, s, -1);
    }
  }
  // before tile 0's first segment and after the last tile's, none
  const int cl = __ldg(in.cov + in.L - 1);
  if (tile == 0)
    for (int s = t; s < sf; s += NOR_THREADS)
      nor_put(in, acc, s, I32_MAX, I32_MAX, cl);
  if (tile == ntiles - 1)
    for (int s = se + 1 + t; s < in.nseg; s += NOR_THREADS)
      nor_put(in, acc, s, I32_MAX, I32_MAX, cl);
  // an edge: its minima here added to the words, then this tile's arrival;
  // the one that completes the edge's tiles writes it. The first of its
  // tiles that holds a normal position of it holds its first one: it
  // writes that position and the coverage there itself, before arriving.
  if ((t == 0 && sf == sb) || (t == 32 && se != sb)) {
    const int2 tt = nor_tiles(in, es, lo, hi, gb);
    const int j = es - sb;
    if (tt.x == tt.y && staged_b) {
      const int f = s_first[j];
      nor_put(in, acc, es, f, s_min[j],
              f != I32_MAX ? s_cov[f - base] : cl);
      return;
    }
    if (staged_b && s_first[j] != I32_MAX) {
      const int f = s_first[j];
      atomicMax(&acc.acc[es], acc.tag | (unsigned)(I32_MAX - f));
      atomicMax(&acc.acc[in.nseg + es],
                acc.tag | (unsigned)(I32_MAX - s_min[j]));
      if (tile == tt.x) {
        acc.out[es] = f;
        acc.out[2 * in.nseg + es] = s_cov[f - base];
      }
    } else if (!staged_b && tile == tt.x) {
      // this tile's adds are in the words, and any other tile's first
      // position of the segment lies past it
      const unsigned long long w = __ldcg(acc.acc + es);
      const int f = w >> 32 == acc.tag >> 32 ? I32_MAX - (int)(unsigned)w
                                             : I32_MAX;
      if (f != I32_MAX && f / NOR_TILE == tile) {
        acc.out[es] = f;
        acc.out[2 * in.nseg + es] = __ldg(in.cov + f);
      }
    }
    if (tt.x != tt.y) {
      // the count after the minima (release), the words after it (acquire)
      unsigned long long* cnt = acc.acc + 2 * in.nseg + es;
      unsigned long long k;
      atomicMax(cnt, acc.tag);          // an earlier launch's count: 0
      asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
                   : "=l"(k) : "l"(cnt), "l"(1ull) : "memory");
      if ((unsigned)k + 1 != (unsigned)(tt.y - tt.x + 1)) return;
    }
    nor_put_words(in, acc, es, tt.x != tt.y ? tt.x : -1);
  }
}

// Persistent blocks, tiles blockIdx.x + k * gridDim.x. The slice form
// (B4's NOR, a shard's positions 0 .. L - 1 of a genome's positions off
// ..): keys count the global breaks at or before off + p, and the
// excluded positions are global (the shard's own, sorted); its minima are
// local positions. out [3][nseg]: first position, minimum coverage
// (INT32_MAX for a segment with no normal position) and the coverage at
// the clamped first position.
template <bool SLICE>
__device__ __forceinline__ void nor_body(const NorIn& in, const NorAcc& acc,
                                         int ntiles) {
  __shared__ __align__(16) int s_cov[NOR_TILE];
  __shared__ int s_brk[NOR_STAGE];
  __shared__ int s_first[NOR_STAGE + 1], s_min[NOR_STAGE + 1];
  __shared__ int s_rng[5];
  __shared__ __align__(8) unsigned long long s_bar;
  if (NOR_BULK && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&s_bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  unsigned phase = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    nor_tile<SLICE>(in, acc, tile, ntiles, phase, s_cov, s_brk, s_first,
                    s_min, s_rng, &s_bar);
    phase ^= 1;
  }
}

__global__ void __launch_bounds__(NOR_THREADS, NOR_MIN_BLOCKS)
nor_blocks_kernel(NorIn in, NorAcc acc, int ntiles) {
  nor_body<false>(in, acc, ntiles);
}

__global__ void __launch_bounds__(NOR_THREADS, NOR_MIN_BLOCKS)
nor_blocks_slice_kernel(NorIn in, NorAcc acc, int ntiles) {
  nor_body<true>(in, acc, ntiles);
}

bool epoch_ok(int epoch) { return epoch >= 1 && epoch < (1 << 30); }

LookBack look_back_state(void* scratch, int epoch) {
  return LookBack{(unsigned int*)scratch,
                  (unsigned long long*)scratch + SLOT_WORDS,
                  (unsigned long long)epoch};
}

// The blocks of `kernel` (threads a block, smem bytes of dynamic shared
// memory, which it is first allowed) an SM holds, and the current
// device's SMs.
template <typename K>
cudaError_t resident(K* kernel, int threads, int smem, int* per_sm,
                     int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// One launch of the NOR blocks (SLICE: the slice form) over
// min(tiles, blocks an SM x SMs) persistent blocks.
template <bool SLICE>
int nor_launch(const void* cov, int L, const void* em, int E,
               const void* brk, int K, int nseg, long long off, void* out,
               void* scratch, int cap, int epoch, void* stream) {
  if (L < 1 || E < 0 || K < 0 || nseg < 1 || nseg > cap ||
      cap > (1 << 29) || off < 0 || cov == nullptr || out == nullptr ||
      scratch == nullptr || !epoch_ok(epoch) || (E > 0 && em == nullptr) ||
      (K > 0 && brk == nullptr) || (!SLICE && off != 0))
    return (int)cudaErrorInvalidValue;
  auto kernel = SLICE ? nor_blocks_slice_kernel : nor_blocks_kernel;
  int per_sm = 0, sms = 0;
  const cudaError_t err = resident(kernel, NOR_THREADS, 0, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (int)(((long long)L + NOR_TILE - 1) / NOR_TILE);
  const int grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  const NorIn in{(const int*)cov, (const long long*)em,
                 (const long long*)brk, L, E, K, nseg, off};
  const NorAcc acc{(unsigned long long*)scratch,
                   (unsigned long long)epoch << 32, (int*)out};
  kernel<<<grid, NOR_THREADS, 0, (cudaStream_t)stream>>>(in, acc, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The finalize's (which 0), the scan's (1) or the NOR blocks' (2)
// geometry on the current device: out int32[6] = positions a tile, threads
// a block, tiles staged a block, bytes of dynamic shared memory a block,
// blocks an SM, SMs (a launch runs min(tiles, blocks an SM x SMs)
// persistent blocks).
extern "C" int mc_calling_geometry(int which, void* out) {
  int* o = (int*)out;
  if (o == nullptr || which < 0 || which > 2)
    return (int)cudaErrorInvalidValue;
  if (which == 2) {
    o[0] = NOR_TILE;
    o[1] = NOR_THREADS;
    o[2] = 1;
    o[3] = 0;
    return (int)resident(nor_blocks_kernel, NOR_THREADS, 0, o + 4, o + 5);
  }
  o[0] = which ? SCAN_TILE : FIN_TILE;
  o[1] = which ? SCAN_THREADS : FIN_THREADS;
  o[2] = which ? SCAN_STAGES : FIN_STAGES;
  o[3] = which ? SCAN_SMEM : FIN_SMEM;
  return (int)(which ? resident(caller_scan_kernel, SCAN_THREADS, SCAN_SMEM,
                                o + 4, o + 5)
                     : resident(evidence_finalize_kernel, FIN_THREADS,
                                FIN_SMEM, o + 4, o + 5));
}

// The finalize fold over positions [0, n): acgt int32[4][sa], exact int32
// [>= n], fdiff int32[4][sf], mdiff int32[>= n]; the reference codes from rc
// int32[n] or from the text words (then written to rc_out, when not
// nullptr); carry int64[7] (the six int32 prefixes coming in, or nullptr
// for 0) and cov_in. Outputs acgt_out, F_out int32[4][n], multi_out,
// cov_out int32[n], cpre int64[n] (cpre[-1] too when lead), carry_out
// int64[7]: the six int32 prefixes at n - 1 and cov_in plus the coverage
// total. scratch int64[SLOT_WORDS * (1 + tiles)] holds no flag of this
// epoch: zeroed at first, then used by launches of smaller epochs only.
extern "C" int mc_evidence_finalize(
    const void* acgt, int sa, const void* exact, const void* fdiff, int sf,
    const void* mdiff, const void* rc, const void* words, const void* carry,
    long long cov_in, int n, void* acgt_out, void* F_out, void* multi_out,
    void* cov_out, void* cpre, int lead, void* rc_out, void* carry_out,
    void* scratch, int tiles, int epoch, void* stream) {
  const int ntiles = (n + FIN_TILE - 1) / FIN_TILE;
  if (n < 1 || n > (1 << 30) || sa < n || sf < n ||
      (rc == nullptr) == (words == nullptr) ||
      (rc_out != nullptr && words == nullptr) || carry_out == nullptr ||
      scratch == nullptr || tiles < ntiles || !epoch_ok(epoch))
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const cudaError_t err = resident(evidence_finalize_kernel, FIN_THREADS,
                                   FIN_SMEM, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const FinIn in{(const int*)acgt, (const int*)exact, (const int*)fdiff,
                 (const int*)mdiff, (const int*)rc, (const long long*)words,
                 (const long long*)carry, cov_in, sa, sf, n};
  const FinOut out{(int*)acgt_out, (int*)F_out, (int*)multi_out,
                   (int*)cov_out, (long long*)cpre, (int*)rc_out,
                   (long long*)carry_out, lead};
  const int grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  evidence_finalize_kernel<<<grid, FIN_THREADS, FIN_SMEM,
                             (cudaStream_t)stream>>>(
      in, out, look_back_state(scratch, epoch), ntiles);
  return (int)cudaGetLastError();
}

// The caller scan over positions [0, n), of which [0, valid) count: acgt
// int32[4][sa], multi, cov, rc int32[n]; seam int32[1] (the run state at
// position -1) or nullptr. tables int32[CAND_CAP + 2 * RUN_CAP] (the
// candidates, the run starts, the run values: filled with -1, -1 and 0
// here, then written up to their counts), bd int32[ceil(n / 100)], small
// int64[4] = (n_cand, n_runs, n_aligned, total_cov), seam_out int32[1] (the
// state at n - 1) or nullptr. Scratch as mc_evidence_finalize's.
extern "C" int mc_caller_scan(const void* acgt, int sa, const void* multi,
                              const void* cov, const void* rc, int n,
                              int valid, int ad, float fb, int somatic,
                              const void* seam, void* bd, void* tables,
                              void* small, void* seam_out, void* scratch,
                              int tiles, int epoch, void* stream) {
  const int ntiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (n < 1 || n > (1 << 30) || sa < n || valid < 0 || valid > n ||
      scratch == nullptr || tiles < ntiles || !epoch_ok(epoch))
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = resident(caller_scan_kernel, SCAN_THREADS, SCAN_SMEM,
                             &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  int* tab = (int*)tables;
  err = cudaMemsetAsync(tab, 0xFF, sizeof(int) * ((size_t)CAND_CAP + RUN_CAP),
                        st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(tab + CAND_CAP + RUN_CAP, 0,
                          sizeof(int) * (size_t)RUN_CAP, st);
  if (err != cudaSuccess) return (int)err;
  const int nb = (n + BLOCK_SIZE - 1) / BLOCK_SIZE;
  const ScanIn in{(const int*)acgt, (const int*)multi, (const int*)cov,
                  (const int*)rc, (const int*)seam, sa, n, valid, nb, ad,
                  somatic, fb};
  const ScanOut out{(int*)bd, tab, tab + CAND_CAP, tab + CAND_CAP + RUN_CAP,
                    (long long*)small, (int*)seam_out};
  const int grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  caller_scan_kernel<<<grid, SCAN_THREADS, SCAN_SMEM, st>>>(
      in, out, look_back_state(scratch, epoch), ntiles);
  return (int)cudaGetLastError();
}

// The launch of either fetch form: ntile position tiles, then a thread a
// point or block.
template <bool SLICE, int NS>
static int fetch_launch(const FetchIn<NS>& in, void* out, void* stream) {
  const long long tiles = (in.P + FETCH_TILE - 1) / FETCH_TILE;
  const long long blocks =
      tiles + ((long long)in.Q + in.nbd + FETCH_THREADS - 1) / FETCH_THREADS;
  if (blocks == 0) return (int)cudaSuccess;
  if (in.idx == nullptr || out == nullptr || (uintptr_t)out % 16 ||
      blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if constexpr (SLICE)
    caller_fetch_slice_kernel<<<(unsigned int)blocks, FETCH_THREADS, 0,
                                (cudaStream_t)stream>>>(in,
                                                        (long long*)out);
  else
    caller_fetch_kernel<<<(unsigned int)blocks, FETCH_THREADS, 0,
                          (cudaStream_t)stream>>>(in, (long long*)out);
  return (int)cudaGetLastError();
}

// The column fetch: out int64[10 P + Q + nbd] (on 16 bytes) from idx
// int64[P + Q + nbd] (positions, prefix points, blocks < the length of
// bd); acgt and F int32[4][L], multi and cov int32[L], cpre int64[L + 1],
// bd int32 (or nullptr when nbd is 0). One launch.
extern "C" int mc_caller_fetch(const void* acgt, const void* multi,
                               const void* F, const void* cov,
                               const void* cpre, const void* bd,
                               const void* idx, int L, int P, int Q, int nbd,
                               void* out, void* stream) {
  if (L < 1 || P < 0 || Q < 0 || nbd < 0 || (nbd > 0 && bd == nullptr))
    return (int)cudaErrorInvalidValue;
  FetchIn<1> in{};
  in.sh[0] = FetchShard{(const int*)acgt, (const int*)multi, (const int*)F,
                        (const int*)cov, (const long long*)cpre,
                        (const int*)bd, 0, 0, L};
  in.idx = (const long long*)idx;
  in.L = L;
  in.n = 1;
  in.P = P;
  in.Q = Q;
  in.nbd = nbd;
  return fetch_launch<false>(in, out, stream);
}

// The fetch's slice form (B4): out int64[10 P + Q + nbd] (on 16 bytes)
// over the n shards of table (n records of 9 int64 words: acgt, multi, F,
// cov, cpre, bd addresses, off, before, len; offs in order, each shard's
// positions [off, off + len) apart from the next's, off a multiple of
// BLOCK_SIZE), from idx int64[P + Q + nbd] in the caller's order: genome
// positions (clamped to [0, L - 1]), prefix points (clamped to [0, L];
// point q reads its shard's before + cpre[q - off - 1], or before at q =
// off) and genome blocks (each held by a shard with a bd). One launch.
extern "C" int mc_caller_fetch_slice(const void* table, int n, long long L,
                                     const void* idx, int P, int Q, int nbd,
                                     void* out, void* stream) {
  if (table == nullptr || n < 1 || n > FETCH_MAX_SHARDS || L < 1 || P < 0 ||
      Q < 0 || nbd < 0)
    return (int)cudaErrorInvalidValue;
  const long long* w = (const long long*)table;
  FetchIn<FETCH_MAX_SHARDS> in{};
  for (int s = 0; s < n; ++s, w += 9) {
    const long long off = w[6], len = w[8];
    if (off < 0 || off % BLOCK_SIZE || len < 1 || len > 0x7FFFFFFFLL ||
        (s && off < in.sh[s - 1].off + in.sh[s - 1].len) ||
        (P > 0 && (!w[0] || !w[1] || !w[2] || !w[3])) || (Q > 0 && !w[4]))
      return (int)cudaErrorInvalidValue;
    in.sh[s] = FetchShard{(const int*)w[0], (const int*)w[1],
                          (const int*)w[2], (const int*)w[3],
                          (const long long*)w[4], (const int*)w[5], off, w[7],
                          (int)len};
  }
  in.idx = (const long long*)idx;
  in.L = L;
  in.n = n;
  in.P = P;
  in.Q = Q;
  in.nbd = nbd;
  return fetch_launch<true>(in, out, stream);
}

// The NOR blocks: out int32[3 * nseg] = (first position, minimum coverage,
// coverage at the first position) a segment, from cov int32[L], em int64[E]
// and brk int64[K], both sorted (E or K may be 0). One launch of
// persistent blocks. scratch int64[3 * cap] (the launch's words),
// nseg <= cap, holds no word of this epoch or a later one: zeroed at
// first, then used by launches of smaller epochs only.
extern "C" int mc_nor_blocks(const void* cov, int L, const void* em, int E,
                             const void* brk, int K, int nseg, void* out,
                             void* scratch, int cap, int epoch,
                             void* stream) {
  return nor_launch<false>(cov, L, em, E, brk, K, nseg, 0, out, scratch,
                           cap, epoch, stream);
}

// The NOR blocks' slice form (B4, a shard): out int32[3 * nseg] = (first
// local position, minimum coverage, coverage at the clamped first local
// position) a segment over the shard's valid positions 0 .. L - 1, whose
// global positions are off .. off + L - 1: cov int32[>= L], em int64[E]
// the shard's own excluded positions (global, sorted, each in [off, off +
// L)), brk int64[K] every break (global, sorted). One launch, scratch as
// mc_nor_blocks's.
extern "C" int mc_nor_blocks_slice(const void* cov, int L, const void* em,
                                   int E, const void* brk, int K, int nseg,
                                   long long off, void* out, void* scratch,
                                   int cap, int epoch, void* stream) {
  return nor_launch<true>(cov, L, em, E, brk, K, nseg, off, out, scratch,
                          cap, epoch, stream);
}
