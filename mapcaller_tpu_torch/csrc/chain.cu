// The once-a-batch stages of the seed + chain dispatch after the seed scan,
// for Hopper (sm_90a). Built with nvcc into a plain C library and bound
// with ctypes (mapcaller_tpu_torch/ops/chain_kernels.py, which holds each
// kernel's plain PyTorch version beside its wrapper).
//
// Replaces XLA device programs of the reference package (no Pallas
// kernel): the hit expansion of build_seed_chain_kernel
// (mapcaller_tpu/ops/fm_search.py:704-731, jnp.repeat with
// total_repeat_length), sa_resolve (mapcaller_tpu/ops/fm_device.py:169-192,
// a fori_loop of inverse-Psi steps at :192), classify_reads
// (mapcaller_tpu/ops/chain_device.py:103-221) with the read words of
// fm_search.py:733-747, the folded evidence apply (ops/evidence.py:16,
// folded at fm_search.py:777-794) and the pack with its cumsum
// (fm_search.py:749-771, cumsum at :752). Three kernels, launched in this
// order on one stream:
//
//   chain_scan_kernel      the exclusive prefix sum of a per-read count and
//     the total, out[B], in one pass over tiles of SCAN_THREADS reads, a
//     tile a block, with decoupled look-back (Merrill & Garland, "Single-
//     pass Parallel Prefix Scan with Decoupled Look-back", 2016). On a
//     batch, each read's raw hits (the sum of its valid seeds' freq); it
//     also writes the hits kernel's start index (for each group of
//     HITS_GROUP hit slots, the flat seed slot that owns the group's first
//     slot and the hits before that seed) and zeroes each read's
//     unresolved flag, so the hits launch needs no memset before it. On
//     int32 counts it is the stand-alone scan (chain_scan).
//   chain_hits_kernel      a block per group of HITS_GROUP hit slots h < H:
//     from the group's start, the block stages the masked freqs of the
//     seeds it spans in shared memory, HITS_CHUNK at a time, with their
//     prefix; each thread finds its slot's seed there by binary search and
//     takes the SA row x0 + rank; the text position from the full SA, or
//     by walking inverse-Psi over the occ4 rows until the row is a
//     multiple of 32 (at most max_walk steps; a hit still unresolved flags
//     its read, and each slot's own flag is written when the caller asks,
//     as the mesh's map step does). Slots at or past min(total, H) hold the last seed slot's
//     values with valid 0, as jnp.repeat pads.
//   chain_hits_routed_kernel  the hits kernel over a genome-sharded SA
//     (-shards N): the full-SA gather, or each inverse-Psi step's occ4 row
//     and the sampled SA entry, read from its shard through a table of the
//     shards' base addresses (the reference's routed gathers,
//     mapcaller_tpu/parallel/sharded_index.py:176-285).
//   chain_hits_big_kernel  the hits kernel of the x64 big-genome path
//     (big_x64 under -shards N; mapcaller_tpu/parallel/big_index.py:97-107,
//     :249-271): the hit rows x0 + rank and the locations int64, each read
//     from an int64 SA in shards (RoutedSa64); full SA only, as the
//     reference's big path.
//   chain_classify_pack_kernel  a tile of CP_READS reads a block, a group
//     of CP_GROUP lanes a read. The block stages the tile's off, rlens and
//     flags, its read words (contiguous) and its hit range (contiguous:
//     hits are grouped by read) in shared memory, CP_HIT_CAP hits at a
//     time, and the chromosome ends when there are at most CP_KEY_CAP. A
//     group takes its read's hits CP_GROUP at a time, ballots on keep and
//     ranks by popcount, so the read's s-th kept hit (s < K_HITS) lands in
//     window slot s, on lane s % CP_GROUP; the window is sorted stably by
//     (pd, rpos) by counting ranks over shuffles (ties keep hit order, as
//     _sort_slots), the shuffles stopping at the warp's most kept hits.
//     Lane j takes the read's 16-base words j, j + CP_GROUP, ...: its two
//     text words, the mismatch and coverage bits; mm is a group sum, the
//     leftmost MM_SLOTS mismatches come from a group prefix of popcounts,
//     and the group's leader walks the gaps over 32-position chunks (runs
//     of uncovered bits) from the masks the lanes left in shared memory.
//     Then the class, pd, mm, rplast, cscore and mmp; with planes, the
//     FAST reads' evidence as int32 atomicAdds (integer adds commute, so
//     the planes equal the plain scatter's exactly). Then the pack in the
//     same block: a block scan of the tile's SLOW kept counts, the
//     look-back of chain_scan_kernel (the same device code) to the tile's
//     prefix, each SLOW read's kept hits from shared memory to its slots
//     (slots >= H2 dropped), the count words and the overflow words by
//     ballot; the block with the last tile, which holds the total, writes
//     the total kept and the buffer-overflow flag and zeroes the slots no
//     read fills. One launch where there were three (classify, the scan
//     of the slow counts, pack). CP_GROUP 2 and CP_READS 256 measured
//     fastest on an H100 (2, 4, 8 lanes; 32 to 512 reads): at 64
//     registers a thread an SM holds 1,024 threads, so at 8 lanes a batch
//     of 32,768 reads takes two waves of blocks, and at 2 or 4 one.
//   chain_classify_pack_big_kernel  the same body over int64 positions (the
//     x64 big-genome path; classify_reads with int64 locations,
//     mapcaller_tpu/parallel/big_index.py:273-291): hit locations,
//     diagonals, the text-word index, seq_len and the chromosome-end
//     compares in 64 bits, an empty slot INT64_MAX; pd and the packed
//     hits' locations go to an int64 side output; no evidence apply (the
//     sharded path applies evidence on its own planes). At least one block
//     an SM, so up to 128 registers a thread.
//
// Two more kernels are the collectives of the multichip mesh
// (parallel/mesh.py through ops/mesh_kernels.py), replacing the XLA
// programs of mapcaller_tpu/parallel/mesh.py's shard-mapped steps:
//
//   dp_scatter_scan_kernel (K1)  over n int32 partials read through a
//     table of their base addresses (peer memory across cards): the psum
//     (mesh.py:171-173, sum-only mode: the elementwise sum) and the
//     genome-sharded coverage (mesh.py:165-178 and :451-459: psum_scatter,
//     all_gather of the slices' totals, cumsum) in one pass: one launch a
//     distinct device, over the tiles of the padded length that start in
//     its slices, with the look-back of chain_scan_kernel over one status
//     array of every tile, so the tiles of a slice carry the totals of the
//     slices before it through the look-back (no totals pass). Bytes
//     bound it (n partials read once, the sum or the slices written once;
//     a few integer adds a byte); a tile of 4,096 elements a block of 512
//     threads keeps the loads coalesced (16 bytes a load where aligned)
//     and the scan's intermediates in shared memory (512 threads x 8
//     elements measured faster than 128 x 16, 256 x 8, 256 x 16 and
//     1,024 x 4, and than 4-byte loads, on an H100: mesh_variants.py).
//   evidence_apply_bits_kernel (K2)  the stand-alone evidence apply of the
//     main path (pipeline/device_profile.py: the per-batch apply, the dense
//     undo of a speculation, the sparse reject correction;
//     mapcaller_tpu/pipeline/device_profile.py:67-132) and phase B's
//     evidence (mesh.py:211-251): a warp an admit word of 32 reads (the
//     host's bitmask, or the chain kernel's classes: FAST admitted), which
//     it skips whole when no bit is set; 4 lanes a read, a lane a mismatch
//     slot, doing the folded apply's atomicAdds with sign +1 or -1
//     (apply_fast_evidence, the one body both kernels call). A few MB of
//     inputs a device, and its atomics scattered over planes far larger
//     than L2: bound by latency and by those atomics, one launch.
//
// Two more serve the x64 big-genome path's genome-sharded planes
// (pipeline/big_profile.py, B4) and the single-card planes' host merge:
//
//   evidence_apply_slice_kernel  K2's slice form, B4's apply
//     (mapcaller_tpu/pipeline/big_profile.py:103-187): the same body over
//     int64 pd into one shard's slice of the planes (positions [off, off +
//     Pl), rows of Pl, 64-bit row offsets); every endpoint and mismatch
//     position is clipped over the whole genome, as the reference does, and
//     only those the shard holds are added (a read whose span straddles a
//     seam adds its start in one shard and its end in the next). A launch a
//     shard a batch, each over all B reads.
//   host_merge_kernel  the host leg's sparse slow-read deltas, added once
//     at finalize (A5's build_host_merge_kernel, mapcaller_tpu/pipeline/
//     device_profile.py:136-165; B4's _merge_kernel, big_profile.py:
//     189-289): the (int64 index, int32 value) lists of the four planes,
//     each strictly increasing, cut on the host into segments, one a
//     (shard, list, row) of the shards a device holds; one launch a
//     device over every segment (see the kernel).
//     Bound by bytes: 12 B an entry read, its plane word read and written
//     (a 32-byte sector each way, the entries lying ~400 B apart).
//
// Bound on an H100 SXM (HBM3, 3.35 TB/s): bytes, for all three. The work a
// byte asks for is a few integer operations (a binary search of 15 steps,
// a popcount step of ~20 operations per 32-byte occ4 row, ~60 per 16 read
// bases), far below the 16.7 T int32 operations/s that would take longer
// than the bytes. chip_smoke.py counts each kernel's bytes from the run's
// own inputs (each input read once, each output written once, one SA entry
// or occ4 row per gather). The design keeps every per-hit and per-read
// intermediate of the XLA program (the K-slot windows, the [B, max_len]
// masks, the gap indices, the scattered index arrays, the slow counts and
// their prefix) on the chip: in registers, shuffles and shared memory.
//
// The kernels are latency-bound: a batch's counts, seed tables and hits
// are a few MB, well under a microsecond at the card's rate. So they
// spread their tiles over the card and wait on no second pass: each tile
// publishes its aggregate, then its inclusive prefix, in a 64-bit status
// word (epoch << 34 | flag << 32 | sum, relaxed stores and loads);
// warp 0 of a later tile reads up to LOOKBACK predecessors at a time and adds
// aggregates back to the nearest inclusive prefix. A tile's index is an
// atomic ticket, not blockIdx, so every tile a block waits on belongs to a
// block that already runs. The status words and the ticket live in a
// scratch the wrapper keeps per device: the epoch tag, one a launch from
// the wrapper, makes the words of earlier launches read as not ready, and
// the block that draws the last ticket resets the counter (no block draws
// one after it). Launches that share the scratch run one after another on
// one stream. Sums are uint32 and wrap modulo 2^32, as the plain version's
// int64 cumsum cast to int32 does; the start index assumes totals below
// 2^31, as off's int32 does. Loads are coalesced: a scan tile's [reads, S]
// int64 freqs, a hits block's seed freqs and a classify+pack block's hits
// and read words are staged in shared memory, consecutive threads on
// consecutive words. Where a thread per read used to walk a chain of
// dependent global loads (its offsets, each hit's keep flag and then its
// fields, a binary search of the chromosome ends, two text and two read
// words a chunk), a read's lanes now load its words side by side from
// shared memory, and the slow counts and their offsets never leave it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_HITS = 8;               // per-read hit window
constexpr int MAX_GAPS = 10;
constexpr int MM_SLOTS = 4;
constexpr int CLASS_NOCAND = 0, CLASS_FAST = 1, CLASS_SLOW = 2;
constexpr int PD_EMPTY = 0x7FFFFFFF;    // INT32_MAX: an empty window slot
constexpr long long PD_EMPTY64 = 0x7FFFFFFFFFFFFFFFLL;  // INT64_MAX
constexpr int SCAN_THREADS = 384;       // reads a scan tile, one a thread
constexpr int SCAN_MAX_S = 31;          // seed slots a read (max_len <= 496)
constexpr int LOOKBACK = 32;            // predecessors a look-back step reads
constexpr int HITS_GROUP = 256;         // hit slots a hits block
constexpr int HITS_ITEMS = 8;           // seeds a hits thread stages a chunk
constexpr int HITS_CHUNK = HITS_GROUP * HITS_ITEMS;
constexpr int CP_READS = 256;           // reads a classify+pack tile
constexpr int CP_GROUP = 2;             // lanes a read
constexpr int CP_THREADS = CP_READS * CP_GROUP;
constexpr int CP_SLOTS = K_HITS / CP_GROUP;   // window slots a lane
constexpr int CP_HIT_CAP = 2048;        // hits a block stages at a time
constexpr int CP_KEY_CAP = 1024;        // chromosome ends staged, at most
constexpr int CP_MAX_WORDS = 31;        // read words (max_len <= 496)
constexpr int DP_THREADS = 512;         // threads a K1 tile
constexpr int DP_ITEMS = 8;             // elements a K1 thread scans
constexpr int DP_TILE = DP_THREADS * DP_ITEMS;
static_assert(DP_TILE % (4 * DP_THREADS) == 0,
              "K1: whole int4 loads a thread");
constexpr int DP_SUM = 0, DP_SCAN = 1;  // K1's modes
constexpr int APPLY_THREADS = 128;      // a K2 block: a warp an admit word
constexpr int APPLY_LANES = MM_SLOTS;   // K2's lanes a read, a lane a slot
constexpr int MERGE_THREADS = 256;      // a host-merge block: a unit a
constexpr int MERGE_ITEMS = 8;          // thread, of 8 consecutive entries
constexpr int MERGE_MAX_SEGS = 512;     // segments a launch stages

// ---- chain_scan_kernel ---------------------------------------------------

constexpr unsigned long long FLAG_AGGREGATE = 1, FLAG_PREFIX = 2;
constexpr unsigned int FULL = 0xFFFFFFFFu;

struct ScanState {
  unsigned int* ticket;                 // tiles handed out this launch
  unsigned long long* status;           // [tiles]: epoch<<34 | flag<<32 | sum
  unsigned int epoch;                   // this launch's tag, 1 .. 2^30 - 1
};

struct SeedOut {                        // the seed-freq scan's extras
  int2* start;                          // [ngroups], or nullptr
  uint8_t* unresolved;                  // [B], zeroed; or nullptr
  int ngroups;
};

// A status word is the whole message (epoch, flag and sum in one 64-bit
// word, written and read whole): no other data is published through it, so
// relaxed loads and stores at gpu scope suffice (they measured ~1 us faster
// a launch than acquire / release on an H100). Sys: at system scope, for
// status words that launches on other cards poll and write (K1 over
// several cards, whose status array lives on the first card).
template <bool Sys = false>
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  if constexpr (Sys)
    asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <bool Sys = false>
__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  if constexpr (Sys)
    asm volatile("st.relaxed.sys.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
  else
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// Exclusive scan of one value a thread over a block of NT threads: returns
// the thread's exclusive prefix and sets *total. warp_sum: NT/32 words of
// shared memory; ends with the block synchronised.
template <int NT>
__device__ __forceinline__ uint32_t block_excl_scan(uint32_t mine,
                                                    uint32_t* warp_sum,
                                                    uint32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sum[w] = inc;
  __syncthreads();
  if (w == 0) {
    uint32_t ws = lane < NT / 32 ? warp_sum[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, ws, d);
      if (lane >= d) ws += y;
    }
    if (lane < NT / 32) warp_sum[lane] = ws;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_sum[NT / 32 - 1];
  const uint32_t before = w > 0 ? warp_sum[w - 1] : 0u;
  __syncthreads();                      // warp_sum may be written again
  return before + inc - mine;
}

// The block's tile: an atomic ticket, not blockIdx, so every tile a block
// waits on in the look-back belongs to a block that already runs. The block
// that draws the last ticket resets the counter (no block draws one after
// it). Ends with the block synchronised.
__device__ __forceinline__ int draw_ticket(const ScanState& ss, int* tile_s) {
  if (threadIdx.x == 0) {
    const int k = (int)atomicAdd(ss.ticket, 1u);
    if (k == (int)gridDim.x - 1) *ss.ticket = 0u;   // every other is taken
    *tile_s = k;
  }
  __syncthreads();
  return *tile_s;
}

// Warp 0 of tile `tile`: publish the tile's aggregate, look back to the
// nearest inclusive prefix, publish the tile's own; returns the sum of the
// tiles before it (in every lane). Sys: the status words at system scope.
template <bool Sys = false>
__device__ __forceinline__ uint32_t look_back(const ScanState& ss, int tile,
                                              uint32_t agg) {
  const int lane = threadIdx.x & 31;
  const unsigned long long tag = (unsigned long long)ss.epoch << 34;
  if (tile == 0) {
    if (lane == 0) st_relaxed<Sys>(ss.status, tag | FLAG_PREFIX << 32 | agg);
    return 0u;
  }
  if (lane == 0)
    st_relaxed<Sys>(ss.status + tile, tag | FLAG_AGGREGATE << 32 | agg);
  uint32_t excl = 0;
  for (int top = tile - 1;; top -= LOOKBACK) {
    const int i = top - (LOOKBACK - 1) + lane;   // lane 31: the nearest
    unsigned long long st;
    bool ready;
    do {                                // slots before tile 0 hold prefix 0
      st = i >= 0 ? ld_relaxed<Sys>(ss.status + i)
                  : (tag | FLAG_PREFIX << 32);
      ready = (st >> 34) == ss.epoch;
    } while (!__all_sync(FULL, ready));
    const uint32_t pm = __ballot_sync(FULL, ((st >> 32) & 3u) == FLAG_PREFIX);
    // from the nearest inclusive prefix on: it and the aggregates after it
    const int from = pm ? 31 - __clz(pm) : 0;
    uint32_t v = lane >= from ? (uint32_t)st : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    excl += v;
    if (pm) break;
  }
  if (lane == 0)
    st_relaxed<Sys>(ss.status + tile, tag | FLAG_PREFIX << 32 | (excl + agg));
  return excl;
}

__global__ void __launch_bounds__(SCAN_THREADS)
chain_scan_kernel(const long long* __restrict__ freq,
                  const long long* __restrict__ n,
                  const int* __restrict__ cnt, int B, int S,
                  int* __restrict__ out, SeedOut so, ScanState ss) {
  extern __shared__ uint32_t sf[];      // seed freqs: [SCAN_THREADS, S]
  __shared__ uint32_t warp_sum[SCAN_THREADS / 32];
  __shared__ int tile_s;
  __shared__ uint32_t excl_s;
  const int t = threadIdx.x;
  const int ntiles = gridDim.x;
  const int tile = draw_ticket(ss, &tile_s);
  const int b0 = tile * SCAN_THREADS, b = b0 + t;
  const int nr = min(SCAN_THREADS, B - b0);  // reads in the tile
  uint32_t mine = 0;
  if (freq != nullptr) {
    // the tile's rows, consecutive threads on consecutive words; a seed
    // slot counts when its index is below the read's n
    const long long* f0 = freq + (size_t)b0 * S;
    for (int e = t; e < nr * S; e += SCAN_THREADS) {
      const int r = e / S;
      const long long f = f0[e];
      const long long nv = n == nullptr ? S : n[b0 + r];
      sf[e] = e - r * S < nv ? (uint32_t)f : 0u;
    }
    __syncthreads();
    if (t < nr)
      for (int j = 0; j < S; ++j) mine += sf[t * S + j];
  } else if (t < nr) {
    mine = (uint32_t)cnt[b];
  }
  uint32_t agg;
  const uint32_t excl_in = block_excl_scan<SCAN_THREADS>(mine, warp_sum, &agg);
  if (t < 32) {
    const uint32_t excl = look_back(ss, tile, agg);
    if (t == 0) excl_s = excl;
  }
  __syncthreads();
  const uint32_t base = excl_s + excl_in;     // hits before read b
  if (t < nr) out[b] = (int)base;
  const bool last_tile = tile == ntiles - 1;
  if (last_tile && t == 0) out[B] = (int)(excl_s + agg);
  if (freq == nullptr) return;
  if (so.unresolved != nullptr && t < nr) so.unresolved[b] = 0;
  if (so.start == nullptr) return;
  // the start index: each group whose first slot falls in one of read b's
  // seeds names that seed and the hits before it
  if (t < nr) {
    uint32_t p = base;
    for (int j = 0; j < S; ++j) {
      const uint32_t f = sf[t * S + j];
      for (uint32_t g = (p + HITS_GROUP - 1) / HITS_GROUP;
           g < (uint32_t)so.ngroups && g * HITS_GROUP < p + f; ++g)
        so.start[g] = make_int2(b * S + j, (int)p);
      p += f;
    }
  }
  // groups at or past the total: past the last seed slot, as
  // torch.searchsorted (side right) finds them
  if (last_tile) {
    const uint32_t total = excl_s + agg;
    for (uint32_t g = (total + HITS_GROUP - 1) / HITS_GROUP + t;
         g < (uint32_t)so.ngroups; g += SCAN_THREADS)
      so.start[g] = make_int2(B * S, (int)total);
  }
}

// ---- chain_hits_kernel ---------------------------------------------------

// The SA tables a hits kernel reads: one copy (Fm, the main path), or
// split over shards (RoutedFm, -shards N, ops/routed.py): entry r of a
// routed table lives in shard r / per at local entry r % per, whose base
// address its shard table holds; or the x64 big-genome SA (RoutedSa64,
// big_x64 under -shards N): int64 entries in shards, rows and positions
// int64 (Pos), full SA only (no walk: kWalk). The kernel body is a
// template over them, so chain_hits_kernel compiles as it did.
struct Fm {
  static constexpr bool kWalk = true;
  using Pos = int;
  const int* occ;                       // int32[nw+1, 8] occ4 rows
  const long long* L2;                  // int64[5]
  const long long* sa_samp;             // int64[n/32+1]
  const int* sa_full;                   // int32[n+1], or nullptr
  int primary, max_walk;
  __device__ __forceinline__ bool full() const { return sa_full != nullptr; }
  __device__ __forceinline__ const int4* occ_row(int w) const {
    return reinterpret_cast<const int4*>(occ + (size_t)w * 8);
  }
  __device__ __forceinline__ int sa(int r) const { return __ldg(sa_full + r); }
  __device__ __forceinline__ int samp(int r) const {
    return (int)__ldg(sa_samp + r);
  }
};

struct RoutedFm {
  static constexpr bool kWalk = true;
  using Pos = int;
  const unsigned long long* occ;        // [n] shards of int32[per, 8]
  const long long* L2;                  // int64[5]
  const unsigned long long* sa_samp;    // [n] shards of int64[per]
  const unsigned long long* sa_full;    // [n] shards of int32[per], or
                                        // nullptr
  int primary, max_walk;
  unsigned occ_per, samp_per, full_per;
  __device__ __forceinline__ bool full() const { return sa_full != nullptr; }
  __device__ __forceinline__ const int4* occ_row(int w) const {
    const unsigned s = (unsigned)w / occ_per;
    const int* p = reinterpret_cast<const int*>(__ldg(occ + s));
    return reinterpret_cast<const int4*>(
        p + (size_t)((unsigned)w - s * occ_per) * 8);
  }
  __device__ __forceinline__ int sa(int r) const {
    const unsigned s = (unsigned)r / full_per;
    const int* p = reinterpret_cast<const int*>(__ldg(sa_full + s));
    return __ldg(p + ((unsigned)r - s * full_per));
  }
  __device__ __forceinline__ int samp(int r) const {
    const unsigned s = (unsigned)r / samp_per;
    const long long* p =
        reinterpret_cast<const long long*>(__ldg(sa_samp + s));
    return (int)__ldg(p + ((unsigned)r - s * samp_per));
  }
};

struct RoutedSa64 {
  static constexpr bool kWalk = false;
  using Pos = long long;
  const unsigned long long* sa_full;    // [n] shards of int64[per]
  unsigned long long per;
  __device__ __forceinline__ long long sa(long long r) const {
    const unsigned long long s = (unsigned long long)r / per;
    const long long* p = reinterpret_cast<const long long*>(__ldg(sa_full + s));
    return __ldg(p + ((unsigned long long)r - s * per));
  }
};

struct Seeds {
  const long long *n, *rpos, *len, *x0, *freq;   // [B], [B, S] x4
  int B, S;
};

template <class P>
struct HitsT {
  int *read, *rpos, *len;               // int32[H]
  P* loc;                               // [H], int32 or int64
  uint8_t *valid, *keep;                // [H] (torch.bool)
  uint8_t* unresolved;                  // [B], zeroed by the seed-freq scan
  uint8_t* resolved = nullptr;          // [H] each slot's flag, or nullptr
};
using Hits = HitsT<int>;

__device__ __forceinline__ int pick4(const int4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// One LF step (ref: bwt_search.cpp:101-107; ops/fm_device.py::inv_psi):
// one 32-byte row gives both the BWT code at k and its occ count.
template <class F>
__device__ __forceinline__ int inv_psi(const F& fm, int k) {
  const int kadj = k - (k >= fm.primary ? 1 : 0);
  const int4* row = fm.occ_row(kadj >> 4);
  const int4 cnt = __ldg(row), wv = __ldg(row + 1);
  const uint32_t word = (uint32_t)wv.x;
  const int crumb = (~kadj) & 15;
  const int c = (int)((word >> (crumb << 1)) & 3u);
  const uint32_t keep = ~((1u << (2 * crumb)) - 1u) & 0x55555555u;
  const uint32_t nx = ~(word ^ ((uint32_t)c * 0x55555555u));
  const int occ_kc = pick4(cnt, c) + __popc(nx & (nx >> 1) & keep);
  return k == fm.primary ? 0 : (int)__ldg(fm.L2 + c) + occ_kc;
}

// Staged word e of a chunk: one pad word every 32, so a thread's
// HITS_ITEMS consecutive words fall in distinct banks across its warp.
__host__ __device__ constexpr int padded(int e) { return e + (e >> 5); }

template <class F>
__device__ __forceinline__ void hits_body(const int* __restrict__ off,
                                          const int2* __restrict__ start,
                                          Seeds sd, F fm, int H,
                                          HitsT<typename F::Pos> o) {
  using P = typename F::Pos;
  __shared__ uint32_t pre[padded(HITS_CHUNK)];
  __shared__ uint32_t warp_sum[HITS_GROUP / 32];
  const int t = threadIdx.x;
  const int B = sd.B, S = sd.S, BS = B * S;
  const int h0 = blockIdx.x * HITS_GROUP, h = h0 + t;
  const int nvalid = min(off[B], H);    // slots [0, nvalid) hold hits
  const int last = min(h0 + HITS_GROUP, nvalid) - 1;  // the block's last
  int seed = BS - 1, pos = 0;           // padding: the last seed slot
  bool found = false;
  if (last >= h0) {                     // the same in the whole block
    const int2 st = start[blockIdx.x];
    int lo = st.x;                      // the seed of slot h0
    uint32_t base = (uint32_t)st.y;     // hits before seed lo
    for (;;) {
      // the masked freqs of seeds lo .. lo + HITS_CHUNK - 1, coalesced
#pragma unroll
      for (int k = 0; k < HITS_ITEMS; ++k) {
        const int e = k * HITS_GROUP + t, i = lo + e;
        uint32_t v = 0;
        if (i < BS) {
          const int r = i / S;
          const long long f = sd.freq[i], nv = sd.n[r];
          v = i - r * S < nv ? (uint32_t)f : 0u;
        }
        pre[padded(e)] = v;
      }
      __syncthreads();
      // their inclusive prefix: HITS_ITEMS consecutive seeds a thread,
      // then over the threads
      uint32_t run = 0;
#pragma unroll
      for (int k = 0; k < HITS_ITEMS; ++k) {
        const int e = padded(t * HITS_ITEMS + k);
        run += pre[e];
        pre[e] = run;
      }
      uint32_t ctot;
      const uint32_t before =
          block_excl_scan<HITS_GROUP>(run, warp_sum, &ctot);
#pragma unroll
      for (int k = 0; k < HITS_ITEMS; ++k)
        pre[padded(t * HITS_ITEMS + k)] += before;
      __syncthreads();
      const uint32_t r = (uint32_t)(h - (int)base);  // rank past the chunk
      if (h < nvalid && !found && r < ctot) {
        // the first staged seed whose inclusive prefix passes r
        int a = 0, z = HITS_CHUNK - 1;
        while (a < z) {
          const int mid = (a + z) >> 1;
          if (pre[padded(mid)] > r) z = mid; else a = mid + 1;
        }
        seed = lo + a;
        pos = (int)(r - (a > 0 ? pre[padded(a - 1)] : 0u));
        found = true;
      }
      if ((uint32_t)(last - (int)base) < ctot || lo + HITS_CHUNK >= BS) break;
      base += ctot;
      lo += HITS_CHUNK;
      __syncthreads();                  // every search ends before the stores
    }
  }
  if (h >= H) return;
  const bool valid = h < nvalid;
  const int b = seed / S;
  const int rpos = (int)sd.rpos[seed], len = (int)sd.len[seed];
  const P row = valid ? (P)sd.x0[seed] + pos : (P)32;
  P loc;
  bool resolved = valid;
  if constexpr (!F::kWalk) {
    loc = fm.sa(row);
  } else if (fm.full()) {
    loc = fm.sa(row);
  } else {
    // an inactive slot walks no step: sa_samp[32 >> 5]
    int k = row, steps = 0;
    if (valid)
      while (steps < fm.max_walk && (k & 31)) {
        k = inv_psi(fm, k);
        ++steps;
      }
    resolved = valid && (k & 31) == 0;
    loc = steps + fm.samp(k >> 5);
  }
  o.read[h] = b;
  o.rpos[h] = rpos;
  o.len[h] = len;
  o.loc[h] = loc;
  o.valid[h] = valid;
  o.keep[h] = valid && loc - rpos > 0;
  if (o.resolved != nullptr) o.resolved[h] = resolved;
  if (valid && !resolved) o.unresolved[b] = 1;
}

__global__ void __launch_bounds__(HITS_GROUP)
chain_hits_kernel(const int* __restrict__ off, const int2* __restrict__ start,
                  Seeds sd, Fm fm, int H, Hits o) {
  hits_body(off, start, sd, fm, H, o);
}

// The hits kernel over a genome-sharded SA (-shards N).
__global__ void __launch_bounds__(HITS_GROUP)
chain_hits_routed_kernel(const int* __restrict__ off,
                         const int2* __restrict__ start, Seeds sd,
                         RoutedFm fm, int H, Hits o) {
  hits_body(off, start, sd, fm, H, o);
}

// The hits kernel over the x64 big-genome SA: int64 rows and locations.
__global__ void __launch_bounds__(HITS_GROUP)
chain_hits_big_kernel(const int* __restrict__ off,
                      const int2* __restrict__ start, Seeds sd, RoutedSa64 fm,
                      int H, HitsT<long long> o) {
  hits_body(off, start, sd, fm, H, o);
}

// ---- chain_classify_pack_kernel ------------------------------------------

// The classify+pack kernel over positions of type P: int32 (the main
// path and -shards N), or int64 (the x64 big-genome path, whose text
// positions, diagonals and hit locations may pass 2^31). An empty window
// slot holds P's largest value (the plain version's iinfo max of the
// position dtype).
template <class P>
__device__ __forceinline__ P pd_empty() {
  if constexpr (sizeof(P) == 4) return PD_EMPTY;
  else return PD_EMPTY64;
}

// a + b wrapping modulo 2^64, as the plain version's int64 sums do (an
// empty slot's diagonal plus a read length)
__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

template <class P>
struct CtxT {
  const long long* text;                // packed 2-bit text, bwa order,
                                        // 32 bits a word in int64
  const long long* bkeys;               // sorted chromosome ends
  int ntext, nkeys;
  P seq_len;
};

// The planes an evidence apply adds to: the adds of one read
// (apply_fast_evidence) at global positions p of a genome of L, a row of
// the orientation or allele plane picked by `row`.
struct Planes {
  int *exact, *fd, *acgt;               // int32[L+2], [4(L+2)], [4(L+1)]
  int L, pair_end;                      // exact == nullptr: no apply

  __device__ __forceinline__ void add_exact(long long p, int v) const {
    atomicAdd(exact + p, v);
  }
  __device__ __forceinline__ void add_fd(int row, long long p, int v) const {
    atomicAdd(fd + row * (L + 2LL) + p, v);
  }
  __device__ __forceinline__ void add_acgt(int row, long long p,
                                           int v) const {
    atomicAdd(acgt + row * (L + 1LL) + p, v);
  }
};

// A shard's slice of the planes of the x64 big-genome path (B4): positions
// [off, off + Pl) of every plane, each row Pl long; an add at a position
// the shard does not hold is dropped. Row offsets in 64 bits: row * Pl
// passes 2^31 at human scale.
struct SlicePlanes {
  int *exact, *fd, *acgt;               // int32[Pl], [4][Pl], [4][Pl]
  long long L, off, Pl;
  int pair_end;

  __device__ __forceinline__ void add_at(int* plane, int row, long long p,
                                         int v) const {
    const long long li = p - off;
    if (li >= 0 && li < Pl) atomicAdd(plane + row * Pl + li, v);
  }
  __device__ __forceinline__ void add_exact(long long p, int v) const {
    add_at(exact, 0, p, v);
  }
  __device__ __forceinline__ void add_fd(int row, long long p, int v) const {
    add_at(fd, row, p, v);
  }
  __device__ __forceinline__ void add_acgt(int row, long long p,
                                           int v) const {
    add_at(acgt, row, p, v);
  }
};

template <class P>
struct CpInT {
  const int* off;                       // [B+1], the seed-freq scan's
  const int *rpos, *len;                // hits, int32[H]
  const P* loc;                         // [H]
  const uint8_t* keep;                  // [H]
  const uint8_t *unresolved, *overflow; // [B]
  const uint32_t* packed;               // [B, max_len/16] words
  const int* rlens;                     // [B]
  int B, H, H2, max_len;
};

// Where the packed output goes: the int32 vector's fields, and pd and
// hit_loc in P (in the int32 vector at P = int; an int64 side output at P
// = long long).
template <class P>
struct CpOut {
  int* meta;                            // [B]
  P* pd;                                // [B]
  int* hit_w;                           // [H2]
  P* hit_l;                             // [H2]
  int* counts2;                         // [B/2]
  int* ovf;                             // [B/32], total kept, overflow
};

// Slot q of read b's evidence, for an admitted FAST read
// (ops/evidence.py::scatter_fast_evidence): slot 0 also adds the read's
// span, the exact-coverage and orientation range endpoints (the plane by
// read-index parity when pair_end); a mismatch e >= 0 (r << 2 | base)
// punches a coverage hole and adds its base. sign +1 applies, -1 retracts.
// Integer atomics commute, so the planes equal the plain scatter's exactly.
// Positions in 64 bits: a read with no hit has pd INT32_MAX, and its sums
// clip to 0 as the plain version's int64 ones do. The one body of
// classify+pack's folded apply (a lane a slot) and of
// evidence_apply_bits_kernel (a thread a read) over the whole planes
// (Planes), and of evidence_apply_slice_kernel over a shard's slice
// (SlicePlanes: the same positions, each add kept by the shard that holds
// it).
template <class PL>
__device__ __forceinline__ void apply_fast_evidence(const PL& pl,
                                                    long long two_l,
                                                    long long pd, int rlen,
                                                    int b, int q, int e,
                                                    int sign) {
  const long long L = pl.L;
  const bool ori = pd < L;
  if (q == 0) {
    const long long gs = min(max(ori ? pd : two_l - pd - rlen, 0LL), L - 1);
    const long long end = min(gs + rlen, L);
    const bool first = !pl.pair_end || (b & 1) == 0;
    const int row = first ? (ori ? 0 : 3) : (ori ? 1 : 2);
    pl.add_exact(gs, sign);
    pl.add_exact(end, -sign);
    pl.add_fd(row, gs, sign);
    pl.add_fd(row, end, -sign);
  }
  if (e >= 0) {
    const long long at = pd + (e >> 2);
    const long long p = min(max(ori ? at : two_l - 1 - at, 0LL), L - 1);
    const int base = ori ? (e & 3) : 3 - (e & 3);
    pl.add_exact(p, -sign);
    pl.add_exact(p + 1, sign);
    pl.add_acgt(base, p, sign);
  }
}

// (a_pd, a_rp) after (b_pd, b_rp): _sort_slots' swap test.
template <class P>
__device__ __forceinline__ bool after(P a_pd, int a_rp, P b_pd, int b_rp) {
  return a_pd > b_pd || (a_pd == b_pd && a_rp > b_rp);
}

// Bits [lo, hi) of a 32-position chunk, clipped to it.
__device__ __forceinline__ uint32_t span_bits(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 32);
  if (lo >= hi) return 0u;
  const uint32_t upto = hi >= 32 ? 0xFFFFFFFFu : ((1u << hi) - 1u);
  return upto & ~((1u << lo) - 1u);
}

// 16 bases of a uint32 word with base j at bits 2j (the packed batch read
// little-endian) -> bwa crumb order, base j at bits 30 - 2j.
__device__ __forceinline__ uint32_t to_bwa(uint32_t le) {
  const uint32_t r = __brev(le);
  return ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
}

// Mismatch crumbs of two bwa words -> 16 bits, bit j = base j differs.
__device__ __forceinline__ uint32_t mismatch16(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  uint32_t y = (x | (x >> 1)) & 0x55555555u;   // base j at bit 30 - 2j
  y = (y | (y >> 1)) & 0x33333333u;
  y = (y | (y >> 2)) & 0x0F0F0F0Fu;
  y = (y | (y >> 4)) & 0x00FF00FFu;
  y = (y | (y >> 8)) & 0x0000FFFFu;            // base j at bit 15 - j
  return __brev(y) >> 16;
}

// Lower bound of v in the sorted keys (torch.searchsorted, side left);
// the keys in shared or in global memory.
__device__ __forceinline__ int lower_bound(const long long* k, int n,
                                           long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ bool dp_gap(int lg, int mg) {
  return lg > 0 && mg > 1 && mg >= lg / 5;
}

// The position of set bit n (from 0, lowest first) of m.
__device__ __forceinline__ int nth_bit(uint32_t m, int n) {
  for (; n > 0; --n) m &= m - 1u;
  return __ffs(m) - 1;
}

// Sum and max over a read's group of CP_GROUP lanes (every lane of the
// warp calls them).
__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int d = CP_GROUP / 2; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}
__device__ __forceinline__ int group_max(int v) {
#pragma unroll
  for (int d = CP_GROUP / 2; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// Shared memory of a block (dynamic, bytes): the staged hits and read
// words, the chromosome ends when they fit, the keep flags.
template <class P>
__host__ __device__ constexpr size_t cp_smem_bytes(int nwords, int nkeys) {
  return 4 * (size_t)(2 * CP_HIT_CAP + CP_READS * nwords) +
         sizeof(P) * (size_t)CP_HIT_CAP +
         8 * (size_t)(nkeys <= CP_KEY_CAP ? nkeys : 0) + CP_HIT_CAP;
}

template <class P>
struct CpStage {                        // the block's shared arrays
  int *rpos, *len;
  P* loc;
  uint8_t* keep;
};

// Hits [c0, c1) into shared memory, consecutive threads on consecutive
// words.
template <class P>
__device__ __forceinline__ void stage_hits(const CpInT<P>& in,
                                           const CpStage<P>& st, int c0,
                                           int c1) {
  for (int i = threadIdx.x; i < c1 - c0; i += CP_THREADS) {
    st.rpos[i] = in.rpos[c0 + i];
    st.len[i] = in.len[c0 + i];
    st.loc[i] = in.loc[c0 + i];
    st.keep[i] = in.keep[c0 + i];
  }
}

// The body of both instantiations of the classify+pack kernel.
template <class P>
__device__ __forceinline__ void classify_pack_body(
    const CpInT<P>& in, const CtxT<P>& cx, const Planes& pl,
    const CpOut<P>& op, int* __restrict__ mmp, const ScanState& ss) {
  extern __shared__ __align__(16) unsigned char cp_smem[];
  __shared__ int s_off[CP_READS + 1];
  __shared__ int s_rlen[CP_READS];
  __shared__ uint8_t s_flag[CP_READS];  // unresolved | overflow << 1
  __shared__ int s_slow[CP_READS];      // kept hits of SLOW reads
  __shared__ uint32_t s_base[CP_READS]; // their prefix in the tile
  __shared__ int s_mm[CP_READS * MM_SLOTS];
  __shared__ uint32_t warp_sum[CP_THREADS / 32];
  __shared__ int tile_s;
  __shared__ uint32_t excl_s;
  static_assert(K_HITS % CP_GROUP == 0 && 32 % CP_GROUP == 0,
                "window slots and groups split evenly");
  static_assert(CP_READS % 32 == 0, "an overflow word a warp of reads");
  const int t = threadIdx.x, lane = t & 31;
  const int r = t / CP_GROUP, j = t % CP_GROUP;  // a read, a lane of its group
  const int gbase = lane & ~(CP_GROUP - 1);
  const int B = in.B, H = in.H, nwords = in.max_len >> 4;
  const bool keys_staged = cx.nkeys <= CP_KEY_CAP;
  const P empty = pd_empty<P>();
  CpStage<P> st;
  st.rpos = reinterpret_cast<int*>(cp_smem);
  st.len = st.rpos + CP_HIT_CAP;
  st.loc = reinterpret_cast<P*>(st.len + CP_HIT_CAP);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(st.loc + CP_HIT_CAP);
  long long* s_keys =
      reinterpret_cast<long long*>(s_words + CP_READS * nwords);
  st.keep = reinterpret_cast<uint8_t*>(s_keys + (keys_staged ? cx.nkeys : 0));
  const int tile = draw_ticket(ss, &tile_s);
  const int b0 = tile * CP_READS, nr = min(CP_READS, B - b0);
  const int b = b0 + r;
  const bool live = r < nr;             // whole warps: nr % 32 == 0
  // ---- the tile's per-read inputs and read words, coalesced ------------
  for (int i = t; i <= nr; i += CP_THREADS) s_off[i] = in.off[b0 + i];
  if (t < nr) {
    s_rlen[t] = in.rlens[b0 + t];
    s_flag[t] = in.unresolved[b0 + t] | (in.overflow[b0 + t] << 1);
  }
  const uint32_t* wsrc = in.packed + (size_t)b0 * nwords;
  for (int i = t; i < nr * nwords; i += CP_THREADS) s_words[i] = wsrc[i];
  if (keys_staged)
    for (int i = t; i < cx.nkeys; i += CP_THREADS) s_keys[i] = cx.bkeys[i];
  __syncthreads();
  const long long* keys = keys_staged ? s_keys : cx.bkeys;
  const int hs = min(s_off[0], H), he = min(s_off[nr], H);
  const int ob = live ? min(s_off[r], H) : he;
  const int ob1 = live ? min(s_off[r + 1], H) : he;
  const int rlen = live ? s_rlen[r] : 0;
  // ---- the first K_HITS kept hits: slot j + i * CP_GROUP on lane j -----
  P w_pd[CP_SLOTS];
  int w_rp[CP_SLOTS], w_ln[CP_SLOTS];
#pragma unroll
  for (int i = 0; i < CP_SLOTS; ++i) {
    w_pd[i] = empty;
    w_rp[i] = w_ln[i] = 0;
  }
  int nkept = 0;                        // the same in the whole group
  for (int c0 = hs; c0 < he; c0 += CP_HIT_CAP) {
    const int c1 = min(c0 + CP_HIT_CAP, he);
    stage_hits(in, st, c0, c1);
    __syncthreads();
    const int a = max(ob, c0), z = min(ob1, c1);
    const int iters = __reduce_max_sync(
        FULL, z > a ? (z - a + CP_GROUP - 1) / CP_GROUP : 0);
    for (int it = 0; it < iters; ++it) {
      const int h0 = a + it * CP_GROUP, h = h0 + j;
      const uint32_t m =
          (__ballot_sync(FULL, h < z && st.keep[h - c0]) >> gbase) &
          ((1u << CP_GROUP) - 1u);
      const int cnt = __popc(m);
#pragma unroll
      for (int i = 0; i < CP_SLOTS; ++i) {
        const int s = j + i * CP_GROUP;
        if (s >= nkept && s < nkept + cnt) {  // kept hit number s
          const int e = h0 + nth_bit(m, s - nkept) - c0;
          w_rp[i] = st.rpos[e];
          w_ln[i] = st.len[e];
          w_pd[i] = st.loc[e] - w_rp[i];
        }
      }
      nkept += cnt;
    }
    __syncthreads();                    // the chunk is read: stage the next
  }
  // ---- the window stably sorted by (pd, rpos): ranks over shuffles ------
  // (slot e of the group on lane e % CP_GROUP, register e / CP_GROUP).
  // Slots at or past the warp's most kept hits are empty in every group
  // and keep their places: the loops stop there.
  const int nwin = __reduce_max_sync(FULL, min(nkept, K_HITS));
  int rank[CP_SLOTS];
#pragma unroll
  for (int i = 0; i < CP_SLOTS; ++i) rank[i] = 0;
#pragma unroll
  for (int e = 0; e < K_HITS; ++e) {
    if (e >= nwin) break;
    const int src = gbase + e % CP_GROUP;
    const P pe = __shfl_sync(FULL, w_pd[e / CP_GROUP], src);
    const int re = __shfl_sync(FULL, w_rp[e / CP_GROUP], src);
#pragma unroll
    for (int i = 0; i < CP_SLOTS; ++i) {
      const int s = j + i * CP_GROUP;
      rank[i] += e < s ? !after(pe, re, w_pd[i], w_rp[i])
                       : after(w_pd[i], w_rp[i], pe, re);
    }
  }
  P spd[CP_SLOTS];
  int srp[CP_SLOTS], sln[CP_SLOTS];
#pragma unroll
  for (int i = 0; i < CP_SLOTS; ++i) {
    spd[i] = empty;
    srp[i] = sln[i] = 0;
  }
#pragma unroll
  for (int e = 0; e < K_HITS; ++e) {
    if (e >= nwin) break;
    const int src = gbase + e % CP_GROUP;
    const int ke = __shfl_sync(FULL, rank[e / CP_GROUP], src);
    const P pe = __shfl_sync(FULL, w_pd[e / CP_GROUP], src);
    const int re = __shfl_sync(FULL, w_rp[e / CP_GROUP], src);
    const int le = __shfl_sync(FULL, w_ln[e / CP_GROUP], src);
#pragma unroll
    for (int i = 0; i < CP_SLOTS; ++i)
      if (ke == j + i * CP_GROUP) {
        spd[i] = pe;
        srp[i] = re;
        sln[i] = le;
      }
  }
  const bool has_hits = nkept > 0, too_many = nkept > K_HITS;
  const P pd0 = __shfl_sync(FULL, spd[0], gbase);
  int off_diag = 0, cscore = 0, seed_end = 0, seed_last_rp = -1;
#pragma unroll
  for (int i = 0; i < CP_SLOTS; ++i) {
    const bool valid = spd[i] != empty, same = spd[i] == pd0;
    off_diag += valid && !same;
    if (valid) cscore += sln[i];
    if (valid && same) {
      seed_end = max(seed_end, srp[i] + sln[i]);
      seed_last_rp = max(seed_last_rp, srp[i]);
    }
    if (!same) sln[i] = 0;              // covers nothing: off the diagonal
  }
  const bool one_diag = group_sum(off_diag) == 0;
  cscore = group_sum(cscore);
  seed_end = group_max(seed_end);
  seed_last_rp = group_max(seed_last_rp);
  const bool has_can = cscore > (rlen >> 2);
  // ---- the span [pd, pd + rlen) inside one chromosome ------------------
  const long long pd_end = wadd(pd0, rlen);
  const long long last = (long long)cx.seq_len - 1;
  const long long p1 = min(max((long long)pd0, 0LL), last);
  const long long p2 = min(max(wadd(pd_end, -1), 0LL), last);
  const bool span_ok = pd_end <= cx.seq_len &&
                       lower_bound(keys, cx.nkeys, p1) ==
                           lower_bound(keys, cx.nkeys, p2);
  // ---- masks along the diagonal: read word k*CP_GROUP + j on lane j ------
  const P pds = span_ok && has_hits ? pd0 : (P)0;
  const int sh = (int)(pds & 15) * 2;
  const P wbase = pds >> 4;
  const int lim = min(rlen, in.max_len);
  uint32_t* rw = s_words + r * nwords;
  int* smm = s_mm + r * MM_SLOTS;
  for (int q = j; q < MM_SLOTS; q += CP_GROUP) smm[q] = -1;
  __syncwarp();
  int mm_total = 0, carry = 0;          // carry: mismatches in earlier words
  for (int k = 0; k * CP_GROUP < nwords; ++k) {
    const int wi = k * CP_GROUP + j;
    const bool act = live && wi < nwords;
    uint32_t cov = 0;
#pragma unroll
    for (int e = 0; e < K_HITS; ++e) {
      if (e >= nwin) break;
      const int src = gbase + e % CP_GROUP;
      const int re = __shfl_sync(FULL, srp[e / CP_GROUP], src) - 16 * wi;
      cov |= span_bits(re, re + __shfl_sync(FULL, sln[e / CP_GROUP], src));
    }
    uint32_t mm = 0, unc = 0, rb = 0;
    if (act) {
      rb = to_bwa(rw[wi]);
      const uint32_t t0 = (uint32_t)cx.text[min(max(wbase + wi, (P)0),
                                                (P)(cx.ntext - 1))];
      const uint32_t t1 = (uint32_t)cx.text[min(max(wbase + wi + 1, (P)0),
                                                (P)(cx.ntext - 1))];
      const uint32_t al = (t0 << sh) | (sh > 0 ? t1 >> (32 - sh) : 0u);
      const uint32_t inlen = span_bits(0, lim - 16 * wi) & 0xFFFFu;
      mm = mismatch16(al, rb) & inlen;
      unc = ~cov & inlen;
    }
    mm_total += __popc(mm & unc);
    // the leftmost MM_SLOTS mismatches: the group's prefix of popcounts
    const int c = __popc(mm);
    int inc = c;
#pragma unroll
    for (int d = 1; d < CP_GROUP; d <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, d, CP_GROUP);
      if (j >= d) inc += y;
    }
    int slot = carry + inc - c;
    for (uint32_t bits = mm; bits != 0u && slot < MM_SLOTS; bits &= bits - 1u) {
      const int p = __ffs(bits) - 1;
      smm[slot++] = ((16 * wi + p) << 2) | (int)((rb >> ((15 - p) * 2)) & 3u);
    }
    carry += __shfl_sync(FULL, inc, gbase + CP_GROUP - 1);
    if (act) rw[wi] = (mm & unc) | (unc << 16);  // for the gap walk
  }
  mm_total = group_sum(mm_total);
  __syncwarp();
  // ---- gaps: the group's leader walks the read's 32-position chunks -----
  int cls = CLASS_NOCAND;
  if (j == 0 && live) {
    int g = -1, lg = 0, mg = 0;         // open gap: index, length, mismatches
    bool open = false, dp_any = false;
    for (int c = 0; 2 * c < nwords; ++c) {
      const uint32_t w0 = rw[2 * c];
      const uint32_t w1 = 2 * c + 1 < nwords ? rw[2 * c + 1] : 0u;
      const uint32_t unc = (w0 >> 16) | (w1 & 0xFFFF0000u);
      const uint32_t mm = (w0 & 0xFFFFu) | (w1 << 16);  // uncovered only
      // runs of uncovered in-length positions; a run at bit 0 continues
      // the gap open at the end of the chunk before
      for (uint32_t bits = unc; bits != 0u;) {
        const int a = __ffs(bits) - 1;
        const uint32_t rest = ~(bits >> a);
        const int len = rest ? __ffs(rest) - 1 : 32 - a;
        const uint32_t run =
            (len >= 32 ? 0xFFFFFFFFu : ((1u << len) - 1u)) << a;
        if (!(a == 0 && open)) {
          if (g >= 0 && g < MAX_GAPS) dp_any |= dp_gap(lg, mg);
          ++g;
          lg = mg = 0;
        }
        lg += len;
        mg += __popc(mm & run);
        bits &= ~run;
      }
      open = (unc >> 31) != 0u;
    }
    if (g >= 0 && g < MAX_GAPS) dp_any |= dp_gap(lg, mg);
    const bool many_gaps = g >= MAX_GAPS;
    const bool fast = has_hits && !too_many && one_diag && has_can &&
                      span_ok && !dp_any && !many_gaps && mm_total <= MM_SLOTS;
    const bool nocand = !has_hits || (!too_many && one_diag && !has_can);
    cls = fast ? CLASS_FAST : (nocand ? CLASS_NOCAND : CLASS_SLOW);
    if (s_flag[r] & 1) cls = CLASS_SLOW;   // unresolved: the host oracle
    const int rplast =
        min(max(seed_end < rlen ? seed_end : seed_last_rp, 0), 511);
    op.meta[b] = (int)((uint32_t)cls | ((uint32_t)mm_total << 2) |
                       ((uint32_t)rplast << 8) |
                       ((uint32_t)min(cscore, 511) << 17));
    op.pd[b] = pd0;
  }
  cls = __shfl_sync(FULL, cls, gbase);
  if (j == 0) s_slow[r] = live && cls == CLASS_SLOW ? nkept : 0;
  // mmp and the speculative evidence apply (ops/evidence.py): lane 0 the
  // read's span, lane j the mismatches j, j + CP_GROUP, ...
  for (int q = j; live && q < MM_SLOTS; q += CP_GROUP) {
    const int e = smm[q];
    mmp[(size_t)b * MM_SLOTS + q] = e;
    if constexpr (sizeof(P) == 4)       // the 64-bit form folds no apply
    if (pl.exact != nullptr && cls == CLASS_FAST)
      apply_fast_evidence(pl, cx.seq_len, pd0, rlen, b, q, e, 1);
  }
  __syncthreads();
  // ---- the pack: the slow counts' prefix by look-back -------------------
  uint32_t agg;
  const uint32_t excl_in = block_excl_scan<CP_THREADS>(
      t < CP_READS ? (uint32_t)s_slow[t] : 0u, warp_sum, &agg);
  if (t < CP_READS) s_base[t] = excl_in;
  if (t < 32) {
    const uint32_t excl = look_back(ss, tile, agg);
    if (t == 0) excl_s = excl;
  }
  __syncthreads();
  int* hit_w = op.hit_w;
  P* hit_l = op.hit_l;
  int* counts2 = op.counts2;
  int* ovf_bits = op.ovf;
  // each SLOW read's kept hits at its slot, slots >= H2 dropped; a tile
  // whose hits took one chunk still has them staged
  if (agg != 0u) {
    const bool restage = he - hs > CP_HIT_CAP;
    const bool slow = live && s_slow[r] > 0;
    const int base = (int)(excl_s + s_base[r]);
    int nk = 0;
    for (int c0 = hs; c0 < he; c0 += CP_HIT_CAP) {
      const int c1 = min(c0 + CP_HIT_CAP, he);
      if (restage) {
        __syncthreads();
        stage_hits(in, st, c0, c1);
        __syncthreads();
      }
      const int a = max(ob, c0), z = slow ? min(ob1, c1) : a;
      const int iters = __reduce_max_sync(
          FULL, z > a ? (z - a + CP_GROUP - 1) / CP_GROUP : 0);
      for (int it = 0; it < iters; ++it) {
        const int h = a + it * CP_GROUP + j;
        const bool kp = h < z && st.keep[h - c0];
        const uint32_t m =
            (__ballot_sync(FULL, kp) >> gbase) & ((1u << CP_GROUP) - 1u);
        const int s = base + nk + __popc(m & ((1u << j) - 1u));
        if (kp && s < in.H2) {
          hit_w[s] = (st.rpos[h - c0] << 9) | st.len[h - c0];
          hit_l[s] = st.loc[h - c0];
        }
        nk += __popc(m);
      }
    }
  }
  // the count words, two reads a word; the overflow words, a warp a word
  if (t < nr / 2)
    counts2[b0 / 2 + t] = (int)(((uint32_t)s_slow[2 * t] & 0xFFFFu) |
                                ((uint32_t)s_slow[2 * t + 1] << 16));
  if (t < nr) {
    const uint32_t w = __ballot_sync(FULL, s_flag[t] != 0);
    if (lane == 0) ovf_bits[(b0 + t) >> 5] = (int)w;
  }
  // the last tile holds the total: the totals, and the slots no read fills
  if (tile == (int)gridDim.x - 1) {
    const int total_kept = (int)(excl_s + agg);
    if (t == 0) {
      ovf_bits[B / 32] = total_kept;
      ovf_bits[B / 32 + 1] = s_off[nr] > H || total_kept > in.H2;
    }
    for (int s = max(total_kept, 0) + t; s < in.H2; s += CP_THREADS) {
      hit_w[s] = 0;
      hit_l[s] = 0;
    }
  }
}

// At most 64 registers a thread: 1,024 threads of blocks share an SM.
__global__ void __launch_bounds__(CP_THREADS, 1024 / CP_THREADS)
chain_classify_pack_kernel(CpInT<int> in, CtxT<int> cx, Planes pl,
                           CpOut<int> op, int* __restrict__ mmp,
                           ScanState ss) {
  classify_pack_body(in, cx, pl, op, mmp, ss);
}

// The x64 big-genome form: int64 positions, no evidence apply; a block an
// SM at the least, so up to 128 registers a thread.
__global__ void __launch_bounds__(CP_THREADS, 1)
chain_classify_pack_big_kernel(CpInT<long long> in, CtxT<long long> cx,
                               CpOut<long long> op, int* __restrict__ mmp,
                               ScanState ss) {
  classify_pack_body(in, cx, Planes{nullptr, nullptr, nullptr, 0, 0}, op,
                     mmp, ss);
}

// ---- the mesh's collectives and the stand-alone evidence apply ----------

// dp_scatter_scan_kernel: over n int32 partials, each element the sum of
// the partials at k (zero at or past len). DP_SUM: that sum is written for
// k < per (the psum), a block a tile in blockIdx order. DP_SCAN: [0, len)
// padded to Gp = nslices * per elements, cut into nslices slices of per;
// element k goes to outs[k / per] + k % per as the inclusive cumsum of the
// sums up to it (the reference's psum_scatter, all_gather of totals and
// cumsum, in one pass). Tiles of DP_TILE elements over [0, Gp), tile T at
// status word T of one status array; a launch takes, by ticket and in
// ascending order, the tiles whose first element lies in one of its slices
// (mine), so the look-back of a slice's first tiles runs into the slices
// before it, whichever launch or card scans them, and a tile that runs
// over a slice's end writes the next slice's first elements through its
// pointer. A tile's block sums its elements (each partial read once, 16
// bytes a load where the partial is aligned), scans them (a thread's
// DP_ITEMS consecutive elements, then block_excl_scan over the threads),
// looks back to its prefix and writes them. A tile waits only on lower
// ones, each drawn by a block that already runs (on its card or on
// another, whose launch must not queue behind this one: the wrapper
// queues every stream wait before any launch). Sums are uint32 and wrap
// modulo 2^32, as int32 sums do.
struct DpArgs {
  const unsigned long long* parts;      // [n] base addresses, int32 each
  int n;
  int len;                              // elements read: [0, len)
  int per;                              // a slice's elements (DP_SUM: all)
  int nslices;
  const long long* outs;                // DP_SCAN: [nslices] slices' bases
  const long long* mine;                // DP_SCAN: this launch's slices
  int nmine;
  int* out;                             // DP_SUM: [per]
};

__device__ __forceinline__ uint32_t dp_value(const DpArgs& a, long long k) {
  uint32_t v = 0;
  if (k < a.len)
    for (int p = 0; p < a.n; ++p)
      v += (uint32_t)__ldg(reinterpret_cast<const int*>(__ldg(a.parts + p)) +
                           k);
  return v;
}

// The first tile whose first element lies in slice i (or past it).
__device__ __forceinline__ int dp_first_tile(const DpArgs& a, int i) {
  return (int)(((long long)i * a.per + DP_TILE - 1) / DP_TILE);
}

template <bool Sys>
__device__ __forceinline__ void dp_scan_tile(const DpArgs& a,
                                             const ScanState& ss,
                                             uint32_t* buf,
                                             uint32_t* warp_sum,
                                             int* tile_s, uint32_t* excl_s) {
  constexpr int VEC = DP_TILE / 4 / DP_THREADS;        // int4 a thread
  const int t = threadIdx.x;
  // the ticket's tile: the launch's slices' tiles in ascending order
  int k = draw_ticket(ss, tile_s), T = 0;
  for (int s = 0; s < a.nmine; ++s) {
    const int i = (int)a.mine[s];
    const int lo = dp_first_tile(a, i), cnt = dp_first_tile(a, i + 1) - lo;
    if (k < cnt) {
      T = lo + k;
      break;
    }
    k -= cnt;
  }
  const int gp = a.nslices * a.per;
  const int g0 = T * DP_TILE;
  const int cnt = min(DP_TILE, gp - g0);
  const int nread = max(0, min(cnt, a.len - g0));
  // loads: chunk c (elements 4c .. 4c+3) on thread c % DP_THREADS, a
  // partial's VEC chunks a thread in flight at once
  uint4 v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int p = 0; p < a.n; ++p) {
    const int* src = reinterpret_cast<const int*>(__ldg(a.parts + p)) + g0;
    const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int e = 4 * (t + i * DP_THREADS);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (aligned && e + 3 < nread) {
        x = __ldg(reinterpret_cast<const uint4*>(src + e));
      } else {
        if (e < nread) x.x = (uint32_t)__ldg(src + e);
        if (e + 1 < nread) x.y = (uint32_t)__ldg(src + e + 1);
        if (e + 2 < nread) x.z = (uint32_t)__ldg(src + e + 2);
        if (e + 3 < nread) x.w = (uint32_t)__ldg(src + e + 3);
      }
      v[i].x += x.x;
      v[i].y += x.y;
      v[i].z += x.z;
      v[i].w += x.w;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int e = 4 * (t + i * DP_THREADS);
    buf[padded(e)] = v[i].x;
    buf[padded(e + 1)] = v[i].y;
    buf[padded(e + 2)] = v[i].z;
    buf[padded(e + 3)] = v[i].w;
  }
  __syncthreads();
  uint32_t run = 0;
#pragma unroll
  for (int i = 0; i < DP_ITEMS; ++i) {
    const int e = padded(t * DP_ITEMS + i);
    run += buf[e];
    buf[e] = run;
  }
  uint32_t agg;
  const uint32_t before = block_excl_scan<DP_THREADS>(run, warp_sum, &agg);
  if (t < 32) {
    const uint32_t excl = look_back<Sys>(ss, T, agg);
    if (t == 0) *excl_s = excl;
  }
  __syncthreads();
  const uint32_t base = *excl_s + before;
#pragma unroll
  for (int i = 0; i < DP_ITEMS; ++i) buf[padded(t * DP_ITEMS + i)] += base;
  __syncthreads();
  // striped stores to the slices: the tile's first slice, then past its
  // end (a tile is at most DP_TILE elements) the next ones
  const int s0 = g0 / a.per, base0 = s0 * a.per;
  int* const out0 = reinterpret_cast<int*>(a.outs[s0]);
#pragma unroll
  for (int i = 0; i < DP_ITEMS; ++i) {
    const int e = t + i * DP_THREADS, k = g0 + e;
    if (e >= cnt) continue;
    if (k < base0 + a.per) {
      out0[k - base0] = (int)buf[padded(e)];
    } else {
      const int s = k / a.per;
      reinterpret_cast<int*>(a.outs[s])[k - s * a.per] = (int)buf[padded(e)];
    }
  }
}

__global__ void __launch_bounds__(DP_THREADS)
dp_scatter_scan_kernel(DpArgs a, int mode, int sys, ScanState ss) {
  __shared__ uint32_t buf[padded(DP_TILE)];
  __shared__ uint32_t warp_sum[DP_THREADS / 32];
  __shared__ int tile_s;
  __shared__ uint32_t excl_s;
  const int t = threadIdx.x;
  if (mode == DP_SUM) {
    const long long k0 = (long long)blockIdx.x * DP_TILE;
    for (int e = t; e < DP_TILE && k0 + e < a.per; e += DP_THREADS)
      a.out[k0 + e] = (int)dp_value(a, k0 + e);
    return;
  }
  if (sys)
    dp_scan_tile<true>(a, ss, buf, warp_sum, &tile_s, &excl_s);
  else
    dp_scan_tile<false>(a, ss, buf, warp_sum, &tile_s, &excl_s);
}

// evidence_apply_bits_kernel: a warp an admit word, reads b0 .. b0 + 31:
// bit b % 32 of bits[b / 32], or, with meta (the chain kernel's packed
// output vector), the class in meta[b]'s low bits being FAST (the
// reference's source="meta": the speculative dispatch's FAST reads, read
// on the card). Group g of APPLY_LANES lanes takes reads b0 + g, b0 + g +
// 8, ...; lane q of a group loads each read's mmp row in one 16-byte load
// and keeps slot q. The word and the warp's 32 reads (768 contiguous
// bytes) are loaded together, so a warp waits on memory once before its
// atomics; a word with no bit set then ends the warp, whole. Lane q adds
// (sign +1) or retracts (-1) slot q's evidence of each admitted read of
// its group, lane 0 also the read's span (apply_fast_evidence) on a text
// of 2L. Blocks of APPLY_THREADS: a 32,768-read batch is 256 blocks, on
// every SM. The body over positions of type Pos into planes PL: int32 pd
// into the whole planes (K2), or int64 pd into a shard's slice (its slice
// form, B4's apply).
template <class PL, class Pos>
__device__ __forceinline__ void apply_bits_body(
    const Pos* __restrict__ pd, const int4* __restrict__ mmp,
    const int* __restrict__ rlens, const uint32_t* __restrict__ bits,
    const int* __restrict__ meta, int B, const PL& pl, int sign) {
  constexpr int GROUPS = 32 / APPLY_LANES, ITEMS = 32 / GROUPS;
  const int lane = threadIdx.x & 31;
  const int w = (blockIdx.x * APPLY_THREADS + threadIdx.x) >> 5;
  const int b0 = w * 32;
  if (b0 >= B) return;                  // the whole warp
  const int g = lane / APPLY_LANES, q = lane % APPLY_LANES;
  Pos p[ITEMS];
  int rl[ITEMS], e[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int b = b0 + g + GROUPS * it;
    p[it] = 0;
    rl[it] = 0;
    e[it] = -1;
    if (b < B) {
      p[it] = __ldg(pd + b);
      rl[it] = __ldg(rlens + b);
      e[it] = pick4(__ldg(mmp + b), q);
    }
  }
  uint32_t word;
  if (meta != nullptr) {
    const int b = b0 + lane;
    word = __ballot_sync(FULL, b < B && (__ldg(meta + b) & 3) == CLASS_FAST);
  } else {
    word = __ldg(bits + w);
    if (B - b0 < 32) word &= (1u << (B - b0)) - 1u;
  }
  if (word == 0u) return;               // the whole warp
  const long long two_l = 2LL * pl.L;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int r = g + GROUPS * it;
    if ((word >> r) & 1u)
      apply_fast_evidence(pl, two_l, p[it], rl[it], b0 + r, q, e[it], sign);
  }
}

__global__ void __launch_bounds__(APPLY_THREADS)
evidence_apply_bits_kernel(const int* __restrict__ pd,
                           const int4* __restrict__ mmp,
                           const int* __restrict__ rlens,
                           const uint32_t* __restrict__ bits,
                           const int* __restrict__ meta, int B, Planes pl,
                           int sign) {
  apply_bits_body(pd, mmp, rlens, bits, meta, B, pl, sign);
}

// K2's slice form: a batch's admitted reads (admit bits only) added into
// one shard's slice of the planes, int64 pd; each shard of a batch is one
// launch over all B reads, and adds the positions it holds.
__global__ void __launch_bounds__(APPLY_THREADS)
evidence_apply_slice_kernel(const long long* __restrict__ pd,
                            const int4* __restrict__ mmp,
                            const int* __restrict__ rlens,
                            const uint32_t* __restrict__ bits, int B,
                            SlicePlanes pl) {
  apply_bits_body(pd, mmp, rlens, bits, (const int*)nullptr, B, pl, 1);
}

// ---- host_merge_kernel -----------------------------------------------------

// One segment of a host-delta merge: the entries [g0, g1) of the lists,
// all of one (shard, list, row), so each entry x adds at base[x - sub]
// (sub the index of the row's first position the shard holds, base that
// word's address in the shard's plane). A launch's segments are sorted
// and disjoint; the consecutive ones make its runs of entries [a, b),
// cut into units of MERGE_ITEMS entries aligned in the lists: a run's
// units are the launch's w0, w0 + 1, ..., unit w being the lists' unit
// w + ubase. One launch on a device that holds every shard has one run.
// The host computes all of it (ops/mesh_kernels.py, merge_table).
struct MergeSeg {
  long long g0, g1, sub, base;
};

struct MergeRun {
  long long w0, ubase, a, b;
};

// The last of n sorted keys at or before x (0 if none), keys[k].g0 or
// .w0 by `at`.
template <typename T, typename F>
__device__ __forceinline__ int merge_find(const T* keys, int n, long long x,
                                          F at) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (at(keys[mid]) <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The entries of unit u: four 16-byte index loads, two 16-byte value
// loads, streamed past L1 (each is read once).
__device__ __forceinline__ void merge_load(const long long* __restrict__ idx,
                                           const int* __restrict__ val,
                                           long long u,
                                           long long (&x)[MERGE_ITEMS],
                                           int (&v)[MERGE_ITEMS]) {
  const longlong2* ip =
      reinterpret_cast<const longlong2*>(idx + u * MERGE_ITEMS);
  const int4* vp = reinterpret_cast<const int4*>(val + u * MERGE_ITEMS);
#pragma unroll
  for (int k = 0; k < MERGE_ITEMS / 2; ++k) {
    const longlong2 t = __ldcs(ip + k);
    x[2 * k] = t.x;
    x[2 * k + 1] = t.y;
  }
#pragma unroll
  for (int k = 0; k < MERGE_ITEMS / 4; ++k) {
    const int4 t = __ldcs(vp + k);
    v[4 * k] = t.x;
    v[4 * k + 1] = t.y;
    v[4 * k + 2] = t.z;
    v[4 * k + 3] = t.w;
  }
}

// host_merge_kernel: a thread a unit of 8 consecutive entries of one run,
// read as four 16-byte index loads and two 16-byte value loads. With one
// run (its fields in the parameters) the loads are issued first, while
// the block stages the segments in shared memory. A block's first
// segment is found once, by a binary search over the staged segment
// starts; each thread walks on from it, entry by entry (a block spans
// few segments). The word's offset is a subtraction: no 64-bit division,
// and no entry outside the launch's segments is added (a unit at a run's
// edge may carry a neighbour's entries in its loads; the thread skips
// them). Every list is strictly increasing and each goes to its own
// plane rows, so no two entries of a launch touch the same word. Each
// add is a red.global.add, which nothing waits for: a plain
// read-add-write, exact too, measured slower (the scattered words miss
// L2, and a read-add-write waits for each one before its store).
__global__ void __launch_bounds__(MERGE_THREADS)
host_merge_kernel(const long long* __restrict__ idx,
                  const int* __restrict__ val,
                  const MergeSeg* __restrict__ seg, int nseg,
                  const MergeRun* __restrict__ run, int nrun, MergeRun run0,
                  long long W) {
  __shared__ MergeSeg s_seg[MERGE_MAX_SEGS];
  __shared__ MergeRun s_run[MERGE_MAX_SEGS];
  __shared__ int s_first;
  for (int i = threadIdx.x; i < nseg; i += MERGE_THREADS) s_seg[i] = seg[i];
  if (nrun > 1)
    for (int i = threadIdx.x; i < nrun; i += MERGE_THREADS)
      s_run[i] = run[i];
  const long long w = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
  long long x[MERGE_ITEMS];
  int v[MERGE_ITEMS];
  MergeRun r = run0;
  const bool in = w < W;
  if (nrun == 1 && in) merge_load(idx, val, w + r.ubase, x, v);
  __syncthreads();
  if (nrun > 1 && in)
    r = s_run[merge_find(s_run, nrun, w,
                         [](const MergeRun& q) { return q.w0; })];
  if (threadIdx.x == 0) {
    // the block's first entry, in its first unit's run
    const long long g = (w + r.ubase) * MERGE_ITEMS;
    s_first = merge_find(s_seg, nseg, g > r.a ? g : r.a,
                         [](const MergeSeg& q) { return q.g0; });
  }
  __syncthreads();
  if (!in) return;
  if (nrun > 1) merge_load(idx, val, w + r.ubase, x, v);
  const long long g = (w + r.ubase) * MERGE_ITEMS;
  int s = s_first;
  int* at[MERGE_ITEMS];
  bool mine[MERGE_ITEMS];
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j) {
    const long long e = g + j;
    while (s + 1 < nseg && s_seg[s + 1].g0 <= e) ++s;
    mine[j] = e >= r.a && e < r.b && e >= s_seg[s].g0 && e < s_seg[s].g1;
    at[j] = reinterpret_cast<int*>(s_seg[s].base) + (x[j] - s_seg[s].sub);
  }
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j)
    if (mine[j]) atomicAdd(at[j], v[j]);   // no return: red.global.add
}

}  // namespace

// Exclusive prefix sum of per-read counts into out int32[B+1] (out[B] =
// total): with freq int64[B, S] each read's sum of its first min(n[b], S)
// entries (n int64[B], or nullptr for all S), else cnt int32[B]. With freq,
// start int32[ngroups, 2] (or nullptr) gets the hits kernel's start index
// and unresolved uint8[B] (or nullptr) is zeroed. scratch int64[1 + tiles]
// (the ticket in word 0, the status words after it) holds no word of this
// epoch: zeroed at first, then used by launches of smaller epochs only.
extern "C" int mc_chain_scan(const void* freq, const void* n, const void* cnt,
                             int B, int S, void* out, void* start, int ngroups,
                             void* unresolved, void* scratch, int tiles,
                             int epoch, void* stream) {
  const int ntiles = (B + SCAN_THREADS - 1) / SCAN_THREADS;
  if (B < 1 || S < 1 || (freq == nullptr) == (cnt == nullptr) ||
      (freq != nullptr && S > SCAN_MAX_S) ||
      (freq == nullptr && (start != nullptr || unresolved != nullptr)) ||
      (start != nullptr && ngroups < 1) || (long long)B * S >= (1LL << 31) ||
      scratch == nullptr || tiles < ntiles || epoch < 1 || epoch >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  const SeedOut so{(int2*)start, (uint8_t*)unresolved, ngroups};
  const ScanState ss{(unsigned int*)scratch,
                     (unsigned long long*)scratch + 1, (unsigned int)epoch};
  const size_t smem = freq != nullptr ? sizeof(uint32_t) * SCAN_THREADS * S : 0;
  chain_scan_kernel<<<ntiles, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      (const long long*)freq, (const long long*)n, (const int*)cnt, B, S,
      (int*)out, so, ss);
  return (int)cudaGetLastError();
}

// Hit expansion and SA resolve. off int32[B+1], start int32[ceil(H /
// HITS_GROUP), 2] and unresolved uint8[B] from mc_chain_scan of the seed
// freqs (which zeroed unresolved); seed tables n_seeds int64[B],
// rpos/len/x0/freq int64[B, S]; occ int32[nw+1, 8] (16-byte aligned), L2
// int64[5], sa_samp int64[], sa_full int32[n+1] or nullptr (then the
// inverse-Psi walk of max_walk steps). Outputs: read/rpos/len/loc
// int32[H], valid/keep uint8[H], the flags of unresolved reads set, and
// resolved uint8[H] (or nullptr): each slot's valid-and-resolved flag.
extern "C" int mc_chain_hits(const void* off, const void* start,
                             const void* n_seeds, const void* rpos,
                             const void* len, const void* x0,
                             const void* freq, int B, int S, const void* occ,
                             const void* L2, const void* sa_samp,
                             const void* sa_full, int primary, int max_walk,
                             int H, void* read, void* hrpos, void* hlen,
                             void* loc, void* valid, void* keep,
                             void* unresolved, void* resolved,
                             void* stream) {
  if (B < 1 || S < 1 || H < 1 || max_walk < 0 ||
      (long long)B * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Seeds sd{(const long long*)n_seeds, (const long long*)rpos,
                 (const long long*)len, (const long long*)x0,
                 (const long long*)freq, B, S};
  const Fm fm{(const int*)occ, (const long long*)L2,
              (const long long*)sa_samp, (const int*)sa_full, primary,
              max_walk};
  const Hits o{(int*)read,       (int*)hrpos,       (int*)hlen,
               (int*)loc,        (uint8_t*)valid,   (uint8_t*)keep,
               (uint8_t*)unresolved, (uint8_t*)resolved};
  chain_hits_kernel<<<(H + HITS_GROUP - 1) / HITS_GROUP, HITS_GROUP, 0,
                      (cudaStream_t)stream>>>(
      (const int*)off, (const int2*)start, sd, fm, H, o);
  return (int)cudaGetLastError();
}

// Hit expansion and SA resolve over a genome-sharded SA: as mc_chain_hits,
// with occ, sa_samp and sa_full each a table of shard base addresses
// (int64[n], each shard readable from this device) and the rows a shard
// of each: with full_ptrs the full SA's shards of int32[full_per], else
// the occ4 rows' of int32[occ_per, 8] (16-byte aligned) and sa_samp's of
// int64[samp_per] for the inverse-Psi walk.
extern "C" int mc_chain_hits_routed(const void* off, const void* start,
                                    const void* n_seeds, const void* rpos,
                                    const void* len, const void* x0,
                                    const void* freq, int B, int S,
                                    const void* occ_ptrs, int occ_per,
                                    const void* L2, const void* samp_ptrs,
                                    int samp_per, const void* full_ptrs,
                                    int full_per, int primary, int max_walk,
                                    int H, void* read, void* hrpos,
                                    void* hlen, void* loc, void* valid,
                                    void* keep, void* unresolved,
                                    void* stream) {
  if (B < 1 || S < 1 || H < 1 || max_walk < 0 ||
      (long long)B * S >= (1LL << 31) ||
      (full_ptrs != nullptr ? full_per < 1
                            : (occ_ptrs == nullptr || samp_ptrs == nullptr ||
                               occ_per < 1 || samp_per < 1)))
    return (int)cudaErrorInvalidValue;
  const Seeds sd{(const long long*)n_seeds, (const long long*)rpos,
                 (const long long*)len, (const long long*)x0,
                 (const long long*)freq, B, S};
  const RoutedFm fm{(const unsigned long long*)occ_ptrs, (const long long*)L2,
                    (const unsigned long long*)samp_ptrs,
                    (const unsigned long long*)full_ptrs, primary, max_walk,
                    (unsigned)occ_per, (unsigned)samp_per,
                    (unsigned)full_per};
  const Hits o{(int*)read, (int*)hrpos, (int*)hlen, (int*)loc,
               (uint8_t*)valid, (uint8_t*)keep, (uint8_t*)unresolved};
  chain_hits_routed_kernel<<<(H + HITS_GROUP - 1) / HITS_GROUP, HITS_GROUP,
                             0, (cudaStream_t)stream>>>(
      (const int*)off, (const int2*)start, sd, fm, H, o);
  return (int)cudaGetLastError();
}

// Hit expansion and SA resolve over the x64 big-genome SA (big_x64 under
// -shards N): as mc_chain_hits_routed with a full SA only, sa_ptrs the
// shards' base addresses (int64[n], each shard int64[per] and readable
// from this device); the hit rows (x0 + rank) and loc are int64[H].
extern "C" int mc_chain_hits_big(const void* off, const void* start,
                                 const void* n_seeds, const void* rpos,
                                 const void* len, const void* x0,
                                 const void* freq, int B, int S,
                                 const void* sa_ptrs, long long per, int H,
                                 void* read, void* hrpos, void* hlen,
                                 void* loc, void* valid, void* keep,
                                 void* unresolved, void* stream) {
  if (B < 1 || S < 1 || H < 1 || (long long)B * S >= (1LL << 31) ||
      sa_ptrs == nullptr || per < 1)
    return (int)cudaErrorInvalidValue;
  const Seeds sd{(const long long*)n_seeds, (const long long*)rpos,
                 (const long long*)len, (const long long*)x0,
                 (const long long*)freq, B, S};
  const RoutedSa64 fm{(const unsigned long long*)sa_ptrs,
                      (unsigned long long)per};
  const HitsT<long long> o{(int*)read, (int*)hrpos, (int*)hlen,
                           (long long*)loc, (uint8_t*)valid, (uint8_t*)keep,
                           (uint8_t*)unresolved};
  chain_hits_big_kernel<<<(H + HITS_GROUP - 1) / HITS_GROUP, HITS_GROUP, 0,
                          (cudaStream_t)stream>>>(
      (const int*)off, (const int2*)start, sd, fm, H, o);
  return (int)cudaGetLastError();
}

// Classification and pack of a batch in one launch: the packed output
// vector out int32[2B + 2H2 + B/2 + B/32 + 2] (meta1, pd, hit_w, hit_loc,
// counts2, the overflow words, total kept, buffer overflow) and mmp
// int32[B, 4]. off int32[B+1] from mc_chain_scan of the seed freqs, hits
// as mc_chain_hits writes them, unresolved and overflow uint8[B], packed
// uint8[B, max_len/4] (4-byte aligned, read as max_len/16 words a read),
// rlens int32[B], text int64[ntext] (a 32-bit word in each), bkeys
// int64[nkeys]; exact/fd/acgt nullptr: no evidence apply, else the int32
// planes of genome size L, pair_end picking the orientation plane by
// batch-index parity. B % 32 == 0. scratch as mc_chain_scan's.
extern "C" int mc_chain_classify_pack(
    const void* off, const void* hrpos, const void* hlen, const void* loc,
    const void* keep, const void* unresolved, const void* overflow,
    const void* packed, const void* rlens, int B, int H, int H2, int max_len,
    const void* text, int ntext, const void* bkeys, int nkeys, int seq_len,
    void* exact, void* fd, void* acgt, int L, int pair_end, void* out,
    void* mmp, void* scratch, int tiles, int epoch, void* stream) {
  const int ntiles = (B + CP_READS - 1) / CP_READS;
  if (B < 32 || B % 32 || H < 1 || H2 < 1 || max_len < 16 || max_len % 16 ||
      max_len > 511 || ntext < 1 || nkeys < 1 || seq_len < 1 ||
      (exact != nullptr && (fd == nullptr || acgt == nullptr || L < 1)) ||
      scratch == nullptr || tiles < ntiles || epoch < 1 ||
      epoch >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  // static and dynamic shared memory may pass the 48 KB a block gets
  // without opting in: opt in once a device to the most a launch asks for
  static bool opted[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(chain_classify_pack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cp_smem_bytes<int>(CP_MAX_WORDS, CP_KEY_CAP));
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  const size_t smem = cp_smem_bytes<int>(max_len >> 4, nkeys);
  const CpInT<int> in{(const int*)off, (const int*)hrpos, (const int*)hlen,
                      (const int*)loc, (const uint8_t*)keep,
                      (const uint8_t*)unresolved, (const uint8_t*)overflow,
                      (const uint32_t*)packed, (const int*)rlens, B, H, H2,
                      max_len};
  const CtxT<int> cx{(const long long*)text, (const long long*)bkeys, ntext,
                     nkeys, seq_len};
  const Planes pl{(int*)exact, (int*)fd, (int*)acgt, L, pair_end};
  const ScanState ss{(unsigned int*)scratch,
                     (unsigned long long*)scratch + 1, (unsigned int)epoch};
  int* o = (int*)out;
  const CpOut<int> op{o, o + B, o + 2 * B, o + 2 * B + H2, o + 2 * B + 2 * H2,
                      o + 2 * B + 2 * H2 + B / 2};
  chain_classify_pack_kernel<<<ntiles, CP_THREADS, smem,
                               (cudaStream_t)stream>>>(in, cx, pl, op,
                                                       (int*)mmp, ss);
  return (int)cudaGetLastError();
}

// The x64 big-genome classify+pack (big_x64 under -shards N): as
// mc_chain_classify_pack with hit locations loc int64[H], seq_len int64,
// and no evidence apply. pd and the packed hits' locations are int64, so
// they move out of the int32 vector into an int64 side output: out
// int32[B + H2 + B/2 + B/32 + 2] holds meta1, hit_w, counts2, the overflow
// words, the total kept and the buffer-overflow flag, in that order; wide
// int64[B + H2] (8-byte aligned) holds pd, then hit_loc.
extern "C" int mc_chain_classify_pack_big(
    const void* off, const void* hrpos, const void* hlen, const void* loc,
    const void* keep, const void* unresolved, const void* overflow,
    const void* packed, const void* rlens, int B, int H, int H2, int max_len,
    const void* text, int ntext, const void* bkeys, int nkeys,
    long long seq_len, void* out, void* wide, void* mmp, void* scratch,
    int tiles, int epoch, void* stream) {
  const int ntiles = (B + CP_READS - 1) / CP_READS;
  if (B < 32 || B % 32 || H < 1 || H2 < 1 || max_len < 16 || max_len % 16 ||
      max_len > 511 || ntext < 1 || nkeys < 1 || seq_len < 1 ||
      wide == nullptr || ((uintptr_t)wide & 7) || scratch == nullptr ||
      tiles < ntiles || epoch < 1 || epoch >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  static bool opted[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(
        chain_classify_pack_big_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cp_smem_bytes<long long>(CP_MAX_WORDS, CP_KEY_CAP));
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  const size_t smem = cp_smem_bytes<long long>(max_len >> 4, nkeys);
  const CpInT<long long> in{(const int*)off, (const int*)hrpos,
                            (const int*)hlen, (const long long*)loc,
                            (const uint8_t*)keep, (const uint8_t*)unresolved,
                            (const uint8_t*)overflow, (const uint32_t*)packed,
                            (const int*)rlens, B, H, H2, max_len};
  const CtxT<long long> cx{(const long long*)text, (const long long*)bkeys,
                           ntext, nkeys, seq_len};
  const ScanState ss{(unsigned int*)scratch,
                     (unsigned long long*)scratch + 1, (unsigned int)epoch};
  int* o = (int*)out;
  long long* w = (long long*)wide;
  const CpOut<long long> op{o, w, o + B, w + B, o + B + H2, o + B + H2 + B / 2};
  chain_classify_pack_big_kernel<<<ntiles, CP_THREADS, smem,
                                   (cudaStream_t)stream>>>(in, cx, op,
                                                           (int*)mmp, ss);
  return (int)cudaGetLastError();
}

// K1 (dp_scatter_scan_kernel) over n int32 partials whose base addresses
// parts holds (int64[n] on this device, each partial readable from it).
// DP_SUM: out[k] = the sum at k for k < per (len == per). DP_SCAN: the
// sums at 0 .. len-1, zero-padded to Gp = nslices * per (< 2^31), cut
// into nslices slices of per, slice i written from its base address
// (table: int64[nslices + nmine] on this device, the slices' int32[per]
// base addresses, then the nmine slices this launch scans, ascending) as
// the inclusive cumsum from element 0. The launch runs `tiles_mine`
// tiles of DP_TILE (4,096) elements, those whose first element lies in
// one of its slices. status (int64[tiles]: tiles >= ceil(Gp / DP_TILE))
// is the look-back's one status array of every tile, holding no word of this
// epoch (1 .. 2^30 - 1), shared by the launches of one scan on other
// cards (sys 1: then polled at system scope); ticket (uint32, zero) is
// this launch's own. The scan's scratch as mc_chain_scan's.
extern "C" int mc_dp_scatter_scan(const void* parts, int n, int len,
                                  int per, int nslices, const void* table,
                                  int nmine, int tiles_mine, void* out,
                                  int mode, int sys, void* ticket,
                                  void* status, int tiles, int epoch,
                                  void* stream) {
  const long long gp = (long long)nslices * per;
  const long long ntiles = ((mode == DP_SUM ? per : gp) + DP_TILE - 1) /
                           DP_TILE;
  if (parts == nullptr || n < 1 || per < 1 || len < 1 ||
      (mode != DP_SUM && mode != DP_SCAN) ||
      (mode == DP_SUM && (out == nullptr || len != per)) ||
      (mode == DP_SCAN &&
       (table == nullptr || nmine < 1 || nmine > nslices ||
        gp >= (1LL << 31) || len > gp || tiles_mine < 1 ||
        tiles_mine > ntiles || ticket == nullptr || status == nullptr ||
        tiles < ntiles || epoch < 1 || epoch >= (1 << 30))))
    return (int)cudaErrorInvalidValue;
  const long long* tab = (const long long*)table;
  const DpArgs a{(const unsigned long long*)parts, n, len, per, nslices,
                 tab, tab == nullptr ? nullptr : tab + nslices, nmine,
                 (int*)out};
  const ScanState ss{(unsigned int*)ticket, (unsigned long long*)status,
                     (unsigned int)epoch};
  const int grid = mode == DP_SUM ? (int)ntiles : tiles_mine;
  dp_scatter_scan_kernel<<<grid, DP_THREADS, 0, (cudaStream_t)stream>>>(
      a, mode, sys, ss);
  return (int)cudaGetLastError();
}

// K2 (evidence_apply_bits_kernel): pd, rlens int32[B], mmp int32[B, 4]
// (16-byte aligned rows); bits uint32[>= ceil(B/32)] the admit bitmask, or
// meta int32[>= B] the chain kernel's packed output (its FAST reads
// admitted), exactly one of the two; the int32 planes exact [L+2], fd
// [4(L+2)], acgt [4(L+1)] of a genome of L (a text of 2L); pair_end picks
// the orientation plane by read-index parity; sign +1 or -1.
extern "C" int mc_evidence_apply_bits(const void* pd, const void* mmp,
                                      const void* rlens, const void* bits,
                                      const void* meta, int B, void* exact,
                                      void* fd, void* acgt, int L,
                                      int pair_end, int sign, void* stream) {
  if (B < 1 || L < 1 || (sign != 1 && sign != -1) || pd == nullptr ||
      mmp == nullptr || ((uintptr_t)mmp & 15) != 0 || rlens == nullptr ||
      (bits == nullptr) == (meta == nullptr) || exact == nullptr ||
      fd == nullptr || acgt == nullptr)
    return (int)cudaErrorInvalidValue;
  const Planes pl{(int*)exact, (int*)fd, (int*)acgt, L, pair_end};
  const int warps = (B + 31) / 32, per_block = APPLY_THREADS / 32;
  evidence_apply_bits_kernel<<<(warps + per_block - 1) / per_block,
                               APPLY_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)pd, (const int4*)mmp, (const int*)rlens,
      (const uint32_t*)bits, (const int*)meta, B, pl, sign);
  return (int)cudaGetLastError();
}

// K2's slice form (evidence_apply_slice_kernel), B4's apply: pd int64[B],
// rlens int32[B], mmp int32[B, 4] (16-byte aligned rows), bits uint32[>=
// ceil(B/32)] the admit bitmask; one shard's planes exact int32[Pl], fd and
// acgt int32[4][Pl], holding positions [off, off + Pl) of a genome of L (a
// text of 2L); pair_end picks the orientation plane by read-index parity.
extern "C" int mc_evidence_apply_slice(const void* pd, const void* mmp,
                                       const void* rlens, const void* bits,
                                       int B, void* exact, void* fd,
                                       void* acgt, long long L, long long off,
                                       long long Pl, int pair_end,
                                       void* stream) {
  if (B < 1 || L < 1 || off < 0 || Pl < 1 ||
      pd == nullptr || mmp == nullptr || ((uintptr_t)mmp & 15) != 0 ||
      rlens == nullptr || bits == nullptr || exact == nullptr ||
      fd == nullptr || acgt == nullptr)
    return (int)cudaErrorInvalidValue;
  const SlicePlanes pl{(int*)exact, (int*)fd, (int*)acgt, L, off, Pl,
                       pair_end};
  const int warps = (B + 31) / 32, per_block = APPLY_THREADS / 32;
  evidence_apply_slice_kernel<<<(warps + per_block - 1) / per_block,
                                APPLY_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)pd, (const int4*)mmp, (const int*)rlens,
      (const uint32_t*)bits, B, pl);
  return (int)cudaGetLastError();
}

// The host-delta merge (host_merge_kernel): idx int64[Np] and val
// int32[Np], Np a multiple of MERGE_ITEMS past the last entry, both on 16
// bytes; seg the launch's nseg segments (MergeSeg, sorted, disjoint, 1 <=
// nseg <= MERGE_MAX_SEGS) and run its nrun runs (MergeRun, 1 <= nrun <=
// nseg), both on the card, units 0 .. W - 1 in order; run0 = (ubase, a,
// b) of run 0 from the host. W may be 0: no launch.
extern "C" int mc_host_merge(const void* idx, const void* val,
                             const void* seg, int nseg, const void* run,
                             int nrun, long long ubase0, long long a0,
                             long long b0, long long W, void* stream) {
  if (nseg < 1 || nseg > MERGE_MAX_SEGS || nrun < 1 || nrun > nseg ||
      W < 0 || W > (1LL << 37))
    return (int)cudaErrorInvalidValue;
  if (W == 0) return (int)cudaSuccess;
  if (idx == nullptr || val == nullptr || seg == nullptr || run == nullptr ||
      (uintptr_t)idx % 16 || (uintptr_t)val % 16 || (uintptr_t)seg % 16 ||
      (uintptr_t)run % 16)
    return (int)cudaErrorInvalidValue;
  host_merge_kernel<<<(unsigned int)((W + MERGE_THREADS - 1) /
                                     MERGE_THREADS),
                      MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)idx, (const int*)val, (const MergeSeg*)seg, nseg,
      (const MergeRun*)run, nrun, MergeRun{0, ubase0, a0, b0}, W);
  return (int)cudaGetLastError();
}
