// Greedy-MEM seed scans, one thread per read, for Hopper (sm_90a). Built
// with nvcc into a plain C library and bound with ctypes
// (mapcaller_tpu_torch/ops/seed_scan_device.py::seed_scan3 / seed_scan1,
// whose plain PyTorch versions are ops/fm_search.py::_seed_scan3,
// _seed_scan3_compact and _seed_scan).
//
// Replaces three XLA device programs of mapcaller_tpu/ops/fm_search.py
// (no Pallas kernel): _seed_scan3 (:55-211, a lax.while_loop at :206 over
// 8-step unrolled blocks), _seed_scan3_compact (:214-450, while_loop at
// :447) and the 1-step _seed_scan (:856-964, while_loop at :961). Same
// function (ref: src/bwt_search.cpp:121-164, BWT_Search):
//
//   seed_scan3_kernel  the occ3 state machine. An idle read starts an
//     extension at pos: without the fused prefix skip the 1-base interval
//     of its code; with it (pfx_base > 0) the prefix entry of the K bases
//     at pos, packed 16 to a row at rows[pfx_base + key/16], entry key%16
//     = (x0, x1, x2, 0), and the 1-base init when the entry is empty
//     (x2 == 0). An extension with 3 bases left and no replay takes a
//     3-step over the two occ3 rows at x1 and x1+x2; a failed 3-step sets
//     replay and changes nothing else; otherwise a derived 1-step. A read
//     at its end, or whose 1-step fails, finalizes: a seed of >= 16 bases
//     and <= 50 hits goes to slot min(n, S-1) (overflow once the table is
//     full), and the read moves to ext_pos + 1. good, s_x0 and s_freq use
//     x0 and x2 before the step. With lanes < B, `lanes` threads take
//     reads from an atomic counter (the compacted scan's contract: the
//     same per-read outputs).
//   seed_scan3_routed_kernel  the same machine, a lane group per read
//     (scan3_group, below), over an occ3 table split into shards of `per`
//     rows (-shards N): each row fetch reads row w from shard w / per
//     through a table of the shards' base addresses (the reference routes
//     the same rows through an all-gather and a psum,
//     mapcaller_tpu/parallel/sharded_index.py:115-132). No prefix skip:
//     the sharded table has no prefix rows. The row fetch is a template
//     parameter of the group form (ShardRows, ShardRows64); the thread
//     form, scan3_read, reads the main path's one table (FlatRows).
//   seed_scan3_big_kernel  the routed machine of the x64 big-genome path
//     (big_x64 under -shards N; mapcaller_tpu/parallel/big_index.py:73-94,
//     _seed_scan3 with idx_dtype int64): the shards' rows hold counts
//     relative to their shard (int32), each fetch adds its shard's int64
//     base counts (ShardRows64), and the interval state, the row indices
//     and the correction rows are int64, so a text may pass 2^31 rows.
//     No prefix skip, a lane group per read.
//   seed_scan1_kernel  the same machine over the 1-step occ4 rows, one
//     base a step; with has_n byte codes whose N (> 3) ends an extension
//     and is skipped as a start, else 2-bit packed codes.
//
// Each read runs at most `cap` steps, the trip count of the plain lockstep
// loop (a whole number of its unrolled blocks); a finished read stays
// unchanged there, so its result is its state after min(trajectory, cap)
// steps, which is what the thread computes. Slots at or past n_seeds are
// written 0, as the plain version leaves them, so the seed tables are
// equal element for element. iters[r] is the read's step count (the
// reference's with_iters output), rows[r] the index rows it gathered (two
// a step that extends or tries to, none a step that starts or ends at the
// read's end): the bytes the scan must move.
//
// Row layout (ops/fm3_device.py): an occ3 row is 72 int32, 288 bytes: 64
// trinucleotide counts at the row's first BWT index, then 16 symbol bytes
// (T[p-3]*16 + T[p-2]*4 + T[p-1], 255 for p < 3) in words 64-67, then 4
// pad words. Index i selects row i >> 4 and in-row offset m = i & 15.
// An occ4 row (ops/fm_device.py) is [cntA, cntC, cntG, cntT, word, 0, 0,
// 0], the BWT word's crumbs big end first. Read words: the packed
// uint8[B, max_len/4] batch read as uint32 is already little-endian
// words with base j at bits 2*(j%16) of word j/16 (max_len % 16 == 0).
//
// Bound on an H100 SXM (HBM3, 3.35 TB/s): bytes. A step that extends, or
// tries to, gathers two rows (288 B each for occ3, 32 B for occ4), so
// bytes = sum(rows) * row over the memory rate; chip_smoke.py counts them
// from each run's rows. The operations bound lies below it: about 930
// int32 operations per occ3 step (a row's 64 counts at ~4 for the two
// conditional sums, its 16 symbols at ~13 for the byte extract, rev3 and
// the tallies; two rows) and about 80 per occ4 step (two masked popcounts
// of 4 bases and the update), against the int32 issue rate. Every step is
// a dependent chain (state -> row index -> two row loads -> sums ->
// state), so a thread waits one memory latency a step. The design keeps
// the whole state in registers, loads each row as 17 16-byte vectors with
// both rows' loads independent, computes only the branch the read takes,
// and writes each seed straight to its slot; no host sync and no launch
// per step. On an NVIDIA H100 80GB HBM3 at 700 W a 32,768-read batch of
// the E. coli-scale main path ran at about two thirds of the byte bound
// (PERF.md).
//
// The routed scans run on a shard's part of a batch (B / N reads), where a
// thread a read sits at a floor: 2,048 to 16,384 reads took 0.20-0.28 ms
// on that card, set by the loads (the loads alone, without the sums, took
// nearly as long; the sums alone a ninth of it): each warp-wide 16-byte
// load of the thread form touches 32 rows, 34 such loads a step. So they
// take a group of lanes a read (scan3_group): every lane holds the read's
// state, each lane loads its share of the two rows' count vectors
// (neighbouring lanes on neighbouring 16-byte vectors, so a load touches
// a few lines) and sums them, and the group adds its partials by xor
// shuffles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MIN_SEED_LEN = 16;
constexpr int OCC_THR = 50;
constexpr int THREADS = 128;
// Lanes a read and least blocks an SM (__launch_bounds__) of the routed
// scans, chosen on the card on a shard's 16,384 and 8,192 reads (PERF.md,
// seed_scan_variants.py). The 32-bit kernel: 16 lanes within 64 registers
// (8 blocks an SM, no spills) hold 8,192 reads in one wave, where 8 lanes
// take 0.10 ms against 0.085; they tie at 16,384. The 64-bit kernel takes
// 79 registers at 16 lanes and spills at 64, so 8,192 reads need 1.3
// waves there; at 8 lanes (93 registers) they fit one, 0.100 ms against
// 0.113; they tie at 16,384. Fewer reads (-shards 8 and up) would favour
// 16 lanes for both.
constexpr int ROUTED_GROUP = 16, ROUTED_MIN_BLOCKS = 8;
constexpr int BIG_GROUP = 8;
constexpr int ROW3 = 72;                // int32 per occ3 row
constexpr int ROW1 = 8;                 // int32 per occ4 row
// int64 per row of a shard's base table (ShardRows64): its 64 base counts,
// their rev3 prefix (65), a pad (3) and their group sums by last base (4)
constexpr int B3X = 136, B3X_REV = 64, B3X_GRP = 132;

// The row-index constants in the scan's index type I (int, or long long
// for the x64 big-genome scan, whose rows may pass 2^31).
template <class I>
struct Occ3ConstsT {
  I primary, row_p1, row_p2;
  int t0, t1, tail1, tail2a, tail2b;
  int pfx_base, pfx_k;
};
using Occ3Consts = Occ3ConstsT<int>;

// Where a scan's occ3 rows come from. FlatRows: one table (the main
// path). ShardRows: the table split over shards of `per` rows (-shards N,
// ops/routed.py); row w lives in shard w / per at local row w % per, whose
// base address the shard table holds (on this card, or on a peer card
// with peer access). ShardRows64: the x64 big-genome table (big_x64 under
// -shards N, parallel/big_index.py), routed the same way, whose rows hold
// counts relative to their shard: the absolute count is the shard's int64
// base count (base3[s][d]) plus the row's. A shard's base table row
// (base3x, B3X int64) also holds what the sums need of the 64 base counts
// precomputed: for each order key w their sum over the trinucleotides d
// with rev3(d) < w, and their sums by last base; so a fetch adds two
// loads, not 64. The scan's state and row indices are int64 (Index).
// kBase: whether counts add a shard's base. The main path's scan
// (scan3_read) reads FlatRows; the routed kernels run scan3_group over
// ShardRows or ShardRows64.
struct FlatRows {
  const int* rows;
  __device__ __forceinline__ const int4* row(unsigned w) const {
    return reinterpret_cast<const int4*>(rows + (size_t)w * ROW3);
  }
};

struct ShardRows {
  static constexpr bool kBase = false;
  using Index = int;
  using UIndex = unsigned;
  const unsigned long long* base;       // [n] shard base addresses
  unsigned per;                         // rows a shard
  __device__ __forceinline__ const int4* row(unsigned w) const {
    const unsigned s = w / per;
    const int* p = reinterpret_cast<const int*>(__ldg(base + s));
    return reinterpret_cast<const int4*>(p + (size_t)(w - s * per) * ROW3);
  }
};

struct ShardRows64 {
  static constexpr bool kBase = true;
  using Index = long long;
  using UIndex = unsigned long long;
  const unsigned long long* base;       // [n] shard base addresses
  const long long* base3x;              // [n, B3X] each shard's base table
  unsigned long long per;               // rows a shard
  double inv_per;                       // 1.0 / per
  // w / per without a 64-bit division (a long chain of integer steps):
  // w and per are exact in a double (< 2^53), so the rounded quotient is
  // at most one off, and one comparison each way settles it.
  __device__ __forceinline__ unsigned long long shard(
      unsigned long long w) const {
    unsigned long long s = (unsigned long long)((double)w * inv_per);
    if (s * per > w)
      --s;
    else if ((s + 1) * per <= w)
      ++s;
    return s;
  }
  // row w and its shard's base table row b
  __device__ __forceinline__ const int4* row(unsigned long long w,
                                             const long long*& b) const {
    const unsigned long long s = shard(w);
    b = base3x + (size_t)s * B3X;
    const int* p = reinterpret_cast<const int*>(__ldg(base + s));
    return reinterpret_cast<const int4*>(p + (size_t)(w - s * per) * ROW3);
  }
};

struct Out {
  long long* n_seeds;                   // [B]
  long long* tab;                       // [4, B, S]: rpos, len, x0, freq
  uint8_t* overflow;                    // [B] (torch.bool)
  int* iters;                           // [B]
  int* rows;                            // [B]
  int B, S;
};

template <class I = int>
__device__ __forceinline__ I l2(const long long* __restrict__ L2, int c) {
  return (I)__ldg(L2 + c);
}

template <class I>
__device__ __forceinline__ I pick4(I a0, I a1, I a2, I a3, int c) {
  return c == 0 ? a0 : (c == 1 ? a1 : (c == 2 ? a2 : a3));
}

// The 16 symbol bytes of a row, in 4 words.
__device__ __forceinline__ uint32_t sym_at(const int4& s, int q) {
  const uint32_t w = (uint32_t)(q < 4 ? s.x : q < 8 ? s.y : q < 12 ? s.z : s.w);
  return (w >> ((q & 3) * 8)) & 0xFFu;
}

// 3-step sums of one occ3 row for trinucleotide d and order key w:
// occ_d = Occ3(d, i), rev = sum_d' cnt[d'] [rev3(d') < w] + #{q < m:
// sym_q valid, rev3(sym_q) < w}, rev3(d) = 63 - ((d&3)*16 + (d&12) +
// (d>>4)) (ops/fm3_device.py occ3_d, rev3_lt_w_sum).
__device__ __forceinline__ void sums3(const FlatRows& src, unsigned i, int d,
                                      int w, int& occ_d, int& rev) {
  const int4* R = src.row(i >> 4);
  const int m = (int)(i & 15u);
  int base = 0, rs = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int4 v = __ldg(R + j);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dd = 4 * j + q;
      const int r3 = 63 - ((dd & 3) * 16 + (dd & 12) + (dd >> 4));
      const int c = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
      base += dd == d ? c : 0;
      rs += r3 < w ? c : 0;
    }
  }
  const int4 s = __ldg(R + 16);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int sym = (int)sym_at(s, q);
    const bool in = q < m;
    base += (in && sym == d) ? 1 : 0;
    const int r3 = 63 - ((sym & 3) * 16 + (sym & 12) + (sym >> 4));
    rs += (in && sym < 64 && r3 < w) ? 1 : 0;
  }
  occ_d = base;
  rev = rs;
}

// Derived 1-step counts of all 4 bases at occ3 index i (== bwt_occ4(i-1)):
// group sums of the 64 counts by last base, the in-row symbols before m,
// and the corrections for rows p=1, p=2 (ops/fm3_device.py occ1_4).
__device__ __forceinline__ void occ1_4(const FlatRows& src,
                                       const Occ3Consts& k, unsigned i,
                                       int& c0, int& c1, int& c2, int& c3) {
  const int4* R = src.row(i >> 4);
  const int m = (int)(i & 15u);
  int g0 = 0, g1 = 0, g2 = 0, g3 = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int4 v = __ldg(R + j);
    g0 += v.x;
    g1 += v.y;
    g2 += v.z;
    g3 += v.w;
  }
  const int4 s = __ldg(R + 16);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int sym = (int)sym_at(s, q);
    const bool in = q < m && sym < 64;
    const int c = sym & 3;
    g0 += (in && c == 0) ? 1 : 0;
    g1 += (in && c == 1) ? 1 : 0;
    g2 += (in && c == 2) ? 1 : 0;
    g3 += (in && c == 3) ? 1 : 0;
  }
  const int a1 = (int)i > k.row_p1 ? 1 : 0;
  const int a2 = (int)i > k.row_p2 ? 1 : 0;
  c0 = g0 + (k.t0 == 0 ? a1 : 0) + (k.t1 == 0 ? a2 : 0);
  c1 = g1 + (k.t0 == 1 ? a1 : 0) + (k.t1 == 1 ? a2 : 0);
  c2 = g2 + (k.t0 == 2 ? a1 : 0) + (k.t1 == 2 ? a2 : 0);
  c3 = g3 + (k.t0 == 3 ? a1 : 0) + (k.t1 == 3 ? a2 : 0);
}

// bwt_occ4 over the 1-step rows: counts of each base in BWT rows [0, k];
// k < 0 gives zeros (ops/fm_device.py occ4).
__device__ __forceinline__ void occ4(const int* __restrict__ occ, int primary,
                                     int k, int& c0, int& c1, int& c2,
                                     int& c3) {
  if (k < 0) {
    c0 = c1 = c2 = c3 = 0;
    return;
  }
  const int kadj = k - (k >= primary ? 1 : 0);
  const int4* R = reinterpret_cast<const int4*>(occ + (size_t)(kadj >> 4) * ROW1);
  const int4 cnt = __ldg(R);
  const uint32_t word = (uint32_t)__ldg(R + 1).x;
  const uint32_t crumb = (uint32_t)(~kadj) & 15u;
  const uint32_t keep = ~((1u << (2 * crumb)) - 1u) & 0x55555555u;
  uint32_t nx = ~word;                          // c = 0
  c0 = cnt.x + __popc(nx & (nx >> 1) & keep);
  nx = ~(word ^ 0x55555555u);
  c1 = cnt.y + __popc(nx & (nx >> 1) & keep);
  nx = ~(word ^ 0xAAAAAAAAu);
  c2 = cnt.z + __popc(nx & (nx >> 1) & keep);
  nx = word;                                    // c = 3: ~(word ^ ~0)
  c3 = cnt.w + __popc(nx & (nx >> 1) & keep);
}

// The K bases at p as a prefix-table key, first base most significant;
// bases past the last word read as 0 (fm_search._word_key).
__device__ __forceinline__ int word_key(const uint32_t* __restrict__ words,
                                        int nwords, int p, int K) {
  const int wi = p >> 4;
  const uint32_t w0 = __ldg(words + wi);
  const uint32_t w1 = wi + 1 < nwords ? __ldg(words + wi + 1) : 0u;
  const int sh = (p & 15) * 2;
  const uint32_t comb = (w0 >> sh) | (sh > 0 ? (w1 << (32 - sh)) : 0u);
  int key = 0;
  for (int j = 0; j < K; ++j)
    key |= (int)((comb >> (2 * j)) & 3u) << (2 * (K - 1 - j));
  return key;
}

__device__ __forceinline__ int word_code(const uint32_t* __restrict__ words,
                                         int p) {
  return (int)((__ldg(words + (p >> 4)) >> ((p & 15) * 2)) & 3u);
}

// Seed bookkeeping of a finalize (fm_search._record_seed): x0 and x2 are
// the state before the step.
template <class I>
__device__ __forceinline__ void finalize(const Out& o, int r, int start,
                                         int ext_pos, I x0, I x2, int& ns,
                                         bool& ovf) {
  const int slen = ext_pos - start;
  if (slen >= MIN_SEED_LEN && x2 <= OCC_THR) {
    const int slot = min(ns, o.S - 1);
    const size_t plane = (size_t)o.B * o.S;
    long long* t = o.tab + (size_t)r * o.S + slot;
    t[0] = start;
    t[plane] = slen;
    t[2 * plane] = x0;
    t[3 * plane] = x2;
    if (ns >= o.S) ovf = true;
    ns = min(ns + 1, o.S);
  }
}

// Per-read outputs; slots at or past n_seeds are 0.
__device__ __forceinline__ void store(const Out& o, int r, int ns, bool ovf,
                                      int it, int g) {
  o.n_seeds[r] = ns;
  o.overflow[r] = ovf ? 1 : 0;
  o.iters[r] = it;
  o.rows[r] = g;
  const size_t plane = (size_t)o.B * o.S;
  long long* t = o.tab + (size_t)r * o.S;
  for (int s = ns; s < o.S; ++s) {
    t[s] = 0;
    t[s + plane] = 0;
    t[s + 2 * plane] = 0;
    t[s + 3 * plane] = 0;
  }
}

// The occ3 machine for read r on one thread, over the main path's table.
__device__ __forceinline__ void scan3_read(
    const FlatRows& src, const int* __restrict__ c3_first,
    const long long* __restrict__ L2, const uint8_t* __restrict__ packed,
    const int* __restrict__ rlens, int max_len, int cap,
    const Occ3Consts& k, const Out& o, int r) {
  using I = int;
  using U = unsigned;
  const int nwords = max_len >> 4;
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(packed + (size_t)r * (max_len >> 2));
  const int rlen = rlens[r];
  const int last = max_len - 1;
  int pos = 0, start = 0, ext_pos = 0, ns = 0;
  I x0 = 0, x1 = 0, x2 = 0;
  bool in_ext = false, replay = false, ovf = false;
  int it = 0, g = 0;
  for (; it < cap; ++it) {
    if (!in_ext) {
      if (pos >= rlen - MIN_SEED_LEN) break;         // done
      const int p = min(pos, last);
      bool jump = false;
      if (k.pfx_base > 0) {
        const int key = word_key(words, nwords, p, k.pfx_k);
        const int4 e = __ldg(src.row((unsigned)(k.pfx_base + (key >> 4))) +
                             (key & 15));
        if (e.z > 0) {
          x0 = e.x;
          x1 = e.y;
          x2 = e.z;
          ext_pos = pos + k.pfx_k;
          jump = true;
        }
      }
      if (!jump) {
        const int c = word_code(words, p);
        x0 = l2<I>(L2, c) + 1;
        x1 = l2<I>(L2, 3 - c) + 1;
        x2 = l2<I>(L2, c + 1) - l2<I>(L2, c);
        ext_pos = pos + 1;
      }
      start = pos;
      in_ext = true;
      replay = false;
      continue;
    }
    if (ext_pos >= rlen) {                             // at the read's end
      finalize(o, r, start, ext_pos, x0, x2, ns, ovf);
      pos = ext_pos + 1;
      in_ext = replay = false;
      continue;
    }
    const int e0 = word_code(words, min(ext_pos, last));
    const U ik = (U)x1, il = (U)(x1 + x2);
    if (!replay && ext_pos + 3 <= rlen) {              // 3-step
      const int e1 = word_code(words, min(ext_pos + 1, last));
      const int e2 = word_code(words, min(ext_pos + 2, last));
      const int d = (3 - e2) * 16 + (3 - e1) * 4 + (3 - e0);
      const int w = e0 * 16 + e1 * 4 + e2;
      I tk, rk, tl, rl;
      sums3(src, ik, d, w, tk, rk);
      sums3(src, il, d, w, tl, rl);
      g += 2;
      const I n2 = tl - tk;
      if (n2 <= 0) {                                   // exact end within 3
        replay = true;
        continue;
      }
      const I lo = x1, hi = x1 + x2;
      const int cmp1 = k.tail1 <= e0 ? 1 : 0;
      const int cmp2 = (k.tail2a < e0 || (k.tail2a == e0 && k.tail2b <= e1)) ? 1 : 0;
      const int adj = (lo <= k.primary && k.primary < hi ? 1 : 0) +
                      (lo <= k.row_p1 && k.row_p1 < hi ? cmp1 : 0) +
                      (lo <= k.row_p2 && k.row_p2 < hi ? cmp2 : 0);
      x0 = x0 + adj + (rl - rk);
      x1 = __ldg(c3_first + d) + tk;
      x2 = n2;
      ext_pos += 3;
      continue;
    }
    // derived 1-step (tail bases, or the replay after a failed 3-step)
    I k0, k1, k2, k3, l0, l1, l2v, l3;
    occ1_4(src, k, ik, k0, k1, k2, k3);
    occ1_4(src, k, il, l0, l1, l2v, l3);
    g += 2;
    const int ci = 3 - e0;
    const I o1 = l1 - k1, o2 = l2v - k2, o3 = l3 - k3;
    const I n2 = pick4(l0 - k0, o1, o2, o3, ci);
    if (n2 <= 0) {
      finalize(o, r, start, ext_pos, x0, x2, ns, ovf);
      pos = ext_pos + 1;
      in_ext = replay = false;
      continue;
    }
    const int adj = (x1 <= k.primary && x1 + x2 - 1 >= k.primary) ? 1 : 0;
    x0 = x0 + adj + (ci < 3 ? o3 : 0) + (ci < 2 ? o2 : 0) + (ci < 1 ? o1 : 0);
    x1 = l2<I>(L2, ci) + 1 + pick4(k0, k1, k2, k3, ci);
    x2 = n2;
    ext_pos += 1;
  }
  store(o, r, ns, ovf, it, g);
}

// ---- the lane-group form of the occ3 machine (the routed scans) ----

// The lanes of this thread's group of G in its warp: a group's shuffles
// name only its own lanes, so the warp's other groups may be elsewhere
// (another branch, or done).
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32)
    return 0xFFFFFFFFu;
  else
    return ((1u << G) - 1u) << (G * ((threadIdx.x & 31) / G));
}

// The group's sum of v, on every lane: xor partners stay within a group
// aligned to G lanes. Unsigned, so partials may wrap: the totals fit int32
// and integer sums in any order give the same words.
template <int G>
__device__ __forceinline__ unsigned group_sum(unsigned mask, unsigned v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// What a step counts, as selectors on a trinucleotide x = 4 v + q (lane q
// of count vector v, or a symbol byte): x is selected when (v & vmask) ==
// vval and q == sel (a 3-step's d: Occ3(d, .); a 1-step's base ci: its
// group sum by last base), and counts toward the order sum when key(x) =
// 63 - rev3(x) = 16 q + 4 (v & 3) + (v >> 2) > thr (a 3-step: rev3(x) <
// w, thr = 63 - w; a 1-step: the bases after ci, thr = 16 ci + 15).
struct StepSel {
  int vmask, vval, sel, thr;
};

// One gathering step's row sums for a lane group, over rows Rk (index ik,
// in-row offset mk) and Rl (il, ml): A = row ik's selected count, N = row
// il's minus row ik's, X = the same of the order sums, each over the 64
// counts and the symbols before the row's m (ops/fm3_device.py occ3_d,
// rev3_lt_w_sum, occ1_4), without the per-row terms. Lane j takes the
// count vectors v = j, j + G, ... of the two rows' 32 (row v / 16, vector
// v % 16: neighbouring lanes load neighbouring 16-byte vectors of a row)
// and the symbols of the same numbers (a lane loads the symbol word that
// holds one, neighbouring lanes the same or the next word). The partials
// are int32 sums of one row's counts (for ShardRows64 relative to the
// row's shard) and are reduced as such. Shuffles: every lane of the group
// calls this once a step that gathers, on the group's own state, so all
// lanes in `mask` reach each shuffle; 3- and 1-steps share this one
// reduction.
struct GroupSums {
  int A, N, X;
};

template <int G>
__device__ __forceinline__ GroupSums group_sums(const int4* Rk, const int4* Rl,
                                                int mk, int ml,
                                                const StepSel& q, int lane,
                                                unsigned mask) {
  unsigned a = 0, n = 0, x = 0;
#pragma unroll
  for (int t = 0; t < 32 / G; ++t) {
    // which row: known at compile time unless a group is the whole warp
    const bool second = G == 32 ? lane >= 16 : t * G >= 16;
    const int v = (lane + t * G) & 15;
    const int4* R = second ? Rl : Rk;
    const int4 c4 = __ldg(R + v);
    const uint32_t sw = __ldg(reinterpret_cast<const uint32_t*>(R + 16) +
                              (v >> 2));
    const bool vm = (v & q.vmask) == q.vval;
    const int kv = (v & 3) * 4 + (v >> 2);
    unsigned ca = 0, cx = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned c =
          (unsigned)(e == 0 ? c4.x : e == 1 ? c4.y : e == 2 ? c4.z : c4.w);
      ca += (vm && e == q.sel) ? c : 0u;
      cx += 16 * e + kv > q.thr ? c : 0u;
    }
    const int sym = (int)((sw >> ((v & 3) * 8)) & 0xFFu);
    if (v < (second ? ml : mk) && sym < 64) {
      const int sv = sym >> 2, se = sym & 3;
      ca += ((sv & q.vmask) == q.vval && se == q.sel) ? 1u : 0u;
      cx += 16 * se + (sv & 3) * 4 + (sv >> 2) > q.thr ? 1u : 0u;
    }
    if (second) {
      n += ca;
      x += cx;
    } else {
      a += ca;
      n -= ca;
      x -= cx;
    }
  }
  return GroupSums{(int)group_sum<G>(mask, a), (int)group_sum<G>(mask, n),
                   (int)group_sum<G>(mask, x)};
}

// A row of the scan's table and, for shard-relative rows, its shard's base
// table row (one shard lookup for both).
template <class Src>
__device__ __forceinline__ const int4* fetch_row(const Src& src,
                                                 typename Src::UIndex w,
                                                 const long long*& b) {
  if constexpr (Src::kBase)
    return src.row(w, b);
  else
    return src.row(w);
}

// finalize() for a lane group: every lane updates the read's state, lane 0
// writes the seed.
template <class I>
__device__ __forceinline__ void finalize_group(const Out& o, int r,
                                               int start, int ext_pos, I x0,
                                               I x2, int& ns, bool& ovf,
                                               int lane) {
  const int slen = ext_pos - start;
  if (slen >= MIN_SEED_LEN && x2 <= OCC_THR) {
    if (lane == 0) {
      const int slot = min(ns, o.S - 1);
      const size_t plane = (size_t)o.B * o.S;
      long long* t = o.tab + (size_t)r * o.S + slot;
      t[0] = start;
      t[plane] = slen;
      t[2 * plane] = x0;
      t[3 * plane] = x2;
    }
    if (ns >= o.S) ovf = true;
    ns = min(ns + 1, o.S);
  }
}

// store() for a lane group: lane 0 writes the per-read words, the lanes
// share the zero fill of the slots at or past n_seeds.
__device__ __forceinline__ void store_group(const Out& o, int r, int ns,
                                            bool ovf, int it, int g,
                                            int lane, int G) {
  if (lane == 0) {
    o.n_seeds[r] = ns;
    o.overflow[r] = ovf ? 1 : 0;
    o.iters[r] = it;
    o.rows[r] = g;
  }
  const size_t plane = (size_t)o.B * o.S;
  long long* t = o.tab + (size_t)r * o.S;
  for (int s = ns + lane; s < o.S; s += G) {
    t[s] = 0;
    t[s + plane] = 0;
    t[s + 2 * plane] = 0;
    t[s + 3 * plane] = 0;
  }
}

// scan3_read's machine without the prefix skip (the routed tables have no
// prefix rows) for read r on the G lanes of a group (lane `lane`, the
// group's lanes `mask`). Every lane holds the whole state, so the
// group takes each branch together and leaves the loop together; a group
// that finishes early leaves its warp's other groups, whose shuffles name
// only their own lanes. Each read still runs at most `cap` steps, and
// counts its steps and row gathers as the thread does. The row sums come
// from group_sums; the per-row terms are added once, after the reduction:
// the 1-step corrections for rows p = 1, 2 and, for ShardRows64, the
// shards' int64 base counts (loaded by every lane, before the reduction,
// as broadcasts). The interval state and x1 + x2 stay in Index / UIndex as
// in the thread form.
template <class Src, int G>
__device__ __forceinline__ void scan3_group(
    const Src& src, const typename Src::Index* __restrict__ c3_first,
    const long long* __restrict__ L2, const uint8_t* __restrict__ packed,
    const int* __restrict__ rlens, int max_len, int cap,
    const Occ3ConstsT<typename Src::Index>& k, const Out& o, int r,
    int lane, unsigned mask) {
  using I = typename Src::Index;
  using U = typename Src::UIndex;
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(packed + (size_t)r * (max_len >> 2));
  const int rlen = rlens[r];
  const int last = max_len - 1;
  int pos = 0, start = 0, ext_pos = 0, ns = 0;
  I x0 = 0, x1 = 0, x2 = 0;
  bool in_ext = false, replay = false, ovf = false;
  int it = 0, g = 0;
  for (; it < cap; ++it) {
    if (!in_ext) {                      // no prefix skip: the 1-base init
      if (pos >= rlen - MIN_SEED_LEN) break;         // done
      const int c = word_code(words, min(pos, last));
      x0 = l2<I>(L2, c) + 1;
      x1 = l2<I>(L2, 3 - c) + 1;
      x2 = l2<I>(L2, c + 1) - l2<I>(L2, c);
      ext_pos = pos + 1;
      start = pos;
      in_ext = true;
      replay = false;
      continue;
    }
    if (ext_pos >= rlen) {                             // at the read's end
      finalize_group(o, r, start, ext_pos, x0, x2, ns, ovf, lane);
      pos = ext_pos + 1;
      in_ext = replay = false;
      continue;
    }
    const int e0 = word_code(words, min(ext_pos, last));
    const U ik = (U)x1, il = (U)(x1 + x2);
    const bool three = !replay && ext_pos + 3 <= rlen;
    const int ci = 3 - e0;
    int e1 = 0, d = 0, w = 0;
    if (three) {
      e1 = word_code(words, min(ext_pos + 1, last));
      const int e2 = word_code(words, min(ext_pos + 2, last));
      d = (3 - e2) * 16 + (3 - e1) * 4 + (3 - e0);
      w = e0 * 16 + e1 * 4 + e2;
    }
    const long long* bk = nullptr;
    const long long* bl = nullptr;
    const int4* Rk = fetch_row(src, ik >> 4, bk);
    const int4* Rl = fetch_row(src, il >> 4, bl);
    // the per-row terms: bA (row ik's), bN and bX (row il's minus row ik's)
    I bA = 0, bN = 0, bX = 0;
    if (three) {
      if constexpr (Src::kBase) {
        const long long dk = __ldg(bk + d);
        bA = dk;
        bN = __ldg(bl + d) - dk;
        bX = __ldg(bl + B3X_REV + w) - __ldg(bk + B3X_REV + w);
      }
    } else {                    // the corrections for rows p = 1, 2
      const int a1k = (I)ik > k.row_p1 ? 1 : 0, a2k = (I)ik > k.row_p2 ? 1 : 0;
      const int a1 = ((I)il > k.row_p1 ? 1 : 0) - a1k;
      const int a2 = ((I)il > k.row_p2 ? 1 : 0) - a2k;
      bA = (k.t0 == ci ? a1k : 0) + (k.t1 == ci ? a2k : 0);
      bN = (k.t0 == ci ? a1 : 0) + (k.t1 == ci ? a2 : 0);
      bX = (k.t0 > ci ? a1 : 0) + (k.t1 > ci ? a2 : 0);
      if constexpr (Src::kBase) {           // the base counts' group sums
        const longlong2* gk = reinterpret_cast<const longlong2*>(bk + B3X_GRP);
        const longlong2* gl = reinterpret_cast<const longlong2*>(bl + B3X_GRP);
        const longlong2 uk = __ldg(gk), vk = __ldg(gk + 1);
        const longlong2 ul = __ldg(gl), vl = __ldg(gl + 1);
        const I o1 = ul.y - uk.y, o2 = vl.x - vk.x, o3 = vl.y - vk.y;
        bA += pick4<I>(uk.x, uk.y, vk.x, vk.y, ci);
        bN += pick4<I>(ul.x - uk.x, o1, o2, o3, ci);
        bX += (ci < 3 ? o3 : 0) + (ci < 2 ? o2 : 0) + (ci < 1 ? o1 : 0);
      }
    }
    const StepSel q = three ? StepSel{15, d >> 2, d & 3, 63 - w}
                            : StepSel{0, 0, ci, 16 * ci + 15};
    const GroupSums sums = group_sums<G>(Rk, Rl, (int)(ik & 15u),
                                         (int)(il & 15u), q, lane, mask);
    const int A = sums.A, N = sums.N, X = sums.X;
    g += 2;
    const I n2 = (I)N + bN;
    if (three) {                                       // 3-step
      if (n2 <= 0) {                                   // exact end within 3
        replay = true;
        continue;
      }
      const I lo = x1, hi = x1 + x2;
      const int cmp1 = k.tail1 <= e0 ? 1 : 0;
      const int cmp2 = (k.tail2a < e0 || (k.tail2a == e0 && k.tail2b <= e1)) ? 1 : 0;
      const int adj = (lo <= k.primary && k.primary < hi ? 1 : 0) +
                      (lo <= k.row_p1 && k.row_p1 < hi ? cmp1 : 0) +
                      (lo <= k.row_p2 && k.row_p2 < hi ? cmp2 : 0);
      x0 = x0 + adj + ((I)X + bX);
      x1 = __ldg(c3_first + d) + ((I)A + bA);
      x2 = n2;
      ext_pos += 3;
      continue;
    }
    // derived 1-step (tail bases, or the replay after a failed 3-step)
    if (n2 <= 0) {
      finalize_group(o, r, start, ext_pos, x0, x2, ns, ovf, lane);
      pos = ext_pos + 1;
      in_ext = replay = false;
      continue;
    }
    const int adj = (x1 <= k.primary && x1 + x2 - 1 >= k.primary) ? 1 : 0;
    x0 = x0 + adj + ((I)X + bX);
    x1 = l2<I>(L2, ci) + 1 + ((I)A + bA);
    x2 = n2;
    ext_pos += 1;
  }
  store_group(o, r, ns, ovf, it, g, lane, G);
}

// A kernel's reads, G lanes each (groups never straddle a warp or a
// block).
template <int G, class Src>
__device__ __forceinline__ void scan3_groups(
    const Src& src, const typename Src::Index* __restrict__ c3_first,
    const long long* __restrict__ L2, const uint8_t* __restrict__ packed,
    const int* __restrict__ rlens, int max_len, int cap,
    const Occ3ConstsT<typename Src::Index>& k, const Out& o) {
  static_assert(32 % G == 0 && THREADS % G == 0, "a group in one warp");
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int r = t / G;
  if (r >= o.B) return;                 // the whole group: one read
  scan3_group<Src, G>(src, c3_first, L2, packed, rlens, max_len, cap, k, o,
                      r, t % G, group_mask<G>());
}

// Blocks of a launch of G lanes a read over B reads.
int group_blocks(int B, int G) {
  return (int)(((long long)B * G + THREADS - 1) / THREADS);
}

__global__ void __launch_bounds__(THREADS)
seed_scan3_kernel(const int* __restrict__ rows,
                  const int* __restrict__ c3_first,
                  const long long* __restrict__ L2,
                  const uint8_t* __restrict__ packed,
                  const int* __restrict__ rlens, int lanes, int max_len,
                  int cap, Occ3Consts k, Out o, int* __restrict__ next) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= lanes) return;
  const bool queue = lanes < o.B;
  // lanes mode: each lane takes the next unread read until none is left
  for (int r = queue ? atomicAdd(next, 1) : t; r < o.B;
       r = queue ? atomicAdd(next, 1) : o.B)
    scan3_read(FlatRows{rows}, c3_first, L2, packed, rlens, max_len, cap, k,
               o, r);
}

// The occ3 scan over a genome-sharded table, a lane group per read.
__global__ void __launch_bounds__(THREADS, ROUTED_MIN_BLOCKS)
seed_scan3_routed_kernel(ShardRows src, const int* __restrict__ c3_first,
                         const long long* __restrict__ L2,
                         const uint8_t* __restrict__ packed,
                         const int* __restrict__ rlens, int max_len, int cap,
                         Occ3Consts k, Out o) {
  scan3_groups<ROUTED_GROUP>(src, c3_first, L2, packed, rlens, max_len, cap,
                             k, o);
}

// The x64 big-genome scan: int64 state over shard-relative rows, a lane
// group per read. The explicit least of 1 block an SM is not the default:
// ptxas then takes 93 registers, without it 77, and the kernel ran 0.187
// ms against 0.247 on a shard's 16,384 reads (PERF.md, seed_scan_variants.py
// Mb0).
__global__ void __launch_bounds__(THREADS, 1)
seed_scan3_big_kernel(ShardRows64 src, const long long* __restrict__ c3_first,
                      const long long* __restrict__ L2,
                      const uint8_t* __restrict__ packed,
                      const int* __restrict__ rlens, int max_len, int cap,
                      Occ3ConstsT<long long> k, Out o) {
  scan3_groups<BIG_GROUP>(src, c3_first, L2, packed, rlens, max_len, cap, k,
                          o);
}

__global__ void __launch_bounds__(THREADS)
seed_scan1_kernel(const int* __restrict__ occ,
                  const long long* __restrict__ L2,
                  const uint8_t* __restrict__ codes,
                  const int* __restrict__ rlens, int has_n, int max_len,
                  int cap, int primary, Out o) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= o.B) return;
  // has_n: byte codes uint8[B, max_len]; else 2-bit packed [B, max_len/4]
  const uint8_t* row = codes + (size_t)r * (has_n ? max_len : max_len >> 2);
  const int rlen = rlens[r];
  const int last = max_len - 1;
  int pos = 0, start = 0, ext_pos = 0, x0 = 0, x1 = 0, x2 = 0, ns = 0;
  bool in_ext = false, ovf = false;
  int it = 0, g = 0;
  for (; it < cap; ++it) {
    if (!in_ext) {
      if (pos >= rlen - MIN_SEED_LEN) break;         // done
      const int p = min(pos, last);
      const int c = has_n ? (int)__ldg(row + p)
                          : (int)((__ldg(row + (p >> 2)) >> ((p & 3) * 2)) & 3);
      if (c > 3) {                                     // N: skip as a start
        pos += 1;
        continue;
      }
      x0 = l2(L2, c) + 1;
      x1 = l2(L2, 3 - c) + 1;
      x2 = l2(L2, c + 1) - l2(L2, c);
      start = pos;
      ext_pos = pos + 1;
      in_ext = true;
      continue;
    }
    const int p = min(ext_pos, last);
    const int ce = has_n ? (int)__ldg(row + p)
                         : (int)((__ldg(row + (p >> 2)) >> ((p & 3) * 2)) & 3);
    if (ext_pos < rlen && ce <= 3) {
      int k0, k1, k2, k3, l0, l1, l2v, l3;
      occ4(occ, primary, x1 - 1, k0, k1, k2, k3);
      occ4(occ, primary, x1 - 1 + x2, l0, l1, l2v, l3);
      g += 2;
      const int ci = 3 - ce;
      const int o1 = l1 - k1, o2 = l2v - k2, o3 = l3 - k3;
      const int n2 = pick4(l0 - k0, o1, o2, o3, ci);
      if (n2 != 0) {
        const int adj = (x1 <= primary && x1 + x2 - 1 >= primary) ? 1 : 0;
        x0 = x0 + adj + (ci < 3 ? o3 : 0) + (ci < 2 ? o2 : 0) + (ci < 1 ? o1 : 0);
        x1 = l2(L2, ci) + 1 + pick4(k0, k1, k2, k3, ci);
        x2 = n2;
        ext_pos += 1;
        continue;
      }
    }
    finalize(o, r, start, ext_pos, x0, x2, ns, ovf);
    pos = ext_pos + 1;
    in_ext = false;
  }
  store(o, r, ns, ovf, it, g);
}

bool shape_ok(int B, int max_len, int S, int cap) {
  return B > 0 && max_len >= 16 && max_len % 16 == 0 && S >= 1 && cap >= 0;
}

}  // namespace

// occ3 scan. rows int32[nrows, 72] (16-byte aligned), c3_first int32[64],
// L2 int64[5], packed uint8[B, max_len/4] (4-byte aligned rows), rlens
// int32[B]; lanes in [1, B) streams the reads through `lanes` threads
// from the zeroed int32 counter `next`, else one thread per read.
// Outputs: n_seeds int64[B], tab int64[4, B, S] (rpos, len, x0, freq),
// overflow uint8[B], iters and rows int32[B]. pfx_base 0 turns the fused
// prefix skip off. Launches on `stream`; returns cudaGetLastError().
extern "C" int mc_seed_scan3(const void* rows, const void* c3_first,
                             const void* L2, const void* packed,
                             const void* rlens, int B, int lanes, int max_len,
                             int S, int cap, int primary, int row_p1,
                             int row_p2, int t0, int t1, int tail1,
                             int tail2a, int tail2b, int pfx_base, int pfx_k,
                             void* next, void* n_seeds, void* tab,
                             void* overflow, void* iters, void* rows_out,
                             void* stream) {
  if (!shape_ok(B, max_len, S, cap) || pfx_k < 0 || pfx_k > 15 ||
      (pfx_base > 0 && pfx_k < 2))
    return (int)cudaErrorInvalidValue;
  const Occ3Consts k{primary, row_p1, row_p2, t0, t1, tail1, tail2a, tail2b,
                     pfx_base, pfx_k};
  const Out o{(long long*)n_seeds, (long long*)tab, (uint8_t*)overflow,
              (int*)iters, (int*)rows_out, B, S};
  const int threads = lanes > 0 && lanes < B ? lanes : B;
  const int blocks = (threads + THREADS - 1) / THREADS;
  seed_scan3_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)c3_first, (const long long*)L2,
      (const uint8_t*)packed, (const int*)rlens, threads, max_len, cap, k, o,
      (int*)next);
  return (int)cudaGetLastError();
}

// occ3 scan over shards: shard_ptrs int64[n] (the shards' base addresses,
// each int32[per, 72] and 16-byte aligned, readable from this device),
// per > 0 rows a shard; the other inputs and the outputs as
// mc_seed_scan3's, with no prefix skip and ROUTED_GROUP lanes a read.
extern "C" int mc_seed_scan3_routed(const void* shard_ptrs, int per,
                                    const void* c3_first, const void* L2,
                                    const void* packed, const void* rlens,
                                    int B, int max_len, int S, int cap,
                                    int primary, int row_p1, int row_p2,
                                    int t0, int t1, int tail1, int tail2a,
                                    int tail2b, void* n_seeds, void* tab,
                                    void* overflow, void* iters,
                                    void* rows_out, void* stream) {
  if (!shape_ok(B, max_len, S, cap) || shard_ptrs == nullptr || per < 1)
    return (int)cudaErrorInvalidValue;
  const Occ3Consts k{primary, row_p1, row_p2, t0, t1, tail1, tail2a, tail2b,
                     0, 0};
  const Out o{(long long*)n_seeds, (long long*)tab, (uint8_t*)overflow,
              (int*)iters, (int*)rows_out, B, S};
  const ShardRows src{(const unsigned long long*)shard_ptrs, (unsigned)per};
  seed_scan3_routed_kernel<<<group_blocks(B, ROUTED_GROUP), THREADS, 0,
                             (cudaStream_t)stream>>>(
      src, (const int*)c3_first, (const long long*)L2,
      (const uint8_t*)packed, (const int*)rlens, max_len, cap, k, o);
  return (int)cudaGetLastError();
}

// The x64 big-genome occ3 scan (big_x64 under -shards N): shard_ptrs
// int64[n] as mc_seed_scan3_routed's, each shard int32[per, 72] of counts
// relative to the shard, base3x int64[n, 136] each shard's base table
// (16-byte aligned): its counts at its first row (0-63), for w in 0..64
// their sum over the d with rev3(d) < w (64-128), and their sums by last
// base d & 3 (132-135); c3_first int64[64], L2 int64[5]; primary,
// row_p1 and row_p2 int64. The interval state and the row indices are
// int64, so a text may pass 2^31 rows; the seed table is int64 as before.
// Other inputs and the outputs as mc_seed_scan3_routed's.
extern "C" int mc_seed_scan3_big(const void* shard_ptrs, long long per,
                                 const void* base3x, const void* c3_first,
                                 const void* L2, const void* packed,
                                 const void* rlens, int B, int max_len, int S,
                                 int cap, long long primary, long long row_p1,
                                 long long row_p2, int t0, int t1, int tail1,
                                 int tail2a, int tail2b, void* n_seeds,
                                 void* tab, void* overflow, void* iters,
                                 void* rows_out, void* stream) {
  if (!shape_ok(B, max_len, S, cap) || shard_ptrs == nullptr ||
      base3x == nullptr || per < 1)
    return (int)cudaErrorInvalidValue;
  const Occ3ConstsT<long long> k{primary, row_p1, row_p2, t0, t1, tail1,
                                 tail2a, tail2b, 0, 0};
  const Out o{(long long*)n_seeds, (long long*)tab, (uint8_t*)overflow,
              (int*)iters, (int*)rows_out, B, S};
  const ShardRows64 src{(const unsigned long long*)shard_ptrs,
                        (const long long*)base3x, (unsigned long long)per,
                        1.0 / (double)per};
  seed_scan3_big_kernel<<<group_blocks(B, BIG_GROUP), THREADS, 0,
                          (cudaStream_t)stream>>>(
      src, (const long long*)c3_first, (const long long*)L2,
      (const uint8_t*)packed, (const int*)rlens, max_len, cap, k, o);
  return (int)cudaGetLastError();
}

// Let device `dev` read device `peer`'s memory (the routed kernels read
// shards on other cards). Returns cudaSuccess when it already could, and
// cudaErrorPeerAccessUnsupported where the pair cannot reach each other.
extern "C" int mc_enable_peer_access(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    (void)cudaGetLastError();           // clear the reported error
    e = cudaSuccess;
  }
  const cudaError_t r = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : r);
}

// 1-step scan. occ int32[nw+1, 8] (16-byte aligned), L2 int64[5]; codes
// uint8[B, max_len] byte codes with N = 4 when has_n, else uint8[B,
// max_len/4] 2-bit packed; rlens int32[B]. Outputs as mc_seed_scan3.
extern "C" int mc_seed_scan1(const void* occ, const void* L2,
                             const void* codes, const void* rlens, int B,
                             int has_n, int max_len, int S, int cap,
                             int primary, void* n_seeds, void* tab,
                             void* overflow, void* iters, void* rows_out,
                             void* stream) {
  if (!shape_ok(B, max_len, S, cap)) return (int)cudaErrorInvalidValue;
  const Out o{(long long*)n_seeds, (long long*)tab, (uint8_t*)overflow,
              (int*)iters, (int*)rows_out, B, S};
  seed_scan1_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int*)occ, (const long long*)L2, (const uint8_t*)codes,
      (const int*)rlens, has_n, max_len, cap, primary, o);
  return (int)cudaGetLastError();
}
