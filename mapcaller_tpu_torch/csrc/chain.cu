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
// folded at fm_search.py:777-794) and the pack (fm_search.py:749-771).
// Four kernels, launched in this order on one stream:
//
//   chain_scan_kernel      one block of 1,024 threads: the exclusive prefix
//     sum of a per-read count and the total, out[B] (twice a batch: each
//     read's raw hits = the sum of its valid seeds' freq, then each read's
//     SLOW kept hits).
//   chain_hits_kernel      a thread per hit slot h < H: the read that owns
//     h (a binary search of the first scan), its seed (a walk of the read's
//     <= S seeds) and the SA row x0 + rank; the text position from the full
//     SA, or by walking inverse-Psi over the occ4 rows until the row is a
//     multiple of 32 (at most max_walk steps; a hit still unresolved flags
//     its read). Slots at or past min(total, H) hold the last seed slot's
//     values with valid 0, as jnp.repeat pads.
//   chain_classify_kernel  a thread per read over its own hit range (hits
//     are grouped by read): the first 8 kept hits in a stably sorted
//     window, the read's words in bwa crumb order from the packed batch,
//     the mismatch and coverage masks as 32-position bitmasks walked chunk
//     by chunk (the gaps as runs of uncovered bits), then the class, pd,
//     mm, rplast, cscore and the leftmost 4 mismatches; with planes, the
//     FAST reads' evidence as int32 atomicAdds (integer adds commute, so
//     the planes equal the plain scatter's exactly).
//   chain_pack_kernel      a thread per read: its SLOW kept hits at its
//     offset from the second scan (slots >= H2 dropped, the rest of the
//     H2 slots zeroed), the count words, the overflow words by warp ballot,
//     the total and the buffer-overflow flag, straight into the int32
//     output vector.
//
// Bound on an H100 SXM (HBM3, 3.35 TB/s): bytes, for all four. The work a
// byte asks for is a few integer operations (a binary search of 15 steps,
// a popcount step of ~20 operations per 32-byte occ4 row, ~60 per 16 read
// bases), far below the 16.7 T int32 operations/s that would take longer
// than the bytes. chip_smoke.py counts each kernel's bytes from the run's
// own inputs (each input read once, each output written once, one SA entry
// or occ4 row per gather). The design keeps every per-hit and per-read
// intermediate of the XLA program (the K-slot windows, the [B, max_len]
// masks, the gap indices, the scattered index arrays) in registers: the
// sort is an unrolled stable insertion, the masks are one 32-bit word of
// positions at a time, so no thread has an array that needs a stack frame.
// The scan is one block because a batch's counts are at most a few hundred
// KB: simple before fast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_HITS = 8;               // per-read hit window
constexpr int MAX_GAPS = 10;
constexpr int MM_SLOTS = 4;
constexpr int CLASS_NOCAND = 0, CLASS_FAST = 1, CLASS_SLOW = 2;
constexpr int PD_EMPTY = 0x7FFFFFFF;    // INT32_MAX: an empty window slot
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 8;           // consecutive reads a scan thread sums
constexpr int THREADS = 256;
constexpr int CLASSIFY_THREADS = 128;

// ---- chain_scan_kernel ---------------------------------------------------

// Read b's count: with freq, the sum of its first min(n[b], S) entries
// (n == nullptr: all S); else cnt[b].
__device__ __forceinline__ int read_count(const long long* __restrict__ freq,
                                          const long long* __restrict__ n,
                                          const int* __restrict__ cnt, int S,
                                          int b) {
  if (freq == nullptr) return cnt[b];
  const long long nv = n == nullptr ? S : n[b];
  const int m = nv < 0 ? 0 : (nv > S ? S : (int)nv);
  int s = 0;
  for (int j = 0; j < m; ++j) s += (int)freq[(size_t)b * S + j];
  return s;
}

__global__ void __launch_bounds__(SCAN_THREADS)
chain_scan_kernel(const long long* __restrict__ freq,
                  const long long* __restrict__ n,
                  const int* __restrict__ cnt, int B, int S,
                  int* __restrict__ out) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  __shared__ int carry_s;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) carry_s = 0;
  __syncthreads();
  for (int base = 0; base < B; base += SCAN_THREADS * SCAN_ITEMS) {
    const int first = base + t * SCAN_ITEMS;
    int v[SCAN_ITEMS];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      v[k] = first + k < B ? read_count(freq, n, cnt, S, first + k) : 0;
      mine += v[k];
    }
    // inclusive scan of the threads' sums: in the warp, then over warps
    int inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) warp_sum[w] = inc;
    __syncthreads();
    if (w == 0) {
      int ws = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, ws, d);
        if (lane >= d) ws += y;
      }
      warp_sum[lane] = ws;                    // inclusive over warps
    }
    __syncthreads();
    const int carry = carry_s;
    int run = carry + (w > 0 ? warp_sum[w - 1] : 0) + inc - mine;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (first + k < B) out[first + k] = run;
      run += v[k];
    }
    __syncthreads();                          // every thread has read carry
    if (t == SCAN_THREADS - 1) carry_s = run;  // the last thread ends the tile
    __syncthreads();
  }
  if (t == 0) out[B] = carry_s;
}

// ---- chain_hits_kernel ---------------------------------------------------

struct Fm {
  const int* occ;                       // int32[nw+1, 8] occ4 rows
  const long long* L2;                  // int64[5]
  const long long* sa_samp;             // int64[n/32+1]
  const int* sa_full;                   // int32[n+1], or nullptr
  int primary, max_walk;
};

struct Seeds {
  const long long *n, *rpos, *len, *x0, *freq;   // [B], [B, S] x4
  int B, S;
};

struct Hits {
  int *read, *rpos, *len, *loc;         // int32[H]
  uint8_t *valid, *keep;                // [H] (torch.bool)
  uint8_t* unresolved;                  // [B], zeroed before the launch
};

__device__ __forceinline__ int pick4(const int4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// One LF step (ref: bwt_search.cpp:101-107; ops/fm_device.py::inv_psi):
// one 32-byte row gives both the BWT code at k and its occ count.
__device__ __forceinline__ int inv_psi(const Fm& fm, int k) {
  const int kadj = k - (k >= fm.primary ? 1 : 0);
  const int4* row =
      reinterpret_cast<const int4*>(fm.occ + (size_t)(kadj >> 4) * 8);
  const int4 cnt = __ldg(row), wv = __ldg(row + 1);
  const uint32_t word = (uint32_t)wv.x;
  const int crumb = (~kadj) & 15;
  const int c = (int)((word >> (crumb << 1)) & 3u);
  const uint32_t keep = ~((1u << (2 * crumb)) - 1u) & 0x55555555u;
  const uint32_t nx = ~(word ^ ((uint32_t)c * 0x55555555u));
  const int occ_kc = pick4(cnt, c) + __popc(nx & (nx >> 1) & keep);
  return k == fm.primary ? 0 : (int)__ldg(fm.L2 + c) + occ_kc;
}

__global__ void __launch_bounds__(THREADS)
chain_hits_kernel(const int* __restrict__ off, Seeds sd, Fm fm, int H,
                  Hits o) {
  const int h = blockIdx.x * THREADS + threadIdx.x;
  if (h >= H) return;
  const int B = sd.B, S = sd.S;
  const int total = off[B];
  const bool valid = h < min(total, H);
  int b = B - 1, s = S - 1, row = 32;
  if (valid) {
    // the last read with off[b] <= h (off[B] = total > h)
    int lo = 0, hi = B;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= h) lo = mid; else hi = mid - 1;
    }
    b = lo;
    int pos = h - off[b];
    const long long nv = sd.n[b];
    const int m = nv < 0 ? 0 : (nv > S ? S : (int)nv);
    for (s = 0; s < m; ++s) {
      const int f = (int)sd.freq[(size_t)b * S + s];
      if (pos < f) break;
      pos -= f;
    }
    row = (int)sd.x0[(size_t)b * S + s] + pos;
  }
  const size_t bs = (size_t)b * S + s;
  const int rpos = (int)sd.rpos[bs], len = (int)sd.len[bs];
  int loc;
  bool resolved = valid;
  if (fm.sa_full != nullptr) {
    loc = __ldg(fm.sa_full + row);
  } else {
    // an inactive slot walks no step: sa_samp[32 >> 5]
    int k = row, steps = 0;
    if (valid)
      while (steps < fm.max_walk && (k & 31)) {
        k = inv_psi(fm, k);
        ++steps;
      }
    resolved = valid && (k & 31) == 0;
    loc = steps + (int)__ldg(fm.sa_samp + (k >> 5));
  }
  o.read[h] = b;
  o.rpos[h] = rpos;
  o.len[h] = len;
  o.loc[h] = loc;
  o.valid[h] = valid;
  o.keep[h] = valid && loc - rpos > 0;
  if (valid && !resolved) o.unresolved[b] = 1;
}

// ---- chain_classify_kernel -----------------------------------------------

struct Ctx {
  const long long* text;                // packed 2-bit text, bwa order,
                                        // 32 bits a word in int64
  const long long* bkeys;               // sorted chromosome ends
  int ntext, nkeys, seq_len;
};

struct Planes {
  int *exact, *fd, *acgt;               // int32[L+2], [4(L+2)], [4(L+1)]
  int L, pair_end;                      // exact == nullptr: no apply
};

struct ClsOut {
  int* meta;                            // [B]: packed output's meta1
  int* pd;                              // [B]: packed output's pd
  int* mmp;                             // [B, MM_SLOTS]
  int* slow_kept;                       // [B]: kept hits of SLOW reads
};

// (a_pd, a_rp) after (b_pd, b_rp): _sort_slots' swap test.
__device__ __forceinline__ bool after(int a_pd, int a_rp, int b_pd, int b_rp) {
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

// Lower bound of v in the sorted keys (torch.searchsorted, side left).
__device__ __forceinline__ int lower_bound(const long long* __restrict__ k,
                                           int n, long long v) {
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

__global__ void __launch_bounds__(CLASSIFY_THREADS)
chain_classify_kernel(const int* __restrict__ off, int H,
                      const int* __restrict__ hit_rpos,
                      const int* __restrict__ hit_len,
                      const int* __restrict__ hit_loc,
                      const uint8_t* __restrict__ keep,
                      const uint8_t* __restrict__ unresolved,
                      const uint32_t* __restrict__ packed,
                      const int* __restrict__ rlens, int B, int max_len,
                      Ctx cx, Planes pl, ClsOut o) {
  const int b = blockIdx.x * CLASSIFY_THREADS + threadIdx.x;
  if (b >= B) return;
  const int rlen = rlens[b];
  // ---- the first K_HITS kept hits, stably sorted by (pd, rpos) --------
  int spd[K_HITS], srp[K_HITS], sln[K_HITS];
#pragma unroll
  for (int i = 0; i < K_HITS; ++i) {
    spd[i] = PD_EMPTY;
    srp[i] = 0;
    sln[i] = 0;
  }
  int nkept = 0;
  const int h1 = min(off[b + 1], H);
  for (int h = off[b]; h < h1; ++h) {
    if (!keep[h]) continue;
    if (nkept < K_HITS) {
      const int e_rp = hit_rpos[h], e_ln = hit_len[h];
      const int e_pd = hit_loc[h] - e_rp;
      // insert after every slot that does not come after it (stable);
      // the window has a free slot, so slot K_HITS-1 holds no hit
      bool placed = false;
#pragma unroll
      for (int i = K_HITS - 1; i >= 0; --i) {
        if (placed) continue;
        if (i > 0 && after(spd[i - 1], srp[i - 1], e_pd, e_rp)) {
          spd[i] = spd[i - 1];
          srp[i] = srp[i - 1];
          sln[i] = sln[i - 1];
        } else {
          spd[i] = e_pd;
          srp[i] = e_rp;
          sln[i] = e_ln;
          placed = true;
        }
      }
    }
    ++nkept;
  }
  const bool has_hits = nkept > 0, too_many = nkept > K_HITS;
  const int pd0 = spd[0];
  bool one_diag = true;
  int cscore = 0, seed_end = 0, seed_last_rp = -1;
#pragma unroll
  for (int i = 0; i < K_HITS; ++i) {
    const bool valid = spd[i] != PD_EMPTY, same = spd[i] == pd0;
    if (valid && !same) one_diag = false;
    if (valid) cscore += sln[i];
    if (valid && same) {
      seed_end = max(seed_end, srp[i] + sln[i]);
      seed_last_rp = max(seed_last_rp, srp[i]);
    }
    if (!same) sln[i] = 0;            // covers nothing: off the diagonal
  }
  const bool has_can = cscore > (rlen >> 2);
  // ---- the span [pd, pd + rlen) inside one chromosome ------------------
  const long long pd_end = (long long)pd0 + rlen;
  const long long last = cx.seq_len - 1;
  const long long p1 = min(max((long long)pd0, 0LL), last);
  const long long p2 = min(max(pd_end - 1, 0LL), last);
  const bool span_ok = pd_end <= cx.seq_len &&
                       lower_bound(cx.bkeys, cx.nkeys, p1) ==
                           lower_bound(cx.bkeys, cx.nkeys, p2);
  // ---- masks along the diagonal, 32 read positions at a time ------------
  const int pds = span_ok && has_hits ? pd0 : 0;
  const int sh = (pds & 15) * 2, wbase = pds >> 4;
  const int nwords = max_len >> 4;
  const int lim = min(rlen, max_len);
  const uint32_t* rw = packed + (size_t)b * nwords;
  int mm_total = 0, nmm = 0, m0 = -1, m1 = -1, m2 = -1, m3 = -1;
  int g = -1, lg = 0, mg = 0;           // open gap: index, length, mismatches
  bool open = false, dp_any = false;
  for (int c = 0; 32 * c < max_len; ++c) {
    uint32_t mm = 0, rw0 = 0, rw1 = 0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int wi = 2 * c + q;
      if (wi >= nwords) continue;
      const uint32_t r = to_bwa(rw[wi]);
      const uint32_t t0 =
          (uint32_t)cx.text[min(max(wbase + wi, 0), cx.ntext - 1)];
      const uint32_t t1 =
          (uint32_t)cx.text[min(max(wbase + wi + 1, 0), cx.ntext - 1)];
      const uint32_t al = (t0 << sh) | (sh > 0 ? t1 >> (32 - sh) : 0u);
      mm |= mismatch16(al, r) << (16 * q);
      if (q == 0) rw0 = r; else rw1 = r;
    }
    const uint32_t inlen = span_bits(0, lim - 32 * c);
    mm &= inlen;
    uint32_t cov = 0;
#pragma unroll
    for (int i = 0; i < K_HITS; ++i)
      cov |= span_bits(srp[i] - 32 * c, srp[i] + sln[i] - 32 * c);
    const uint32_t unc = ~cov & inlen;
    mm_total += __popc(mm & unc);
    // the leftmost MM_SLOTS mismatches of the whole read
    for (uint32_t bits = mm; bits != 0u && nmm < MM_SLOTS; bits &= bits - 1u) {
      const int p = __ffs(bits) - 1, j = 32 * c + p;
      const uint32_t word = p < 16 ? rw0 : rw1;
      const int v = (j << 2) | (int)((word >> ((15 - (j & 15)) * 2)) & 3u);
      if (nmm == 0) m0 = v; else if (nmm == 1) m1 = v;
      else if (nmm == 2) m2 = v; else m3 = v;
      ++nmm;
    }
    // gaps: runs of uncovered in-length positions; a run at bit 0
    // continues the gap open at the end of the chunk before
    for (uint32_t bits = unc; bits != 0u;) {
      const int a = __ffs(bits) - 1;
      const uint32_t rest = ~(bits >> a);
      const int len = rest ? __ffs(rest) - 1 : 32 - a;
      const uint32_t run = (len >= 32 ? 0xFFFFFFFFu : ((1u << len) - 1u)) << a;
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
  const bool fast = has_hits && !too_many && one_diag && has_can && span_ok &&
                    !dp_any && !many_gaps && mm_total <= MM_SLOTS;
  const bool nocand = !has_hits || (!too_many && one_diag && !has_can);
  int cls = fast ? CLASS_FAST : (nocand ? CLASS_NOCAND : CLASS_SLOW);
  if (unresolved[b]) cls = CLASS_SLOW;   // the host oracle seeds this read
  const int rplast =
      min(max(seed_end < rlen ? seed_end : seed_last_rp, 0), 511);
  o.meta[b] = (int)((uint32_t)cls | ((uint32_t)mm_total << 2) |
                    ((uint32_t)rplast << 8) |
                    ((uint32_t)min(cscore, 511) << 17));
  o.pd[b] = pd0;
  int* mp = o.mmp + (size_t)b * MM_SLOTS;
  mp[0] = m0;
  mp[1] = m1;
  mp[2] = m2;
  mp[3] = m3;
  o.slow_kept[b] = cls == CLASS_SLOW ? nkept : 0;
  if (pl.exact == nullptr || cls != CLASS_FAST) return;
  // ---- the speculative evidence apply (ops/evidence.py) ----------------
  const long long L = pl.L, two_l = cx.seq_len, pd = pd0;
  const bool ori = pd < L;
  const long long gs = min(max(ori ? pd : two_l - pd - rlen, 0LL), L - 1);
  const long long end = min(gs + rlen, L);
  const bool first = !pl.pair_end || (b & 1) == 0;
  const long long fo = (first ? (ori ? 0 : 3) : (ori ? 1 : 2)) * (L + 2);
  atomicAdd(pl.exact + gs, 1);
  atomicAdd(pl.exact + end, -1);
  atomicAdd(pl.fd + fo + gs, 1);
  atomicAdd(pl.fd + fo + end, -1);
#pragma unroll
  for (int k = 0; k < MM_SLOTS; ++k) {
    const int e = k == 0 ? m0 : (k == 1 ? m1 : (k == 2 ? m2 : m3));
    if (e < 0) continue;
    const long long at = pd + (e >> 2);
    const long long p = min(max(ori ? at : two_l - 1 - at, 0LL), L - 1);
    const int base = ori ? (e & 3) : 3 - (e & 3);
    atomicAdd(pl.exact + p, -1);
    atomicAdd(pl.exact + p + 1, 1);
    atomicAdd(pl.acgt + base * (L + 1) + p, 1);
  }
}

// ---- chain_pack_kernel ---------------------------------------------------

__global__ void __launch_bounds__(THREADS)
chain_pack_kernel(const int* __restrict__ off, const int* __restrict__ off2,
                  const int* __restrict__ hit_rpos,
                  const int* __restrict__ hit_len,
                  const int* __restrict__ hit_loc,
                  const uint8_t* __restrict__ keep,
                  const int* __restrict__ slow_kept,
                  const uint8_t* __restrict__ overflow,
                  const uint8_t* __restrict__ unresolved, int B, int H,
                  int H2, int* __restrict__ out) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  int* hit_w = out + 2 * B;
  int* hit_l = hit_w + H2;
  int* counts2 = hit_l + H2;
  int* ovf_bits = counts2 + B / 2;
  const int total_kept = off2[B];
  // slots no read fills
  for (int s = max(total_kept, 0) + t; s < H2; s += gridDim.x * THREADS)
    hit_w[s] = hit_l[s] = 0;
  if (t == 0) {
    ovf_bits[B / 32] = total_kept;
    ovf_bits[B / 32 + 1] = off[B] > H || total_kept > H2;
  }
  if (t >= B) return;                   // whole warps: B % 32 == 0
  const int b = t;
  const int n = slow_kept[b];           // 0 unless the read is SLOW
  if (n > 0) {
    int slot = off2[b];
    const int h1 = min(off[b + 1], H);
    for (int h = off[b]; h < h1 && slot < H2; ++h) {
      if (!keep[h]) continue;
      hit_w[slot] = (hit_rpos[h] << 9) | hit_len[h];
      hit_l[slot] = hit_loc[h];
      ++slot;
    }
  }
  const int n_next = __shfl_down_sync(0xFFFFFFFFu, n, 1);
  if ((b & 1) == 0)
    counts2[b >> 1] = (int)(((uint32_t)n & 0xFFFFu) | ((uint32_t)n_next << 16));
  const uint32_t w = __ballot_sync(0xFFFFFFFFu, overflow[b] || unresolved[b]);
  if ((b & 31) == 0) ovf_bits[b >> 5] = (int)w;
}

}  // namespace

// Exclusive prefix sum of per-read counts into out int32[B+1] (out[B] =
// total): with freq int64[B, S] each read's sum of its first min(n[b], S)
// entries (n int64[B], or nullptr for all S), else cnt int32[B].
extern "C" int mc_chain_scan(const void* freq, const void* n, const void* cnt,
                             int B, int S, void* out, void* stream) {
  if (B < 1 || S < 1 || (freq == nullptr) == (cnt == nullptr))
    return (int)cudaErrorInvalidValue;
  chain_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)freq, (const long long*)n, (const int*)cnt, B, S,
      (int*)out);
  return (int)cudaGetLastError();
}

// Hit expansion and SA resolve. off int32[B+1] (mc_chain_scan of the seed
// freqs); seed tables n_seeds int64[B], rpos/len/x0/freq int64[B, S]; occ
// int32[nw+1, 8] (16-byte aligned), L2 int64[5], sa_samp int64[], sa_full
// int32[n+1] or nullptr (then the inverse-Psi walk of max_walk steps).
// Outputs: read/rpos/len/loc int32[H], valid/keep uint8[H], unresolved
// uint8[B] (zeroed here, on the stream, before the launch).
extern "C" int mc_chain_hits(const void* off, const void* n_seeds,
                             const void* rpos, const void* len, const void* x0,
                             const void* freq, int B, int S, const void* occ,
                             const void* L2, const void* sa_samp,
                             const void* sa_full, int primary, int max_walk,
                             int H, void* read, void* hrpos, void* hlen,
                             void* loc, void* valid, void* keep,
                             void* unresolved, void* stream) {
  if (B < 1 || S < 1 || H < 1 || max_walk < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(unresolved, 0, (size_t)B,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const Seeds sd{(const long long*)n_seeds, (const long long*)rpos,
                 (const long long*)len, (const long long*)x0,
                 (const long long*)freq, B, S};
  const Fm fm{(const int*)occ, (const long long*)L2,
              (const long long*)sa_samp, (const int*)sa_full, primary,
              max_walk};
  const Hits o{(int*)read, (int*)hrpos, (int*)hlen, (int*)loc,
               (uint8_t*)valid, (uint8_t*)keep, (uint8_t*)unresolved};
  chain_hits_kernel<<<(H + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>((const int*)off, sd, fm, H, o);
  return (int)cudaGetLastError();
}

// Classification of each read from its hit range. packed uint8[B,
// max_len/4] (4-byte aligned, read as max_len/16 words a read), rlens
// int32[B], text int64[ntext] (a 32-bit word in each), bkeys int64[nkeys].
// Outputs: meta, pd int32[B] (the packed output vector's first 2B
// entries), mmp int32[B, 4], slow_kept int32[B]. exact/fd/acgt nullptr:
// no evidence apply; else the
// int32 planes of genome size L, pair_end picking the orientation plane by
// batch-index parity.
extern "C" int mc_chain_classify(const void* off, int H, const void* hrpos,
                                 const void* hlen, const void* loc,
                                 const void* keep, const void* unresolved,
                                 const void* packed, const void* rlens, int B,
                                 int max_len, const void* text, int ntext,
                                 const void* bkeys, int nkeys, int seq_len,
                                 void* exact, void* fd, void* acgt, int L,
                                 int pair_end, void* meta, void* pd, void* mmp,
                                 void* slow_kept, void* stream) {
  if (B < 1 || H < 1 || max_len < 16 || max_len % 16 || max_len > 511 ||
      ntext < 1 || nkeys < 1 || seq_len < 1 ||
      (exact != nullptr && (fd == nullptr || acgt == nullptr || L < 1)))
    return (int)cudaErrorInvalidValue;
  const Ctx cx{(const long long*)text, (const long long*)bkeys, ntext, nkeys,
               seq_len};
  const Planes pl{(int*)exact, (int*)fd, (int*)acgt, L, pair_end};
  const ClsOut o{(int*)meta, (int*)pd, (int*)mmp, (int*)slow_kept};
  chain_classify_kernel<<<(B + CLASSIFY_THREADS - 1) / CLASSIFY_THREADS,
                          CLASSIFY_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)off, H, (const int*)hrpos, (const int*)hlen,
      (const int*)loc, (const uint8_t*)keep, (const uint8_t*)unresolved,
      (const uint32_t*)packed, (const int*)rlens, B, max_len, cx, pl, o);
  return (int)cudaGetLastError();
}

// The packed output vector's entries from 2B on: hit_w[H2], hit_loc[H2],
// counts2[B/2], ovf_bits[B/32], total_kept, buffer_overflow. off, off2
// int32[B+1] (the two scans), hits as mc_chain_hits writes them,
// slow_kept int32[B], overflow and unresolved uint8[B]; B % 32 == 0.
extern "C" int mc_chain_pack(const void* off, const void* off2,
                             const void* hrpos, const void* hlen,
                             const void* loc, const void* keep,
                             const void* slow_kept, const void* overflow,
                             const void* unresolved, int B, int H, int H2,
                             void* out, void* stream) {
  if (B < 32 || B % 32 || H < 1 || H2 < 1) return (int)cudaErrorInvalidValue;
  const int threads = B > H2 ? B : H2;
  chain_pack_kernel<<<(threads + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int*)off, (const int*)off2, (const int*)hrpos, (const int*)hlen,
      (const int*)loc, (const uint8_t*)keep, (const int*)slow_kept,
      (const uint8_t*)overflow, (const uint8_t*)unresolved, B, H, H2,
      (int*)out);
  return (int)cudaGetLastError();
}
