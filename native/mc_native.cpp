// MapCaller-TPU native runtime: post-seeding chunk processing.
//
// Port of the validated Python host pipeline (pipeline/chaining.py,
// pairing.py, rescue.py, alignment.py, profile.py, io/sam.py) to C++,
// which itself mirrors the reference's semantics
// (ref: src/ReadMapping.cpp, ReadAlignment.cpp, AlignmentRescue.cpp,
// KmerAnalysis.cpp, AlignmentProfile.cpp, SamReport.cpp,
// nw_alignment.cpp, ksw2_alignment.cpp). Device kernels (JAX) feed this
// module flat seed arrays; it returns SAM text, updates the PFM planes
// in place, and emits indel/breakpoint/discord events for the caller.
//
// Build: g++ -O3 -fPIC -shared -o libmc_native.so mc_native.cpp
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <map>
#include <string>
#include <vector>

using std::string;
using std::vector;

typedef int64_t i64;
typedef int32_t i32;

// ---------------------------------------------------------------------------
// context
// ---------------------------------------------------------------------------
struct Chrom {
  string name;
  i64 len;
  i64 fwd_loc;
};

// optional stage timing, switched with mc_prof_enable (the port turns it
// on under MC_STAGE_PROF=1): accumulated ns per stage; off, no clock is
// read and no counter written
static bool g_prof_on = false;
static i64 g_prof_ns[8] = {0};  // build_read, pair, align, profile, sam, span, spare, reads
static inline i64 now_ns() {
  if (!g_prof_on) return 0;
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (i64)ts.tv_sec * 1000000000 + ts.tv_nsec;
}
static inline void prof_add(int k, i64 v) {
  if (g_prof_on) g_prof_ns[k] += v;
}
extern "C" void mc_prof_fetch(i64* out8) {
  for (int i = 0; i < 8; i++) { out8[i] = g_prof_ns[i]; g_prof_ns[i] = 0; }
}
extern "C" void mc_prof_enable(i32 on) {
  g_prof_on = on != 0;
  for (int i = 0; i < 8; i++) g_prof_ns[i] = 0;
}

struct Ctx {
  const char* ref;  // RefSequence chars, length two_l (borrowed from numpy)
  i64 L;            // genome size
  i64 two_l;
  vector<i64> bkeys;     // sorted boundary keys (chrom end positions)
  vector<i32> bchrom;    // owning chrom per key
  vector<Chrom> chroms;
  // profile planes (borrowed numpy buffers), length L each
  i32* acgt[4] = {nullptr, nullptr, nullptr, nullptr};
  i32* multi_hit = nullptr;
  i32* read_count = nullptr;
  i32* F1 = nullptr; i32* R2 = nullptr; i32* F2 = nullptr; i32* R1 = nullptr;
  // config
  i32 max_pos_diff = 30;
  double max_mismatch_rate = 0.05;
  i32 max_clip_size = 5;
  i32 max_duplicate = 5;
  bool use_nw = true;
  bool unique_only = true;
  bool vcf_output = true;
  bool sam_output = false;
  bool fastq = true;
  // persistent DiscordPair state (mirrors ReadMapping.cpp:420 reuse bug)
  i64 discord_gpos = 0;
  // device-evidence mode: instead of touching the (host) planes, emit a
  // compact op stream + per-read duplicate-gate entries; a JAX kernel
  // applies them to the HBM-resident planes with exact file-order gate
  // semantics (pipeline/device_profile.py)
  bool ops_mode = false;   // fast-read evidence applied on device
  // true once any HOST plane/diff array received evidence (slow-path
  // reads, or every read when ops_mode is off): lets the device merge
  // skip its O(L) nonzero scans when the host side stayed clean
  bool host_planes_dirty = false;
  std::vector<uint32_t> fast_bits;
  // device gapped extension: DP-pair strings collected by a dry pass,
  // aligned in one Pallas batch, consumed via this cache (bit-identical
  // to the scalar aligners, so cache hits change nothing but speed)
  std::map<std::string, std::pair<std::string, std::string>> dp_cache;
  std::vector<std::pair<std::string, std::string>> dp_pending;
  // diff mode: every exactly-matching base credits the REFERENCE base's
  // plane (an exact seed's read base equals the forward-strand ref base
  // at that position, on either strand), so matched runs become +1/-1
  // endpoints on exact_diff and only mismatch bases (<1/read) are point
  // adds into the acgt planes. F1/R2/F2/R1 and multi_hit likewise become
  // diff arrays (i32[L+1]) cumsum'd once at finalize. Cap-at-end ==
  // cap-per-increment for pure +1 streams, so saturation is exact.
  bool emit_segments = false;
  i32* f_diff[4] = {nullptr, nullptr, nullptr, nullptr};  // F1,R2,F2,R1
  i32* multi_diff = nullptr;
  i32* exact_diff = nullptr;
};

static unsigned char NT4[256];
static bool nt4_init = [] {
  memset(NT4, 4, 256);
  NT4['A'] = NT4['a'] = 0; NT4['C'] = NT4['c'] = 1;
  NT4['G'] = NT4['g'] = 2; NT4['T'] = NT4['t'] = 3;
  return true;
}();

static char COMP[256];
static bool comp_init = [] {
  for (int i = 0; i < 256; i++) COMP[i] = 'N';
  COMP['A'] = 'T'; COMP['a'] = 'T'; COMP['C'] = 'G'; COMP['c'] = 'G';
  COMP['G'] = 'C'; COMP['g'] = 'C'; COMP['T'] = 'A'; COMP['t'] = 'A';
  return true;
}();

// ---------------------------------------------------------------------------
// data structures (ref: structure.h:113-150)
// ---------------------------------------------------------------------------
struct FragPair {
  bool simple;
  i32 rPos;
  i64 gPos;
  i32 rLen;
  i32 gLen;
  i64 PosDiff;
  string aln1, aln2;
};

struct AlnCan {
  i32 score = 0;
  bool orientation = true;
  i32 SamFlag = 0;
  i32 paired_idx = -1;
  bool fast = false;   // device-classified diagonal-identity candidate
  vector<FragPair> frags;
};

struct Read {
  const char* seq;   // possibly revcomped storage (owned below)
  const char* qual;
  const char* header;
  i32 rlen;
  string seq_store, qual_store;
  i32 score = 0, sub_score = 0, best_idx = -1;
  vector<AlnCan> cans;
  // device fast-path classification (ops/chain_device.py): the read's
  // kept seeds all lie on diagonal fast_pd and the identity alignment
  // along it is provably what the full pipeline would produce
  i64 fast_pd = 0;
  i32 fast_mm = 0, fast_rplast = 0;
};

// ---------------------------------------------------------------------------
// genome coordinate helpers (ref: tools.cpp:112-164)
// ---------------------------------------------------------------------------
static size_t boundary_index(const Ctx& c, i64 g) {
  return std::lower_bound(c.bkeys.begin(), c.bkeys.end(), g) - c.bkeys.begin();
}

static i64 alignment_boundary(const Ctx& c, i64 g) {
  size_t i = boundary_index(c, g);
  if (i >= c.bkeys.size()) return c.bkeys.back();
  return c.bkeys[i];
}

static bool check_alignment_validity(const Ctx& c, i64 first, i64 last_end) {
  if (first < 0 || last_end > c.two_l) return false;
  size_t i1 = boundary_index(c, first);
  size_t i2 = boundary_index(c, last_end - 1);
  return i1 < c.bkeys.size() && i2 < c.bkeys.size() && c.bkeys[i1] == c.bkeys[i2];
}

struct Coor { i32 ci; i64 pos; };

static Coor determine_coordinate(const Ctx& c, i64 g) {
  Coor r;
  if (g < c.L) {
    if (c.chroms.size() == 1) { r.ci = 0; r.pos = g + 1; return r; }
    size_t i = boundary_index(c, g);
    r.ci = c.bchrom[i];
    r.pos = g + 1 - c.chroms[r.ci].fwd_loc;
  } else {
    if (c.chroms.size() == 1) { r.ci = 0; r.pos = c.two_l - g; return r; }
    size_t i = boundary_index(c, g);
    r.ci = c.bchrom[i];
    r.pos = c.bkeys[i] - g + 1;
  }
  return r;
}

// ---------------------------------------------------------------------------
// NW aligner, scaled-by-2 integers (exact vs reference float32;
// ref: nw_alignment.cpp, see ops/nw_host.py)
// ---------------------------------------------------------------------------
static const i64 MAXPEN = -131072, OPENG = -2, EXTG = -1, NEWG = -3;

static void nw_align(string& s1, string& s2) {
  int m = (int)s1.size() + 1, n = (int)s2.size() + 1;
  vector<i64> r((size_t)m * n), t((size_t)m * n), s((size_t)m * n);
  auto R = [&](int i, int j) -> i64& { return r[(size_t)i * n + j]; };
  auto T = [&](int i, int j) -> i64& { return t[(size_t)i * n + j]; };
  auto S = [&](int i, int j) -> i64& { return s[(size_t)i * n + j]; };
  R(0, 0) = T(0, 0) = S(0, 0) = 0;
  for (int i = 1; i < m; i++) { R(i, 0) = MAXPEN; S(i, 0) = T(i, 0) = OPENG + (i64)i * EXTG; }
  for (int j = 1; j < n; j++) { T(0, j) = MAXPEN; S(0, j) = R(0, j) = OPENG + (i64)j * EXTG; }
  for (int i = 1; i < m; i++) {
    unsigned char c1 = NT4[(unsigned char)s1[i - 1]];
    for (int j = 1; j < n; j++) {
      i64 rv = std::max(R(i, j - 1) + EXTG, S(i, j - 1) + NEWG);
      i64 tv = std::max(T(i - 1, j) + EXTG, S(i - 1, j) + NEWG);
      i64 d = S(i - 1, j - 1) + (c1 == NT4[(unsigned char)s2[j - 1]] ? 2 : -2);
      R(i, j) = rv; T(i, j) = tv; S(i, j) = std::max(std::max(d, rv), tv);
    }
  }
  int i = m - 1, j = n - 1;
  while (i > 0 || j > 0) {
    if (S(i, j) == R(i, j)) { s1.insert((size_t)i, 1, '-'); j--; }
    else if (S(i, j) == T(i, j)) { s2.insert((size_t)j, 1, '-'); i--; }
    else { i--; j--; }
  }
}

// ---------------------------------------------------------------------------
// ksw2 aligner (exact transliteration of ops/ksw2_host.py, which is
// fuzz-identical to the reference's ksw_extz2_sse)
// ---------------------------------------------------------------------------
static void ksw2_align(string& s1, string& s2) {
  int qlen = (int)s1.size(), tlen = (int)s2.size();
  if (qlen == 0 || tlen == 0) return;
  const int Q = 2, E = 1, QE = 3, QE2 = 6, MAXSC = 7, WILD = 4;
  int w = std::max(qlen, tlen), wl = w, wr = w;
  int tlen_ = (tlen + 15) / 16;
  int n_col = ((tlen + 15) / 16 + 1) * 16;
  int nt16 = tlen_ * 16;
  vector<int8_t> u(nt16, 0), v(nt16, 0), x(nt16, 0), y(nt16, 0), s8(nt16 + 16, 0);
  vector<uint8_t> sf(nt16 + 16, 0), qr(qlen + 16, 0);
  for (int i = 0; i < tlen; i++) sf[i] = NT4[(unsigned char)s2[i]];
  for (int i = 0; i < qlen; i++) qr[i] = NT4[(unsigned char)s1[qlen - 1 - i]];
  int n_diag = qlen + tlen - 1;
  vector<uint8_t> p((size_t)n_diag * n_col, 0);
  vector<int> off(n_diag), off_end(n_diag);
  int last_st = -1, last_en = -1;
  for (int r = 0; r < n_diag; r++) {
    int st = 0, en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    if (st < ((r - wr + 1) >> 1)) st = (r - wr + 1) >> 1;
    if (en > ((r + wl) >> 1)) en = (r + wl) >> 1;
    int st0 = st, en0 = en;
    st = st / 16 * 16; en = (en + 16) / 16 * 16 - 1;
    int8_t x1, v1;
    if (st > 0) {
      if (last_st <= st - 1 && st - 1 <= last_en) { x1 = x[st - 1]; v1 = v[st - 1]; }
      else { x1 = v1 = 0; }
    } else { x1 = 0; v1 = r ? Q : 0; }
    if (en >= r) { y[r] = 0; u[r] = r ? Q : 0; }
    for (int t0 = st0; t0 <= en0; t0 += 16) {
      for (int k = 0; k < 16; k++) {
        uint8_t sq = sf[t0 + k];
        uint8_t stq = qr[qlen - 1 - r + t0 + k];
        int8_t val = (sq == WILD || stq == WILD) ? 0 : (sq == stq ? 1 : -1);
        s8[t0 + k] = val;
      }
    }
    uint8_t* pr = &p[(size_t)r * n_col];
    off[r] = st; off_end[r] = en;
    int8_t xp = x1, vp = v1;  // shifted-in boundary values
    for (int t = st; t <= en; t++) {
      int8_t z = (int8_t)(s8[t] + QE2);
      int8_t xt1 = xp, vt1 = vp;
      xp = x[t]; vp = v[t];              // carry for next position
      int8_t a = (int8_t)(xt1 + vt1);
      int8_t ut = u[t];
      int8_t b = (int8_t)(y[t] + ut);
      uint8_t d = (a > z) ? 1 : 0;
      if (a > z) z = a;
      if (b > z) d = 2;
      uint8_t zu = std::max((uint8_t)z, (uint8_t)b);
      zu = std::min(zu, (uint8_t)MAXSC);
      z = (int8_t)zu;
      u[t] = (int8_t)(z - vt1);
      v[t] = (int8_t)(z - ut);
      z = (int8_t)(z - Q);
      a = (int8_t)(a - z);
      b = (int8_t)(b - z);
      x[t] = a > 0 ? a : 0; if (a > 0) d |= 0x08;
      y[t] = b > 0 ? b : 0; if (b > 0) d |= 0x10;
      pr[t - st] = d;
    }
    last_st = st; last_en = en;
  }
  // backtrack (ref: ksw2_alignment.cpp:25-68). The state/force_state
  // control flow follows Heng Li's public ksw2 (ksw_backtrack, MIT
  // license, github.com/lh3/ksw2) — that algorithm IS the bit-identical
  // CIGAR contract; the DP above is an original scalar re-derivation of
  // the SSE kernel in integer difference form.
  int i = tlen - 1, j = qlen - 1, state = 0;
  string cig;
  while (i >= 0 && j >= 0) {
    int force_state = -1;
    int r = i + j;
    if (i < off[r]) force_state = 2;
    if (i > off_end[r]) force_state = 1;
    int tmp = force_state < 0 ? p[(size_t)r * n_col + (i - off[r])] : 0;
    if (state == 0) state = tmp & 7;
    else if (!((tmp >> (state + 2)) & 1)) state = 0;
    if (state == 0) state = tmp & 7;
    if (force_state >= 0) state = force_state;
    if (state == 0) { cig.push_back('M'); i--; j--; }
    else if (state == 1 || state == 3) { cig.push_back('D'); i--; }
    else { cig.push_back('I'); j--; }
  }
  if (i >= 0) cig.append((size_t)i + 1, 'D');
  if (j >= 0) cig.append((size_t)j + 1, 'I');
  // apply reversed cigar: '-' insertions (ref: ksw2_alignment.cpp:263-271)
  int pos = 0;
  for (int k = (int)cig.size() - 1; k >= 0; k--, pos++) {
    if (cig[k] == 'D') s1.insert(s1.begin() + pos, '-');
    else if (cig[k] == 'I') s2.insert(s2.begin() + pos, '-');
  }
}

// ---------------------------------------------------------------------------
// chaining (ref: ReadMapping.cpp:160-242; pipeline/chaining.py)
// ---------------------------------------------------------------------------
static AlnCan identify_closest(const vector<FragPair>& sp, int beg, int end) {
  AlnCan can;
  can.score = 0;
  int i = beg, bs = 0, b0 = beg, b1 = beg;
  int s = sp[beg].rLen;
  int j = beg + 1;
  for (; j < end; j++) {
    if (sp[j].PosDiff != sp[i].PosDiff) {
      if (s > bs) { bs = s; b0 = i; b1 = j; }
      i = j; s = sp[j].rLen;
    } else s += sp[j].rLen;
  }
  if (s > bs) { bs = s; b0 = i; b1 = j; }
  can.score = bs;
  can.frags.assign(sp.begin() + b0, sp.begin() + b1);
  return can;
}

static vector<AlnCan> simple_pair_clustering(const Ctx& c, i32 rlen,
                                             vector<FragPair>& sp) {
  vector<AlnCan> out;
  int num = (int)sp.size();
  int head = 0;
  i64 gend = alignment_boundary(c, sp[0].gPos);
  int score = sp[0].rLen, score_thr = rlen >> 2;
  for (int i = 0, j = 1; j < num; i++, j++) {
    if (sp[j].gPos > gend || llabs(sp[j].PosDiff - sp[i].PosDiff) > c.max_pos_diff) {
      if (score > score_thr) {
        if (score_thr < (score >> 1)) score_thr = score >> 1;
        if (score >= rlen) out.push_back(identify_closest(sp, head, j));
        else {
          AlnCan can;
          can.score = score;
          can.frags.assign(sp.begin() + head, sp.begin() + j);
          out.push_back(std::move(can));
        }
      }
      head = j;
      gend = alignment_boundary(c, sp[j].gPos);
      score = sp[j].rLen;
    } else score += sp[j].rLen;
  }
  return out;
}

static void remove_redundant(vector<AlnCan>& cans) {
  if (cans.size() > 1) {
    i32 mx = 0;
    for (auto& c : cans) if (c.score > mx) mx = c.score;
    for (auto& c : cans) if (c.score < mx) c.score = 0;
  }
}

static int check_aln_number(const vector<AlnCan>& cans) {
  int n = 0;
  for (auto& c : cans) if (c.score > 0) n++;
  return n;
}

// ---------------------------------------------------------------------------
// pairing (ref: ReadMapping.cpp:244-394; pipeline/pairing.py)
// ---------------------------------------------------------------------------
static int check_paired_distance(i64 esti, vector<AlnCan>& c1, vector<AlnCan>& c2) {
  int num1 = (int)c1.size(), num2 = (int)c2.size();
  if ((i64)num1 * num2 > 100) { remove_redundant(c1); remove_redundant(c2); }
  struct PR { int i, j; i64 s; };
  vector<PR> vec;
  i64 maxs = 0;
  for (int i = 0; i < num1; i++) {
    if (c1[i].score == 0) continue;
    int idx2 = -1;
    i64 ps = 0;
    for (int j = 0; j < num2; j++) {
      if (c2[j].score == 0 || c2[j].frags[0].PosDiff < c1[i].frags[0].PosDiff) continue;
      i64 d = c2[j].frags[0].PosDiff - c1[i].frags[0].PosDiff;
      if (d < esti && c2[j].score > ps) { idx2 = j; ps = c2[j].score; }
    }
    if (idx2 != -1) {
      ps = c1[i].score + c2[idx2].score;
      if (ps >= maxs) { maxs = ps; vec.push_back({i, idx2, ps}); }
    }
  }
  int n = 0;
  if (maxs > 0) {
    for (auto& pr : vec) if (pr.s == maxs) {
      n++;
      c1[pr.i].paired_idx = pr.j;
      c2[pr.j].paired_idx = pr.i;
    }
  }
  return n;
}

static void mask_unpaired(vector<AlnCan>& c1, vector<AlnCan>& c2) {
  i32 mx = 0;
  for (auto& c : c1)
    if (c.paired_idx != -1 && mx < c.score + c2[c.paired_idx].score)
      mx = c.score + c2[c.paired_idx].score;
  for (auto& c : c1)
    if (c.paired_idx == -1 || c.score + c2[c.paired_idx].score < mx) c.score = 0;
  for (auto& c : c2)
    if (c.paired_idx == -1 || c.score + c1[c.paired_idx].score < mx) c.score = 0;
}

struct CoorPair { i64 dist = 0, g1 = 0, g2 = 0; };

static CoorPair gen_coordinate_pair(const vector<AlnCan>& c1, const vector<AlnCan>& c2) {
  CoorPair cp;
  for (auto& c : c1) {
    if (c.score > 0 && c.paired_idx != -1 && c2[c.paired_idx].score > 0) {
      cp.g1 = c.frags[0].gPos;
      cp.g2 = c2[c.paired_idx].frags[0].gPos;
      cp.dist = llabs(cp.g2 - cp.g1);
      return cp;
    }
  }
  vector<i64> g1v, g2v;
  for (auto& c : c1) if (c.score > 0) g1v.push_back(c.frags[0].gPos);
  for (auto& c : c2) if (c.score > 0) g2v.push_back(c.frags[0].gPos);
  if (g1v.size() == 1 && g2v.size() == 1) {
    cp.g1 = g1v[0]; cp.g2 = g2v[0]; cp.dist = llabs(cp.g2 - cp.g1);
  } else if (g1v.empty() && !g2v.empty()) {
    cp.g1 = -1; cp.dist = cp.g2 = g2v[0];
  } else if (!g1v.empty() && g2v.empty()) {
    cp.dist = cp.g1 = g1v[0]; cp.g2 = -1;
  } else cp.dist = 0;
  return cp;
}

// ---------------------------------------------------------------------------
// k-mer rescue (ref: KmerAnalysis.cpp, AlignmentRescue.cpp; pipeline/rescue.py)
// ---------------------------------------------------------------------------
static const int KMER = 8;
static const uint32_t KPOW = 0x3FFF;

static vector<std::pair<uint32_t, uint32_t>> kmer_vec(const char* seq, int len) {
  vector<std::pair<uint32_t, uint32_t>> v;
  int tail = 0, count = 0;
  while (count < KMER && tail < len) {
    if (seq[tail++] != 'N') count++; else count = 0;
  }
  if (count == KMER) {
    uint32_t head = tail - KMER, wid = 0;
    for (int i = (int)head; i < tail; i++) wid = (wid << 2) + NT4[(unsigned char)seq[i]];
    v.push_back({wid, head});
    head++;
    while (tail < len) {
      if (seq[tail] != 'N') {
        wid = ((wid & KPOW) << 2) + NT4[(unsigned char)seq[tail]];
        v.push_back({wid, head});
        head++; tail++;
      } else {
        count = 0; tail++;
        while (count < KMER && tail < len) {
          if (seq[tail++] != 'N') count++; else count = 0;
        }
        if (count == KMER) {
          head = tail - KMER; wid = 0;
          for (int i = (int)head; i < (int)head + KMER; i++)
            wid = (wid << 2) + NT4[(unsigned char)seq[i]];
          v.push_back({wid, head});
          head++;
        } else break;
      }
    }
    std::sort(v.begin(), v.end(),
              [](const std::pair<uint32_t, uint32_t>& a,
                 const std::pair<uint32_t, uint32_t>& b) { return a.first < b.first; });
  }
  return v;
}

struct KPair { i64 pd; uint32_t rpos, gpos; };

static vector<KPair> common_kmers(uint32_t max_shift,
                                  const vector<std::pair<uint32_t, uint32_t>>& v1,
                                  const vector<std::pair<uint32_t, uint32_t>>& v2) {
  vector<KPair> out;
  for (auto& it : v1) {
    auto lo = std::lower_bound(v2.begin(), v2.end(), std::make_pair(it.first, 0u),
        [](const std::pair<uint32_t, uint32_t>& a, const std::pair<uint32_t, uint32_t>& b) {
          return a.first < b.first;
        });
    for (auto k = lo; k != v2.end() && k->first == it.first; ++k) {
      uint32_t g = k->second, r = it.second;
      if ((g >= r && g - r < max_shift) || (g < r && r - g < max_shift))
        out.push_back({(i64)g - (i64)r, r, g});
    }
  }
  std::sort(out.begin(), out.end(), [](const KPair& a, const KPair& b) {
    if (a.pd == b.pd) return a.rpos < b.rpos;
    return a.pd < b.pd;
  });
  return out;
}

static vector<FragPair> pairs_from_kmers(int thr, i64 gpos, const vector<KPair>& kp) {
  vector<FragPair> out;
  int num = (int)kp.size();
  for (int i = 0; i < num;) {
    i64 pd = kp[i].pd;
    uint32_t npos = kp[i].rpos + 1;
    int j = i + 1;
    while (j < num && kp[j].rpos == npos && kp[j].pd == pd) { npos++; j++; }
    int l = KMER + (j - 1 - i);
    if (l >= thr) {
      FragPair fp;
      fp.simple = true;
      fp.rPos = (i32)kp[i].rpos;
      fp.gPos = kp[i].gpos + gpos;
      fp.rLen = fp.gLen = l;
      fp.PosDiff = pd + gpos;
      out.push_back(std::move(fp));
    }
    i = j;
  }
  return out;
}

static AlnCan best_aln_can(const vector<FragPair>& sp) {
  AlnCan best;
  int num = (int)sp.size();
  for (int i = 0; i < num;) {
    int score = sp[i].rLen;
    int j = i + 1;
    while (j < num && sp[j].PosDiff == sp[i].PosDiff) { score += sp[j].rLen; j++; }
    if (score > best.score) {
      best.score = score;
      best.frags.assign(sp.begin() + i, sp.begin() + j);
    }
    i = j;
  }
  return best;
}

static int alignment_rescue(const Ctx& c, i64 est, Read& r1, Read& r2) {
  i32 score1 = 0, score2 = 0;
  for (auto& can : r1.cans) if (can.score > score1) score1 = can.score;
  for (auto& can : r2.cans) if (can.score > score2) score2 = can.score;
  if (score1 < (r1.rlen >> 2) && score2 < (r2.rlen >> 2)) return 0;
  int strategy;
  if (score1 - score2 > (r2.rlen >> 2)) strategy = 1;
  else if (score2 - score1 > (r1.rlen >> 2)) strategy = 2;
  else strategy = 3;
  int n_paired = 0;
  int num1 = (int)r1.cans.size(), num2 = (int)r2.cans.size();

  auto try_fix = [&](Read& anchor, Read& other, i32 other_score, i32 thr,
                     int n_other, bool left_of) {
    auto k1 = kmer_vec(other.seq, other.rlen);
    int added = 0;
    size_t n_anchor = anchor.cans.size();
    for (size_t idx = 0; idx < n_anchor; idx++) {
      AlnCan& can = anchor.cans[idx];
      if (can.score < thr || can.paired_idx != -1) continue;
      i64 left_end, right_end;
      if (left_of) { left_end = can.frags[0].PosDiff; right_end = can.frags[0].PosDiff + est + other.rlen; }
      else { left_end = can.frags[0].PosDiff - est; right_end = can.frags[0].PosDiff + other.rlen; }
      if (right_end > c.two_l) right_end = c.two_l;
      size_t i1 = boundary_index(c, left_end), i2 = boundary_index(c, right_end);
      i32 ci1 = i1 < c.bkeys.size() ? c.bchrom[i1] : -1;
      i32 ci2 = i2 < c.bkeys.size() ? c.bchrom[i2] : -2;
      if (ci1 != ci2) continue;
      i64 slen = right_end - left_end;
      if (slen < other.rlen) continue;
      auto k2 = kmer_vec(c.ref + left_end, (int)slen);
      auto kp = common_kmers((uint32_t)slen, k1, k2);
      auto sp = pairs_from_kmers(10, left_end, kp);
      if (sp.empty()) continue;
      AlnCan best = best_aln_can(sp);
      if (best.score > other_score) {
        n_paired++;
        can.paired_idx = n_other + added;
        best.paired_idx = (int)idx;
        other.cans.push_back(std::move(best));
        added++;
      }
    }
    return added;
  };
  if (strategy == 1 || strategy == 3) try_fix(r1, r2, score2, score1 >> 1, num2, true);
  if (strategy == 2 || strategy == 3) try_fix(r2, r1, score1, score2 >> 1, num1, false);
  return n_paired;
}

// ---------------------------------------------------------------------------
// alignment production (ref: ReadAlignment.cpp; pipeline/alignment.py)
// ---------------------------------------------------------------------------
static const int MIN_ALN_BLOCK = 5;

static void revcomp_inplace(string& s) {
  int i = 0, j = (int)s.size() - 1;
  while (i < j) {
    char a = s[i];
    s[i] = COMP[(unsigned char)s[j]];
    s[j] = COMP[(unsigned char)a];
    i++; j--;
  }
  if (i == j) s[i] = COMP[(unsigned char)s[i]];
}

// builds the '-'-free pair strings for a normal pair and decides
// whether the gapped DP runs (ref: ReadAlignment.cpp:155-190)
static bool build_pair_strings(const Ctx& c, const char* seq, FragPair& fp) {
  if (fp.rLen > 0) fp.aln1.assign(seq + fp.rPos, (size_t)fp.rLen);
  else fp.aln1.assign((size_t)fp.gLen, '-');
  if (fp.gLen > 0) fp.aln2.assign(c.ref + fp.gPos, (size_t)fp.gLen);
  else fp.aln2.assign((size_t)fp.rLen, '-');
  if (fp.gPos >= c.L) {
    if (fp.rLen > 0) revcomp_inplace(fp.aln1);
    if (fp.gLen > 0) revcomp_inplace(fp.aln2);
  }
  if (fp.rLen > 0 && fp.gLen > 0) {
    bool run = fp.rLen != fp.gLen;
    if (!run) {
      int mis = 0;
      for (int i = 0; i < fp.rLen; i++) if (fp.aln1[i] != fp.aln2[i]) mis++;
      run = mis > 1 && mis >= (int)(fp.rLen * 0.2);
    }
    return run;
  }
  return false;
}

// device-extension batch cap: pairs at most this long go to the Pallas
// NW/ksw2 kernels; longer pairs fall back to the scalar aligner
static const int DP_DEV_MAX = 160;

static void process_normal_pair(const Ctx& c, const char* seq, FragPair& fp,
                                bool use_nw) {
  bool run = build_pair_strings(c, seq, fp);
  if (run) {
    if (!c.dp_cache.empty()) {
      auto it = c.dp_cache.find(fp.aln1 + '\x01' + fp.aln2);
      if (it != c.dp_cache.end() && !it->second.first.empty()) {
        fp.aln1 = it->second.first;
        fp.aln2 = it->second.second;
        return;
      }
    }
    if (use_nw) nw_align(fp.aln1, fp.aln2);
    else ksw2_align(fp.aln1, fp.aln2);
  }
}

static bool check_local_quality(const FragPair& fp) {
  int aln_type = -1, n = 0, mis = 0, status = 0;
  for (size_t i = 0; i < fp.aln1.size(); i++) {
    if (fp.aln1[i] == '-') { if (aln_type != 0) { aln_type = 0; status++; } }
    else if (fp.aln2[i] == '-') { if (aln_type != 1) { aln_type = 1; status++; } }
    else {
      n++;
      if (fp.aln1[i] != fp.aln2[i]) mis++;
      if (aln_type != 2) { aln_type = 2; status++; }
    }
  }
  return !(status >= 4 || (mis >= 3 && mis >= (int)(n * 0.3)));
}

static int evaluate_score(const vector<FragPair>& frags) {
  int score = 0;
  for (auto& f : frags) {
    if (f.simple) score += f.rLen;
    else if (!f.aln1.empty())
      for (size_t i = 0; i < f.aln1.size(); i++) if (f.aln1[i] == f.aln2[i]) score++;
  }
  return score;
}

static int find_mismatch_number(const vector<FragPair>& frags) {
  int mm = 0;
  for (auto& f : frags)
    if (!f.simple)
      for (size_t i = 0; i < f.aln1.size(); i++)
        if (f.aln1[i] != f.aln2[i] && f.aln1[i] != '-' && f.aln2[i] != '-') mm++;
  return mm;
}

static void remove_heading_gaps(bool first, FragPair& fp) {
  int rs = 0, gs = 0, n = (int)fp.aln1.size(), j = 0;
  while (j < n) {
    if (fp.aln1[j] == '-') gs++;
    else if (fp.aln2[j] == '-') rs++;
    else break;
    j++;
  }
  if (j > 0) {
    fp.aln1.erase(0, j); fp.aln2.erase(0, j);
    fp.rLen -= rs; fp.gLen -= gs;
    if (first) { fp.rPos += rs; fp.gPos += gs; }
  }
}

static void remove_tailing_gaps(bool first, FragPair& fp) {
  int rs = 0, gs = 0, n = (int)fp.aln1.size(), j = n - 1;
  while (j >= 0) {
    if (fp.aln1[j] == '-') gs++;
    else if (fp.aln2[j] == '-') rs++;
    else break;
    j--;
  }
  j++;
  if (j < n) {
    fp.aln1.resize(j); fp.aln2.resize(j);
    fp.rLen -= rs; fp.gLen -= gs;
    if (first) { fp.rPos += rs; fp.gPos += gs; }
  }
}

// shared pre-DP derivation: sort by rPos, trim overlaps, insert normal
// pairs incl. head/tail extensions (ref: ReadAlignment.cpp:38-153)
static void prepare_frags(const Ctx& c, i32 rlen, vector<FragPair>& frags) {
  std::stable_sort(frags.begin(), frags.end(), [](const FragPair& a, const FragPair& b) {
    if (a.rPos == b.rPos) return a.gPos < b.gPos;
    return a.rPos < b.rPos;
  });
  bool overlap = false;
  for (size_t i = 0; i + 1 < frags.size(); i++) {
    FragPair& a = frags[i];
    FragPair& b = frags[i + 1];
    if (a.rPos == b.rPos) { overlap = true; a.rLen = a.gLen = 0; }
    else if (a.gPos >= b.gPos || a.gPos + a.gLen > b.gPos) {
      overlap = true;
      i64 ov = a.gPos + a.gLen - b.gPos;
      a.rLen -= (i32)ov; if (a.rLen < 0) a.rLen = 0;
      a.gLen -= (i32)ov; if (a.gLen < 0) a.gLen = 0;
    }
  }
  if (overlap) {
    vector<FragPair> kept;
    for (auto& f : frags) if (f.rLen != 0) kept.push_back(std::move(f));
    frags = std::move(kept);
  }
  size_t num = frags.size();
  vector<FragPair> ins;
  for (size_t i = 0; i + 1 < num; i++) {
    i32 rg = frags[i + 1].rPos - (frags[i].rPos + frags[i].rLen);
    if (rg < 0) rg = 0;
    i64 gg = frags[i + 1].gPos - (frags[i].gPos + frags[i].gLen);
    if (gg < 0) gg = 0;
    if (rg > 0 || gg > 0) {
      FragPair fp;
      fp.simple = false;
      fp.rPos = frags[i].rPos + frags[i].rLen;
      fp.gPos = frags[i].gPos + frags[i].gLen;
      fp.rLen = rg; fp.gLen = (i32)gg;
      fp.PosDiff = fp.gPos - fp.rPos;
      ins.push_back(std::move(fp));
    }
  }
  if (!ins.empty()) {
    for (auto& f : ins) frags.push_back(std::move(f));
    std::stable_sort(frags.begin(), frags.end(), [](const FragPair& a, const FragPair& b) {
      if (a.rPos == b.rPos) return a.gPos < b.gPos;
      return a.rPos < b.rPos;
    });
  }
  if (frags[0].rPos > 0) {
    FragPair fp;
    fp.simple = false;
    fp.rPos = 0;
    fp.gPos = fp.PosDiff = frags[0].PosDiff;
    fp.rLen = fp.gLen = frags[0].rPos;
    frags.insert(frags.begin(), std::move(fp));
  }
  FragPair& last = frags.back();
  if (last.rPos + last.rLen < rlen) {
    FragPair fp;
    fp.simple = false;
    fp.rPos = last.rPos + last.rLen;
    fp.gPos = last.gPos + last.gLen;
    fp.PosDiff = last.PosDiff;
    fp.rLen = fp.gLen = rlen - fp.rPos;
    frags.push_back(std::move(fp));
  }
}

// dry pass for the device gapped-extension batch: derive each slow
// candidate's normal pairs on a COPY and collect the DP-triggering
// pair strings (deterministic => identical to what process_normal_pair
// will ask for)
static void collect_dp_pairs(Ctx& c, const Read& read) {
  for (auto& can0 : read.cans) {
    if (can0.score == 0 || can0.fast) continue;
    vector<FragPair> frags = can0.frags;
    prepare_frags(c, read.rlen, frags);
    if (!check_alignment_validity(c, frags[0].gPos,
                                  frags.back().gPos + frags.back().gLen))
      continue;
    for (auto& fp : frags) {
      if (fp.simple) continue;
      FragPair tmp = fp;
      bool run = build_pair_strings(c, read.seq, tmp);
      if (run && tmp.rLen <= DP_DEV_MAX && tmp.gLen <= DP_DEV_MAX) {
        std::string key = tmp.aln1 + '\x01' + tmp.aln2;
        if (c.dp_cache.emplace(key, std::pair<std::string, std::string>()
                               ).second)
          c.dp_pending.emplace_back(tmp.aln1, tmp.aln2);
      }
    }
  }
}

static bool produce_read_alignment(const Ctx& c, Read& read) {
  int max_mm_thr = (int)(read.rlen * c.max_mismatch_rate);
  for (size_t ci = 0; ci < read.cans.size(); ci++) {
    AlnCan& can = read.cans[ci];
    if (can.score == 0) continue;
    if (can.fast) {
      // identity alignment along fast_pd: score = matched bases, same
      // mismatch-rate veto as the generic path below
      int sc = read.rlen - read.fast_mm;
      if (sc < (int)(read.rlen * (1 - c.max_mismatch_rate)) &&
          read.fast_mm > max_mm_thr)
        can.score = 0;
      else {
        can.score = sc;
        if (can.score > read.score) {
          read.score = can.score;
          read.best_idx = (int)ci;
        } else if (can.score > read.sub_score) read.sub_score = can.score;
      }
      continue;
    }
    auto& frags = can.frags;
    prepare_frags(c, read.rlen, frags);
    if (!check_alignment_validity(c, frags[0].gPos,
                                  frags.back().gPos + frags.back().gLen)) {
      can.score = 0;
      continue;
    }
    bool b_head = true, b_tail = true;
    int tail_idx = (int)frags.size() - 1;
    for (int i = 0; i < (int)frags.size(); i++) {
      FragPair& fp = frags[i];
      if (fp.simple) continue;
      process_normal_pair(c, read.seq, fp, c.use_nw);
      if (i == 0) {
        if (fp.gPos < c.L) remove_heading_gaps(true, fp);
        else remove_tailing_gaps(true, fp);
        if ((int)fp.aln1.size() >= MIN_ALN_BLOCK && !check_local_quality(fp)) {
          b_head = false;
          fp.rLen = fp.gLen = 0;
          fp.aln1.clear(); fp.aln2.clear();
          fp.rPos = frags[i + 1].rPos;
          fp.gPos = frags[i + 1].gPos;
        }
      } else if (i == tail_idx) {
        if (fp.gPos < c.L) remove_tailing_gaps(false, fp);
        else remove_heading_gaps(false, fp);
        if ((int)fp.aln1.size() >= MIN_ALN_BLOCK && !check_local_quality(fp)) {
          b_tail = false;
          fp.rLen = fp.gLen = 0;
          fp.rPos = frags[i - 1].rPos + frags[i - 1].rLen;
          fp.gPos = frags[i - 1].gPos + frags[i - 1].gLen;
          fp.aln1.clear(); fp.aln2.clear();
        }
      } else {
        if (fp.rLen >= MIN_ALN_BLOCK && fp.gLen >= MIN_ALN_BLOCK && !check_local_quality(fp)) {
          can.score = 0;
          break;
        }
      }
    }
    if (can.score == 0) continue;
    if (!b_head && !b_tail) can.score = 0;
    else {
      can.score = evaluate_score(frags);
      if (can.score == 0) continue;
      if (can.score < (int)(read.rlen * (1 - c.max_mismatch_rate)) &&
          find_mismatch_number(frags) > max_mm_thr)
        can.score = 0;
      else {
        can.orientation = frags[0].gPos < c.L;
        if (!can.orientation) std::reverse(frags.begin(), frags.end());
        if (can.score > read.score) {
          read.score = can.score;
          read.best_idx = (int)ci;
        } else if (can.score > read.sub_score) read.sub_score = can.score;
      }
    }
  }
  for (auto& can : read.cans) if (can.score < read.score) can.score = 0;
  return read.score > 0;
}

// ---------------------------------------------------------------------------
// SAM generation (ref: SamReport.cpp; io/sam.py)
// ---------------------------------------------------------------------------
static int evaluate_mapq(const Read& r) {
  if (r.score == 0 || r.score == r.sub_score) return 0;
  if (r.sub_score == 0 || r.score - r.sub_score > 5) return 60;
  float ratio = (float)(r.score - r.sub_score) / (float)r.score;
  float inner = 30.0f * (1.0f - ratio);
  int mapq = (int)((double)inner * log((double)r.score) + 0.4999);
  return mapq > 60 ? 60 : mapq;
}

static string generate_cigar(i32 rlen, bool orientation, const vector<FragPair>& frags) {
  string cig;
  char buf[32];
  char state = ' ';
  i64 cnt = 0;
  auto flush = [&]() {
    if (cnt > 0) { snprintf(buf, sizeof buf, "%lld%c", (long long)cnt, state); cig += buf; }
    cnt = 0;
  };
  if (!frags[0].simple) {
    if (orientation) {
      if (frags[0].rPos != 0) { snprintf(buf, sizeof buf, "%dS", frags[0].rPos); cig += buf; }
    } else {
      i32 s = rlen - (frags[0].rPos + frags[0].rLen);
      if (s > 0) { snprintf(buf, sizeof buf, "%dS", s); cig += buf; }
    }
  }
  for (auto& f : frags) {
    if (f.simple) {
      if (state != 'M') { flush(); state = 'M'; }
      cnt += f.rLen;
    } else if (!f.aln1.empty()) {
      for (size_t j = 0; j < f.aln1.size(); j++) {
        char st = f.aln1[j] == '-' ? 'D' : (f.aln2[j] == '-' ? 'I' : 'M');
        if (state != st) { flush(); state = st; }
        cnt++;
      }
    } else if (f.rLen > 0) {
      if (state != 'I') { flush(); state = 'I'; }
      cnt += f.rLen;
    } else if (f.gLen > 0) {
      if (state != 'D') { flush(); state = 'D'; }
      cnt += f.gLen;
    }
  }
  flush();
  const FragPair& last = frags.back();
  if (frags.size() > 1 && !last.simple) {
    if (orientation) {
      i32 s = rlen - (last.rPos + last.rLen);
      if (s > 0) { snprintf(buf, sizeof buf, "%dS", s); cig += buf; }
    } else {
      if (last.rPos != 0) { snprintf(buf, sizeof buf, "%dS", last.rPos); cig += buf; }
    }
  }
  return cig;
}

static Coor get_aln_coordinate(const Ctx& c, bool orientation, const vector<FragPair>& frags) {
  for (auto& f : frags) {
    if (f.gLen > 0) {
      if (orientation) return determine_coordinate(c, f.gPos);
      return determine_coordinate(c, f.gPos + f.gLen - 1);
    }
  }
  return {0, 0};
}

static void set_paired_flags(Read& r1, Read& r2) {
  auto one_side = [](Read& rd, Read& other, int base_flag, bool fwd_is_0x20) {
    auto obit = [&](bool orient, bool primary) {
      if (fwd_is_0x20) return primary ? (orient ? 0x20 : 0x10) : (orient ? 0x10 : 0x20);
      return primary ? (orient ? 0x10 : 0x20) : (orient ? 0x20 : 0x10);
    };
    if (rd.score > rd.sub_score) {
      AlnCan& c = rd.cans[rd.best_idx];
      c.SamFlag = base_flag | obit(c.orientation, true);
      int j = c.paired_idx;
      if (j != -1 && other.cans[j].score > 0) c.SamFlag |= 0x2;
      else { c.SamFlag |= obit(c.orientation, false); c.SamFlag |= 0x8; }
    } else if (rd.score > 0) {
      for (auto& c : rd.cans) {
        if (c.score > 0) {
          c.SamFlag = base_flag | obit(c.orientation, true);
          int j = c.paired_idx;
          if (j != -1 && other.cans[j].score > 0) c.SamFlag |= 0x2;
          else c.SamFlag |= 0x8;
        }
      }
    }
  };
  one_side(r1, r2, 0x41, true);
  one_side(r2, r1, 0x81, false);
}

static void append_sam_paired(const Ctx& c, Read& r1, Read& r2, string& out) {
  set_paired_flags(r1, r2);
  char buf[512];
  auto unmapped = [&](Read& rd, Read& other, int frag_bit) {
    int flag = 0x1 | 0x4 | frag_bit;
    if (other.score == 0) flag |= 0x8;
    else if (!other.cans.empty()) flag |= 0x30;  // ref: SamReport.cpp:398-399
    out += rd.header;
    snprintf(buf, sizeof buf, "\t%d\t*\t0\t0\t*\t*\t0\t0\t", flag);
    out += buf;
    out += rd.seq;
    out.push_back('\t');
    out += c.fastq ? rd.qual : "*";
    out += "\tAS:i:0\tXS:i:0\n";
  };
  auto mapped = [&](Read& rd, Read& other, bool is_first) {
    int mapq = evaluate_mapq(rd);
    string rseq, rqual;
    bool have_r = false;
    for (int i = rd.best_idx; i < (int)rd.cans.size(); i++) {
      AlnCan& can = rd.cans[i];
      if (can.score != rd.score) continue;
      if (!can.orientation && !have_r) {
        rseq.assign(rd.seq, rd.rlen);
        revcomp_inplace(rseq);
        if (c.fastq) {
          rqual.assign(rd.qual, rd.rlen);
          std::reverse(rqual.begin(), rqual.end());
        }
        have_r = true;
      }
      string cig = generate_cigar(rd.rlen, can.orientation, can.frags);
      Coor co = get_aln_coordinate(c, can.orientation, can.frags);
      int j = can.paired_idx;
      const char* sq = can.orientation ? rd.seq : rseq.c_str();
      const char* qq = c.fastq ? (can.orientation ? rd.qual : rqual.c_str()) : "*";
      out += rd.header;
      if (j != -1 && other.score > 0 && other.cans[j].score == other.score) {
        AlnCan& oc = other.cans[j];
        Coor co2 = get_aln_coordinate(c, oc.orientation, oc.frags);
        i64 dist;
        if (is_first) {
          // dist sign convention (ref: SamReport.cpp:425,473)
          dist = co2.pos - co.pos + (can.orientation ? r2.rlen : -(i64)r1.rlen);
        } else {
          dist = -(co.pos - co2.pos + (oc.orientation ? r2.rlen : -(i64)r1.rlen));
        }
        snprintf(buf, sizeof buf, "\t%d\t%s\t%lld\t%d\t", can.SamFlag,
                 c.chroms[co.ci].name.c_str(), (long long)co.pos, mapq);
        out += buf;
        out += cig;
        snprintf(buf, sizeof buf, "\t=\t%lld\t%lld\t", (long long)co2.pos, (long long)dist);
        out += buf;
      } else {
        snprintf(buf, sizeof buf, "\t%d\t%s\t%lld\t%d\t", can.SamFlag,
                 c.chroms[co.ci].name.c_str(), (long long)co.pos, mapq);
        out += buf;
        out += cig;
        out += "\t*\t0\t0\t";
      }
      out += sq;
      out.push_back('\t');
      out += qq;
      snprintf(buf, sizeof buf, "\tNM:i:%d\tAS:i:%d\tXS:i:%d\n",
               rd.rlen - can.score, rd.score, rd.sub_score);
      out += buf;
      if (c.unique_only) break;
    }
  };
  if (r1.score == 0) unmapped(r1, r2, 0x40); else mapped(r1, r2, true);
  if (r2.score == 0) unmapped(r2, r1, 0x80); else mapped(r2, r1, false);
}

static void append_sam_single(const Ctx& c, Read& rd, string& out) {
  char buf[512];
  if (rd.score == 0) {
    out += rd.header;
    out += "\t4\t*\t0\t0\t*\t*\t0\t0\t";
    out += rd.seq;
    out.push_back('\t');
    out += c.fastq ? rd.qual : "*";
    out += "\tAS:i:0\tXS:i:0\n";
    return;
  }
  // flags (ref: SamReport.cpp:7-24)
  if (rd.score > rd.sub_score || !c.unique_only) {
    AlnCan& can = rd.cans[rd.best_idx];
    can.SamFlag = can.orientation ? 0 : 0x10;
  } else if (rd.score > 0) {
    for (auto& can : rd.cans) if (can.score > 0) can.SamFlag = can.orientation ? 0 : 0x10;
  }
  int mapq = evaluate_mapq(rd);
  string rseq, rqual;
  bool have_r = false;
  for (int i = rd.best_idx; i < (int)rd.cans.size(); i++) {
    AlnCan& can = rd.cans[i];
    if (can.score != rd.score) continue;
    if (!can.orientation && !have_r) {
      rseq.assign(rd.seq, rd.rlen);
      revcomp_inplace(rseq);
      if (c.fastq) {
        rqual.assign(rd.qual, rd.rlen);
        std::reverse(rqual.begin(), rqual.end());
      }
      have_r = true;
    }
    string cig = generate_cigar(rd.rlen, can.orientation, can.frags);
    Coor co = get_aln_coordinate(c, can.orientation, can.frags);
    out += rd.header;
    snprintf(buf, sizeof buf, "\t%d\t%s\t%lld\t%d\t", can.SamFlag,
             c.chroms[co.ci].name.c_str(), (long long)co.pos, mapq);
    out += buf;
    out += cig;
    out += "\t*\t0\t0\t";
    out += can.orientation ? rd.seq : rseq.c_str();
    out.push_back('\t');
    out += c.fastq ? (can.orientation ? rd.qual : rqual.c_str()) : "*";
    snprintf(buf, sizeof buf, "\tNM:i:%d\tAS:i:%d\tXS:i:%d\n",
             rd.rlen - can.score, rd.score, rd.sub_score);
    out += buf;
    if (c.unique_only) break;
  }
}

// ---------------------------------------------------------------------------
// profile accumulation (ref: AlignmentProfile.cpp; pipeline/profile.py)
// ---------------------------------------------------------------------------
static const int MIN_BP_SIZE = 20;
static const i32 MAX_ALLELE = 4095;

// event kinds for the host-side maps
enum { EV_BP = 0, EV_INS = 1, EV_DEL = 2 };
struct Event { i64 gpos; i32 kind; string seq; };

struct ChunkOut {
  i64 mapped_num = 0, paired_num = 0, dist_sum = 0, rlen_sum = 0;
  vector<std::pair<i64, i64>> inv_sites, tnl_sites;  // (gpos, dist)
  vector<Event> events;
  string sam;
};

static void bump_base(Ctx& c, i64 g, int plane) {
  if (g >= 0 && g < c.L && c.acgt[plane][g] < MAX_ALLELE) c.acgt[plane][g]++;
}

// diff-mode point add: uncapped — the MaxAlleleCount saturation is
// applied once at finalize over (point + exact range) totals, which for
// a pure +1 stream equals per-increment capping.
static void bump_base_nocap(Ctx& c, i64 g, int plane) {
  if (g >= 0 && g < c.L) c.acgt[plane][g]++;
}

// diff-mode exact-match range add over forward positions [g, g+len)
static void exact_range(Ctx& c, i64 g, i32 len) {
  if (len <= 0) return;
  i64 e = g + len;
  if (g < 0) g = 0;
  if (e > c.L) e = c.L;
  if (e <= g) return;
  c.exact_diff[g]++;
  c.exact_diff[e]--;
}

// Walk a '-'-padded alignment block. In plane mode bumps acgt directly;
// in diff mode matched columns become exact_diff range-adds (a2 holds
// forward-strand ref chars on both strands, because process_normal_pair
// revcomps reverse blocks) and only mismatch columns are point adds.
static void walk_aln(Ctx& c, const string& a1, const string& a2, i64 gpos,
                     vector<Event>& evs, bool diff_mode) {
  size_t j = 0, n = a1.size();
  while (j < n) {
    if (a2[j] == '-') {
      size_t e = j + 1;
      while (e < n && a2[e] == '-') e++;
      evs.push_back({gpos - 1, EV_INS, a1.substr(j, e - j)});
      j = e;
    } else if (a1[j] == '-') {
      size_t e = j + 1;
      while (e < n && a1[e] == '-') e++;
      evs.push_back({gpos - 1, EV_DEL, a2.substr(j, e - j)});
      gpos += e - j;
      j = e;
    } else if (diff_mode) {
      unsigned char b = NT4[(unsigned char)a1[j]];
      if (b < 4 && a1[j] == a2[j]) {
        i64 g0 = gpos;
        size_t e = j;
        while (e < n && a1[e] == a2[e]
               && NT4[(unsigned char)a1[e]] < 4) { e++; gpos++; }
        exact_range(c, g0, (i32)(e - j));
        j = e;
      } else {
        if (b < 4) bump_base_nocap(c, gpos, b);
        j++; gpos++;
      }
    } else {
      unsigned char b = NT4[(unsigned char)a1[j]];
      if (b < 4) bump_base(c, gpos, b);
      j++; gpos++;
    }
  }
}

// Evidence for a fast-path read: the alignment is the identity along
// fast_pd, so the net effect of UpdateProfile (AlignmentProfile.cpp:
// 41-119) is one coverage range minus holes at the mismatch positions,
// plus read-base point adds there. Mismatch positions are recomputed
// from the read (cheap, cache-resident) — they equal the device count.
static void fast_profile(Ctx& c, bool b_first, Read& rd, AlnCan& can) {
  bool emit = c.emit_segments;
  bool ori = can.orientation;
  i64 pd = rd.fast_pd;
  i64 g_start = ori ? pd : c.two_l - pd - rd.rlen;
  if (c.read_count[g_start] < c.max_duplicate) c.read_count[g_start]++;
  else return;
  c.host_planes_dirty = true;
  i64 end = std::min<i64>(g_start + rd.rlen, c.L);
  if (emit) {
    i32* fd = c.f_diff[b_first ? (ori ? 0 : 3) : (ori ? 1 : 2)];
    fd[g_start]++;
    fd[end]--;
    exact_range(c, g_start, rd.rlen);
    if (rd.fast_mm > 0) {
      const char* ref = c.ref;
      for (i32 r = 0; r < rd.rlen; r++) {
        if (rd.seq[r] != ref[pd + r]) {
          i64 p = ori ? pd + r : c.two_l - 1 - (pd + r);
          c.exact_diff[p]--;
          c.exact_diff[p + 1]++;
          unsigned char b = NT4[(unsigned char)rd.seq[r]];
          bump_base(c, p, ori ? b : 3 - b);
        }
      }
    }
  } else {
    i32* tgt = b_first ? (ori ? c.F1 : c.R1) : (ori ? c.R2 : c.F2);
    for (i64 g = g_start; g < end; g++) tgt[g]++;
    const char* ref = c.ref;
    for (i32 r = 0; r < rd.rlen; r++) {
      unsigned char b = NT4[(unsigned char)rd.seq[r]];
      i64 p = ori ? pd + r : c.two_l - 1 - (pd + r);
      (void)ref;
      bump_base(c, p, ori ? b : 3 - b);
    }
  }
}

static void update_profile(Ctx& c, bool b_first, Read& rd, vector<Event>& evs,
                           i32 order) {
  bool emit = c.emit_segments;
  for (auto& can : rd.cans) {
    if (can.score == 0) continue;
    if (can.fast) {
      if (c.ops_mode) {
        // evidence is applied on device from the device-resident chain
        // outputs; the sequential PCR-duplicate gate stays host-side
        // (ref: AlignmentProfile.cpp:76) and filters the admit bitmask
        bool ori = can.orientation;
        i64 gs = ori ? rd.fast_pd : c.two_l - rd.fast_pd - rd.rlen;
        if (c.read_count[gs] < c.max_duplicate) {
          c.read_count[gs]++;
          c.fast_bits[order >> 5] |= 1u << (order & 31);
        }
      } else fast_profile(c, b_first, rd, can);
      continue;
    }
    auto& frags = can.frags;
    const FragPair& first = frags.front();
    const FragPair& last = frags.back();
    if (first.rLen == 0 && first.gLen == 0) {
      if (first.rPos > MIN_BP_SIZE) {
        i64 g = first.gPos;
        evs.push_back({g < c.L ? g : c.two_l - 1 - g, EV_BP, string()});
      }
      if (first.rPos > c.max_clip_size) continue;
    }
    if (last.rLen == 0 && last.gLen == 0) {
      if (rd.rlen - last.rPos > MIN_BP_SIZE) {
        i64 g = last.gPos;
        evs.push_back({g < c.L ? g : c.two_l - 1 - g, EV_BP, string()});
      }
      if (rd.rlen - last.rPos > c.max_clip_size) continue;
    }
    i64 g_start = can.orientation ? first.gPos : c.two_l - (first.gPos + first.gLen);
    i64 end = std::min<i64>(g_start + rd.rlen, c.L);
    int fplane = b_first ? (can.orientation ? 0 : 3)
                         : (can.orientation ? 1 : 2);
    if (c.read_count[g_start] < c.max_duplicate) c.read_count[g_start]++;
    else continue;
    c.host_planes_dirty = true;
    if (emit) {
      i32* fd = c.f_diff[fplane];
      fd[g_start]++;
      fd[end]--;
    } else {
      i32* tgt = b_first ? (can.orientation ? c.F1 : c.R1)
                         : (can.orientation ? c.R2 : c.F2);
      for (i64 g = g_start; g < end; g++) tgt[g]++;
    }
    if (can.orientation) {
      for (auto& fp : frags) {
        if (fp.simple) {
          if (emit) {
            // exact seed: every base equals the forward ref base
            exact_range(c, fp.gPos, fp.rLen);
          } else {
            i32 rp = fp.rPos;
            i64 gp = fp.gPos;
            for (i32 j = 0; j < fp.rLen; j++, rp++, gp++) {
              unsigned char b = NT4[(unsigned char)rd.seq[rp]];
              if (b < 4) bump_base(c, gp, b);
            }
          }
        } else if (fp.gLen == 0) evs.push_back({fp.gPos - 1, EV_INS, fp.aln1});
        else if (fp.rLen == 0) evs.push_back({fp.gPos - 1, EV_DEL, fp.aln2});
        else walk_aln(c, fp.aln1, fp.aln2, fp.gPos, evs, emit);
      }
    } else {
      for (auto& fp : frags) {
        if (fp.simple) {
          if (emit) {
            exact_range(c, c.two_l - fp.gPos - fp.rLen, fp.rLen);
          } else {
            i32 rp = fp.rPos;
            i64 gp = c.two_l - 1 - fp.gPos;
            for (i32 j = 0; j < fp.rLen; j++, rp++, gp--) {
              unsigned char b = NT4[(unsigned char)rd.seq[rp]];
              if (b < 4) bump_base(c, gp, 3 - b);
            }
          }
        } else if (fp.gLen == 0) evs.push_back({c.two_l - fp.gPos - 1, EV_INS, fp.aln1});
        else if (fp.rLen == 0) evs.push_back({c.two_l - fp.gPos - fp.gLen - 1, EV_DEL, fp.aln2});
        else walk_aln(c, fp.aln1, fp.aln2, c.two_l - (fp.gPos + fp.gLen), evs,
                      emit);
      }
    }
  }
}

static void update_multi_hit(Ctx& c, Read& rd) {
  for (auto& can : rd.cans) {
    if (can.score > 0) {
      i64 g, ge;
      if (can.orientation) {
        g = can.frags.front().gPos;
        ge = can.frags.back().gPos + can.frags.back().gLen;
      } else {
        g = c.two_l - (can.frags.front().gPos + can.frags.front().gLen);
        ge = c.two_l - can.frags.back().gPos;
      }
      if (g < 0) g = 0;
      if (ge > c.L) ge = c.L;
      if (ge <= g) continue;
      c.host_planes_dirty = true;
      if (c.emit_segments) {
        c.multi_diff[g]++;
        c.multi_diff[ge]--;
      } else {
        for (; g < ge; g++) if (c.multi_hit[g] < MAX_ALLELE) c.multi_hit[g]++;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// chunk driver (ref: ReadMapping.cpp:416-646; pipeline/engine.py)
// ---------------------------------------------------------------------------
static const i64 MIN_INV = 1000, MAX_INV = 10000000, MIN_TNL = 1000;

static void build_read(const Ctx& c, Read& rd,
                       const i32* seed_rpos, const i64* seed_gpos,
                       const i32* seed_len, i32 n_seeds) {
  vector<FragPair> sp;
  sp.reserve(n_seeds + 1);
  for (i32 i = 0; i < n_seeds; i++) {
    FragPair fp;
    fp.simple = true;
    fp.rPos = seed_rpos[i];
    fp.gPos = seed_gpos[i];
    fp.rLen = fp.gLen = seed_len[i];
    fp.PosDiff = fp.gPos - fp.rPos;
    sp.push_back(std::move(fp));
  }
  std::stable_sort(sp.begin(), sp.end(), [](const FragPair& a, const FragPair& b) {
    if (a.PosDiff == b.PosDiff) return a.rPos < b.rPos;
    return a.PosDiff < b.PosDiff;
  });
  FragPair sent;
  sent.simple = true;
  sent.rPos = 0; sent.rLen = sent.gLen = 0;
  sent.gPos = sent.PosDiff = c.two_l;
  sp.push_back(std::move(sent));
  rd.cans = simple_pair_clustering(c, rd.rlen, sp);
}

// Synthesize the fast-path candidate (class FAST from
// ops/chain_device.py): a two-block all-M frag chain in final
// (post-reversal) order, carrying the exact values the generic
// pairing / SAM / coordinate code reads from real candidates:
// frags[0].PosDiff = pd, frags[0].gPos = pd (fwd) / pd + rplast (rev),
// get_aln_coordinate = pd (fwd) / pd + rlen - 1 (rev).
static void build_read_fast(const Ctx& c, Read& rd, i64 pd, i32 mm,
                            i32 rplast, i32 cscore) {
  rd.fast_pd = pd;
  rd.fast_mm = mm;
  rd.fast_rplast = rplast;
  AlnCan can;
  can.fast = true;
  can.score = cscore;               // cluster score until "alignment"
  can.orientation = pd < c.L;
  FragPair f1, f2;
  f1.simple = f2.simple = true;
  f1.rPos = 0; f1.gPos = pd; f1.PosDiff = pd;
  f1.rLen = f1.gLen = rplast;
  f2.rPos = rplast; f2.gPos = pd + rplast; f2.PosDiff = pd;
  f2.rLen = f2.gLen = rd.rlen - rplast;
  if (rplast == 0) can.frags.push_back(std::move(f2));
  else if (can.orientation) {
    can.frags.push_back(std::move(f1));
    can.frags.push_back(std::move(f2));
  } else {
    can.frags.push_back(std::move(f2));
    can.frags.push_back(std::move(f1));
  }
  rd.cans.push_back(std::move(can));
}

extern "C" {

void* mc_create(const char* refseq, i64 genome_size,
                const i64* bkeys, const i32* bchrom, i32 n_boundaries,
                const char* chrom_names_concat, const i64* chrom_lens,
                const i64* chrom_fwd_locs, i32 n_chroms) {
  Ctx* c = new Ctx();
  c->ref = refseq;
  c->L = genome_size;
  c->two_l = genome_size * 2;
  c->bkeys.assign(bkeys, bkeys + n_boundaries);
  c->bchrom.assign(bchrom, bchrom + n_boundaries);
  const char* p = chrom_names_concat;
  for (i32 i = 0; i < n_chroms; i++) {
    Chrom ch;
    ch.name = p;
    p += ch.name.size() + 1;
    ch.len = chrom_lens[i];
    ch.fwd_loc = chrom_fwd_locs[i];
    c->chroms.push_back(std::move(ch));
  }
  return c;
}

void mc_destroy(void* ctx) { delete (Ctx*)ctx; }

void mc_set_profile(void* ctx, i32* a, i32* cc, i32* g, i32* t, i32* multi,
                    i32* rc, i32* f1, i32* r2, i32* f2, i32* r1) {
  Ctx* c = (Ctx*)ctx;
  c->acgt[0] = a; c->acgt[1] = cc; c->acgt[2] = g; c->acgt[3] = t;
  c->multi_hit = multi; c->read_count = rc;
  c->F1 = f1; c->R2 = r2; c->F2 = f2; c->R1 = r1;
}

void mc_configure(void* ctx, i32 max_pos_diff, double max_mismatch_rate,
                  i32 max_clip_size, i32 max_duplicate, i32 use_nw,
                  i32 unique_only, i32 vcf_output, i32 sam_output, i32 fastq) {
  Ctx* c = (Ctx*)ctx;
  c->max_pos_diff = max_pos_diff;
  c->max_mismatch_rate = max_mismatch_rate;
  c->max_clip_size = max_clip_size;
  c->max_duplicate = max_duplicate;
  c->use_nw = use_nw != 0;
  c->unique_only = unique_only != 0;
  c->vcf_output = vcf_output != 0;
  c->sam_output = sam_output != 0;
  c->fastq = fastq != 0;
}

// Serialized outputs: the caller provides growable buffers through two
// calls — first mc_process returns sizes, then mc_fetch copies them out.
static thread_local ChunkOut g_out;
static thread_local vector<string> g_seq_store;

// Shared per-span pipeline (one 200-read chunk's worth of reads):
// pairing / rescue / alignment / SAM / profile over reads[lo, hi).
static void process_span(Ctx& c, vector<Read>& reads, i32 lo, i32 hi,
                         bool pair_end, i64 avg_dist, ChunkOut& o);

// seqs / quals / headers: concatenated NUL-terminated strings.
// seeds: flat arrays with per-read counts. pair_end != 0 => (even idx =
// mate1, odd = mate2, mate2 seq ALREADY revcomped by caller).
void mc_process_chunk(void* ctx, i32 n_reads, i32 pair_end,
                      const char* seqs, const char* quals, const char* headers,
                      const i32* rlens, const i32* seed_counts,
                      const i32* seed_rpos, const i64* seed_gpos,
                      const i32* seed_len, i64 avg_dist,
                      i64* out_sizes /*[8]*/) {
  Ctx& c = *(Ctx*)ctx;
  ChunkOut& o = g_out;
  o = ChunkOut();
  vector<Read> reads(n_reads);
  {
    const char* sp = seqs;
    const char* qp = quals;
    const char* hp = headers;
    i64 soff = 0;
    for (i32 i = 0; i < n_reads; i++) {
      reads[i].seq = sp; sp += rlens[i] + 1;
      reads[i].qual = qp; qp += strlen(qp) + 1;
      reads[i].header = hp; hp += strlen(hp) + 1;
      reads[i].rlen = rlens[i];
      i32 ns = seed_counts[i];
      build_read(c, reads[i], seed_rpos + soff, seed_gpos + soff,
                 seed_len + soff, ns);
      soff += ns;
    }
  }
  process_span(c, reads, 0, n_reads, pair_end && n_reads % 2 == 0, avg_dist, o);
  out_sizes[0] = o.mapped_num;
  out_sizes[1] = o.paired_num;
  out_sizes[2] = o.dist_sum;
  out_sizes[3] = o.rlen_sum;
  out_sizes[4] = (i64)o.sam.size();
  out_sizes[5] = (i64)o.events.size();
  out_sizes[6] = (i64)o.inv_sites.size();
  out_sizes[7] = (i64)o.tnl_sites.size();
}

}  // extern "C"

static void process_span(Ctx& c, vector<Read>& reads, i32 lo, i32 hi,
                         bool pair_end, i64 avg_dist, ChunkOut& o) {
  i32 n_reads = hi;
  if (pair_end) {
    for (i32 i = lo; i + 1 < n_reads; i += 2) {
      Read& r1 = reads[i];
      Read& r2 = reads[i + 1];
      i64 tp0 = now_ns();
      for (auto& can : r1.cans) can.paired_idx = -1;
      for (auto& can : r2.cans) can.paired_idx = -1;
      i64 est = (i64)(avg_dist * 1.5);
      int n = check_paired_distance(est, r1.cans, r2.cans);
      if (n == 0) n = alignment_rescue(c, est, r1, r2);
      if (n == 0) { remove_redundant(r1.cans); remove_redundant(r2.cans); }
      else mask_unpaired(r1.cans, r2.cans);
      i64 tp1 = now_ns();
      prof_add(1, tp1 - tp0);
      if (produce_read_alignment(c, r1)) o.mapped_num++;
      if (produce_read_alignment(c, r2)) o.mapped_num++;
      prof_add(2, now_ns() - tp1);
      CoorPair cp = gen_coordinate_pair(r1.cans, r2.cans);
      if (cp.dist != 0 && cp.g1 != -1 && cp.g2 != -1) {
        if (cp.g1 < c.L && cp.g2 >= c.L) {
          if (c.vcf_output) {
            i64 d = llabs(c.two_l - cp.g1 - cp.g2);
            if (d > MIN_INV && d < MAX_INV) {
              c.discord_gpos = cp.g1;
              o.inv_sites.push_back({c.discord_gpos, d});
            }
          }
        } else if (cp.g1 >= c.L && cp.g2 < c.L) {
          if (c.vcf_output) {
            i64 d = llabs(c.two_l - cp.g1 - cp.g2);
            if (d > MIN_INV && d < MAX_INV) c.discord_gpos = cp.g2;
            // brace bug (ref: ReadMapping.cpp:502): push regardless
            o.inv_sites.push_back({c.discord_gpos, d});
          }
        } else if (cp.dist > MIN_TNL) {
          if (c.vcf_output) {
            if (cp.g1 < c.L && cp.g2 < c.L) {
              o.tnl_sites.push_back({cp.g1, cp.dist});
              o.tnl_sites.push_back({cp.g2, cp.dist});
              c.discord_gpos = cp.g2;
            } else if (cp.g1 >= c.L && cp.g2 >= c.L) {
              o.tnl_sites.push_back({c.two_l - cp.g1, cp.dist});
              o.tnl_sites.push_back({c.two_l - cp.g2, cp.dist});
              c.discord_gpos = c.two_l - cp.g2;
            }
          }
        } else {
          o.rlen_sum += r1.rlen + r2.rlen;
          o.paired_num++;
          o.dist_sum += cp.dist;
        }
      }
    }
    if (c.sam_output)
      for (i32 i = lo; i + 1 < n_reads; i += 2)
        append_sam_paired(c, reads[i], reads[i + 1], o.sam);
    if (c.vcf_output) {
      i64 tv0 = now_ns();
      for (i32 i = lo; i < n_reads; i++) {
        Read& rd = reads[i];
        if (rd.score == 0) continue;
        if (check_aln_number(rd.cans) == 1)
          update_profile(c, i % 2 == 0, rd, o.events, i);
        else update_multi_hit(c, rd);
      }
      prof_add(3, now_ns() - tv0);
    }
  } else {
    for (i32 i = lo; i < n_reads; i++) {
      Read& rd = reads[i];
      remove_redundant(rd.cans);
      if (produce_read_alignment(c, rd)) o.mapped_num++;
    }
    if (c.sam_output)
      for (i32 i = lo; i < n_reads; i++) append_sam_single(c, reads[i], o.sam);
    if (c.vcf_output) {
      for (i32 i = lo; i < n_reads; i++) {
        Read& rd = reads[i];
        if (rd.score == 0) continue;
        if (check_aln_number(rd.cans) == 1) update_profile(c, true, rd, o.events, i);
        else update_multi_hit(c, rd);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// stream runtime: native FASTQ/FASTA parsing + double-buffered batch store
// (replaces the Python per-read hot path; ref: GetData.cpp:22-145 parsing,
//  tools.cpp:45-55 mate-2 revcomp, ReadMapping.cpp:434-448 chunk loop)
// ---------------------------------------------------------------------------

struct StreamRead {
  string header, seq, qual;
};

struct Batch {
  vector<StreamRead> reads;
  i32 n = 0;
  // set when the batch is handed to the device pipeline; the host read
  // data must stay alive until mc_slot_release. Reusing a busy slot
  // would silently overwrite reads of a batch still in flight.
  bool busy = false;
};

struct Input {
  const char* buf = nullptr;
  i64 len = 0;
  i64 pos = 0;
  bool fastq = true;
};

// single source of truth for the parser ring size (exported via
// mc_parser_slots; Python must not hard-code it)
static const i32 kParserSlots = 16;

struct Stream {
  Input in1, in2;
  bool paired_files = false;
  bool pair_interleaved = false;
  Batch slot[kParserSlots];
};

static thread_local Stream g_stream;

// bounds-checked slot access: an out-of-range index is a host-side
// logic bug that previously wrapped silently (& 15) and corrupted
// in-flight read data — fail loudly instead.
static Batch& slot_ref(i32 idx) {
  if (idx < 0 || idx >= kParserSlots) {
    fprintf(stderr, "[mc_native] FATAL: parser slot %d out of range [0,%d)\n",
            idx, kParserSlots);
    abort();
  }
  return g_stream.slot[idx];
}

// header trim (ref: GetData.cpp:3-20 / io/fastq.py _trim_header):
// strip leading '@'/'>' run, cut at space / '/' / non-printable, <=100 chars
static void trim_header(const char* s, i64 n, string& out) {
  i64 i = 0;
  while (i < n && (s[i] == '@' || s[i] == '>')) i++;
  i64 j = i;
  i64 limit = n < 100 ? n : 100;
  while (j < limit) {
    unsigned char ch = (unsigned char)s[j];
    if (ch == ' ' || ch == '/' || ch < 0x21 || ch == 0x7f) break;
    j++;
  }
  out.assign(s + i, j - i);
}

static inline i64 line_end(const Input& in, i64 p) {
  const char* nl = (const char*)memchr(in.buf + p, '\n', in.len - p);
  return nl ? nl - in.buf : in.len;
}

static inline i64 rstrip(const Input& in, i64 s, i64 e) {
  while (e > s && (in.buf[e - 1] == '\r' || in.buf[e - 1] == '\n')) e--;
  return e;
}

// parse one record; returns false at EOF / truncated record
static bool parse_one(Input& in, StreamRead& rd) {
  if (in.pos >= in.len) return false;
  if (in.fastq) {
    i64 h0 = in.pos, h1 = line_end(in, h0);
    if (h1 >= in.len) return false;
    i64 s0 = h1 + 1, s1 = line_end(in, s0);
    i64 p0 = s1 < in.len ? s1 + 1 : in.len;
    i64 p1 = p0 < in.len ? line_end(in, p0) : in.len;
    i64 q0 = p1 < in.len ? p1 + 1 : in.len;
    i64 q1 = q0 < in.len ? line_end(in, q0) : in.len;
    in.pos = q1 < in.len ? q1 + 1 : in.len;
    i64 se = rstrip(in, s0, s1);
    if (se <= s0) return false;
    trim_header(in.buf + h0, rstrip(in, h0, h1) - h0, rd.header);
    rd.seq.assign(in.buf + s0, se - s0);
    i64 qe = rstrip(in, q0, q1);
    rd.qual.assign(in.buf + q0, qe - q0);
    return true;
  }
  // FASTA: '>' header + sequence lines until next '>' (multi-line)
  while (in.pos < in.len && in.buf[in.pos] != '>') in.pos = line_end(in, in.pos) + 1;
  if (in.pos >= in.len) return false;
  i64 h0 = in.pos, h1 = line_end(in, h0);
  trim_header(in.buf + h0, rstrip(in, h0, h1) - h0, rd.header);
  rd.seq.clear();
  rd.qual.clear();
  i64 p = h1 < in.len ? h1 + 1 : in.len;
  while (p < in.len && in.buf[p] != '>') {
    i64 e = line_end(in, p);
    i64 ee = rstrip(in, p, e);
    rd.seq.append(in.buf + p, ee - p);
    p = e < in.len ? e + 1 : in.len;
  }
  in.pos = p;
  return !rd.seq.empty();
}

// mate-2 transform (ref: tools.cpp:45-55): revcomp seq, reverse qual
static void reverse_orientation(StreamRead& rd) {
  string rc(rd.seq.size(), 'N');
  for (size_t i = 0, n = rd.seq.size(); i < n; i++)
    rc[i] = COMP[(unsigned char)rd.seq[n - 1 - i]];
  rd.seq.swap(rc);
  std::reverse(rd.qual.begin(), rd.qual.end());
}

extern "C" {

// buffers are borrowed: the caller must keep them alive for the whole run.
// fastq sniffing by first byte ('@' => FASTQ), per file (GetData.cpp:22).
void mc_set_input(void* ctx, const char* buf1, i64 len1,
                  const char* buf2, i64 len2, i32 pair_interleaved) {
  (void)ctx;
  Stream& st = g_stream;
  st = Stream();
  st.in1 = {buf1, len1, 0, len1 > 0 && buf1[0] == '@'};
  st.paired_files = buf2 != nullptr;
  if (st.paired_files) st.in2 = {buf2, len2, 0, len2 > 0 && buf2[0] == '@'};
  st.pair_interleaved = pair_interleaved != 0;
}

// parse up to max_reads reads into a slot; returns count (0 => EOF).
// paired modes emit (mate1, mate2-revcomped) interleaved.
i32 mc_next_batch(void* ctx, i32 slot_idx, i32 max_reads, i32* out_maxlen) {
  (void)ctx;
  Stream& st = g_stream;
  Batch& b = slot_ref(slot_idx);
  if (b.busy) {
    // the batch previously parsed into this slot is still in flight;
    // refusing beats the silent overwrite (returns -1: caller raises)
    *out_maxlen = 0;
    return -1;
  }
  if ((i32)b.reads.size() < max_reads) b.reads.resize(max_reads);
  i32 n = 0;
  i32 maxlen = 0;
  bool paired = st.paired_files || st.pair_interleaved;
  while (n < max_reads) {
    if (paired) {
      if (n + 2 > max_reads) break;
      StreamRead& r1 = b.reads[n];
      StreamRead& r2 = b.reads[n + 1];
      if (!parse_one(st.in1, r1)) break;
      if (!parse_one(st.paired_files ? st.in2 : st.in1, r2)) break;
      reverse_orientation(r2);
      maxlen = std::max<i32>(maxlen, (i32)std::max(r1.seq.size(), r2.seq.size()));
      n += 2;
    } else {
      StreamRead& r = b.reads[n];
      if (!parse_one(st.in1, r)) break;
      maxlen = std::max<i32>(maxlen, (i32)r.seq.size());
      n += 1;
    }
  }
  b.n = n;
  b.busy = n > 0;
  *out_maxlen = maxlen;
  return n;
}

// ring-size contract + in-flight release (paired with mc_next_batch)
i32 mc_parser_slots(void) { return kParserSlots; }

void mc_slot_release(void* ctx, i32 slot_idx) {
  (void)ctx;
  slot_ref(slot_idx).busy = false;
}

// fill the device input matrix: codes[cap][bucket] padded with 4, rlens.
// reads longer than bucket get rlen = -len (caller falls back per read).
void mc_batch_codes(void* ctx, i32 slot_idx, unsigned char* codes,
                    i32* rlens, i32 bucket, i32 cap) {
  (void)ctx;
  Batch& b = slot_ref(slot_idx);
  memset(codes, 4, (size_t)cap * bucket);
  for (i32 i = 0; i < b.n; i++) {
    const string& s = b.reads[i].seq;
    i32 len = (i32)s.size();
    if (len > bucket) { rlens[i] = -len; continue; }
    rlens[i] = len;
    unsigned char* row = codes + (size_t)i * bucket;
    for (i32 j = 0; j < len; j++) row[j] = NT4[(unsigned char)s[j]];
  }
  for (i32 i = b.n; i < cap; i++) rlens[i] = 0;
}

// fill the device input matrix with 2-bit packed codes (4 bases/byte):
// packed[cap][bucket/4]; rlens[i] = -len marks host-fallback reads
// (longer than the bucket, or containing non-ACGT bases — the packed
// form cannot represent N).
void mc_batch_codes_packed(void* ctx, i32 slot_idx, unsigned char* packed,
                           i32* rlens, i32 bucket, i32 cap) {
  (void)ctx;
  Batch& b = slot_ref(slot_idx);
  i32 wb = bucket / 4;
  memset(packed, 0, (size_t)cap * wb);
  for (i32 i = 0; i < b.n; i++) {
    const string& s = b.reads[i].seq;
    i32 len = (i32)s.size();
    if (len > bucket) { rlens[i] = -len; continue; }
    unsigned char* row = packed + (size_t)i * wb;
    bool ok = true;
    for (i32 j = 0; j < len; j++) {
      unsigned char code = NT4[(unsigned char)s[j]];
      // N crumbs stay 0 but are never read: emit_seg splits segments at
      // non-ACGT bases and rlens<0 routes seeding to the host oracle
      if (code > 3) { ok = false; continue; }
      row[j >> 2] |= code << ((j & 3) * 2);
    }
    rlens[i] = ok ? len : -len;
  }
  for (i32 i = b.n; i < cap; i++) rlens[i] = 0;
}

// copy one read's raw seq out (oracle-fallback path for too-long reads);
// copies at most `cap` bytes, returns the full length so the caller can
// resize its buffer and retry when cap was too small
i32 mc_read_seq(void* ctx, i32 slot_idx, i32 i, char* buf, i32 cap) {
  (void)ctx;
  const string& s = slot_ref(slot_idx).reads[i].seq;
  size_t n = s.size() < (size_t)cap ? s.size() : (size_t)cap;
  memcpy(buf, s.data(), n);
  return (i32)s.size();
}

// process a parsed batch in READ_CHUNK_SIZE(=200)-read sub-chunks with the
// reference's running avg_dist semantics (engine.py:147-156): totals update
// after each sub-chunk; avg_dist = round(dist_sum/paired) once paired>1000.
// stats_io[6]: total_reads, mapped, paired, dist_sum, rlen_sum, avg_dist.
void mc_process_batch(void* ctx, i32 slot_idx, i32 pair_end, i32 fastq,
                      const i32* seed_counts, const i32* seed_rpos,
                      const i64* seed_gpos, const i32* seed_len,
                      i64* stats_io, i64* out_sizes /*[8]*/) {
  Ctx& c = *(Ctx*)ctx;
  Batch& b = slot_ref(slot_idx);
  c.fastq = fastq != 0;
  ChunkOut& o = g_out;
  o = ChunkOut();
  i32 n = b.n;
  i64 t0 = now_ns();
  vector<Read> reads(n);
  i64 soff = 0;
  for (i32 i = 0; i < n; i++) {
    Read& rd = reads[i];
    rd.seq = b.reads[i].seq.c_str();
    rd.qual = b.reads[i].qual.c_str();
    rd.header = b.reads[i].header.c_str();
    rd.rlen = (i32)b.reads[i].seq.size();
    build_read(c, rd, seed_rpos + soff, seed_gpos + soff, seed_len + soff,
               seed_counts[i]);
    soff += seed_counts[i];
  }
  i64 t1 = now_ns();
  prof_add(0, t1 - t0);
  prof_add(7, n);
  bool paired = pair_end != 0;
  const i32 CHUNK = 200;
  for (i32 lo = 0; lo < n; lo += CHUNK) {
    i32 hi = std::min(n, lo + CHUNK);
    i64 pn0 = o.paired_num, ds0 = o.dist_sum;
    i64 mn0 = o.mapped_num, rs0 = o.rlen_sum;
    process_span(c, reads, lo, hi, paired && (hi - lo) % 2 == 0,
                 stats_io[5], o);
    stats_io[0] += hi - lo;
    stats_io[1] += o.mapped_num - mn0;
    stats_io[2] += o.paired_num - pn0;
    stats_io[3] += o.dist_sum - ds0;
    stats_io[4] += o.rlen_sum - rs0;
    if (stats_io[2] > 1000)
      stats_io[5] = (i64)((double)stats_io[3] / stats_io[2] + 0.5);
  }
  prof_add(5, now_ns() - t1);
  out_sizes[0] = o.mapped_num;
  out_sizes[1] = o.paired_num;
  out_sizes[2] = o.dist_sum;
  out_sizes[3] = o.rlen_sum;
  out_sizes[4] = (i64)o.sam.size();
  out_sizes[5] = (i64)o.events.size();
  out_sizes[6] = (i64)o.inv_sites.size();
  out_sizes[7] = (i64)o.tnl_sites.size();
}

// Classified batch processing: the device already chained + classified
// every read (ops/chain_device.py). cls: 0=NOCAND (no candidates — the
// host pipeline would produce none), 1=FAST (diagonal-identity
// candidate synthesized from pd/mm/rplast/cscore), 2=SLOW (real seeds
// follow in the flat arrays, exactly as mc_process_batch).
void mc_set_ops_mode(void* ctx, i32 on) {
  ((Ctx*)ctx)->ops_mode = on != 0;
}

// per-batch device-evidence output: the admitted-fast-read bitmask
void mc_fast_bits(void* ctx, i64* n_words, uint32_t* fbits) {
  Ctx& c = *(Ctx*)ctx;
  n_words[0] = (i64)c.fast_bits.size();
  if (fbits) memcpy(fbits, c.fast_bits.data(), c.fast_bits.size() * 4);
}

void mc_process_batch_cls(void* ctx, i32 slot_idx, i32 pair_end, i32 fastq,
                          const i32* cls, const i64* pd, const i32* mm,
                          const i32* rplast, const i32* cscore,
                          const i32* seed_counts, const i32* seed_rpos,
                          const i64* seed_gpos, const i32* seed_len,
                          i64* stats_io, i64* out_sizes /*[8]*/) {
  Ctx& c = *(Ctx*)ctx;
  Batch& b = slot_ref(slot_idx);
  c.fastq = fastq != 0;
  ChunkOut& o = g_out;
  o = ChunkOut();
  i32 n = b.n;
  if (c.ops_mode) c.fast_bits.assign(((size_t)n + 31) / 32, 0u);
  i64 t0 = now_ns();
  vector<Read> reads(n);
  i64 soff = 0;
  for (i32 i = 0; i < n; i++) {
    Read& rd = reads[i];
    rd.seq = b.reads[i].seq.c_str();
    rd.qual = b.reads[i].qual.c_str();
    rd.header = b.reads[i].header.c_str();
    rd.rlen = (i32)b.reads[i].seq.size();
    if (cls[i] == 1)
      build_read_fast(c, rd, pd[i], mm[i], rplast[i], cscore[i]);
    else if (cls[i] == 2) {
      build_read(c, rd, seed_rpos + soff, seed_gpos + soff, seed_len + soff,
                 seed_counts[i]);
    }
    // cls 0: no candidates; cans stay empty
    soff += seed_counts[i];
  }
  i64 t1 = now_ns();
  prof_add(0, t1 - t0);
  prof_add(7, n);
  bool paired = pair_end != 0;
  const i32 CHUNK = 200;
  for (i32 lo = 0; lo < n; lo += CHUNK) {
    i32 hi = std::min(n, lo + CHUNK);
    i64 pn0 = o.paired_num, ds0 = o.dist_sum;
    i64 mn0 = o.mapped_num, rs0 = o.rlen_sum;
    process_span(c, reads, lo, hi, paired && (hi - lo) % 2 == 0,
                 stats_io[5], o);
    stats_io[0] += hi - lo;
    stats_io[1] += o.mapped_num - mn0;
    stats_io[2] += o.paired_num - pn0;
    stats_io[3] += o.dist_sum - ds0;
    stats_io[4] += o.rlen_sum - rs0;
    if (stats_io[2] > 1000)
      stats_io[5] = (i64)((double)stats_io[3] / stats_io[2] + 0.5);
  }
  prof_add(5, now_ns() - t1);
  out_sizes[0] = o.mapped_num;
  out_sizes[1] = o.paired_num;
  out_sizes[2] = o.dist_sum;
  out_sizes[3] = o.rlen_sum;
  out_sizes[4] = (i64)o.sam.size();
  out_sizes[5] = (i64)o.events.size();
  out_sizes[6] = (i64)o.inv_sites.size();
  out_sizes[7] = (i64)o.tnl_sites.size();
}

// ---- two-phase classified batch: device gapped-extension support ----
// phase 1 builds the reads + collects DP-triggering normal pairs (dry
// pass); Python aligns them in one Pallas batch (ops/nw_device.py /
// ops/ksw2_device.py, bit-identical to the scalar aligners); phase 2
// runs the pipeline, which consumes the cache in process_normal_pair.
struct PreparedCls {
  vector<Read> reads;
  i32 slot = 0;
  bool paired = false;
  bool fastq = true;
};
static thread_local PreparedCls g_prep;

i64 mc_prepare_batch_cls(void* ctx, i32 slot_idx, i32 pair_end, i32 fastq,
                         const i32* cls, const i64* pd, const i32* mm,
                         const i32* rplast, const i32* cscore,
                         const i32* seed_counts, const i32* seed_rpos,
                         const i64* seed_gpos, const i32* seed_len) {
  Ctx& c = *(Ctx*)ctx;
  Batch& b = slot_ref(slot_idx);
  i32 n = b.n;
  i64 t0 = now_ns();
  g_prep.reads.assign((size_t)n, Read());
  g_prep.slot = slot_idx;
  g_prep.paired = pair_end != 0;
  g_prep.fastq = fastq != 0;
  if (c.ops_mode) c.fast_bits.assign(((size_t)n + 31) / 32, 0u);
  c.dp_cache.clear();
  c.dp_pending.clear();
  i64 soff = 0;
  for (i32 i = 0; i < n; i++) {
    Read& rd = g_prep.reads[i];
    rd.seq = b.reads[i].seq.c_str();
    rd.qual = b.reads[i].qual.c_str();
    rd.header = b.reads[i].header.c_str();
    rd.rlen = (i32)b.reads[i].seq.size();
    if (cls[i] == 1)
      build_read_fast(c, rd, pd[i], mm[i], rplast[i], cscore[i]);
    else if (cls[i] == 2) {
      build_read(c, rd, seed_rpos + soff, seed_gpos + soff, seed_len + soff,
                 seed_counts[i]);
      collect_dp_pairs(c, rd);
    }
    soff += seed_counts[i];
  }
  prof_add(0, now_ns() - t0);
  prof_add(7, n);
  return (i64)c.dp_pending.size();
}

void mc_dp_sizes(void* ctx, i32* qlens, i32* tlens) {
  Ctx& c = *(Ctx*)ctx;
  for (size_t i = 0; i < c.dp_pending.size(); i++) {
    qlens[i] = (i32)c.dp_pending[i].first.size();
    tlens[i] = (i32)c.dp_pending[i].second.size();
  }
}

void mc_dp_fetch(void* ctx, char* qbuf, char* tbuf) {
  Ctx& c = *(Ctx*)ctx;
  for (auto& pr : c.dp_pending) {
    memcpy(qbuf, pr.first.data(), pr.first.size());
    qbuf += pr.first.size();
    memcpy(tbuf, pr.second.data(), pr.second.size());
    tbuf += pr.second.size();
  }
}

// packed 2-bit traceback ops from the device kernels; mode 0 = NW
// (ops walked from (m, n) back to the origin), mode 1 = ksw2
// (cigar from (tlen-1, qlen-1), applied reversed from the front)
void mc_dp_put_ops(void* ctx, const uint32_t* words, i32 wpp, i32 mode) {
  Ctx& c = *(Ctx*)ctx;
  for (size_t pi = 0; pi < c.dp_pending.size(); pi++) {
    const std::string& s1 = c.dp_pending[pi].first;
    const std::string& s2 = c.dp_pending[pi].second;
    const uint32_t* w = words + pi * wpp;
    std::string a1 = s1, a2 = s2;
    if (mode == 0) {
      i64 i = (i64)s1.size(), j = (i64)s2.size();
      int k = 0;
      while (i > 0 || j > 0) {
        int d = (int)((w[k >> 4] >> ((k & 15) * 2)) & 3);
        if (d == 1) { a1.insert((size_t)i, 1, '-'); j--; }
        else if (d == 2) { a2.insert((size_t)j, 1, '-'); i--; }
        else { i--; j--; }
        k++;
      }
    } else {
      i64 i = (i64)s2.size() - 1, j = (i64)s1.size() - 1;
      std::vector<char> cig;
      int k = 0;
      while (i >= 0 || j >= 0) {
        int d = (int)((w[k >> 4] >> ((k & 15) * 2)) & 3);
        cig.push_back("MDI"[d]);
        if (d == 0) { i--; j--; }
        else if (d == 1) i--;
        else j--;
        k++;
      }
      size_t pos = 0;
      for (auto it = cig.rbegin(); it != cig.rend(); ++it) {
        if (*it == 'D') a1.insert(pos, 1, '-');
        else if (*it == 'I') a2.insert(pos, 1, '-');
        pos++;
      }
    }
    c.dp_cache[s1 + '\x01' + s2] = {std::move(a1), std::move(a2)};
  }
}

// aligned '-'-padded pairs, concatenated; alens[i] = padded length of
// pair i (aln1 and aln2 have equal length)
void mc_dp_put(void* ctx, const char* abuf, const char* bbuf,
               const i32* alens) {
  Ctx& c = *(Ctx*)ctx;
  for (size_t i = 0; i < c.dp_pending.size(); i++) {
    auto& pr = c.dp_pending[i];
    std::string key = pr.first + '\x01' + pr.second;
    i32 ln = alens[i];
    c.dp_cache[key] = {std::string(abuf, (size_t)ln),
                       std::string(bbuf, (size_t)ln)};
    abuf += ln;
    bbuf += ln;
  }
}

void mc_finish_batch_cls(void* ctx, i64* stats_io, i64* out_sizes /*[8]*/) {
  Ctx& c = *(Ctx*)ctx;
  c.fastq = g_prep.fastq;
  ChunkOut& o = g_out;
  o = ChunkOut();
  vector<Read>& reads = g_prep.reads;
  i32 n = (i32)reads.size();
  i64 t1 = now_ns();
  const i32 CHUNK = 200;
  for (i32 lo = 0; lo < n; lo += CHUNK) {
    i32 hi = std::min(n, lo + CHUNK);
    i64 pn0 = o.paired_num, ds0 = o.dist_sum;
    i64 mn0 = o.mapped_num, rs0 = o.rlen_sum;
    process_span(c, reads, lo, hi, g_prep.paired && (hi - lo) % 2 == 0,
                 stats_io[5], o);
    stats_io[0] += hi - lo;
    stats_io[1] += o.mapped_num - mn0;
    stats_io[2] += o.paired_num - pn0;
    stats_io[3] += o.dist_sum - ds0;
    stats_io[4] += o.rlen_sum - rs0;
    if (stats_io[2] > 1000)
      stats_io[5] = (i64)((double)stats_io[3] / stats_io[2] + 0.5);
  }
  prof_add(5, now_ns() - t1);
  c.dp_cache.clear();
  c.dp_pending.clear();
  out_sizes[0] = o.mapped_num;
  out_sizes[1] = o.paired_num;
  out_sizes[2] = o.dist_sum;
  out_sizes[3] = o.rlen_sum;
  out_sizes[4] = (i64)o.sam.size();
  out_sizes[5] = (i64)o.events.size();
  out_sizes[6] = (i64)o.inv_sites.size();
  out_sizes[7] = (i64)o.tnl_sites.size();
}

// enable diff mode: matched-base accumulation becomes +1/-1 endpoints
// on exact_diff; F/multi counters become diff arrays (all i32[L+1]).
void mc_set_diff_mode(void* ctx, i32* f1d, i32* r2d, i32* f2d, i32* r1d,
                      i32* multid, i32* exactd) {
  Ctx* c = (Ctx*)ctx;
  c->f_diff[0] = f1d; c->f_diff[1] = r2d; c->f_diff[2] = f2d; c->f_diff[3] = r1d;
  c->multi_diff = multid;
  c->exact_diff = exactd;
  c->emit_segments = f1d != nullptr;
}

// whether any HOST plane/diff array received evidence this run (lets
// the device-evidence merge skip its O(L) nonzero scans when clean)
i32 mc_host_planes_dirty(void* ctx) {
  return ((Ctx*)ctx)->host_planes_dirty ? 1 : 0;
}

// clear the per-run accumulators so one Ctx (and its borrowed numpy
// planes, memset by Python) can serve repeated runs without the
// multi-GB reallocation — re-faulting genome-sized arrays costs tens
// of seconds on this VM class, and long-running/server use should pay
// plane allocation once per process, not per run
void mc_reset_run(void* ctx) {
  Ctx* c = (Ctx*)ctx;
  c->discord_gpos = 0;
  c->host_planes_dirty = false;
  c->ops_mode = false;   // the next run re-opts-in via mc_set_ops_mode
  c->fast_bits.clear();
  c->dp_cache.clear();
  c->dp_pending.clear();
}

// copy out SAM text + events + discord sites from the last mc_process_chunk
void mc_fetch(void* ctx, char* sam_buf, i64* ev_gpos, i32* ev_kind,
              i32* ev_seq_len, char* ev_seq_concat,
              i64* inv_gpos, i64* inv_dist, i64* tnl_gpos, i64* tnl_dist) {
  ChunkOut& o = g_out;
  memcpy(sam_buf, o.sam.data(), o.sam.size());
  char* sp = ev_seq_concat;
  for (size_t i = 0; i < o.events.size(); i++) {
    ev_gpos[i] = o.events[i].gpos;
    ev_kind[i] = o.events[i].kind;
    ev_seq_len[i] = (i32)o.events[i].seq.size();
    memcpy(sp, o.events[i].seq.data(), o.events[i].seq.size());
    sp += o.events[i].seq.size();
  }
  for (size_t i = 0; i < o.inv_sites.size(); i++) {
    inv_gpos[i] = o.inv_sites[i].first;
    inv_dist[i] = o.inv_sites[i].second;
  }
  for (size_t i = 0; i < o.tnl_sites.size(); i++) {
    tnl_gpos[i] = o.tnl_sites[i].first;
    tnl_dist[i] = o.tnl_sites[i].second;
  }
}

i64 mc_event_seq_total(void* ctx) {
  i64 t = 0;
  for (auto& e : g_out.events) t += (i64)e.seq.size();
  return t;
}

// SA-IS suffix-array construction (offline index build). The reference
// uses BWT-SW incremental construction (ref: src/BWT_Index/bwt_gen.c);
// here a linear-time SA-IS over the full text replaces it — the .bwt /
// sampled-SA artifacts are derived from SA on the Python side
// (index/suffix.py keeps the NumPy prefix-doubling fallback as oracle).
// int32 positions: texts up to 2^31-1 (fwd+rc of a ~1 Gbp genome).

}  // extern "C" (template below must have C++ linkage)

template <typename TC, typename I>
static void sais_core(const TC* T, I* SA, I n, I K, I* unused) {
  (void)unused;
  if (n == 1) { SA[0] = 0; return; }
  vector<unsigned char> stype(n);
  stype[n - 1] = 1;  // sentinel is S
  for (I i = n - 2; i >= 0; i--)
    stype[i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && stype[i + 1])) ? 1 : 0;
  auto is_lms = [&](I i) { return i > 0 && stype[i] && !stype[i - 1]; };
  vector<I> cnt(K, 0), bkt(K);
  for (I i = 0; i < n; i++) cnt[T[i]]++;

  // 1) place LMS suffixes at bucket ends (arbitrary order), induce
  std::fill(SA, SA + n, -1);
  {
    I acc = 0;
    for (I c = 0; c < K; c++) { acc += cnt[c]; bkt[c] = acc; }
    for (I i = n - 1; i >= 1; i--)
      if (is_lms(i)) SA[--bkt[T[i]]] = i;
  }
  {
    // induce with -1 guards
    I acc = 0;
    bkt[0] = 0;
    for (I c = 1; c < K; c++) bkt[c] = bkt[c - 1] + cnt[c - 1];
    for (I i = 0; i < n; i++) {
      I j = SA[i];
      if (j > 0 && !stype[j - 1]) SA[bkt[T[j - 1]]++] = j - 1;
    }
    acc = 0;
    for (I c = 0; c < K; c++) { acc += cnt[c]; bkt[c] = acc; }
    for (I i = n - 1; i >= 0; i--) {
      I j = SA[i];
      if (j > 0 && stype[j - 1]) SA[--bkt[T[j - 1]]] = j - 1;
    }
  }

  // 2) name sorted LMS substrings
  I n1 = 0;
  for (I i = 0; i < n; i++)
    if (SA[i] > 0 && is_lms(SA[i])) SA[n1++] = SA[i];
  I* s1 = SA + n1;                 // reuse tail of SA for names
  std::fill(s1, SA + n, -1);
  I name = 0;
  I prev = -1;
  for (I i = 0; i < n1; i++) {
    I pos = SA[i];
    bool diff = false;
    if (prev < 0) diff = true;
    else {
      for (I d = 0; ; d++) {
        if (T[pos + d] != T[prev + d] || stype[pos + d] != stype[prev + d]) {
          diff = true; break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          diff = !(is_lms(pos + d) && is_lms(prev + d));
          break;
        }
      }
    }
    if (diff) { name++; prev = pos; }
    s1[(pos >> 1)] = name - 1;
  }
  vector<I> lms_pos;
  lms_pos.reserve(n1);
  vector<I> t1;
  t1.reserve(n1);
  for (I i = 1; i < n; i++)
    if (is_lms(i)) lms_pos.push_back(i);
  for (I i = 0; i < (I)lms_pos.size(); i++)
    t1.push_back(s1[lms_pos[i] >> 1]);

  // 3) order LMS suffixes: recurse if names collide. When the reduced
  // problem fits int32, downcast the recursion (halves the workspace of
  // every level below — the dominant build-RSS term at multi-Gbp scale).
  vector<I> sa1(n1);
  if (name < n1) {
    if (sizeof(I) == 8 && n1 < (I)INT32_MAX && name < (I)INT32_MAX) {
      vector<i32> t32(n1), sa32(n1);
      for (I i = 0; i < n1; i++) t32[i] = (i32)t1[i];
      sais_core<i32, i32>(t32.data(), sa32.data(), (i32)n1, (i32)name,
                          (i32*)nullptr);
      for (I i = 0; i < n1; i++) sa1[i] = sa32[i];
    } else {
      sais_core<I, I>(t1.data(), sa1.data(), n1, name, (I*)nullptr);
    }
  } else {
    for (I i = 0; i < n1; i++) sa1[t1[i]] = i;
  }

  // 4) final induced sort from correctly ordered LMS suffixes
  std::fill(SA, SA + n, -1);
  {
    I acc = 0;
    for (I c = 0; c < K; c++) { acc += cnt[c]; bkt[c] = acc; }
    for (I i = n1 - 1; i >= 0; i--) {
      I j = lms_pos[sa1[i]];
      SA[--bkt[T[j]]] = j;
    }
  }
  {
    bkt[0] = 0;
    for (I c = 1; c < K; c++) bkt[c] = bkt[c - 1] + cnt[c - 1];
    for (I i = 0; i < n; i++) {
      I j = SA[i];
      if (j > 0 && !stype[j - 1]) SA[bkt[T[j - 1]]++] = j - 1;
    }
    I acc = 0;
    for (I c = 0; c < K; c++) { acc += cnt[c]; bkt[c] = acc; }
    for (I i = n - 1; i >= 0; i--) {
      I j = SA[i];
      if (j > 0 && stype[j - 1]) SA[--bkt[T[j - 1]]] = j - 1;
    }
  }
}

// ---- memory-lean SA-IS -------------------------------------------------
// Same induced-sort algorithm as sais_core (Nong, Zhang & Chan 2009) but
// with the workspace formulation used by lean implementations: the
// reduced problem, its suffix array, and the regenerated LMS positions
// all live INSIDE the caller's SA buffer, and the bucket array reuses
// the free SA tail (heap fallback only when it doesn't fit). Per level
// the only allocation is the n-byte type map, so peak build memory is
//   8(n+1) [SA] + n [text] + ~1.5n [nested type maps]  ~= 11.5 B/char
// instead of sais_core's ~27 B/char (whose level-1 vectors t1/lms_pos/
// sa1 dominated the 98 GB RSS at 2.2e9 rows, BIG_GENOME.json). This is
// the TPU-era answer to the reference's blockwise BWT-SW builder
// (ref: src/BWT_Index/bwt_gen.c:1436,1601 — 10 MB increments, no full
// SA in RAM): we do keep the full SA (the device seeding path wants it
// resident), but construction overhead beyond the artifact itself is
// now ~3.5 B/char. sais_core above is retained as the test oracle.
template <typename TC, typename I>
static void sais_lean(const TC* T, I* SA, I n, I K,
                      I* tail, i64 tail_slots) {
  if (n == 1) { SA[0] = 0; return; }
  vector<I> heapB;
  I* B;
  if (tail != nullptr && tail_slots >= (i64)K) B = tail;
  else { heapB.resize(K); B = heapB.data(); }
  vector<unsigned char> stype(n);
  stype[n - 1] = 1;
  for (I i = n - 2; i >= 0; i--)
    stype[i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && stype[i + 1])) ? 1 : 0;
  auto is_lms = [&](I i) { return i > 0 && stype[i] && !stype[i - 1]; };
  // bucket boundaries recomputed from T on every use (two O(n) scans per
  // induce pass) so ONE K-entry array suffices instead of cnt+bkt
  auto buckets = [&](bool end) {
    for (I c = 0; c < K; c++) B[c] = 0;
    for (I i = 0; i < n; i++) B[T[i]]++;
    I acc = 0;
    if (end) { for (I c = 0; c < K; c++) { acc += B[c]; B[c] = acc; } }
    else { for (I c = 0; c < K; c++) { I t = B[c]; B[c] = acc; acc += t; } }
  };
  auto induce = [&]() {
    buckets(false);
    for (I i = 0; i < n; i++) {
      I j = SA[i];
      if (j > 0 && !stype[j - 1]) SA[B[T[j - 1]]++] = j - 1;
    }
    buckets(true);
    for (I i = n - 1; i >= 0; i--) {
      I j = SA[i];
      if (j > 0 && stype[j - 1]) SA[--B[T[j - 1]]] = j - 1;
    }
  };

  // 1) place LMS suffixes at bucket ends (text order), induce: after
  // this the LMS suffixes appear in LMS-substring-sorted order
  std::fill(SA, SA + n, (I)-1);
  buckets(true);
  for (I i = n - 1; i >= 1; i--)
    if (is_lms(i)) SA[--B[T[i]]] = i;
  induce();

  // 2) compact the sorted LMS positions into SA[0..n1) (dest index never
  // passes the scan index, so the sweep is in-place safe)
  I n1 = 0;
  for (I i = 0; i < n; i++)
    if (SA[i] > 0 && is_lms(SA[i])) SA[n1++] = SA[i];

  // name sorted LMS substrings; names land at SA[n1 + pos/2] (disjoint
  // from SA[0..n1) since pos/2 >= 0 and LMS positions are >= 2 apart)
  I* s1 = SA + n1;
  std::fill(s1, SA + n, (I)-1);
  I name = 0, prev = -1;
  for (I i = 0; i < n1; i++) {
    I pos = SA[i];
    bool diff = false;
    if (prev < 0) diff = true;
    else {
      for (I d = 0; ; d++) {
        if (T[pos + d] != T[prev + d] || stype[pos + d] != stype[prev + d]) {
          diff = true; break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          diff = !(is_lms(pos + d) && is_lms(prev + d));
          break;
        }
      }
    }
    if (diff) { name++; prev = pos; }
    s1[pos >> 1] = name - 1;
  }
  // compact names (increasing text order) into RA = SA[n1..2*n1)
  {
    I w = 0;
    for (I i = n1; i < n && w < n1; i++)
      if (SA[i] >= 0) SA[n1 + w++] = SA[i];
  }
  I* RA = SA + n1;

  // 3) order the LMS suffixes: recurse on the reduced string when names
  // collide. SA[0..n1) is the recursion's buffer; SA[2*n1..n) its free
  // tail. When the reduced problem fits int32, reinterpret the SA
  // prefix as i32 lanes (halves level-1 time and bandwidth).
  if (name < n1) {
    if (sizeof(I) == 8 && n1 < (I)INT32_MAX && name < (I)INT32_MAX) {
      i32* V = reinterpret_cast<i32*>(SA);
      for (I i = 0; i < n1; i++) V[n1 + i] = (i32)SA[n1 + i];
      sais_lean<i32, i32>(V + n1, V, (i32)n1, (i32)name,
                          V + 2 * n1, (i64)2 * (n - n1));
      for (I i = n1 - 1; i >= 0; i--) SA[i] = (I)V[i];
      // RA (the i64 view) was clobbered by the i32 copy; step 4
      // regenerates it below, so nothing to restore
    } else {
      sais_lean<I, I>(RA, SA, n1, name, SA + 2 * n1, (i64)(n - 2 * n1));
    }
  } else {
    for (I i = 0; i < n1; i++) SA[RA[i]] = i;
  }

  // 4) regenerate LMS positions in text order into RA, translate ranks
  // to positions, place at bucket ends (descending rank: each write
  // lands at a slot >= the read index), induce the final order
  {
    I w = 0;
    for (I i = 1; i < n; i++)
      if (is_lms(i)) RA[w++] = i;
  }
  for (I i = 0; i < n1; i++) SA[i] = RA[SA[i]];
  std::fill(SA + n1, SA + n, (I)-1);
  buckets(true);
  for (I i = n1 - 1; i >= 0; i--) {
    I j = SA[i];
    SA[i] = (I)-1;
    SA[--B[T[j]]] = j;
  }
  induce();
}

extern "C" {
// text: 2-bit codes (0..3), length n. Fills sa[n] with the suffix order
// of the text WITHOUT a sentinel row (matching index/suffix.py).
extern "C" {
void mc_build_suffix_array(const unsigned char* text, i64 n, i32* sa) {
  vector<unsigned char> T(n + 1);
  for (i64 i = 0; i < n; i++) T[i] = text[i] + 1;
  T[n] = 0;  // unique smallest sentinel
  vector<i32> SA(n + 1);
  sais_lean<unsigned char, i32>(T.data(), SA.data(), (i32)(n + 1), 5,
                                nullptr, 0);
  // SA[0] is the sentinel suffix; the rest is the sentinel-free order
  memcpy(sa, SA.data() + 1, n * sizeof(i32));
}

// sais_core kept callable as the cross-check oracle for the lean builder
// (the SA of a string is unique, so equality is a complete test)
void mc_build_sa_full_oracle(const unsigned char* text, i64 n,
                             i32* sa_full) {
  vector<unsigned char> T(n + 1);
  for (i64 i = 0; i < n; i++) T[i] = text[i] + 1;
  T[n] = 0;
  sais_core<unsigned char, i32>(T.data(), sa_full, (i32)(n + 1), 5, nullptr);
}

// int64 variant for texts >= 2^31 (human-scale fwd+rc). Same linear
// algorithm; the text rides as uint8 and the recursion downcasts to
// int32 once the reduced problem fits, so build RSS is ~9 B/char at the
// top level instead of the naive 25 B/char.
void mc_build_suffix_array64(const unsigned char* text, i64 n, i64* sa) {
  vector<unsigned char> T(n + 1);
  for (i64 i = 0; i < n; i++) T[i] = text[i] + 1;
  T[n] = 0;
  vector<i64> SA(n + 1);
  sais_lean<unsigned char, i64>(T.data(), SA.data(), n + 1, (i64)5,
                                nullptr, 0);
  memcpy(sa, SA.data() + 1, n * sizeof(i64));
}

// Full-SA direct builds: write the FULL suffix array (sentinel row 0
// included, sa_full[0] == n — the index/fmindex.py sa_full convention)
// straight into the caller's buffer, avoiding the extra n*wordsize copy
// the sentinel-free entry points pay.
void mc_build_sa_full(const unsigned char* text, i64 n, i32* sa_full) {
  vector<unsigned char> T(n + 1);
  for (i64 i = 0; i < n; i++) T[i] = text[i] + 1;
  T[n] = 0;
  sais_lean<unsigned char, i32>(T.data(), sa_full, (i32)(n + 1), 5,
                                nullptr, 0);
}

void mc_build_sa_full64(const unsigned char* text, i64 n, i64* sa_full) {
  vector<unsigned char> T(n + 1);
  for (i64 i = 0; i < n; i++) T[i] = text[i] + 1;
  T[n] = 0;
  sais_lean<unsigned char, i64>(T.data(), sa_full, n + 1, (i64)5,
                                nullptr, 0);
}

// Streaming BWT + Occ-checkpoint derivation from the full SA — replaces
// the NumPy temporaries of index/suffix.py bwt_from_sa + pack_words +
// the ckpt reduceat (each O(n) extra arrays) with one O(1)-memory pass.
//   sa_full: i32 or i64 [n+1] (is64 selects), text: codes[n]
//   bwt_words: u32[ceil(n/16)] (bwa bit order: base j at bits (15-j%16)*2)
//   ckpt: i64[(ceil(n/128)+1)*4], ckpt[b] = per-base counts in bwt[0:128b)
//   aux[0] <- primary (full row of the suffix at text position 0)
}
}  // extern "C" x2 (template needs C++ linkage)
template <typename I>
static void derive_bwt_stream(const I* sa_full, const unsigned char* text,
                              i64 n, uint32_t* bwt_words, i64* ckpt,
                              i64* aux) {
  i64 nblocks = (n + 127) / 128;
  i64 c4[4] = {0, 0, 0, 0};
  i64 j = 0;                 // $-removed BWT index
  uint32_t word = 0;
  memset(ckpt, 0, 4 * sizeof(i64));   // ckpt[0] = 0
  for (i64 r = 0; r <= n; r++) {
    i64 p = (i64)sa_full[r];
    int ch;
    if (r == 0) ch = text[n - 1];
    else if (p == 0) { aux[0] = r; continue; }   // primary row: '$', skipped
    else ch = text[p - 1];
    word |= (uint32_t)ch << ((15 - (j & 15)) << 1);
    if ((j & 15) == 15) { bwt_words[j >> 4] = word; word = 0; }
    c4[ch]++;
    j++;
    if ((j & 127) == 0) memcpy(ckpt + (j >> 7) * 4, c4, sizeof(c4));
  }
  if (j & 15) bwt_words[j >> 4] = word;
  for (i64 b = (j >> 7) + ((j & 127) ? 1 : 0); b <= nblocks; b++)
    memcpy(ckpt + b * 4, c4, sizeof(c4));
}

extern "C" {
extern "C" {
void mc_derive_bwt(const void* sa_full, i32 is64, const unsigned char* text,
                   i64 n, uint32_t* bwt_words, i64* ckpt, i64* aux) {
  if (is64) derive_bwt_stream<i64>((const i64*)sa_full, text, n, bwt_words,
                                   ckpt, aux);
  else derive_bwt_stream<i32>((const i32*)sa_full, text, n, bwt_words,
                              ckpt, aux);
}

// 3-step occ table build (see index/occ3.py for layout + conventions):
// one pass over n+1 rows, 64 running counters, checkpoint every 16 rows.
// rows: i32[nw3 * 72] zeroed by the caller; sa: i32[n+1]; text: codes[n].
void mc_build_occ3(const i32* sa, const unsigned char* text, i64 n,
                   i32* rows, i64 nw3, i32* c3_first /*[64]*/,
                   i64* aux /*[2]: row_p1, row_p2*/) {
  i32 cnt[64] = {0};
  aux[0] = aux[1] = -1;
  for (i64 w = 0; w < nw3; w++) {
    i32* row = rows + w * 72;
    memcpy(row, cnt, sizeof(cnt));
    unsigned char* syms = (unsigned char*)(row + 64);
    for (i64 q = 0; q < 16; q++) {
      i64 j = w * 16 + q;
      int sym = 255;
      if (j <= n) {
        i64 p = sa[j];
        if (p == 1) aux[0] = j;
        if (p == 2) aux[1] = j;
        if (p >= 3)
          sym = text[p - 3] * 16 + text[p - 2] * 4 + text[p - 1];
      }
      syms[q] = (unsigned char)sym;
      if (sym < 64) cnt[sym]++;
    }
  }
  // c3_first[d] = first row whose suffix starts with 3-gram d: 64 binary
  // searches on the base-5 suffix-start key (pad 0 => short-first order)
  auto key = [&](i64 j) -> int {
    i64 p = sa[j];
    int k0 = p < n ? text[p] + 1 : 0;
    int k1 = p + 1 < n ? text[p + 1] + 1 : 0;
    int k2 = p + 2 < n ? text[p + 2] + 1 : 0;
    return k0 * 25 + k1 * 5 + k2;
  };
  for (int d = 0; d < 64; d++) {
    int dk = ((d >> 4) + 1) * 25 + (((d >> 2) & 3) + 1) * 5 + ((d & 3) + 1);
    i64 lo = 0, hi = n + 1;   // first j with key(j) >= dk
    while (lo < hi) {
      i64 mid = (lo + hi) >> 1;
      if (key(mid) < dk) lo = mid + 1; else hi = mid;
    }
    c3_first[d] = (i32)lo;
  }
}

// int64 / sharded variant for >2^31-row texts (human-scale fwd+rc;
// ref index types are uint64 end to end, src/BWT_Index/bwt.h:44).
// Row counts are stored RELATIVE to the owning shard's base counts so
// the 288 B row stays int32 (a shard slice spans < 2^31 rows); the
// absolute count is base3[shard][d] + row[d], recombined on device in
// the x64 kernels. words_per_shard: occ3 words per shard (<=0 => one
// shard, absolute rows). base3: i64[n_shards*64]; c3_first: i64[64].
void mc_build_occ3_64(const i64* sa, const unsigned char* text, i64 n,
                      i32* rows, i64 nw3, i64 words_per_shard,
                      i64* base3, i64* c3_first, i64* aux);

// int32-SA wrapper: texts < 2^31 rows store sa_full as int32 — reading
// it directly avoids a 16 GB astype(int64) host copy at 1 Gbp scale
// (the first HUMAN_SCALE attempt OOM'd on exactly such staging copies)
void mc_build_occ3_64s(const void* sa, i32 sa_is32,
                       const unsigned char* text, i64 n,
                       i32* rows, i64 nw3, i64 words_per_shard,
                       i64* base3, i64* c3_first, i64* aux) {
  if (!sa_is32) {
    mc_build_occ3_64((const i64*)sa, text, n, rows, nw3, words_per_shard,
                     base3, c3_first, aux);
    return;
  }
  const i32* sa32 = (const i32*)sa;
  i64 wps = words_per_shard > 0 ? words_per_shard : nw3;
  i64 cnt[64] = {0};
  const i64* base = base3;
  aux[0] = aux[1] = -1;
  for (i64 w = 0; w < nw3; w++) {
    if (w % wps == 0) {
      i64* b = base3 + (w / wps) * 64;
      memcpy(b, cnt, sizeof(cnt));
      base = b;
    }
    i32* row = rows + w * 72;
    for (int d = 0; d < 64; d++) row[d] = (i32)(cnt[d] - base[d]);
    unsigned char* syms = (unsigned char*)(row + 64);
    for (i64 q = 0; q < 16; q++) {
      i64 j = w * 16 + q;
      int sym = 255;
      if (j <= n) {
        i64 p = (i64)sa32[j];
        if (p == 1) aux[0] = j;
        if (p == 2) aux[1] = j;
        if (p >= 3)
          sym = text[p - 3] * 16 + text[p - 2] * 4 + text[p - 1];
      }
      syms[q] = (unsigned char)sym;
      if (sym < 64) cnt[sym]++;
    }
  }
  auto key = [&](i64 j) -> int {
    i64 p = (i64)sa32[j];
    int k0 = p < n ? text[p] + 1 : 0;
    int k1 = p + 1 < n ? text[p + 1] + 1 : 0;
    int k2 = p + 2 < n ? text[p + 2] + 1 : 0;
    return k0 * 25 + k1 * 5 + k2;
  };
  for (int d = 0; d < 64; d++) {
    int dk = ((d >> 4) + 1) * 25 + (((d >> 2) & 3) + 1) * 5 + ((d & 3) + 1);
    i64 lo = 0, hi = n + 1;
    while (lo < hi) {
      i64 mid = (lo + hi) >> 1;
      if (key(mid) < dk) lo = mid + 1; else hi = mid;
    }
    c3_first[d] = lo;
  }
}

void mc_build_occ3_64(const i64* sa, const unsigned char* text, i64 n,
                      i32* rows, i64 nw3, i64 words_per_shard,
                      i64* base3, i64* c3_first, i64* aux) {
  i64 wps = words_per_shard > 0 ? words_per_shard : nw3;
  i64 cnt[64] = {0};
  const i64* base = base3;   // current shard's base counts
  aux[0] = aux[1] = -1;
  for (i64 w = 0; w < nw3; w++) {
    if (w % wps == 0) {      // new shard: snapshot base counts
      i64* b = base3 + (w / wps) * 64;
      memcpy(b, cnt, sizeof(cnt));
      base = b;
    }
    i32* row = rows + w * 72;
    for (int d = 0; d < 64; d++) row[d] = (i32)(cnt[d] - base[d]);
    unsigned char* syms = (unsigned char*)(row + 64);
    for (i64 q = 0; q < 16; q++) {
      i64 j = w * 16 + q;
      int sym = 255;
      if (j <= n) {
        i64 p = sa[j];
        if (p == 1) aux[0] = j;
        if (p == 2) aux[1] = j;
        if (p >= 3)
          sym = text[p - 3] * 16 + text[p - 2] * 4 + text[p - 1];
      }
      syms[q] = (unsigned char)sym;
      if (sym < 64) cnt[sym]++;
    }
  }
  auto key = [&](i64 j) -> int {
    i64 p = sa[j];
    int k0 = p < n ? text[p] + 1 : 0;
    int k1 = p + 1 < n ? text[p + 1] + 1 : 0;
    int k2 = p + 2 < n ? text[p + 2] + 1 : 0;
    return k0 * 25 + k1 * 5 + k2;
  };
  for (int d = 0; d < 64; d++) {
    int dk = ((d >> 4) + 1) * 25 + (((d >> 2) & 3) + 1) * 5 + ((d & 3) + 1);
    i64 lo = 0, hi = n + 1;
    while (lo < hi) {
      i64 mid = (lo + hi) >> 1;
      if (key(mid) < dk) lo = mid + 1; else hi = mid;
    }
    c3_first[d] = lo;
  }
}
}  // extern "C"

// standalone aligner entries (for tests)
void mc_nw(const char* s1, const char* s2, char* o1, char* o2) {
  string a1 = s1, a2 = s2;
  nw_align(a1, a2);
  strcpy(o1, a1.c_str());
  strcpy(o2, a2.c_str());
}

void mc_ksw2(const char* s1, const char* s2, char* o1, char* o2) {
  string a1 = s1, a2 = s2;
  ksw2_align(a1, a2);
  strcpy(o1, a1.c_str());
  strcpy(o2, a2.c_str());
}

}  // extern "C"
