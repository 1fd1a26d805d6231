#!/usr/bin/env python3
"""Variants of the routed and 64-bit occ3 seed scans (csrc/seed_scan.cu,
seed_scan3_routed_kernel and seed_scan3_big_kernel) timed on the main
data's batch 0, to see what sets their floor and to choose the lane-group
form's geometry. Needs one CUDA card and nvcc.

    git show 9a4a85f:mapcaller_tpu_torch/csrc/seed_scan.cu \
        > _checkouts/seed_scan_thread.cu
    python3 seed_scan_variants.py [--before=_checkouts/seed_scan_thread.cu] \
        VARIANT [VARIANT ...]

The thread-a-read forms are the source as it was before the lane-group
redesign (commit 9a4a85f), given by --before:
  thread    that source unedited: both kernels a thread a read
            (scan3_read over ShardRows / ShardRows64)
  loads     timing only, a thread a read: each read runs as many two-row
            steps as the thread form's gathers give it (rows / 2), each
            loading both rows' 17 vectors (and with the 64-bit table a
            base-table word of each) and xoring them; the next row index
            is drawn from the xor. The loads without the sums
  sums      timing only, a thread a read: the same steps, each sums3's
            arithmetic for two in-row offsets over one row held in
            registers; the next step's trinucleotide, order key and
            offsets are drawn from the sums. The sums without the loads
Any other variant is tokens joined by "_", each an edit of the source as
it is:
  G<n>      lanes a read of both kernels' group form (ROUTED_GROUP and
            BIG_GROUP: 2 to 32); Gr<n>, Gb<n> of one of them
  M<n>      both kernels' __launch_bounds__ ask for n blocks an SM (M0:
            name no count); Mr<n>, Mb<n> one of them
  div       the 64-bit kernel finds a row's shard by a 64-bit integer
            division, not by the double-precision quotient
  persist   persistent groups: as many blocks as the SMs hold, each group
            drawing its next read from an atomic counter (zeroed by a
            memset before each launch, which the time includes)
  flat      seed_scan3_kernel (the main path's unrouted scan) in the group
            form too, at ROUTED_GROUP lanes, with the fused prefix skip
            added to the group's start step
"source" is the source unedited. Each variant is compiled with the port's nvcc flags, all at once. The reads
are batch 0 of a main-path run of chip_smoke.py's main data (100,000
simulated pairs, mapcaller_tpu_torch.simulator): its first 2,048, 4,096,
8,192, 16,384 and 32,768 reads, each scanned over a 2-shard and a 4-shard
table on this card (the -shards tables, and the big_x64 tables built a
shard at a time). For each: the plain routed versions' step and gather
counts (max and mean steps a read) and the byte bound from the gathers;
then each variant's queued device ms (chip_smoke.cuda_ms) and whether its
outputs equal the plain version's in every word (None for the timing-only
forms), its ptxas reports, and the unrouted kernel on the same reads
(without the prefix skip) and on the whole batch as the main path
launches it. Prints the card's name and power limit, then one JSON line.
"""
import os
import re
import sys

import kernel_variants as kv

SRC = os.path.join(kv.HERE, "mapcaller_tpu_torch", "csrc", "seed_scan.cu")
KERNELS = ("seed_scan3_routed_kernel", "seed_scan3_big_kernel",
           "seed_scan3_kernel")
READS = (2048, 4096, 8192, 16384, 32768)
SHARDS = (2, 4)

BEFORE = ("thread", "loads", "sums")     # forms of the --before source
# a group launch's geometry, and a routed kernel's launch bounds
GROUP_GRID = re.compile(r"(seed_scan3_\w+_kernel)<<<group_blocks\(B, (\w+)\)")
ROUTED_BOUNDS = {
    kern: re.compile(rf"__launch_bounds__\(THREADS(, \w+)?\)\n"
                     rf"seed_scan3_{kern}_kernel\(")
    for kern in ("routed", "big")}
# the --before source's routed kernels' call of the thread form
THREAD_CALL = ("scan3_read(src, c3_first, L2, packed, rlens, max_len, cap, "
               "k, o, r);")
KERNEL_MARK = "__global__ void __launch_bounds__(THREADS)\nseed_scan3_kernel("
FLAT_BODY = """  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= lanes) return;
  const bool queue = lanes < o.B;
  // lanes mode: each lane takes the next unread read until none is left
  for (int r = queue ? atomicAdd(next, 1) : t; r < o.B;
       r = queue ? atomicAdd(next, 1) : o.B)
    scan3_read(FlatRows{rows}, c3_first, L2, packed, rlens, max_len, cap, k,
               o, r);
"""

# FlatRows as the group form reads a table (flat)
FLAT_ROWS = "struct FlatRows {\n"
FLAT_ROWS_GROUP = """struct FlatRows {
  static constexpr bool kBase = false;
  using Index = int;
  using UIndex = unsigned;
"""
# the group form's start step, and with scan3_read's fused prefix skip
GROUP_START = """    if (!in_ext) {                      // no prefix skip: the 1-base init
      if (pos >= rlen - MIN_SEED_LEN) break;         // done
      const int c = word_code(words, min(pos, last));
      x0 = l2<I>(L2, c) + 1;
      x1 = l2<I>(L2, 3 - c) + 1;
      x2 = l2<I>(L2, c + 1) - l2<I>(L2, c);
      ext_pos = pos + 1;
"""
GROUP_START_PREFIX = """    if (!in_ext) {
      if (pos >= rlen - MIN_SEED_LEN) break;         // done
      const int p = min(pos, last);
      bool jump = false;
      if constexpr (std::is_same_v<Src, FlatRows>) if (k.pfx_base > 0) {
        const int key = word_key(words, max_len >> 4, p, k.pfx_k);
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
"""

# the timing-only forms: a thread a read, o.rows[r] (the thread form's
# gathers, filled in before the launch) / 2 steps; each writes its final
# hash to n_seeds so that nothing is optimised away
TIMING_ONLY = r'''
template <class Src>
__device__ __forceinline__ typename Src::UIndex draw(unsigned h,
                                                     unsigned long long n) {
  return (typename Src::UIndex)(((unsigned long long)h * n) >> 32);
}

template <class Src>
__device__ __forceinline__ void scan3_loads(const Src& src,
                                            const long long* __restrict__ L2,
                                            const Out& o, int r) {
  using U = typename Src::UIndex;
  const unsigned long long n = (unsigned long long)__ldg(L2 + 4);
  const int steps = o.rows[r] >> 1;
  unsigned h = (unsigned)r * 2654435761u + 12345u;
  U ik = draw<Src>(h, n);
  for (int t = 0; t < steps; ++t) {
    const U il = min(ik + (U)(h & 15u), (U)n);
    const int4* Rk = src.row(ik >> 4);
    const int4* Rl = src.row(il >> 4);
    unsigned a = h;
#pragma unroll
    for (int j = 0; j < 17; ++j) {
      const int4 v = __ldg(Rk + j), u = __ldg(Rl + j);
      a ^= (unsigned)(v.x ^ v.y ^ v.z ^ v.w ^ u.x ^ u.y ^ u.z ^ u.w);
    }
    if constexpr (Src::kBase)
      a ^= (unsigned)__ldg(src.counts(ik >> 4) + (t & 63)) ^
           (unsigned)__ldg(src.counts(il >> 4) + B3X_REV + (t & 63));
    h = a * 2654435761u + (unsigned)t;
    ik = draw<Src>(h, n);
  }
  o.n_seeds[r] = h;
}

template <class Src>
__device__ __forceinline__ void scan3_sums(const Src& src,
                                           const long long* __restrict__ L2,
                                           const Out& o, int r) {
  const unsigned long long n = (unsigned long long)__ldg(L2 + 4);
  unsigned h = (unsigned)r * 2654435761u + 12345u;
  const int4* R = src.row(draw<Src>(h, n) >> 4);
  int4 v[17];
#pragma unroll
  for (int j = 0; j < 17; ++j) v[j] = __ldg(R + j);
  const int steps = o.rows[r] >> 1;
  for (int t = 0; t < steps; ++t) {
    const int d = (int)(h & 63u), w = (int)((h >> 6) & 63u);
    int acc = 0;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int m = (int)((h >> (12 + 4 * side)) & 15u);
      int base = 0, rs = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int dd = 4 * j + q;
          const int r3 = 63 - ((dd & 3) * 16 + (dd & 12) + (dd >> 4));
          const int c = q == 0 ? v[j].x : q == 1 ? v[j].y
                                        : q == 2 ? v[j].z : v[j].w;
          base += dd == d ? c : 0;
          rs += r3 < w ? c : 0;
        }
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int sym = (int)sym_at(v[16], q);
        const bool in = q < m;
        base += (in && sym == d) ? 1 : 0;
        const int r3 = 63 - ((sym & 3) * 16 + (sym & 12) + (sym >> 4));
        rs += (in && sym < 64 && r3 < w) ? 1 : 0;
      }
      acc = acc * 31 + base * 7 + rs;
    }
    h = (unsigned)acc * 2654435761u + (unsigned)t;
  }
  o.n_seeds[r] = h;
}

'''

PERSIST = r'''
__device__ int g_scan_next;

template <int G, class Src>
__device__ __forceinline__ void scan3_persist(
    const Src& src, const typename Src::Index* __restrict__ c3_first,
    const long long* __restrict__ L2, const uint8_t* __restrict__ packed,
    const int* __restrict__ rlens, int max_len, int cap,
    const Occ3ConstsT<typename Src::Index>& k, const Out& o) {
  const int lane = threadIdx.x % G;
  const unsigned mask = group_mask<G>();
  for (;;) {
    int r = lane == 0 ? atomicAdd(&g_scan_next, 1) : 0;
    r = __shfl_sync(mask, r, 0, G);
    if (r >= o.B) return;
    scan3_group<Src, G>(src, c3_first, L2, packed, rlens, max_len, cap, k,
                        o, r, lane, mask);
  }
}

template <class K>
int persist_blocks(K kernel, cudaStream_t s) {
  int dev = 0, sms = 0, per = 0;
  void* p = nullptr;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS, 0);
  cudaGetSymbolAddress(&p, g_scan_next);
  cudaMemsetAsync(p, 0, sizeof(int), s);
  return sms * per;
}

'''


DOUBLE_SHARD = """    unsigned long long s = (unsigned long long)((double)w * inv_per);
    if (s * per > w)
      --s;
    else if ((s + 1) * per <= w)
      ++s;
    return s;
"""


def sub(pattern, repl, src, count):
    """src with the `count` matches of pattern replaced; raises on any
    other number."""
    out, n = pattern.subn(repl, src)
    if n != count:
        raise ValueError(f"{pattern.pattern!r}: {n} matches, not {count}")
    return out


def set_int(src, name, value):
    """src with its int constant `name = ...` set to value."""
    return sub(re.compile(rf"\b{name} = \d+"), f"{name} = {value}", src, 1)


def variant_source(name, src, before=None):
    """The kernel source edited as variant `name` asks; the thread forms
    (BEFORE) from `before`, the source before the lane-group redesign."""
    if name in BEFORE:
        if before is None:
            raise ValueError(f"variant {name!r} needs --before=PATH")
        if name == "thread":
            return before
        src = kv.edit(before, KERNEL_MARK, TIMING_ONLY + KERNEL_MARK)
        return kv.edit(src, THREAD_CALL, f"scan3_{name}(src, L2, o, r);")
    if name == "source":
        return src
    for tok in name.split("_"):
        if re.fullmatch(r"[GM][rb]?\d+", tok):
            which = {"r": ("routed",), "b": ("big",)}.get(tok[1],
                                                          ("routed", "big"))
            n = tok.lstrip("GMrb")
            for kern in which:
                if tok[0] == "G":
                    src = set_int(src, f"{kern.upper()}_GROUP", n)
                else:
                    bounds = "THREADS" + (f", {n}" if n != "0" else "")
                    src = sub(ROUTED_BOUNDS[kern],
                              f"__launch_bounds__({bounds})\n"
                              f"seed_scan3_{kern}_kernel(", src, 1)
        elif tok == "div":
            src = kv.edit(src, DOUBLE_SHARD, "    return w / per;\n")
        elif tok == "persist":
            src = kv.edit(src, KERNEL_MARK, PERSIST + KERNEL_MARK)
            src = sub(re.compile(r"  scan3_groups<"), "  scan3_persist<",
                      src, 2)
            src = sub(GROUP_GRID,
                      r"\1<<<persist_blocks(\1, (cudaStream_t)stream)", src,
                      2)
        elif tok == "flat":
            src = kv.edit(src, "#include <stdint.h>\n",
                          "#include <stdint.h>\n#include <type_traits>\n")
            src = kv.edit(src, FLAT_ROWS, FLAT_ROWS_GROUP)
            src = kv.edit(src, GROUP_START, GROUP_START_PREFIX)
            src = kv.edit(src, FLAT_BODY, "  scan3_groups<ROUTED_GROUP>("
                          "FlatRows{rows}, c3_first, L2, packed, rlens,\n"
                          "                             max_len, cap, k, o);\n")
            src = kv.edit(src, "  const int blocks = (threads + THREADS - 1)"
                          " / THREADS;\n",
                          "  const int blocks = group_blocks(B, "
                          "ROUTED_GROUP);\n")
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return src


def tables(work, kern):
    """The main data's -shards tables on this card: {("routed" | "big",
    n): the table a shard's launch reads} for n in SHARDS."""
    import dataclasses
    import torch
    from mapcaller_tpu_torch.index.fmindex import load_index
    from mapcaller_tpu_torch.parallel.big_index import build_big_index
    from mapcaller_tpu_torch.parallel.sharded_index import shard_index
    fm3 = kern.fm
    dev = fm3.occ3_rows.device
    flat = dataclasses.replace(fm3, occ3_rows=fm3.occ3_rows[
        :fm3.pfx_base or fm3.occ3_rows.shape[0]], pfx_k=0, pfx_base=0)
    idx = load_index(os.path.join(work, "mci"))
    out = {}
    for n in SHARDS:
        out["routed", n] = shard_index(flat, [dev] * n)[dev]
        out["big", n] = build_big_index(idx, {dev: kern.ctx},
                                        [dev] * n)[dev]
    torch.cuda.synchronize()
    return flat, out


def variants(argv, work):
    import torch
    import chain_variants as cv
    import chip_smoke as cs
    from mapcaller_tpu_torch.ops import seed_scan_device as ssd
    before, names = None, []
    for a in argv:
        if a.startswith("--before="):
            with open(a.split("=", 1)[1]) as f:
                before = f.read()
        else:
            names.append(a)
    libs = kv.build(SRC, names, lambda n, s: variant_source(n, s, before),
                    KERNELS, work)
    kern, packed, rlens = cv.main_path_batch(work, 100_000)
    fm3, max_len, S = kern.fm, kern.max_len, kern.max_seeds
    flat, tabs = tables(work, kern)
    scans = {"routed": (ssd.seed_scan3_routed, ssd.seed_scan3_routed_plain),
             "big": (ssd.seed_scan3_big, ssd.seed_scan3_big_plain)}
    cases, want = {}, {}
    for (kind, n), t in tabs.items():
        for N in READS:
            p, r = packed[:N].contiguous(), rlens[:N].contiguous()
            w = scans[kind][1](t, p, r, max_len, S, with_iters=True)
            steps, rows = w[-2], w[-1]
            bound, by = cs.scan_bound_ms("seed_scan3", N, p.shape[1], S,
                                         int(rows.sum()))
            key = f"{kind}_{n}_{N}"
            want[key] = (t, p, r, w,
                         torch.stack([steps, rows]).to(torch.int32))
            cases[key] = dict(kind=kind, shards=n, reads=N,
                              max_steps=int(steps.max()),
                              mean_steps=float(steps.float().mean()),
                              rows=int(rows.sum()), bound_ms=bound,
                              bound_by=by)
    main_want = ssd.seed_scan3_plain(fm3, packed, rlens, max_len, S)
    outputs = ssd._outputs
    res = {}
    for name, (lib_path, ptxas) in libs.items():
        timing_only = name in ("loads", "sums")
        row = dict(ptxas=ptxas)
        with kv.bound(ssd, lib_path):
            for key, (t, p, r, w, counts) in want.items():
                fn = scans[cases[key]["kind"]][0]
                if timing_only:
                    # the kernel reads each read's gathers from `rows`
                    def filled(B, S_, dev, counts=counts):
                        n_seeds, tab, ovf, _ = outputs(B, S_, dev)
                        return n_seeds, tab, ovf, counts
                    ssd._outputs = filled
                try:
                    got = fn(t, p, r, max_len, S, with_iters=True)
                    torch.cuda.synchronize()
                    row[key] = dict(
                        ms=cs.cuda_ms(lambda: fn(t, p, r, max_len, S), 20,
                                      queued=True),
                        equal=None if timing_only else all(
                            torch.equal(a, b) for a, b in zip(got, w)))
                finally:
                    ssd._outputs = outputs
            for N in READS:
                p, r = packed[:N].contiguous(), rlens[:N].contiguous()
                row[f"unrouted_{N}"] = dict(ms=cs.cuda_ms(
                    lambda: ssd.seed_scan3(flat, p, r, max_len, S), 20,
                    queued=True))
            got = ssd.seed_scan3(fm3, packed, rlens, max_len, S)
            torch.cuda.synchronize()
            row["main_path_batch0"] = dict(
                ms=cs.cuda_ms(lambda: ssd.seed_scan3(
                    fm3, packed, rlens, max_len, S), 20, queued=True),
                equal=all(torch.equal(a, b) for a, b in zip(got, main_want)))
        res[name] = row
    res["floor_ms"] = cs.cuda_ms(lambda: torch.cuda._sleep(0), 50,
                                 queued=True)
    return dict(batch=dict(B=int(packed.shape[0]), max_len=max_len,
                           max_seeds=S, pfx_k=fm3.pfx_k),
                cases=cases, variants=res)


def main(argv=None):
    return kv.run(__doc__, argv, variants)


if __name__ == "__main__":
    sys.exit(main())
