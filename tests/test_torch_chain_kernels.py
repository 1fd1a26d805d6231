"""The chain kernels of the port (mapcaller_tpu_torch/csrc/chain.cu, wrapped
by ops/chain_kernels.py) on the CPU, where no kernel runs:

  * a scalar mirror of each kernel, written as the .cu blocks and threads
    run, is held equal to the plain versions and to the reference
    package's hit expansion, sa_resolve, classify_reads and
    build_seed_chain_kernel (with and without with_planes, pair_end both
    ways, with and without a full SA): the scan's tiles, block scans and
    decoupled look-back (run_look_back, shared with classify+pack) in
    several orders of publication, and its start index; the hits blocks'
    staged freq chunks, binary searches and inverse-Psi walks; the
    classify+pack blocks (mirror_classify_pack) with their tiles
    published in ticket order, aggregates first and at random, groups of
    the kernel's lanes and of one lane, the hits staged at the kernel's
    capacity and at small ones that take several chunks, and tiles whole
    and cut short: a group's ballot and popcount ranks, the window sorted
    by counting ranks, the 16-base words a lane, the prefix of mismatch
    popcounts, the leader's gap walk, the pack's slots from the
    look-back, the count and overflow words and the last tile's totals;
    the start index equals torch.searchsorted over the flat cumsum with
    the total below, at and above H, zero freqs, reads with n_seeds 0 or
    above S and a long run of seedless reads;
  * the cases: more than 8 kept hits, (pd, rpos) ties of different
    lengths, a span across a chromosome boundary, reads at the end of the
    text, the most gaps a window allows (and >= 10 gaps in the gap walk),
    more than 4 mismatches, total raw hits > H and kept slow hits > H2,
    unresolved reads, rlen 0, 496-base reads;
  * the wrappers refuse what the kernels do not take and run the plain
    versions for CPU tensors without counting a launch; the look-back
    scratch is kept per device and its epoch tags never repeat on one
    scratch.

All values are integers: the tolerance is exact equality."""
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.index.packer import PackedReference
from mapcaller_tpu.ops import chain_device as jcd
from mapcaller_tpu.ops import fm_device as jfd
from mapcaller_tpu.ops import fm_search as jfs
from mapcaller_tpu.ops.fm3_device import DeviceFM3 as JaxFM3
from mapcaller_tpu.ops.fm_device import DeviceFMIndex as JaxFM
from mapcaller_tpu.pipeline import device_profile as jdp
from mapcaller_tpu_torch.ops import chain_device as tcd
from mapcaller_tpu_torch.ops import chain_kernels as ck
from mapcaller_tpu_torch.ops import fm_search as tfs
from mapcaller_tpu_torch.ops.fm3_device import DeviceFM3
from mapcaller_tpu_torch.ops.fm_device import DeviceFMIndex
from mapcaller_tpu_torch.ops.seed_scan_device import seed_scan3
from mapcaller_tpu_torch.pipeline import device_profile as tdp

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

B, BUCKET = 256, 128
M32 = 0xFFFFFFFF
CU = os.path.join(os.path.dirname(ck.__file__), "..", "csrc", "chain.cu")
L1, L2 = 14000, 12000       # two chromosomes


def _cu_const(name):
    with open(CU) as f:
        return int(re.search(rf"\b{name} = (\w+);", f.read()).group(1), 0)


SCAN_THREADS, LOOKBACK = _cu_const("SCAN_THREADS"), _cu_const("LOOKBACK")
HITS_GROUP, HITS_ITEMS = _cu_const("HITS_GROUP"), _cu_const("HITS_ITEMS")
CP_READS, CP_GROUP = _cu_const("CP_READS"), _cu_const("CP_GROUP")
CP_HIT_CAP, CP_KEY_CAP = _cu_const("CP_HIT_CAP"), _cu_const("CP_KEY_CAP")


# ---- data ------------------------------------------------------------------

def _pack(mat):
    packed = np.zeros((mat.shape[0], mat.shape[1] // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    return packed


@pytest.fixture(scope="module")
def genome():
    """Two chromosomes (14 + 12 kb) with a 300-bp block repeated 12 times
    (seeds with many hits), and one batch of 256 reads at bucket 128:
    exact, SNP, reverse strand, 2-bp deletion, random, repeat, short,
    across the chromosome boundary, at either end of the text, with 5-9
    spread substitutions, and rlen 0."""
    rng = np.random.default_rng(23)
    n = L1 + L2
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    rep = codes[500:800].copy()
    for k in range(12):
        codes[2000 + 1500 * k:2300 + 1500 * k] = rep
    idx = build_index(None, packed=PackedReference(
        ["chr1", "chr2"], [L1, L2], [0, L1], codes, []))
    text = idx.ref.fwd_rc_codes()
    mat = np.zeros((B, BUCKET), dtype=np.uint8)
    rlens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        ln = int(rng.integers(60, BUCKET + 1))
        p = int(rng.integers(0, n - BUCKET - 2))
        r = codes[p:p + ln + 2].copy()
        kind = b % 11
        if kind == 1:
            r[ln // 2] = (r[ln // 2] + 1) % 4
        elif kind == 2:
            r = (3 - r)[::-1]
        elif kind == 3:
            r = np.concatenate([r[:ln // 2], r[ln // 2 + 2:]])
        elif kind == 4:
            r = rng.integers(0, 4, size=ln + 2).astype(np.uint8)
        elif kind == 5:
            r = codes[2000 + 1500 * (b % 12) + int(rng.integers(0, 100)):][
                :ln + 2].copy()
        elif kind == 6:
            ln = int(rng.integers(4, 17))
        elif kind == 7:                       # across chr1 / chr2
            s = L1 - int(rng.integers(10, ln - 10))
            r = codes[s:s + ln].copy()
        elif kind == 8:                       # at either end of the text
            r = text[2 * n - ln:].copy() if b % 2 else codes[n - ln:].copy()
        elif kind == 9:                       # many spread mismatches
            for j in rng.choice(ln, size=int(rng.integers(5, 10)),
                                replace=False):
                r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        elif kind == 10:
            ln = 0 if b % 2 else ln
        r = r[:ln]
        mat[b, :ln] = r
        rlens[b] = ln
    jfm = JaxFM.from_host(idx)
    tfm = DeviceFMIndex.from_host(idx, device="cpu")
    return dict(idx=idx, mat=mat, rlens=rlens, packed=_pack(mat), jfm=jfm,
                tfm=tfm, jfm0=JaxFM.from_host(idx, sa_budget_bytes=0),
                tfm0=DeviceFMIndex.from_host(idx, device="cpu",
                                             sa_budget_bytes=0),
                jctx=jcd.ChainCtx.from_host(idx),
                tctx=tcd.ChainCtx.from_host(idx, "cpu"))


def _seeds(genome):
    """The batch's seed tables from the port's plain occ3 scan."""
    fm3 = DeviceFM3.from_host(genome["idx"], genome["tfm"], pfx_k=0)
    S = BUCKET // 17 + 2
    return seed_scan3(fm3, torch.from_numpy(genome["packed"]),
                      torch.from_numpy(genome["rlens"]), BUCKET, S)


# ---- the mirrors: each kernel's thread, as csrc/chain.cu runs it ------------

def _popc(x):
    return bin(x & M32).count("1")


def _ffs(x):
    """__ffs: 1 + the index of the lowest set bit, 0 for 0."""
    x &= M32
    return (x & -x).bit_length()


def _brev(x):
    return int(f"{x & M32:032b}"[::-1], 2)


def _i32(x):
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


def block_excl_scan(vals):
    """block_excl_scan: each thread's exclusive prefix over the block and
    the block's total, mod 2^32: shfl_up steps in each warp of 32, then
    over the warp sums."""
    nt = -(-len(vals) // 32) * 32
    inc = list(vals) + [0] * (nt - len(vals))
    for w in range(nt // 32):
        lanes = inc[32 * w:32 * w + 32]
        d = 1
        while d < 32:
            lanes = [(x + (lanes[i - d] if i >= d else 0)) & M32
                     for i, x in enumerate(lanes)]
            d <<= 1
        inc[32 * w:32 * w + 32] = lanes
    warp_sum = [inc[32 * w + 31] for w in range(nt // 32)]
    for w in range(1, len(warp_sum)):
        warp_sum[w] = (warp_sum[w] + warp_sum[w - 1]) & M32
    excl = [((warp_sum[t // 32 - 1] if t >= 32 else 0) + inc[t] - v) & M32
            for t, v in enumerate(vals)]
    return excl, warp_sum[-1]


def _look_back_schedule(order, rng):
    """Which tile moves next: tiles draw tickets in order (each launch its
    own; `ready`: the tiles whose tickets are next), and a started tile
    moves at any time. in_order: each tile runs to its end before the next
    starts; aggregates_first: every tile publishes its aggregate before
    any looks back, the last tile first; random: any started tile."""
    if order == "in_order":
        return lambda ready, live: min(live) if live else min(ready)
    if order == "aggregates_first":
        return lambda ready, live: min(ready) if ready else max(live)
    return lambda ready, live: int(rng.choice(sorted(live) + sorted(ready)))


def run_look_back(ntiles, publish, finish, order="in_order", seed=0,
                  launches=None):
    """The decoupled look-back of csrc/chain.cu over `ntiles` tiles: tiles
    draw tickets in order, and at its ticket a tile runs publish(k) -> its
    aggregate (mod 2^32) and publishes it; then it looks back LOOKBACK
    predecessors at a time to the nearest inclusive prefix, publishes its
    own and runs finish(k, its exclusive prefix). Tiles move in the
    schedule `order`. launches: the tiles of each launch in its ticket
    order, launches drawing side by side over one status array (K1 on
    several cards); default one launch of tiles 0 .. ntiles-1. -> {"prefix":
    look-back windows that found an inclusive prefix, "aggregates":
    windows of aggregates only}."""
    rng = np.random.default_rng(seed)
    nxt = _look_back_schedule(order, rng)
    queues = [list(q) for q in (launches or [range(ntiles)])]
    status = [None] * ntiles                  # None, ("A", v) or ("P", v)
    seen = {"prefix": 0, "aggregates": 0}
    state = {}                                # tile -> its progress
    while len(state) < ntiles or any(s["top"] is not None
                                     for s in state.values()):
        live = [k for k, s in state.items() if s["top"] is not None]
        ready = [q[0] for q in queues if q]
        k = nxt(ready, live)
        if k in ready:                        # draws a ticket, publishes
            queues[[q[:1] for q in queues].index([k])].pop(0)
            agg = publish(k) & M32
            state[k] = dict(agg=agg, excl=0, top=k - 1 if k else None)
            status[k] = ("P", agg) if k == 0 else ("A", agg)
            if k == 0:
                finish(0, 0)
            continue
        s = state[k]
        win = [status[i] if i >= 0 else ("P", 0)
               for i in range(s["top"] - LOOKBACK + 1, s["top"] + 1)]
        if any(x is None for x in win):       # spins: not ready yet
            continue
        pm = [lane for lane, x in enumerate(win) if x[0] == "P"]
        frm = pm[-1] if pm else 0
        s["excl"] = (s["excl"] + sum(x[1] for x in win[frm:])) & M32
        seen["prefix" if pm else "aggregates"] += 1
        if pm:
            status[k] = ("P", (s["excl"] + s["agg"]) & M32)
            s["top"] = None
            finish(k, s["excl"])
        else:
            s["top"] -= LOOKBACK
    return seen


def mirror_scan(B, S=1, freq=None, n=None, cnt=None, tile=SCAN_THREADS,
                H=None, group=HITS_GROUP, order="in_order", seed=0):
    """chain_scan_kernel: tiles of `tile` reads (a thread a read) take
    their index from a ticket, stage and sum their counts, scan them in
    the block and find their prefix by look-back (run_look_back) in the
    schedule `order`. With H the seed-freq scan's start index of
    ceil(H / group) groups. -> (out int64[B+1], start int64[groups, 2] or
    None, the look-back's windows as run_look_back counts them)."""
    ntiles = -(-B // tile)
    out = np.zeros(B + 1, dtype=np.int64)
    ngroups = -(-H // group) if H else 0
    start = np.full((ngroups, 2), -1, dtype=np.int64) if H else None
    tiles = {}

    def staged(b):                            # a read's masked seed freqs
        nv = S if n is None else int(n[b])
        return [int(freq[b, j]) & M32 if j < nv else 0 for j in range(S)]

    def publish(k):
        b0 = k * tile
        rows = [staged(b) if freq is not None else None
                for b in range(b0, min(b0 + tile, B))]
        mine = [sum(r) & M32 if freq is not None else int(cnt[b]) & M32
                for b, r in zip(range(b0, b0 + tile), rows)]
        excl_in, agg = block_excl_scan(mine)
        tiles[k] = dict(rows=rows, excl_in=excl_in, agg=agg)
        return agg

    def finish(k, excl):
        tiles[k]["excl"] = excl

    seen = run_look_back(ntiles, publish, finish, order, seed)
    for k in range(ntiles):
        s, b0 = tiles[k], k * tile
        for t, e in enumerate(s["excl_in"]):
            base = (s["excl"] + e) & M32
            out[b0 + t] = _i32(base)
            if H:
                p = base
                for j, f in enumerate(s["rows"][t]):
                    g = (p + group - 1) // group
                    while g < ngroups and g * group < p + f:
                        start[g] = (b0 * S + t * S + j, _i32(p))
                        g += 1
                    p = (p + f) & M32
    total = (tiles[ntiles - 1]["excl"] + tiles[ntiles - 1]["agg"]) & M32
    out[B] = _i32(total)
    if H:
        for g in range((total + group - 1) // group, ngroups):
            start[g] = (B * S, _i32(total))
    return out, start, seen


def _inv_psi(occ, L2, primary, k):
    kadj = k - (1 if k >= primary else 0)
    row = occ[kadj >> 4]
    word = int(row[4]) & M32
    crumb = (~kadj) & 15
    c = (word >> (crumb << 1)) & 3
    keep = ~((1 << (2 * crumb)) - 1) & 0x55555555
    nx = ~(word ^ (c * 0x55555555)) & M32
    occ_kc = int(row[c]) + _popc(nx & (nx >> 1) & keep)
    return 0 if k == primary else int(L2[c]) + occ_kc


def mirror_hits(tfm, off, start, n_seeds, rpos, slen, x0, freq, H,
                max_walk=192, group=HITS_GROUP, items=HITS_ITEMS,
                resolved_out=None):
    """chain_hits_kernel, a block per group of `group` slots: from the
    group's start entry, stage the masked freqs of `group * items` seeds
    at a time, scan them (items a thread, then block_excl_scan), and let
    each slot find its seed by binary search; then a thread per slot.
    resolved_out (bool[H] or None) gets each slot's resolved flag, as the
    kernel writes it when given the pointer."""
    Bn, S = freq.shape
    BS, chunk = Bn * S, group * items
    occ, L2 = tfm.occ_rows.numpy(), tfm.L2.numpy()
    samp, sa = tfm.sa_samp.numpy(), tfm.sa_full.numpy()
    out = {k: np.zeros(H, dtype=np.int64) for k in ("read", "rpos", "len",
                                                    "loc", "valid", "keep")}
    unres = np.zeros(Bn, dtype=bool)
    nvalid = min(int(off[Bn]), H)
    chunks = 0
    for g in range(-(-H // group)):
        h0 = g * group
        last = min(h0 + group, nvalid) - 1
        seed, pos, found = [BS - 1] * group, [0] * group, [False] * group
        if last >= h0:
            lo, base = int(start[g][0]), int(start[g][1]) & M32
            while True:
                chunks += 1
                v = [0] * chunk
                for e in range(chunk):
                    i = lo + e
                    if i < BS and i % S < int(n_seeds[i // S]):
                        v[e] = int(freq[i // S, i % S]) & M32
                runs = []
                for t in range(group):
                    run = 0
                    for k in range(items):
                        run = (run + v[t * items + k]) & M32
                        v[t * items + k] = run
                    runs.append(run)
                before, ctot = block_excl_scan(runs)
                pre = [(v[e] + before[e // items]) & M32 for e in range(chunk)]
                for t in range(group):
                    h = h0 + t
                    r = (h - base) & M32
                    if h < nvalid and not found[t] and r < ctot:
                        a, z = 0, chunk - 1
                        while a < z:
                            mid = (a + z) >> 1
                            if pre[mid] > r:
                                z = mid
                            else:
                                a = mid + 1
                        seed[t] = lo + a
                        pos[t] = r - (pre[a - 1] if a else 0)
                        found[t] = True
                if (last - base) & M32 < ctot or lo + chunk >= BS:
                    break
                base = (base + ctot) & M32
                lo += chunk
        for t in range(group):
            h = h0 + t
            if h >= H:
                continue
            valid = h < nvalid
            b, s = divmod(seed[t], S)
            rp, ln = int(rpos[b, s]), int(slen[b, s])
            row = int(x0[b, s]) + pos[t] if valid else 32
            resolved = valid
            if sa.shape[0]:
                loc = int(sa[row])
            else:
                k, steps = row, 0
                if valid:
                    while steps < max_walk and k & 31:
                        k = _inv_psi(occ, L2, tfm.primary, k)
                        steps += 1
                resolved = valid and (k & 31) == 0
                loc = steps + int(samp[k >> 5])
            for key, val in (("read", b), ("rpos", rp), ("len", ln),
                             ("loc", loc), ("valid", valid),
                             ("keep", valid and loc - rp > 0)):
                out[key][h] = val
            if resolved_out is not None:
                resolved_out[h] = resolved
            if valid and not resolved:
                unres[b] = True
    return out, unres, chunks


def _span_bits(lo, hi):
    lo, hi = max(lo, 0), min(hi, 32)
    if lo >= hi:
        return 0
    return ((M32 if hi >= 32 else (1 << hi) - 1) & ~((1 << lo) - 1)) & M32


def _to_bwa(le):
    r = _brev(le)
    return ((r >> 1) & 0x55555555) | ((r & 0x55555555) << 1)


def _mismatch16(a, b):
    x = (a ^ b) & M32
    y = (x | (x >> 1)) & 0x55555555
    y = (y | (y >> 1)) & 0x33333333
    y = (y | (y >> 2)) & 0x0F0F0F0F
    y = (y | (y >> 4)) & 0x00FF00FF
    y = (y | (y >> 8)) & 0x0000FFFF
    return _brev(y) >> 16


def _lower_bound(keys, v):
    lo, hi = 0, len(keys)
    while lo < hi:
        mid = (lo + hi) >> 1
        if keys[mid] < v:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _dp_gap(lg, mg):
    return lg > 0 and mg > 1 and mg >= lg // 5


def gap_walk(unc_chunks, mm_chunks):
    """The kernel's gap state over 32-position chunks -> (dp_any,
    many_gaps): runs of uncovered bits, a run at bit 0 continuing the
    gap open at the end of the chunk before."""
    g, lg, mg, opened, dp_any = -1, 0, 0, False, False
    for unc, mm in zip(unc_chunks, mm_chunks):
        bits = unc
        while bits:
            a = _ffs(bits) - 1
            rest = ~(bits >> a) & M32
            ln = _ffs(rest) - 1 if rest else 32 - a
            run = ((M32 if ln >= 32 else (1 << ln) - 1) << a) & M32
            if not (a == 0 and opened):
                if 0 <= g < tcd.MAX_GAPS:
                    dp_any |= _dp_gap(lg, mg)
                g += 1
                lg = mg = 0
            lg += ln
            mg += _popc(mm & run)
            bits &= ~run & M32
        opened = (unc >> 31) != 0
    if 0 <= g < tcd.MAX_GAPS:
        dp_any |= _dp_gap(lg, mg)
    return dp_any, g >= tcd.MAX_GAPS


def _sort_window(win, nwin):
    """The window sorted stably by (pd, rpos) by counting ranks, as the
    group's lanes do over shuffles: slot s < nwin (the warp's most kept
    hits, at most K_HITS) goes to the number of slots before nwin that
    sort before it (ties: the earlier slot first); slots from nwin on,
    empty, keep their places."""
    def after(a, b):
        return a[0] > b[0] or (a[0] == b[0] and a[1] > b[1])
    out = list(win)
    for s, w in enumerate(win[:nwin]):
        rank = sum((not after(e, w)) if i < s else after(w, e)
                   for i, e in enumerate(win[:nwin]))
        out[rank] = w
    return out


def _group_steps(a, z, keep, group):
    """A read's group over hits [a, z), `group` lanes a step: per step,
    the kept hits in lane order (the ballot ranked by popcount)."""
    for h0 in range(a, z, group):
        yield [h for h in range(h0, min(h0 + group, z)) if keep[h]]


def mirror_classify_pack(ctx, packed, rlens, off, hits, unres, overflow,
                         max_len, H2, planes=None, pair_end=False,
                         tile=CP_READS, group=CP_GROUP, cap=CP_HIT_CAP,
                         order="random", seed=0, pd_empty=tcd.INT32_MAX):
    """chain_classify_pack_kernel: tiles of `tile` reads take their index
    from a ticket and stage their hit range `cap` hits at a time; a group
    of `group` lanes a read takes its hits `group` at a time (the first
    K_HITS kept ones to the window, sorted by counting ranks) and its
    16-base words j, j + group, ... (mismatch and coverage bits, the mm
    sum, the leftmost mismatches by a prefix of popcounts), and its
    leader walks the gaps; then the tile's SLOW kept counts are scanned,
    its prefix found by look-back (run_look_back, schedule `order`) and
    the SLOW reads' kept hits written to their slots (restaged chunk by
    chunk when the range took several); the last tile writes the totals
    and zeroes the slots no read fills. hits: numpy dict as mirror_hits
    returns; planes: numpy dict exact/fd/acgt, updated; pd_empty: the
    empty slot's diagonal (the 64-bit kernel's is INT64_MAX). -> (the
    packed vector, mmp, {"chunks": hit chunks staged, "restaged": chunks
    staged again for the pack, and the look-back's windows})."""
    Bn = packed.shape[0]
    H = len(hits["read"])
    keep = np.asarray(hits["keep"], dtype=bool)
    text = ctx.text_words.numpy()
    keys = [int(x) for x in ctx.bkeys.numpy()]
    seq_len = ctx.seq_len
    nwords = max_len >> 4
    words = np.ascontiguousarray(packed).view(np.uint32).reshape(Bn, -1)
    hw0, hl0 = 2 * Bn, 2 * Bn + H2
    c20, ovf0 = hl0 + H2, hl0 + H2 + Bn // 2
    out = np.full(ovf0 + Bn // 32 + 2, -7, dtype=np.int64)   # torch.empty
    mmp = np.full((Bn, tcd.MM_SLOTS), -7, dtype=np.int64)
    stats = {"chunks": 0, "restaged": 0}
    tiles = {}
    PD_EMPTY = pd_empty

    def window(ob, ob1, chunks):
        """A read's first K_HITS kept hits and its kept count."""
        win = [(PD_EMPTY, 0, 0)] * tcd.K_HITS
        nkept = 0
        for c0, c1 in chunks:
            for kept in _group_steps(max(ob, c0), min(ob1, c1), keep, group):
                for s in range(nkept, min(nkept + len(kept), tcd.K_HITS)):
                    h = kept[s - nkept]
                    rp, ln = int(hits["rpos"][h]), int(hits["len"][h])
                    win[s] = (int(hits["loc"][h]) - rp, rp, ln)
                nkept += len(kept)
        return win, nkept

    def classify(b, win, nkept, nwin):
        rlen = int(rlens[b])
        win = _sort_window(win, nwin)
        has_hits, too_many = nkept > 0, nkept > tcd.K_HITS
        pd0 = win[0][0]
        valid = [w[0] != PD_EMPTY for w in win]
        same = [w[0] == pd0 for w in win]
        one_diag = not any(v and not m for v, m in zip(valid, same))
        cscore = sum(w[2] for w, v in zip(win, valid) if v)
        seed_end = max([w[1] + w[2] for w, v, m in zip(win, valid, same)
                        if v and m] + [0])
        seed_last = max([w[1] for w, v, m in zip(win, valid, same)
                         if v and m] + [-1])
        spans = [(w[1], w[1] + (w[2] if m else 0)) for w, m in zip(win, same)]
        has_can = cscore > (rlen >> 2)
        pd_end = pd0 + rlen
        p1 = min(max(pd0, 0), seq_len - 1)
        p2 = min(max(pd_end - 1, 0), seq_len - 1)
        span_ok = (pd_end <= seq_len
                   and _lower_bound(keys, p1) == _lower_bound(keys, p2))
        pds = pd0 if span_ok and has_hits else 0
        sh, wbase = (pds & 15) * 2, pds >> 4
        lim = min(rlen, max_len)
        masks = [0] * nwords
        mm_total, carry, slots = 0, 0, [-1] * tcd.MM_SLOTS
        for k in range(-(-nwords // group)):
            lanes = []                        # (wi, mm, rb) of each lane
            for j in range(group):
                wi = k * group + j
                if wi >= nwords:
                    lanes.append((wi, 0, 0))
                    continue
                rb = _to_bwa(int(words[b, wi]))
                t0 = int(text[min(max(wbase + wi, 0), len(text) - 1)])
                t1 = int(text[min(max(wbase + wi + 1, 0), len(text) - 1)])
                al = ((t0 << sh) | (t1 >> (32 - sh) if sh else 0)) & M32
                inlen = _span_bits(0, lim - 16 * wi) & 0xFFFF
                mm = _mismatch16(al, rb) & inlen
                cov = 0
                for lo, hi in spans:
                    cov |= _span_bits(lo - 16 * wi, hi - 16 * wi)
                unc = ~cov & inlen & 0xFFFF
                mm_total += _popc(mm & unc)
                masks[wi] = (mm & unc) | (unc << 16)
                lanes.append((wi, mm, rb))
            for wi, mm, rb in lanes:          # a prefix of popcounts
                slot = carry
                carry += _popc(mm)
                bits = mm
                while bits and slot < tcd.MM_SLOTS:
                    p = _ffs(bits) - 1
                    slots[slot] = ((16 * wi + p) << 2) | (
                        (rb >> ((15 - p) * 2)) & 3)
                    slot += 1
                    bits &= bits - 1
        # the leader's gap walk over 32-position chunks
        uncs, mms = [], []
        for c in range(-(-nwords // 2)):
            w0 = masks[2 * c]
            w1 = masks[2 * c + 1] if 2 * c + 1 < nwords else 0
            uncs.append((w0 >> 16) | (w1 & 0xFFFF0000))
            mms.append((w0 & 0xFFFF) | ((w1 << 16) & M32))
        dp_any, many_gaps = gap_walk(uncs, mms)
        fast = (has_hits and not too_many and one_diag and has_can
                and span_ok and not dp_any and not many_gaps
                and mm_total <= tcd.MM_SLOTS)
        nocand = not has_hits or (not too_many and one_diag and not has_can)
        cls = tcd.CLASS_FAST if fast else (tcd.CLASS_NOCAND if nocand
                                           else tcd.CLASS_SLOW)
        if unres[b]:
            cls = tcd.CLASS_SLOW
        rplast = min(max(seed_end if seed_end < rlen else seed_last, 0), 511)
        out[b] = _i32(cls | (mm_total << 2) | (rplast << 8)
                      | (min(cscore, 511) << 17))
        out[Bn + b] = pd0
        mmp[b] = slots
        if planes is not None and cls == tcd.CLASS_FAST:
            L, two_l = seq_len // 2, seq_len
            ori = pd0 < L
            gs = min(max(pd0 if ori else two_l - pd0 - rlen, 0), L - 1)
            end = min(gs + rlen, L)
            first = not pair_end or (b & 1) == 0
            fo = (0 if ori else 3) if first else (1 if ori else 2)
            planes["exact"][gs] += 1
            planes["exact"][end] -= 1
            planes["fd"][fo * (L + 2) + gs] += 1
            planes["fd"][fo * (L + 2) + end] -= 1
            for e in slots:
                if e < 0:
                    continue
                at = pd0 + (e >> 2)
                p = min(max(at if ori else two_l - 1 - at, 0), L - 1)
                base = (e & 3) if ori else 3 - (e & 3)
                planes["exact"][p] -= 1
                planes["exact"][p + 1] += 1
                planes["acgt"][base * (L + 1) + p] += 1
        return nkept if cls == tcd.CLASS_SLOW else 0

    def publish(k):
        b0 = k * tile
        nr = min(tile, Bn - b0)
        o = [int(off[b0 + i]) for i in range(nr + 1)]
        hs, he = min(o[0], H), min(o[nr], H)
        chunks = [(c0, min(c0 + cap, he)) for c0 in range(hs, he, cap)]
        stats["chunks"] += len(chunks)
        wins = [window(min(o[r], H), min(o[r + 1], H), chunks)
                for r in range(nr)]
        per_warp = 32 // group                # reads a warp
        slow = [classify(b0 + r, *wins[r], max(
            min(n, tcd.K_HITS) for _, n in
            wins[r - r % per_warp:r - r % per_warp + per_warp]))
            for r in range(nr)]
        excl_in, agg = block_excl_scan(slow)
        tiles[k] = dict(b0=b0, nr=nr, o=o, chunks=chunks, slow=slow,
                        excl_in=excl_in, agg=agg)
        return agg

    def finish(k, excl):
        t = tiles[k]
        b0, nr, o, slow = t["b0"], t["nr"], t["o"], t["slow"]
        if t["agg"]:
            nk = [0] * nr
            for c0, c1 in t["chunks"]:
                stats["restaged"] += len(t["chunks"]) > 1
                for r in range(nr):
                    if not slow[r]:
                        continue
                    base = _i32(excl + t["excl_in"][r])
                    for kept in _group_steps(max(min(o[r], H), c0),
                                             min(o[r + 1], H, c1), keep,
                                             group):
                        for rank, h in enumerate(kept):
                            s = base + nk[r] + rank
                            if s < H2:
                                out[hw0 + s] = (int(hits["rpos"][h]) << 9) \
                                    | int(hits["len"][h])
                                out[hl0 + s] = hits["loc"][h]
                        nk[r] += len(kept)
        for i in range(nr // 2):
            out[c20 + b0 // 2 + i] = _i32((slow[2 * i] & 0xFFFF)
                                          | (slow[2 * i + 1] << 16))
        for w in range(nr // 32):
            out[ovf0 + b0 // 32 + w] = _i32(sum(
                1 << lane for lane in range(32)
                if overflow[b0 + 32 * w + lane] or unres[b0 + 32 * w + lane]))
        if k == ntiles - 1:
            total = _i32(excl + t["agg"])
            out[ovf0 + Bn // 32] = total
            out[ovf0 + Bn // 32 + 1] = int(o[nr] > H or total > H2)
            out[hw0 + max(total, 0):hw0 + H2] = 0
            out[hl0 + max(total, 0):hl0 + H2] = 0

    ntiles = -(-Bn // tile)
    stats.update(run_look_back(ntiles, publish, finish, order, seed))
    return out, mmp, stats


def mirror_chain(genome, seeds, tfm, H, H2, planes=None, pair_end=False,
                 max_walk=192, **kw):
    """The whole once-a-batch chain on the mirrors -> (packed, pd, mmp,
    the classify+pack mirror's stats)."""
    n_seeds, rpos, slen, x0, freq, overflow = (x.numpy() for x in seeds)
    off, start, _ = mirror_scan(B, freq.shape[1], freq=freq, n=n_seeds, H=H,
                                order="random")
    hits, unres, _ = mirror_hits(tfm, off, start, n_seeds, rpos, slen, x0,
                                 freq, H, max_walk)
    packed, mmp, stats = mirror_classify_pack(
        genome["tctx"], genome["packed"], genome["rlens"], off, hits, unres,
        overflow, BUCKET, H2, planes, pair_end, **kw)
    return packed, packed[B:2 * B], mmp, stats


# ---- the mirrors against the plain versions and the reference ---------------

@pytest.mark.parametrize("threads", [32, 64, SCAN_THREADS])
def test_scan_mirror_equal_plain_and_reference(threads):
    """Seed freqs with n_seeds below 0, inside and above S, and int32
    counts, in tiles of `threads` reads (3,000 reads: a last tile cut
    short), each in three orders of publication: in ticket order (every
    look-back finds its neighbour's inclusive prefix), aggregates first
    (look-backs over windows of aggregates only, when there are more
    than LOOKBACK tiles) and at random."""
    Bn, S = 3000, 9
    rng = np.random.default_rng(threads)
    freq = rng.integers(0, 51, size=(Bn, S)).astype(np.int64)
    n = rng.integers(-1, S + 3, size=Bn).astype(np.int64)
    cnt = rng.integers(0, 40, size=Bn).astype(np.int32)
    valid = np.arange(S)[None, :] < n[:, None]
    jf = jnp.where(jnp.asarray(valid), jnp.asarray(freq), 0).sum(axis=1)
    ntiles = -(-Bn // threads)
    for order in ("in_order", "aggregates_first", "random"):
        got_f, _, seen_f = mirror_scan(Bn, S, freq=freq, n=n, tile=threads,
                                       order=order, seed=threads)
        got_c, _, seen_c = mirror_scan(Bn, cnt=cnt, tile=threads,
                                       order=order, seed=threads + 1)
        for got_m, got_p, counts in (
                (got_f, ck.chain_scan_seeds(torch.from_numpy(freq),
                                            torch.from_numpy(n), 1).off, jf),
                (got_c, ck.chain_scan(torch.from_numpy(cnt)),
                 jnp.asarray(cnt))):
            want = np.concatenate([[0], np.asarray(jnp.cumsum(counts))])
            np.testing.assert_array_equal(got_m, want)
            np.testing.assert_array_equal(got_p.numpy(), want)
            assert got_p.dtype == torch.int32
        for seen in (seen_f, seen_c):
            assert seen["prefix"] == ntiles - 1
            if order == "in_order" or ntiles <= LOOKBACK:
                assert seen["aggregates"] == 0
            elif order == "aggregates_first":
                assert seen["aggregates"] > 0


def test_scan_mirror_wraps_as_plain():
    """Counts whose sum passes 2^31: the kernel's uint32 sums wrap as the
    plain version's int64 cumsum cast to int32 does."""
    cnt = np.full(700, 2 ** 30 - 3, dtype=np.int32)
    got_m, _, _ = mirror_scan(700, cnt=cnt, tile=32, order="random")
    want = ck.chain_scan(torch.from_numpy(cnt)).numpy()
    np.testing.assert_array_equal(got_m, want)
    assert want.min() < 0


def _case_seeds(case, rng, Bn=300, S=9):
    """Seed tables of one start-index case: n_seeds from -1 to S + 2, a
    third of the freqs 0, a run of 150 seedless reads (long_gap), or
    freqs scaled so the total is below, at or above H = 4 * Bn."""
    H = 4 * Bn
    freq = rng.integers(0, 12, size=(Bn, S)).astype(np.int64)
    freq[rng.random((Bn, S)) < 0.33] = 0
    n = rng.integers(-1, S + 3, size=Bn).astype(np.int64)
    n[:4] = (0, S, S + 2, -1)
    if case == "long_gap":
        n[60:210] = 0
    valid = np.arange(S)[None, :] < n[:, None]
    total = int(np.where(valid, freq, 0).sum())
    if case == "total_lt_H":
        H = total + 77
    elif case == "total_eq_H":
        H = total
    elif case == "total_gt_H":
        H = total // 3
    return freq, n, H


@pytest.mark.parametrize("case", ["total_lt_H", "total_eq_H", "total_gt_H",
                                  "zero_freqs", "n_seeds_edges",
                                  "long_gap"])
def test_start_index_equal_searchsorted(genome, case):
    """The seed-freq scan's start index (the mirror at the kernel's tile
    and at 32-read tiles, in random orders, and the wrapper's plain
    version) equals torch.searchsorted over the plain flat cumsum, and
    the hits mirror expanding from it (at the kernel's group and chunk,
    and at 32-slot groups staging 64 seeds a chunk, so the seedless run
    takes several chunks) equals chain_hits_plain and the JAX package's
    expansion."""
    rng = np.random.default_rng(len(case))
    freq, n, H = _case_seeds(case, rng)
    Bn, S = freq.shape
    tfm = genome["tfm"]
    nrows = int(tfm.sa_full.shape[0])
    x0 = rng.integers(0, nrows - 12, size=(Bn, S)).astype(np.int64)
    rpos = rng.integers(0, 100, size=(Bn, S)).astype(np.int64)
    slen = rng.integers(17, 60, size=(Bn, S)).astype(np.int64)
    t = [torch.from_numpy(x) for x in (n, rpos, slen, x0, freq)]
    flat = torch.where(torch.arange(S)[None, :] < t[0][:, None], t[4],
                       0).reshape(-1)
    csum = torch.cumsum(flat, 0)
    total = int(csum[-1])
    assert {"total_lt_H": total < H, "total_eq_H": total == H,
            "total_gt_H": total > H}.get(case, True)
    want_plain = ck.chain_hits_plain(tfm, None, *t, H)
    want_jax, unres_jax = _jax_hits(genome["jfm"], (*t, t[4]), H, 192)
    assert not unres_jax.any()
    for group, items in ((HITS_GROUP, HITS_ITEMS), (32, 2)):
        gpos = torch.arange(-(-H // group)) * group
        seed = torch.searchsorted(csum, gpos, right=True)
        before = torch.where(seed < Bn * S, (csum - flat)[
            torch.clamp(seed, max=Bn * S - 1)], total)
        want = torch.stack([seed, before], 1).numpy()
        for tile in (SCAN_THREADS, 32):
            off, start, _ = mirror_scan(Bn, S, freq=freq, n=n, tile=tile,
                                        H=H, group=group, order="random",
                                        seed=tile)
            np.testing.assert_array_equal(start, want)
        if group == HITS_GROUP:
            scan = ck.chain_scan_seeds(t[4], t[0], H)
            np.testing.assert_array_equal(scan.start.numpy(), want)
            np.testing.assert_array_equal(scan.off.numpy(), off)
            assert not scan.unresolved.any()
        got, unres, chunks = mirror_hits(tfm, off, start, n, rpos, slen, x0,
                                         freq, H, group=group, items=items)
        for k in got:
            np.testing.assert_array_equal(
                got[k], getattr(want_plain, k).numpy(), err_msg=k)
            np.testing.assert_array_equal(got[k], want_jax[k], err_msg=k)
        assert not unres.any()
        if case == "long_gap" and group == 32:
            assert chunks > -(-min(total, H) // group)   # some take two


def _jax_hits(jfm, seeds, H, max_walk):
    """The reference's hit expansion (mapcaller_tpu/ops/fm_search.py:704-
    731) with its sa_resolve."""
    n_seeds, rpos, slen, x0, freq, _ = (jnp.asarray(x.numpy()) for x in seeds)
    Bn, S = freq.shape
    valid_s = jnp.arange(S)[None, :] < n_seeds[:, None]
    freqs = jnp.where(valid_s, freq, 0).reshape(-1)
    csum = jnp.cumsum(freqs) - freqs
    hpos = jnp.arange(H)
    rep = functools.partial(jnp.repeat, repeats=freqs, total_repeat_length=H)
    hit_row = rep(x0.reshape(-1)) + hpos - rep(csum)
    hit_rpos, hit_len = rep(rpos.reshape(-1)), rep(slen.reshape(-1))
    hit_read = rep(jnp.repeat(jnp.arange(Bn), S))
    hit_valid = hpos < jnp.minimum(freqs.sum(), H)
    loc, ok = jfd.sa_resolve(jfm, jnp.where(hit_valid, hit_row, 32).astype(
        jnp.int32), hit_valid, max_walk)
    unres = jnp.zeros(Bn, jnp.int32).at[hit_read].max(
        (hit_valid & ~ok).astype(jnp.int32)) > 0
    keep = hit_valid & ((loc - hit_rpos) > 0)
    return {k: np.asarray(v) for k, v in (
        ("read", hit_read), ("rpos", hit_rpos), ("len", hit_len),
        ("loc", loc), ("valid", hit_valid), ("keep", keep),
        ("resolved", ok))}, np.asarray(unres)


@pytest.mark.parametrize("full_sa,max_walk,H", [
    (True, 192, 4 * B), (True, 192, B // 2), (False, 192, 4 * B),
    (False, 6, 4 * B)])
def test_hits_mirror_equal_plain_and_reference(genome, full_sa, max_walk, H):
    """Full SA and the inverse-Psi walk (at 6 steps, reads left
    unresolved); H above the raw total (padding) and below it
    (truncation). Each slot's resolved flag (the optional output the
    mesh's map step reads) equals the reference's sa_resolve flag."""
    seeds = _seeds(genome)
    tfm = genome["tfm"] if full_sa else genome["tfm0"]
    jfm = genome["jfm"] if full_sa else genome["jfm0"]
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], H)
    total = int(scan.off[-1])
    assert (total > H) == (H < B)
    res_m = np.zeros(H, dtype=bool)
    got_m, unres_m, _ = mirror_hits(tfm, scan.off.numpy(),
                                    scan.start.numpy(), *(x.numpy() for x in
                                                          seeds[:5]),
                                    H, max_walk, resolved_out=res_m)
    res_p = torch.ones(H, dtype=torch.bool)
    got_p = ck.chain_hits(tfm, scan, *seeds[:5], H, max_walk,
                          resolved=res_p)
    want, unres_w = _jax_hits(jfm, seeds, H, max_walk)
    got_m["resolved"] = res_m
    for k in want:
        np.testing.assert_array_equal(got_m[k], want[k], err_msg=k)
        got = res_p if k == "resolved" else getattr(got_p, k)
        np.testing.assert_array_equal(got.numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(unres_m, unres_w)
    np.testing.assert_array_equal(got_p.unresolved.numpy(), unres_w)
    # the flags land in the scan's own tensor, as on the card
    assert got_p.unresolved is scan.unresolved
    assert unres_w.any() == (max_walk < 192)


def _true_diagonals(genome):
    """Each read's first kept hit's diagonal (from its seeds), 0 without
    one."""
    seeds = _seeds(genome)
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], 8 * B)
    h = ck.chain_hits(genome["tfm"], scan, *seeds[:5], 8 * B)
    pd = np.zeros(B, dtype=np.int64)
    for b, loc, rp in zip(*(x.numpy()[h.keep.numpy()][::-1]
                            for x in (h.read, h.loc, h.rpos))):
        pd[b] = loc - rp
    return pd


def _synthetic_hits(genome, seed):
    """Flat hits grouped by read, made up to reach every branch: per read
    0-12 hits, some on one diagonal with uncovered runs between them (up
    to the 9 gaps an 8-hit window allows), some off it, some not kept,
    (pd, rpos) ties of different lengths, diagonals at the text's end,
    across the chromosome boundary and the read's own; H cuts the last
    reads' hits."""
    rng = np.random.default_rng(seed)
    two_l = genome["tctx"].seq_len
    rlens = genome["rlens"]
    true_pd = _true_diagonals(genome)
    per = {k: [] for k in ("rpos", "len", "loc", "keep")}
    counts = np.zeros(B, dtype=np.int64)
    for b in range(B):
        ln = int(rlens[b])
        k = int(rng.integers(0, 13))
        mode = b % 5
        diag = int(rng.choice([rng.integers(1, two_l - BUCKET),
                               two_l - max(ln, 1), L1 - ln // 2,
                               two_l - L1 - ln // 2]))
        if mode >= 2 and true_pd[b] > 0:
            diag = int(true_pd[b])
        for j in range(k):
            if mode == 0:                    # spread seeds on one diagonal
                rp = min(5 + j * 14, BUCKET - 1)
                sl = int(rng.integers(1, 10))
                d = diag
            elif mode == 1:                  # ties: same (pd, rpos)
                rp = int(rng.integers(0, 3)) * 20
                sl = int(rng.integers(5, 40))
                d = diag + int(rng.integers(0, 2)) * 7
            else:
                rp = int(rng.integers(0, max(ln, 1)))
                sl = int(rng.integers(1, 60))
                d = diag if rng.random() < 0.7 else int(
                    rng.integers(1, two_l - BUCKET))
            per["rpos"].append(rp)
            per["len"].append(sl)
            per["loc"].append(d + rp)
            per["keep"].append(rng.random() < 0.9)
        counts[b] = k
    H = int(counts.sum()) - 7
    hits = {k: np.asarray(v[:H]) for k, v in per.items()}
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    read = np.repeat(np.arange(B), counts)[:H]
    hits.update(read=read, valid=np.ones(H, dtype=bool))
    unres = rng.random(B) < 0.03
    return off, hits, unres


def _torch_hits(hits, unres):
    i32 = torch.int32
    return ck.Hits(*(torch.from_numpy(np.asarray(hits[k])).to(i32)
                     for k in ("read", "rpos", "len", "loc")),
                   torch.from_numpy(hits["valid"]),
                   torch.from_numpy(np.asarray(hits["keep"], dtype=bool)),
                   torch.from_numpy(unres))


def _jax_classify(jctx, packed, rlens, hits, unres, max_len=BUCKET):
    """The reference's classify_reads, unresolved override and meta1."""
    words = jnp.asarray(ck.read_words_bwa(torch.from_numpy(packed),
                                          max_len).numpy().astype(np.uint32))
    cls, pd0, mm, rplast, cscore, mmp = jcd.classify_reads(
        jctx, words, jnp.asarray(rlens),
        *(jnp.asarray(np.asarray(hits[k]).astype(np.int32))
          for k in ("read", "rpos", "len", "loc")),
        jnp.asarray(np.asarray(hits["keep"], dtype=bool)), max_len)
    cls = jnp.where(jnp.asarray(unres), jcd.CLASS_SLOW, cls)
    meta = cls | (mm << 2) | (rplast << 8) | (cscore << 17)
    return np.asarray(meta), np.asarray(pd0), np.asarray(mmp), \
        np.asarray(cls)


def _np_planes(L):
    return {"exact": np.zeros(L + 2, np.int64), "fd": np.zeros(4 * (L + 2),
                                                                np.int64),
            "acgt": np.zeros(4 * (L + 1), np.int64)}


def _decode_counts(packed, Bn, H2):
    c2 = packed[2 * Bn + 2 * H2:2 * Bn + 2 * H2 + Bn // 2].astype(np.int64)
    counts = np.zeros(Bn, dtype=np.int64)
    counts[0::2], counts[1::2] = c2 & 0xFFFF, (c2 >> 16) & 0xFFFF
    return counts


def check_classify_pack(genome, packed, rlens, off, hits, unres, overflow,
                        H2, mirrors, planes=False, pair_end=False,
                        max_len=BUCKET):
    """The mirror at each of `mirrors` (keyword sets of
    mirror_classify_pack), the wrapper's plain composition and the
    reference: the whole packed vector and mmp of each mirror equal the
    plain composition's; meta1, pd and mmp equal classify_reads', each
    read's SLOW kept count (counts2) its kept hits when the reference
    calls it SLOW; with planes, the FAST reads' plane adds equal
    scatter_fast_evidence's. -> (the packed vector, the reference's
    classes, kept hits a read, each mirror's stats)."""
    Bn = packed.shape[0]
    ctx = genome["tctx"]
    L = ctx.seq_len // 2
    out = torch.full((2 * Bn + 2 * H2 + Bn // 2 + Bn // 32 + 2,), -7,
                     dtype=torch.int32)
    pl_p = tdp.DevicePlanes.zeros(L, "cpu") if planes else None
    mmp_p = ck.chain_classify_pack(
        ctx, torch.from_numpy(packed), torch.from_numpy(rlens),
        torch.from_numpy(np.asarray(off, dtype=np.int32)),
        _torch_hits(hits, unres), torch.from_numpy(overflow), max_len, out,
        H2, pl_p, pair_end)
    want = out.numpy().astype(np.int64)
    meta_w, pd_w, mmp_w, cls_w = _jax_classify(genome["jctx"], packed,
                                               rlens, hits, unres, max_len)
    np.testing.assert_array_equal(want[:Bn], meta_w)
    np.testing.assert_array_equal(want[Bn:2 * Bn], pd_w)
    np.testing.assert_array_equal(mmp_p.numpy(), mmp_w)
    keep = np.asarray(hits["keep"], bool)
    kept = np.bincount(np.asarray(hits["read"])[keep], minlength=Bn)
    np.testing.assert_array_equal(
        _decode_counts(want, Bn, H2),
        np.where(cls_w == jcd.CLASS_SLOW, kept, 0))
    if planes:
        jpl = jdp.DevicePlanes.zeros(L)
        first = (np.arange(Bn) & 1) == 0 if pair_end else np.ones(Bn, bool)
        from mapcaller_tpu.ops.evidence import scatter_fast_evidence as jsc
        jw = [np.asarray(x).reshape(-1) for x in jsc(
            jpl.exact_diff, jpl.f_diff.reshape(-1), jpl.acgt.reshape(-1),
            jnp.asarray(cls_w == jcd.CLASS_FAST), jnp.asarray(pd_w),
            jnp.asarray(mmp_w), jnp.asarray(rlens), jnp.asarray(first),
            L, 2 * L, sign=1)]
        for got, w in zip((pl_p.exact_diff, pl_p.f_diff, pl_p.acgt), jw):
            np.testing.assert_array_equal(got.numpy().reshape(-1), w)
    stats = []
    for kw in mirrors:
        pl_m = _np_planes(L) if planes else None
        got, mmp_m, st = mirror_classify_pack(
            ctx, packed, rlens, off, hits, unres, overflow, max_len, H2,
            pl_m, pair_end, **kw)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
        np.testing.assert_array_equal(mmp_m, mmp_w, err_msg=str(kw))
        if planes:
            for key, w in zip(("exact", "fd", "acgt"), jw):
                np.testing.assert_array_equal(pl_m[key], w, err_msg=str(kw))
        stats.append(st)
    return want, cls_w, kept, stats


KERNEL_MIRROR = dict(tile=CP_READS, group=CP_GROUP, cap=CP_HIT_CAP)


@pytest.mark.parametrize("source,pair_end", [("synthetic", False),
                                             ("synthetic", True),
                                             ("seeds", True)])
def test_classify_mirror_equal_plain_and_reference(genome, source, pair_end):
    """The classify+pack mirror at the kernel's tile, group and staging
    capacity (tiles at random) and the plain composition: each read's
    meta1, pd, mmp and SLOW kept count, and the FAST reads' plane adds,
    against classify_reads and scatter_fast_evidence of the reference;
    the whole packed vector of the mirror equal the plain one's."""
    rng = np.random.default_rng(11 + pair_end)
    if source == "seeds":
        seeds = _seeds(genome)
        scan = ck.chain_scan_seeds(seeds[4], seeds[0], 2 * B)
        th = ck.chain_hits(genome["tfm0"], scan, *seeds[:5], 2 * B, 6)
        off = scan.off.numpy()
        hits = {k: getattr(th, k).numpy() for k in
                ("read", "rpos", "len", "loc", "valid", "keep")}
        unres, overflow = th.unresolved.numpy(), seeds[5].numpy()
    else:
        off, hits, unres = _synthetic_hits(genome, 5 + pair_end)
        overflow = rng.random(B) < 0.05
    _, cls_w, kept, _ = check_classify_pack(
        genome, genome["packed"], genome["rlens"], off, hits, unres,
        overflow, B, [KERNEL_MIRROR], planes=True, pair_end=pair_end)
    # the cases the batch must reach
    assert {0, 1, 2} <= set(cls_w.tolist())
    if source == "synthetic":
        assert (kept > tcd.K_HITS).any() and unres.any()


def test_window_ties_equal_reference(genome):
    """Two kept hits with equal (pd, rpos) and different lengths, after a
    hit that sorts before them: the window's outputs equal the
    reference's, at the kernel's group and at a group of 1."""
    off = np.zeros(B + 1, dtype=np.int32)
    off[1:] = 3
    hits = {"read": np.zeros(3, np.int64), "rpos": np.array([20, 20, 0]),
            "len": np.array([30, 50, 10]), "loc": np.array([520, 520, 500]),
            "keep": np.ones(3, bool), "valid": np.ones(3, bool)}
    unres = np.zeros(B, bool)
    got, _, _, _ = check_classify_pack(
        genome, genome["packed"], genome["rlens"], off, hits, unres, unres,
        8, [KERNEL_MIRROR, dict(KERNEL_MIRROR, group=1)])
    assert got[B] == 500 and (got[0] >> 17) & 0x1FF == 90


@pytest.mark.parametrize("order,group,cap,tile", [
    ("in_order", CP_GROUP, CP_HIT_CAP, CP_READS),
    ("aggregates_first", CP_GROUP, 64, 32),
    ("random", 1, 48, 96),
    ("random", CP_GROUP, 48, CP_READS),
    ("many_tiles", CP_GROUP, 40, 32)])
def test_classify_pack_mirror_schedules(genome, order, group, cap, tile):
    """The mirror with tiles published in ticket order, every aggregate
    first and at random, groups of the kernel's lanes and of 1 lane, the
    kernel's staging capacity and small ones that take a tile's hits in
    several chunks (restaged for the pack), whole and ragged last tiles
    (256 reads in tiles of 96): equal to the plain composition and the
    reference. many_tiles: five copies of the batch (1,280 reads) in 40
    tiles, aggregates first, so some look-backs read windows of
    aggregates only."""
    off, hits, unres = _synthetic_hits(genome, 7)
    packed, rlens = genome["packed"], genome["rlens"]
    overflow = np.random.default_rng(3).random(B) < 0.05
    if order == "many_tiles":
        n = 5
        H = len(hits["read"])
        counts = np.diff(np.minimum(off, H))
        hits = {k: np.tile(np.asarray(v), n) for k, v in hits.items()}
        hits["read"] = np.repeat(np.arange(n * B), np.tile(counts, n))
        off = np.concatenate([[0], np.cumsum(np.tile(counts, n))])
        packed, rlens = np.tile(packed, (n, 1)), np.tile(rlens, n)
        unres, overflow = np.tile(unres, n), np.tile(overflow, n)
        order = "aggregates_first"
    _, _, _, stats = check_classify_pack(
        genome, packed, rlens, off, hits, unres, overflow, 2 * B,
        [dict(tile=tile, group=group, cap=cap, order=order)])
    st = stats[0]
    ntiles = -(-packed.shape[0] // tile)
    assert st["prefix"] == ntiles - 1
    if cap < CP_HIT_CAP:
        assert st["chunks"] > ntiles and st["restaged"] > 0
    else:
        assert st["chunks"] == ntiles and st["restaged"] == 0
    if ntiles > LOOKBACK:
        assert st["aggregates"] > 0


def _long_reads(genome, Bn=64, max_len=496, seed=2):
    """Bn reads of up to max_len bases from chr1 (a few with 6-12
    substitutions), their rlens, and hits along each read's own diagonal:
    8 seeds, spread or overlapping."""
    rng = np.random.default_rng(seed)
    codes = genome["idx"].ref.fwd_rc_codes()
    mat = np.zeros((Bn, max_len), dtype=np.uint8)
    rlens = rng.integers(max_len - 60, max_len + 1, size=Bn).astype(np.int32)
    rlens[:2] = (max_len, 0)
    per = {k: [] for k in ("rpos", "len", "loc", "keep")}
    counts = np.zeros(Bn, dtype=np.int64)
    for b in range(Bn):
        ln = int(rlens[b])
        p = int(rng.integers(0, L1 - max_len - 1))
        r = codes[p:p + ln].copy()
        if b % 4 == 1 and ln:
            for j in rng.choice(ln, size=int(rng.integers(6, 13))):
                r[j] = (r[j] + 1) % 4
        mat[b, :ln] = r
        k = 8 if ln else 0
        for j in range(k):
            rp = min(j * (ln // 8) + int(rng.integers(0, 5)), ln - 1)
            sl = int(rng.integers(20, 70)) if b % 2 else int(
                rng.integers(5, ln // 8 - 4))
            per["rpos"].append(rp)
            per["len"].append(sl)
            per["loc"].append(p + rp)
            per["keep"].append(True)
        counts[b] = k
    hits = {k: np.asarray(v) for k, v in per.items()}
    hits.update(read=np.repeat(np.arange(Bn), counts),
                valid=np.ones(int(counts.sum()), dtype=bool))
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return _pack(mat), rlens, off, hits


@pytest.mark.parametrize("case", ["ragged_last_tile", "both_buffers_overflow",
                                  "rlen_0", "more_than_8_kept",
                                  "more_than_4_mismatches", "most_gaps",
                                  "max_len_496"])
def test_classify_pack_edge_cases(genome, case):
    """Each edge the kernel must meet, in the mirror at the kernel's
    sizes and at a group of 1 lane with a 32-hit staging capacity in
    128-read tiles, the plain composition and the reference: 160 reads
    (a tile cut short; at 128-read tiles a last tile of 32), the total
    raw hits above H and the total kept above H2, reads
    of length 0, more than 8 kept hits, more than 4 mismatches, the 9
    gaps an 8-hit window allows (the gap walk itself past 10 gaps:
    test_gap_walk_equal_plain_gaps), and 496-base reads (31 words a read,
    4 a lane)."""
    mirrors = [KERNEL_MIRROR, dict(group=1, cap=32, tile=128)]
    off, hits, unres = _synthetic_hits(genome, 13)
    packed, rlens, max_len = genome["packed"], genome["rlens"], BUCKET
    overflow = np.zeros(B, bool)
    H2 = 2 * B
    if case == "ragged_last_tile":
        Bn = 160
        H = min(int(off[Bn]), len(hits["read"]))
        hits = {k: np.asarray(v)[:H] for k, v in hits.items()}
        off, packed, rlens = off[:Bn + 1], packed[:Bn], rlens[:Bn]
        unres, overflow = unres[:Bn], overflow[:Bn]
    elif case == "both_buffers_overflow":
        H2 = 16
    elif case == "max_len_496":
        max_len = 496
        packed, rlens, off, hits = _long_reads(genome)
        unres = overflow = np.zeros(packed.shape[0], bool)
    got, cls_w, kept, _ = check_classify_pack(
        genome, packed, rlens, off, hits, unres, overflow, H2, mirrors,
        planes=True, max_len=max_len)
    Bn = packed.shape[0]
    mm = (got[:Bn] >> 2) & 0x3F
    reached = {
        "ragged_last_tile": Bn % CP_READS != 0,
        "both_buffers_overflow": (got[-1] == 1 and got[-2] > H2
                                  and off[-1] > len(hits["read"])),
        "rlen_0": (rlens == 0).any(),
        "more_than_8_kept": (kept > tcd.K_HITS).any(),
        "more_than_4_mismatches": (mm > tcd.MM_SLOTS).any(),
        "most_gaps": max(_gaps(got, Bn, i, genome, packed, rlens, hits,
                               max_len) for i in range(Bn)) == 9,
        "max_len_496": ((cls_w == tcd.CLASS_FAST).any()
                        and (mm > tcd.MM_SLOTS).any()),
    }
    assert reached[case]


def _gaps(got, Bn, b, genome, packed, rlens, hits, max_len):
    """The number of uncovered runs along read b's diagonal in [0, rlen)
    (its window's same-diagonal spans as the kernel sees them)."""
    keep = np.asarray(hits["keep"], bool)
    rows = np.flatnonzero((np.asarray(hits["read"]) == b) & keep)[:8]
    pd0 = int(got[Bn + b])
    cov = np.zeros(max_len, bool)
    for h in rows:
        rp = int(hits["rpos"][h])
        if int(hits["loc"][h]) - rp == pd0:
            cov[rp:rp + int(hits["len"][h])] = True
    unc = ~cov[:int(rlens[b])]
    return int((unc & np.concatenate([[True], ~unc[:-1]])).sum())


@pytest.mark.parametrize("seed", range(4))
def test_gap_walk_equal_plain_gaps(seed):
    """The kernel's run walk over random coverage and mismatch masks
    (up to 40 gaps, runs across chunk edges) against the plain
    definition: gap g = the g-th maximal run of uncovered in-length
    positions, DP on gaps 0-9, many gaps at a gap index >= 10."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(0, 129))
        unc = rng.random(128) < rng.choice([0.1, 0.5, 0.9])
        unc[n:] = False
        mm = (rng.random(128) < 0.4) & (np.arange(128) < n)
        start = unc & np.concatenate([[True], ~unc[:-1]])
        gapidx = np.cumsum(start) - 1
        want_dp = False
        for g in range(tcd.MAX_GAPS):
            lg = int((unc & (gapidx == g)).sum())
            mg = int((unc & (gapidx == g) & mm).sum())
            want_dp |= lg > 0 and mg > 1 and mg >= lg // 5
        want_many = bool((unc & (gapidx >= tcd.MAX_GAPS)).any())

        def chunks(bits):
            return [int(sum(1 << p for p in range(32) if bits[32 * c + p]))
                    for c in range(4)]

        assert gap_walk(chunks(unc), chunks(mm)) == (want_dp, want_many)


# ---- the whole chain dispatch -------------------------------------------

def _jax_chain(genome, jfm, tier, planes_L=None, pair_end=False):
    fm3 = JaxFM3.from_host(genome["idx"], jfm, pfx_k=0)
    kern = jfs.build_seed_chain_kernel(fm3, genome["jctx"], BUCKET, B,
                                       slow_hits_x4=tier,
                                       with_planes=planes_L is not None,
                                       pair_end=pair_end)
    args = (jnp.asarray(genome["packed"]), jnp.asarray(genome["rlens"]))
    if planes_L is None:
        return kern(*args) + (None,)
    return kern(*args, jdp.DevicePlanes.zeros(planes_L))


@pytest.mark.parametrize("full_sa,tier,fold,pair_end", [
    (True, 2, True, True), (True, 18, False, False), (True, 1, True, False),
    (False, 2, True, False), (False, 2, False, True)])
def test_chain_dispatch_equal_reference(genome, monkeypatch, full_sa, tier,
                                        fold, pair_end):
    """The port's SeedChainKernel (the plain versions) and the mirrors
    chained as the kernels run against the reference's
    build_seed_chain_kernel: packed vector, pd, mmp and planes. Tiers 2
    and 1 overflow both hit buffers (total raw > H, kept slow > H2); the
    index without a full SA walks 6 inverse-Psi steps in both packages,
    so reads stay unresolved."""
    jfm = genome["jfm"] if full_sa else genome["jfm0"]
    tfm = genome["tfm"] if full_sa else genome["tfm0"]
    walk = 192 if full_sa else 6
    if not full_sa:
        monkeypatch.setattr(jfs, "sa_resolve",
                            functools.partial(jfd.sa_resolve, max_walk=walk),
                            raising=False)
        monkeypatch.setattr(tfs, "chain_hits",
                            functools.partial(ck.chain_hits, max_walk=walk))
    L = genome["tctx"].seq_len // 2
    w_dev, w_pd, w_mmp, w_pl = _jax_chain(genome, jfm, tier,
                                          L if fold else None, pair_end)
    fm3 = DeviceFM3.from_host(genome["idx"], tfm, pfx_k=0)
    kern = tfs.build_seed_chain_kernel(fm3, genome["tctx"], BUCKET, B,
                                       slow_hits_x4=tier)
    planes = tdp.DevicePlanes.zeros(L, "cpu") if fold else None
    g_dev, g_pd, g_mmp = kern(torch.from_numpy(genome["packed"]),
                              torch.from_numpy(genome["rlens"]),
                              planes=planes, pair_end=pair_end)
    pl_m = _np_planes(L) if fold else None
    m_dev, m_pd, m_mmp, _ = mirror_chain(genome, _seeds(genome), tfm,
                                         kern.H, kern.H2, pl_m, pair_end,
                                         walk)
    for got in ((g_dev.numpy(), g_pd.numpy(), g_mmp.numpy()),
                (m_dev, m_pd, m_mmp)):
        np.testing.assert_array_equal(got[0], np.asarray(w_dev))
        np.testing.assert_array_equal(got[1], np.asarray(w_pd))
        np.testing.assert_array_equal(got[2], np.asarray(w_mmp))
    if fold:
        for key, pkey in (("exact", "exact_diff"), ("fd", "f_diff"),
                          ("acgt", "acgt")):
            want = np.asarray(getattr(w_pl, pkey)).reshape(-1)
            np.testing.assert_array_equal(
                getattr(planes, pkey).numpy().reshape(-1), want)
            np.testing.assert_array_equal(pl_m[key], want)
    p = np.asarray(w_dev)
    H2 = kern.H2
    # tiers 1 and 2 overflow both buffers, tier 18 neither; unresolved
    # reads set overflow bits
    assert bool(p[-1]) == (int(p[-2]) > H2) == (tier < 18)
    ovf = p[2 * B + 2 * H2 + B // 2:2 * B + 2 * H2 + B // 2 + B // 32]
    assert ovf.any() == (not full_sa)


# ---- the wrappers -------------------------------------------------------

def test_constants_equal_cuda_source():
    for name, value in (("K_HITS", tcd.K_HITS), ("MAX_GAPS", tcd.MAX_GAPS),
                        ("MM_SLOTS", tcd.MM_SLOTS),
                        ("PD_EMPTY", tcd.INT32_MAX),
                        ("SCAN_THREADS", ck.SCAN_THREADS),
                        ("SCAN_MAX_S", ck.SCAN_MAX_S),
                        ("HITS_GROUP", ck.HITS_GROUP),
                        ("CP_READS", ck.CP_READS),
                        ("CP_HIT_CAP", ck.CP_HIT_CAP)):
        assert _cu_const(name) == value, name
    # classify+pack: window slots split evenly over a group's lanes, an
    # overflow word a warp of reads, blocks of at most 1,024 threads; its
    # dynamic shared memory (cp_smem_bytes) fits the 48 KB a block gets
    # without opting in at the main path's max_len 128, and at 496 with
    # CP_KEY_CAP staged keys (plus ~9 KB static) two blocks fit the 228 KB
    # of an H100 SM
    assert tcd.K_HITS % CP_GROUP == 0 and 32 % CP_GROUP == 0
    assert CP_READS % 32 == 0 and CP_READS * CP_GROUP <= 1024

    def smem(nwords, nkeys):
        return (4 * (3 * CP_HIT_CAP + CP_READS * nwords)
                + 8 * (nkeys if nkeys <= CP_KEY_CAP else 0) + CP_HIT_CAP)
    assert smem(128 // 16, 64) + 9 * 1024 <= 48 * 1024
    assert 2 * (smem(496 // 16, CP_KEY_CAP) + 9 * 1024) <= 228 * 1024
    assert _cu_const("CP_MAX_WORDS") == 496 // 16
    # the seed-freq scan takes every S the seed kernels make (max_len a
    # multiple of 16 below 512), and a whole tile of its rows fits the
    # 48 KB of shared memory a block gets without opting in
    assert max(m // (tfs.MIN_SEED_LEN + 1) + 2
               for m in range(16, 512, 16)) == ck.SCAN_MAX_S
    assert 4 * ck.SCAN_THREADS * ck.SCAN_MAX_S + 1024 <= 48 * 1024
    with open(CU) as f:
        src = f.read()
    assert re.search(r"CLASS_NOCAND = 0, CLASS_FAST = 1, CLASS_SLOW = 2",
                     src)
    assert (tcd.CLASS_NOCAND, tcd.CLASS_FAST, tcd.CLASS_SLOW) == (0, 1, 2)


def test_scan_scratch_epochs(monkeypatch):
    """The look-back scratch of a device is allocated zeroed once and
    reused; each launch gets the next epoch (never 0, which zeroed words
    hold); a batch with more tiles grows it, and when the epochs run out
    it is allocated zeroed anew and the epochs start again at 1."""
    calls = []
    monkeypatch.setattr(ck, "_launch", lambda name, dev, *a, count:
                        calls.append(a[-3:]))
    monkeypatch.setattr(ck, "_scan_scratch", {})
    monkeypatch.setattr(ck, "_EPOCHS", 5)
    dev = torch.device("cpu")

    def launch(B):
        ck._scan_launch("chain_scan", dev, None, None, 1, B, 1, 2, None, 0,
                        None, count="chain_scan")
        return ck._scan_scratch[ck._scratch_key(dev)][0]

    first = launch(1000)                        # a new scratch: epoch 1
    assert launch(1000) is first                # epoch 2
    grown = launch(3000 * ck.SCAN_THREADS)      # 3,000 tiles: epoch 1
    assert grown is not first
    assert all(launch(10) is grown for _ in range(3))   # epochs 2, 3, 4
    fresh = launch(10)                          # no epoch 5 (_EPOCHS): anew
    assert fresh is not grown and not fresh.any()
    assert [c[2] for c in calls] == [1, 2, 1, 2, 3, 4, 1]
    assert [c[1] for c in calls] == [1024, 1024] + [3000] * 4 + [1024]
    assert calls[0][0] == calls[1][0] == first.data_ptr()


def test_scan_scratch_per_stream(monkeypatch):
    """Launches on two streams of one device (two replicas of -devices on
    one card) each get their own look-back scratch and their own epochs,
    interleaved as they issue; the key is the device and its current
    stream (0 off the card)."""
    calls = []
    monkeypatch.setattr(ck, "_launch", lambda name, dev, *a, count:
                        calls.append(a[-3:]))
    monkeypatch.setattr(ck, "_scan_scratch", {})
    dev = torch.device("cpu")
    assert ck._scratch_key(dev) == (dev, 0)
    stream = {"id": 0}
    monkeypatch.setattr(ck, "_scratch_key",
                        lambda d: (d, stream["id"]))
    for k in range(6):
        stream["id"] = 11 + k % 2
        ck._scan_launch("chain_scan", dev, None, None, 1, 1000, 1, 2, None,
                        0, None, count="chain_scan")
    a, b = ck._scan_scratch[(dev, 11)][0], ck._scan_scratch[(dev, 12)][0]
    assert a is not b and len(ck._scan_scratch) == 2
    assert [c[2] for c in calls] == [1, 1, 2, 2, 3, 3]
    assert [c[0] for c in calls] == [a.data_ptr(), b.data_ptr()] * 3


def test_cpu_dispatch_runs_plain_versions(genome, monkeypatch):
    """CPU tensors take the plain versions and count no launch; the
    kernel library is never loaded."""
    monkeypatch.setattr(ck, "_load_kernel", lambda: pytest.fail("loaded"))
    ck.STATS.reset()
    seeds = _seeds(genome)
    fm3 = DeviceFM3.from_host(genome["idx"], genome["tfm"], pfx_k=0)
    kern = tfs.build_seed_chain_kernel(fm3, genome["tctx"], BUCKET, B)
    kern(torch.from_numpy(genome["packed"]), torch.from_numpy(genome["rlens"]))
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], B)
    assert torch.equal(scan.off, ck.chain_scan_plain(seeds[4], seeds[0]))
    for got, want in zip(scan, ck.chain_scan_seeds_plain(seeds[4], seeds[0],
                                                         B)):
        assert torch.equal(got, want)
    hits = ck.chain_hits(genome["tfm"], scan, *seeds[:5], B)
    args = (genome["tctx"], torch.from_numpy(genome["packed"]),
            torch.from_numpy(genome["rlens"]), scan.off, hits, seeds[5],
            BUCKET)
    H2 = B // 2
    outs = [torch.full((2 * B + 2 * H2 + B // 2 + B // 32 + 2,), -7,
                       dtype=torch.int32) for _ in range(2)]
    mmp = ck.chain_classify_pack(*args, outs[0], H2)
    assert torch.equal(mmp, ck.chain_classify_pack_plain(*args, outs[1], H2))
    assert torch.equal(outs[0], outs[1])
    assert sum(ck.STATS.launches.values()) == 0


def _valid_args(genome):
    seeds = _seeds(genome)
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], 2 * B)
    hits = ck.chain_hits(genome["tfm"], scan, *seeds[:5], 2 * B)
    packed = torch.from_numpy(genome["packed"])
    rlens = torch.from_numpy(genome["rlens"])
    H2 = B
    out = torch.zeros(2 * B + 2 * H2 + B // 2 + B // 32 + 2,
                      dtype=torch.int32)
    return seeds, scan, hits, packed, rlens, out, H2


@pytest.mark.parametrize("bad", [
    "scan_dtype", "scan_n_shape", "scan_3d", "scan_counts_2d", "hits_dtype",
    "hits_off", "hits_start", "hits_devices", "classify_pack_rlens",
    "classify_pack_packed", "classify_pack_hits", "classify_pack_off",
    "classify_pack_planes", "classify_pack_device", "classify_pack_out",
    "classify_pack_batch", "classify_pack_overflow"])
def test_wrapper_refusals(genome, bad):
    seeds, scan, hits, packed, rlens, out, H2 = _valid_args(genome)
    off = scan.off
    n_seeds, s_rpos, s_len, s_x0, s_freq, overflow = seeds
    meta = torch.empty(B, device="meta")
    ctx, fm = genome["tctx"], genome["tfm"]
    calls = {
        "scan_dtype": (TypeError, lambda: ck.chain_scan_seeds(
            s_freq.to(torch.int32), n_seeds, 2 * B)),
        "scan_n_shape": (ValueError, lambda: ck.chain_scan_seeds(
            s_freq, n_seeds[:-1], 2 * B)),
        "scan_3d": (ValueError, lambda: ck.chain_scan_seeds(
            s_freq[:, :, None], n_seeds, 2 * B)),
        "scan_counts_2d": (ValueError, lambda: ck.chain_scan(
            s_freq.to(torch.int32))),
        "hits_dtype": (TypeError, lambda: ck.chain_hits(
            fm, scan, n_seeds, s_rpos.to(torch.int32), s_len, s_x0, s_freq,
            2 * B)),
        "hits_off": (ValueError, lambda: ck.chain_hits(
            fm, scan._replace(off=off[:-1]), n_seeds, s_rpos, s_len, s_x0,
            s_freq, 2 * B)),
        "hits_start": (ValueError, lambda: ck.chain_hits(
            fm, scan, n_seeds, s_rpos, s_len, s_x0, s_freq, 4 * B)),
        "hits_devices": (ValueError, lambda: ck.chain_hits(
            fm, scan, meta.to(torch.int64), s_rpos, s_len, s_x0, s_freq,
            2 * B)),
        "classify_pack_rlens": (TypeError, lambda: ck.chain_classify_pack(
            ctx, packed, rlens.to(torch.int64), off, hits, overflow, BUCKET,
            out, H2)),
        "classify_pack_packed": (ValueError, lambda: ck.chain_classify_pack(
            ctx, packed[:, :-4], rlens, off, hits, overflow, BUCKET, out,
            H2)),
        "classify_pack_hits": (TypeError, lambda: ck.chain_classify_pack(
            ctx, packed, rlens, off, hits._replace(keep=hits.keep.to(
                torch.uint8)), overflow, BUCKET, out, H2)),
        "classify_pack_off": (ValueError, lambda: ck.chain_classify_pack(
            ctx, packed, rlens, off[:-1], hits, overflow, BUCKET, out, H2)),
        "classify_pack_planes": (ValueError, lambda: ck.chain_classify_pack(
            ctx, packed, rlens, off, hits, overflow, BUCKET, out, H2,
            tdp.DevicePlanes.zeros(100, "cpu"))),
        "classify_pack_device": (ValueError, lambda: ck.chain_classify_pack(
            ctx, packed.to("meta"), rlens.to("meta"), off.to("meta"),
            ck.Hits(*(t.to("meta") for t in hits)), overflow.to("meta"),
            BUCKET, out.to("meta"), H2)),
        "classify_pack_out": (ValueError, lambda: ck.chain_classify_pack(
            ctx, packed, rlens, off, hits, overflow, BUCKET, out[:-1], H2)),
        "classify_pack_batch": (ValueError, lambda: ck.chain_classify_pack(
            ctx, packed[:B - 16], rlens[:B - 16], off[:B - 15],
            hits._replace(unresolved=hits.unresolved[:B - 16]),
            overflow[:B - 16], BUCKET, out, H2)),
        "classify_pack_overflow": (TypeError, lambda: ck.chain_classify_pack(
            ctx, packed, rlens, off, hits, overflow.to(torch.int32), BUCKET,
            out, H2)),
    }
    exc, call = calls[bad]
    with pytest.raises(exc):
        call()
