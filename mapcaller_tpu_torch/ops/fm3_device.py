"""Device-resident 3-step FM-index lookups (see index/occ3.py for the
table layout and conventions). Port of mapcaller_tpu/ops/fm3_device.py.

Everything the greedy-MEM state machine needs per iteration derives
from TWO gathered 288-byte occ3 rows (interval start and end):

  * the 3-step interval update for the prepended trinucleotide,
  * the 1-step update (tail bases / exact-MEM-end replay) via group
    sums over the 64 counts plus the row_p1/row_p2 corrections,
  * the forward-interval (x0) ordering sums via the arithmetic
    bit-reversal rev3(d) = 63 - ((d&3)*16 + (d&12) + (d>>4)).

Replaces the per-base occ4 pair of ops/fm_device.py in the seeding hot
loop (ref: src/bwt_search.cpp:121-164): ~3x fewer sequential gathers.
Interval state (x0, x1, x2) is int64 here; every value is below 2^31 and
equals the reference package's int32 state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..index.occ3 import build_occ3
from .fm_device import DeviceFMIndex, occ4, to_i32


def _occ3_row_chunks(sa: torch.Tensor, words: torch.Tensor, n: int,
                     nw3: int, chunk_rows: int):
    """Build the occ3 rows on the device from the resident full SA and
    the packed text words (int64 holding uint32, bwa crumb order), so the
    host never builds or ships an 18 B/text-base table; chunk_rows rows
    at a time, each chunk's counts continuing the last one's, so a build
    holds one chunk's transients (`-shards N` builds a shard at a time).

    Yields (first row, rows int32[m, 72]) for consecutive row ranges."""
    dev = sa.device
    carry = None
    for r0 in range(0, nw3, chunk_rows):
        m = min(chunk_rows, nw3 - r0)
        k = max(0, min((r0 + m) * 16, sa.shape[0]) - r0 * 16)  # SA rows
        rows, carry = occ3_block(
            torch.cat([sa[r0 * 16:r0 * 16 + k].to(torch.int64),
                       torch.full((m * 16 - k,), -1, dtype=torch.int64,
                                  device=dev)]), words, n, carry)
        yield r0, rows


def occ3_block(p: torch.Tensor, words: torch.Tensor, n: int, carry=None):
    """The occ3 rows of SA entries p (int64[16 m]: text positions, -1
    past the text's n + 1 rows) on p's device, their counts starting at
    carry (int32[64]; None: at zero) -> (rows int32[m, 72], the counts
    after them)."""
    dev = p.device
    m = p.shape[0] // 16
    # sym[j] = T[p-3]*16 + T[p-2]*4 + T[p-1]; the three crumbs live in
    # at most two adjacent bwa-order words (T[i] = w[i>>4] >> (15-i&15)*2)
    q = torch.clamp(p - 3, 0, n)
    wi = q >> 4
    off = q & 15
    w0 = words[wi]
    w1 = words[wi + 1]
    sym_a = (w0 >> (torch.clamp(13 - off, min=0) * 2)) & 63
    sym_b = ((w0 & 15) << 2) | (w1 >> 30)
    sym_c = ((w0 & 3) << 4) | (w1 >> 28)
    sym3 = torch.where(off <= 13, sym_a,
                       torch.where(off == 14, sym_b, sym_c))
    sym = torch.where(p >= 3, sym3, 255)
    del p, q, wi, off, w0, w1, sym_a, sym_b, sym_c, sym3

    # per-block symbol histogram (sentinel 255 goes to a dropped
    # column), then the exclusive prefix sum over blocks after the
    # chunks before
    blocks = sym.reshape(m, 16)
    per = torch.zeros((m, 65), dtype=torch.int32, device=dev)
    per.scatter_add_(1, torch.clamp(blocks, max=64),
                     torch.ones_like(blocks, dtype=torch.int32))
    # the prefix sum runs along the inner dimension of the transposed
    # histogram: a scan over the outer dimension of a 64-wide tensor
    # runs one thread per column on CUDA
    cnt = torch.zeros((64, m), dtype=torch.int32, device=dev)
    cnt[:, 1:] = torch.cumsum(per[:-1, :64].t(), dim=1,
                              dtype=torch.int32)
    if carry is not None:
        cnt += carry[:, None]
    carry = cnt[:, -1] + per[-1, :64]
    cnt = cnt.t()
    del per

    # 4 symbol bytes per little-endian word
    packed = (sym[0::4] | (sym[1::4] << 8) | (sym[2::4] << 16)
              | (sym[3::4] << 24))
    rows = torch.cat([cnt, to_i32(packed).reshape(m, 4),
                      torch.zeros((m, 4), dtype=torch.int32,
                                  device=dev)], dim=1)
    del cnt, packed, sym, blocks
    return rows, carry


def c3_first_of(words: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """c3_first[d] = #{suffixes whose base-5 start key < dkey(d)}: a
    multiset count, so a histogram of the 125 keys (the n + 1 suffixes,
    `chunk` at a time) and its prefix sum. int64[64]."""
    dev = words.device
    hist = torch.zeros(125, dtype=torch.int64, device=dev)
    for i0 in range(0, n + 1, chunk):
        m = min(chunk, n + 1 - i0)
        i = torch.arange(i0, min(i0 + m + 2, n), dtype=torch.int64,
                         device=dev)
        # a base's key digit is its code + 1; past the text, 0
        T1 = ((words[i >> 4] >> ((15 - (i & 15)) * 2)) & 3) + 1
        del i
        T1 = torch.cat([T1, torch.zeros(m + 2 - T1.shape[0],
                                        dtype=torch.int64, device=dev)])
        keys = T1[:m] * 25 + T1[1:m + 1] * 5 + T1[2:m + 2]
        del T1
        hist += torch.bincount(keys, minlength=125)
        del keys
    lt = torch.cumsum(hist, 0) - hist                  # #keys < value
    d = np.arange(64)
    dkeys = ((d >> 4) + 1) * 25 + (((d >> 2) & 3) + 1) * 5 + ((d & 3) + 1)
    return lt[torch.as_tensor(dkeys, device=dev)]


def occ3_parts(idx: FMIndex, fm: DeviceFMIndex,
               text_words: torch.Tensor | None = None,
               chunk_rows: int | None = None):
    """The occ3 table of idx (without prefix-skip rows) on fm's device,
    chunk_rows rows at a time (default: one chunk), and its constants:
    built on the device from fm's full SA, or without it from the
    persisted artifact (disk memmap) or a host rebuild, uploaded a chunk
    at a time. -> (iterator of (first row, int32[m, 72]), number of rows,
    dict of c3_first, row_p1, row_p2, t0, t1, tail1, tail2a, tail2b)."""
    dev = fm.device
    if fm.has_full_sa and idx.sa_full.dtype == np.int32:
        if text_words is None:
            text_words = packed_text_words(idx, dev)
        n = idx.seq_len
        nw3 = (n + 16) // 16 + 2
        chunk_rows = chunk_rows or nw3
        sa = fm.sa_full
        pp = torch.stack([torch.argmax((sa == 1).to(torch.uint8)),
                          torch.argmax((sa == 2).to(torch.uint8))])
        pp = pp.cpu().numpy()
        c0, c1 = int(idx.ref.codes[0]), int(idx.ref.codes[1])
        consts = dict(c3_first=c3_first_of(text_words, n, 16 * chunk_rows)
                      .to(torch.int32),
                      row_p1=int(pp[0]), row_p2=int(pp[1]),
                      t0=c0, t1=c1, tail1=3 - c0, tail2a=3 - c1,
                      tail2b=3 - c0)
        return (_occ3_row_chunks(sa, text_words, n, nw3, chunk_rows), nw3,
                consts)
    tab = idx.occ3_table
    if tab is None:
        tab = build_occ3(idx.sa_full, idx.ref.fwd_rc_codes())
    nw3 = int(tab.rows.shape[0])
    chunk_rows = chunk_rows or nw3
    chunks = ((r0, torch.as_tensor(np.array(tab.rows[r0:r0 + chunk_rows]),
                                   device=dev))
              for r0 in range(0, nw3, chunk_rows))
    consts = dict(c3_first=torch.as_tensor(
                      np.asarray(tab.c3_first, dtype=np.int32), device=dev),
                  row_p1=tab.row_p1, row_p2=tab.row_p2, t0=tab.t0,
                  t1=tab.t1, tail1=tab.tail1, tail2a=tab.tail2a,
                  tail2b=tab.tail2b)
    return chunks, nw3, consts


@dataclasses.dataclass
class DeviceFM3:
    """pfx_base > 0 enables the FUSED prefix-skip: the interval states
    after the first pfx_k bases of every possible extension start are
    EMBEDDED as extra rows at occ3_rows[pfx_base + key // 16], so an
    extension start uses its iteration's first occ3 gather slot (the
    start lane was gathering a dummy row anyway) and jumps pfx_k bases
    at zero extra gathers per iteration."""
    fm: DeviceFMIndex          # 1-step table (sa_resolve / occ4) + L2
    occ3_rows: torch.Tensor    # int32[nw3 (+ 4^pfx_k / 16), 72]
    c3_first: torch.Tensor     # int32[64]
    row_p1: int                # correction constants
    row_p2: int
    t0: int
    t1: int
    tail1: int
    tail2a: int
    tail2b: int
    pfx_k: int = 0
    pfx_base: int = 0          # first prefix row index (0 = disabled)

    @property
    def L2(self):
        return self.fm.L2

    @property
    def primary(self):
        return self.fm.primary

    @property
    def seq_len(self):
        return self.fm.seq_len

    @classmethod
    def from_host(cls, idx: FMIndex, dev_fm: DeviceFMIndex | None = None,
                  pfx_k: int = 0, text_words: torch.Tensor | None = None,
                  device="cuda") -> "DeviceFM3":
        """Build the 3-step tables from the host index arrays on `device`
        (the device of dev_fm when one is given). text_words: the packed
        fwd+rc text (int64 holding uint32, 2 zero words of tail) when the
        caller already holds it on the device (ChainCtx)."""
        if idx.sa_full is None:
            raise NotImplementedError(
                "occ3 build requires sa_full; an index without it seeds "
                "with the 1-step scan (DeviceBackend picks it)")
        if not 0 <= pfx_k <= 15:      # must stay below MinSeedLength
            raise ValueError(f"pfx_k={pfx_k} outside [0, 15]")
        fm = (dev_fm if dev_fm is not None
              else DeviceFMIndex.from_host(idx, device=device))
        chunks, _, consts = occ3_parts(idx, fm, text_words)
        kw = dict(fm=fm, occ3_rows=next(chunks)[1], **consts)
        pfx_base = 0
        nrows = int(kw["occ3_rows"].shape[0])
        # fused skip rows must keep (row << 4) + entry inside int32
        # (16 prefix entries pack into each appended 72-int32 row)
        if pfx_k > 1 and ((nrows + (1 << (2 * pfx_k)) // 16 + 2) << 4
                          ) < (1 << 31):
            tab_p = build_prefix_table(fm, pfx_k)          # [4^K, 4]
            kw["occ3_rows"] = _embed_pfx(kw["occ3_rows"], tab_p)
            pfx_base = nrows
        else:
            pfx_k = 0
        return cls(pfx_k=pfx_k, pfx_base=pfx_base, **kw)


def packed_text_words(idx: FMIndex, device) -> torch.Tensor:
    """The fwd+rc text packed 16 crumbs per word (bwa order) plus two
    zero words, as int64 holding uint32, on `device`."""
    from ..index.fmindex import pack_words
    w = pack_words(idx.ref.fwd_rc_codes())
    w = np.concatenate([w, np.zeros(2, dtype=np.uint32)]).astype(np.int64)
    return torch.from_numpy(w).to(device)


def _embed_pfx(rows: torch.Tensor, pfx_tab: torch.Tensor) -> torch.Tensor:
    """Append the prefix-skip states PACKED 16 entries per 72-int32 row
    (entry e of row r = count slots [4e, 4e+4) = (x0, x1, x2, 0)), so
    they share the occ3 gather path at 18 B/entry. The gather index for
    prefix key p is (pfx_base << 4) + p."""
    n_ent = pfx_tab.shape[0]          # 4^K, K >= 2 so a multiple of 16
    packed = pfx_tab.to(torch.int32).reshape(n_ent // 16, 64)
    ext = torch.cat([packed,
                     torch.zeros((n_ent // 16, rows.shape[1] - 64),
                                 dtype=torch.int32, device=rows.device)],
                    dim=1)
    return torch.cat([rows, ext], dim=0)


def gather3(fm3: DeviceFM3, i: torch.Tensor):
    """One row gather: (cnt64 int64[...,64], syms int64[...,16],
    m = i & 15). Symbol byte q of the row sits in byte q&3 of word q>>2."""
    return decode3(fm3.occ3_rows[i >> 4], i)


def decode3(row: torch.Tensor, i: torch.Tensor):
    """gather3's result from the gathered occ3 rows of indices i."""
    cnt64 = row[..., :64].to(torch.int64)
    w = row[..., 64:68].to(torch.int64)
    sh = torch.arange(0, 32, 8, dtype=torch.int64, device=i.device)
    syms = ((w[..., :, None] >> sh) & 0xFF).reshape(w.shape[:-1] + (16,))
    return cnt64, syms, (i & 15)


_D64 = np.arange(64, dtype=np.int64)
_REV3 = 63 - ((_D64 & 3) * 16 + (_D64 & 12) + (_D64 >> 4))


def _qpos(dev) -> torch.Tensor:
    return torch.arange(16, dtype=torch.int64, device=dev)


def occ3_d(cnt64, syms, m, d):
    """Occ3(d, i): # rows j < i with symbol d."""
    base = cnt64.gather(-1, d[..., None])[..., 0]
    part = ((syms == d[..., None]) & (_qpos(d.device) < m[..., None])).sum(-1)
    return base + part


def occ1_4(fm3: DeviceFM3, cnt64, syms, m, i):
    """Derived 1-step counts for all 4 bases at row index i
    (== bwa bwt_occ4(i-1), ref: src/bwt_search.cpp:49-66): group sums of
    the 64 trinucleotide counts by last base + the two excluded-row
    corrections (rows p=1, p=2 have 1-char contexts T[0], T[1])."""
    B = cnt64.shape[:-1]
    grp = cnt64.reshape(B + (16, 4)).sum(dim=-2)            # [...,4]
    valid = (syms < 64) & (_qpos(m.device) < m[..., None])
    lane_c = syms & 3
    c4 = torch.arange(4, dtype=torch.int64, device=m.device)
    part = (valid[..., None, :] & (lane_c[..., None, :] == c4[:, None])
            ).sum(-1)
    out = grp + part
    corr1 = (i > fm3.row_p1).to(torch.int64)
    corr2 = (i > fm3.row_p2).to(torch.int64)
    oh1 = (c4 == fm3.t0).to(torch.int64)
    oh2 = (c4 == fm3.t1).to(torch.int64)
    return out + corr1[..., None] * oh1 + corr2[..., None] * oh2


def rev3_lt_w_sum(cnt64, syms, m, w):
    """For the x0 ordering update: checkpoint part
    sum_d cnt64[d]*[rev3(d) < w] and within-word part
    #{q < m : sym_q valid, rev3(sym_q) < w}. Returns their sum."""
    rev3 = torch.as_tensor(_REV3, device=w.device)
    base = torch.where(rev3 < w[..., None], cnt64, 0).sum(-1)
    rev_s = 63 - ((syms & 3) * 16 + (syms & 12) + (syms >> 4))
    part = ((syms < 64) & (rev_s < w[..., None])
            & (_qpos(w.device) < m[..., None])).sum(-1)
    return base + part


def step3_update(fm3: DeviceFM3, x0, x1, x2, e0, e1, e2, gk, gl):
    """3-step interval update for appending read bases e0,e1,e2 (forward
    order). gk/gl = gather3 results at x1 and x1+x2.
    Returns (new_x0, new_x1, new_x2)."""
    cntK, symsK, mK = gk
    cntL, symsL, mL = gl
    d = (3 - e2) * 16 + (3 - e1) * 4 + (3 - e0)
    w = e0 * 16 + e1 * 4 + e2
    tk3 = occ3_d(cntK, symsK, mK, d)
    tl3 = occ3_d(cntL, symsL, mL, d)
    new_x1 = fm3.c3_first.to(torch.int64)[d] + tk3
    new_x2 = tl3 - tk3
    lo, hi = x1, x1 + x2   # interval [lo, hi)
    x0_extra = (rev3_lt_w_sum(cntL, symsL, mL, w)
                - rev3_lt_w_sum(cntK, symsK, mK, w))

    def contains(r):
        return ((lo <= r) & (r < hi)).to(torch.int64)

    cmp1 = (fm3.tail1 <= e0).to(torch.int64)
    cmp2 = ((fm3.tail2a < e0)
            | ((fm3.tail2a == e0) & (fm3.tail2b <= e1))).to(torch.int64)
    adj = (contains(fm3.primary) + contains(fm3.row_p1) * cmp1
           + contains(fm3.row_p2) * cmp2)
    return x0 + adj + x0_extra, new_x1, new_x2


def step1_update(fm3: DeviceFM3, x0, x1, x2, e0, gk, gl):
    """Derived 1-step update for appending read base e0 (ref:
    src/bwt_search.cpp:121-164 / bwa bwt_extend)."""
    L2 = fm3.L2
    cntK, symsK, mK = gk
    cntL, symsL, mL = gl
    tk = occ1_4(fm3, cntK, symsK, mK, x1)
    tl = occ1_4(fm3, cntL, symsL, mL, x1 + x2)
    ok_x1 = L2[:4][None, :] + 1 + tk
    ok_x2 = tl - tk
    adj = ((x1 <= fm3.primary) & (x1 + x2 - 1 >= fm3.primary)).to(x0.dtype)
    ok3_x0 = x0 + adj
    ok2_x0 = ok3_x0 + ok_x2[:, 3]
    ok1_x0 = ok2_x0 + ok_x2[:, 2]
    ok0_x0 = ok1_x0 + ok_x2[:, 1]
    ok_x0 = torch.stack([ok0_x0, ok1_x0, ok2_x0, ok3_x0], dim=-1)
    ci = (3 - e0)[:, None]
    return (ok_x0.gather(1, ci)[:, 0], ok_x1.gather(1, ci)[:, 0],
            ok_x2.gather(1, ci)[:, 0])


def build_prefix_table(fm: DeviceFMIndex, K: int) -> torch.Tensor:
    """Interval-state lookup table for all 4^K read prefixes: entry
    (e0..e_{K-1}) holds (x0, x1, x2, 0) after K forward-extension steps
    from scratch, built level by level with the occ4 ladder. An empty
    entry (x2 == 0: the MEM ends inside the first K bases) falls back to
    the 1-step walk in the scan, so the seed set does not depend on K."""
    L2 = fm.L2
    dev = fm.device
    c = torch.arange(4, dtype=torch.int64, device=dev)
    x0 = L2[c] + 1
    x1 = L2[3 - c] + 1
    x2 = L2[c + 1] - L2[c]
    ci = 3 - c
    for _ in range(1, K):
        alive = x2 > 0
        k1 = torch.where(alive, x1 - 1, 0)
        k2 = torch.where(alive, x1 - 1 + x2, 0)
        tk = occ4(fm, k1)
        tl = occ4(fm, k2)
        ok_x1 = L2[:4][None, :] + 1 + tk
        ok_x2 = tl - tk
        adj = ((x1 <= fm.primary) & (x1 + x2 - 1 >= fm.primary)
               ).to(torch.int64)
        ok3 = x0 + adj
        ok2 = ok3 + ok_x2[:, 3]
        ok1 = ok2 + ok_x2[:, 2]
        ok0 = ok1 + ok_x2[:, 1]
        ok_x0 = torch.stack([ok0, ok1, ok2, ok3], dim=1)
        x0 = ok_x0[:, ci].reshape(-1)
        x1 = ok_x1[:, ci].reshape(-1)
        x2 = torch.where(alive.repeat_interleave(4),
                         ok_x2[:, ci].reshape(-1), 0)
    return torch.stack([x0, x1, x2, torch.zeros_like(x0)], dim=1)
