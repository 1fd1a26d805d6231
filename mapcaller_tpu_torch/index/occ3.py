"""3-step (trinucleotide) occ table for the device seeding kernel.

The seeding hot loop (ref: src/bwt_search.cpp:121-164) is gather-bound:
every extension step costs two occ-row gathers. A k-step FM-index
(Chacon et al., n-step FM-index; public technique) extends the backward
search k bases per lookup: BWT_k[j] = the k text characters preceding
suffix j, and Occ_k over the 4^k-symbol alphabet gives the interval
update for a k-gram prepend in one step.

We use k=3: rows of 64 int32 cumulative counts + 16 packed symbol
bytes per 16 BWT rows (288 B), so one extension iteration covers three
bases. The 1-step lookups the state machine still needs (tail bases,
exact MEM-end replay) are DERIVED from the same gathered row: group
sums over the 64 counts plus two constant-row corrections, so the
kernel never touches a second table.

Row/symbol conventions (all in TRUE row index space 0..n, primary row
included — unlike bwa's hole-adjusted occ, no kadj is needed):

  sym[j] = T[p-3]*16 + T[p-2]*4 + T[p-1]  where p = sa_full[j]
           (row 0 has p = n); rows with p in {0,1,2} have no 3-char
           context and get sentinel 255.
  occ3 checkpoint row w = counts of each sym among rows [0, 16*w).
  c3_first[d] = first row whose suffix starts with 3-gram d
           (rank base for the 3-step interval update).

Correction constants (see DeviceFM3 docstring for the algebra):
  row_p1/row_p2 = rows of the suffixes at text positions 1 and 2 —
           excluded from occ3 but valid for 1-/2-char contexts;
  t0,t1 = T[0],T[1] (their preceding chars);
  tail1,tail2a,tail2b = T[n-1], T[n-2], T[n-1] — the forward-space
           tails of the occurrences that cannot extend by a full
           3-gram (interval-ordering corrections for x0).
"""
from __future__ import annotations

import dataclasses

import numpy as np

SENTINEL = 255


@dataclasses.dataclass
class Occ3Table:
    rows: np.ndarray       # int32[nw3, 72]: cnt[64], sym_words[4], pad[4]
    c3_first: np.ndarray   # int32[64]
    row_p1: int
    row_p2: int
    t0: int                # T[0]
    t1: int                # T[1]
    tail1: int             # T[n-1]
    tail2a: int            # T[n-2]
    tail2b: int            # T[n-1]


def _build_rows_numpy(sa_full: np.ndarray, text: np.ndarray,
                      n: int, nw3: int) -> np.ndarray:
    p = sa_full.astype(np.int64)
    valid = p >= 3
    ps = np.where(valid, p, 3)
    T = text.astype(np.int32)
    sym = np.where(valid,
                   T[ps - 3] * 16 + T[ps - 2] * 4 + T[ps - 1],
                   SENTINEL).astype(np.uint8)
    syms_pad = np.full(nw3 * 16, SENTINEL, dtype=np.uint8)
    syms_pad[:n + 1] = sym
    blocks = syms_pad.reshape(nw3, 16)
    rows = np.zeros((nw3, 72), dtype=np.int64)
    for d in range(64):
        per_block = (blocks == d).sum(axis=1)
        rows[1:, d] = np.cumsum(per_block, dtype=np.int64)[:-1]
    assert rows[:, :64].max() < 2**31
    # pack 16 symbol bytes into 4 little-endian int32 words
    w = blocks.astype(np.uint32).reshape(nw3, 4, 4)
    shifts = (np.arange(4, dtype=np.uint32) * 8)[None, None, :]
    rows[:, 64:68] = (w << shifts).sum(axis=2, dtype=np.uint32).astype(np.int64)
    return rows.astype(np.int32)


def _build_native(sa_full: np.ndarray, text: np.ndarray, n: int, nw3: int):
    try:
        import ctypes as C

        from ..native import load_lib
        lib = load_lib()
    except Exception:
        return None
    rows = np.zeros((nw3, 72), dtype=np.int32)
    c3_first = np.zeros(64, dtype=np.int32)
    aux = np.zeros(2, dtype=np.int64)
    sa32 = np.ascontiguousarray(sa_full, dtype=np.int32)
    txt = np.ascontiguousarray(text, dtype=np.uint8)
    lib.mc_build_occ3(sa32.ctypes.data_as(C.c_void_p),
                      txt.ctypes.data_as(C.c_void_p),
                      C.c_int64(n),
                      rows.ctypes.data_as(C.c_void_p),
                      C.c_int64(nw3),
                      c3_first.ctypes.data_as(C.c_void_p),
                      aux.ctypes.data_as(C.c_void_p))
    return rows, c3_first, int(aux[0]), int(aux[1])


def _build_numpy(sa_full: np.ndarray, text: np.ndarray, n: int, nw3: int):
    rows32 = _build_rows_numpy(sa_full, text, n, nw3)
    p = sa_full.astype(np.int64)
    T = text.astype(np.int32)
    # c3_first: suffix-start keys in base 5 (pad = 0, so short suffixes
    # sort before any extension — matching suffix-array order)
    idx0 = np.minimum(p, n - 1)
    k0 = np.where(p < n, T[idx0] + 1, 0)
    idx1 = np.minimum(p + 1, n - 1)
    k1 = np.where(p + 1 < n, T[idx1] + 1, 0)
    idx2 = np.minimum(p + 2, n - 1)
    k2 = np.where(p + 2 < n, T[idx2] + 1, 0)
    keys = k0 * 25 + k1 * 5 + k2
    d = np.arange(64)
    dkeys = ((d >> 4) + 1) * 25 + (((d >> 2) & 3) + 1) * 5 + ((d & 3) + 1)
    c3_first = np.searchsorted(keys, dkeys, side="left").astype(np.int32)
    row_p1 = int(np.nonzero(p == 1)[0][0])
    row_p2 = int(np.nonzero(p == 2)[0][0])
    return rows32, c3_first, row_p1, row_p2


def build_occ3(sa_full: np.ndarray, text: np.ndarray) -> Occ3Table:
    """sa_full int[n+1] (row -> text pos, sa_full[0] = n), text uint8[n]."""
    n = int(text.size)
    assert sa_full.size == n + 1 and n >= 4
    nw3 = (n + 16) // 16 + 2               # guard rows for gathers at n+1
    built = _build_native(sa_full, text, n, nw3)
    if built is None:
        built = _build_numpy(sa_full, text, n, nw3)
    rows32, c3_first, row_p1, row_p2 = built
    return Occ3Table(rows=rows32, c3_first=c3_first,
                     row_p1=row_p1, row_p2=row_p2,
                     t0=int(text[0]), t1=int(text[1]),
                     tail1=int(text[n - 1]), tail2a=int(text[n - 2]),
                     tail2b=int(text[n - 1]))


@dataclasses.dataclass
class Occ3Table64:
    """Shard-relative occ3 table for >2^31-row texts (the big-genome /
    human-scale format; reference index types are uint64 end to end,
    ref: src/BWT_Index/bwt.h:44,47-56). Row counts are relative to the
    owning shard's base counts so the 288 B row stays int32; absolute
    count = base3[shard][d] + rows[w][d], recombined in the x64 device
    kernels (parallel/big_index.py)."""
    rows: np.ndarray       # int32[nw3, 72] (possibly a disk memmap)
    base3: np.ndarray      # int64[n_shards, 64]
    c3_first: np.ndarray   # int64[64]
    words_per_shard: int
    row_p1: int
    row_p2: int
    t0: int
    t1: int
    tail1: int
    tail2a: int
    tail2b: int


def build_occ3_64(sa_full: np.ndarray, text: np.ndarray,
                  words_per_shard: int = 0,
                  rows_out: np.ndarray | None = None) -> Occ3Table64:
    """Native streaming build of the shard-relative table. sa_full must
    be int64[n+1]; rows_out lets the caller pass a preallocated (e.g.
    disk-memmapped) int32[nw3, 72] buffer so multi-GB tables never need
    a second in-RAM copy."""
    import ctypes as C

    from ..native import _ptr, load_lib
    lib = load_lib()
    if not hasattr(lib, "_occ364_bound"):
        lib.mc_build_occ3_64.argtypes = [C.c_void_p, C.c_void_p, C.c_int64,
                                         C.c_void_p, C.c_int64, C.c_int64,
                                         C.c_void_p, C.c_void_p, C.c_void_p]
        lib.mc_build_occ3_64s.argtypes = [C.c_void_p, C.c_int32, C.c_void_p,
                                          C.c_int64, C.c_void_p, C.c_int64,
                                          C.c_int64, C.c_void_p, C.c_void_p,
                                          C.c_void_p]
        lib._occ364_bound = True
    n = int(text.size)
    # int32 sa_full (texts < 2^31 rows) is read directly — upcasting a
    # 1 Gbp-scale SA to int64 on the host costs a 16 GB copy
    assert sa_full.dtype in (np.int64, np.int32) and sa_full.size == n + 1
    nw3 = (n + 16) // 16 + 2
    wps = words_per_shard if words_per_shard > 0 else nw3
    n_shards = -(-nw3 // wps)
    if rows_out is None:
        rows_out = np.zeros((nw3, 72), dtype=np.int32)
    assert rows_out.shape == (nw3, 72) and rows_out.dtype == np.int32
    base3 = np.zeros((n_shards, 64), dtype=np.int64)
    c3_first = np.zeros(64, dtype=np.int64)
    aux = np.zeros(2, dtype=np.int64)
    txt = np.ascontiguousarray(text, dtype=np.uint8)
    lib.mc_build_occ3_64s(_ptr(sa_full),
                          C.c_int32(1 if sa_full.dtype == np.int32 else 0),
                          _ptr(txt), C.c_int64(n),
                          _ptr(rows_out), C.c_int64(nw3), C.c_int64(wps),
                          _ptr(base3), _ptr(c3_first), _ptr(aux))
    return Occ3Table64(rows=rows_out, base3=base3, c3_first=c3_first,
                       words_per_shard=wps,
                       row_p1=int(aux[0]), row_p2=int(aux[1]),
                       t0=int(text[0]), t1=int(text[1]),
                       tail1=int(text[n - 1]), tail2a=int(text[n - 2]),
                       tail2b=int(text[n - 1]))


def occ3_meta(tab: Occ3Table) -> dict:
    """JSON-serializable scalars of an Occ3Table (the rows array is
    persisted separately as a raw .bin, see fmindex.FMIndex.save)."""
    return {"nw3": int(tab.rows.shape[0]),
            "c3_first": [int(x) for x in tab.c3_first],
            "row_p1": tab.row_p1, "row_p2": tab.row_p2,
            "t0": tab.t0, "t1": tab.t1, "tail1": tab.tail1,
            "tail2a": tab.tail2a, "tail2b": tab.tail2b}


def occ3_from_meta(meta: dict, rows: np.ndarray) -> Occ3Table:
    return Occ3Table(rows=rows,
                     c3_first=np.asarray(meta["c3_first"], dtype=np.int32),
                     row_p1=int(meta["row_p1"]), row_p2=int(meta["row_p2"]),
                     t0=int(meta["t0"]), t1=int(meta["t1"]),
                     tail1=int(meta["tail1"]), tail2a=int(meta["tail2a"]),
                     tail2b=int(meta["tail2b"]))


def occ3_oracle(tab: Occ3Table, d: int, i: int) -> int:
    """# rows j < i with sym[j] == d (test oracle)."""
    w, m = i >> 4, i & 15
    cnt = int(tab.rows[w, d])
    words = tab.rows[w, 64:68].astype(np.uint32)
    syms = (words[np.arange(16) >> 2] >> ((np.arange(16) & 3) * 8)) & 0xFF
    return cnt + int(((syms[:m] == d)).sum())
