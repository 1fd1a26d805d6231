"""FM-index artifact: build, save, load, and host-side (NumPy) queries.

Device-first re-design of the reference's bwt_t (ref: src/structure.h:32-42).
Instead of bwa's interleaved Occ-checkpoint/BWT words we keep flat
arrays — friendlier to XLA gathers:

  bwt_words : uint32[ceil(n/16)]   packed BWT (16 bases/word, base k at
                                   bits (15-k%16)*2..+1, bwa bit order)
  ckpt      : int64[ceil(n/128)+1, 4]  Occ counts at every 128-base block
                                   boundary (over the $-removed BWT)
  sa_samp   : int64[(n+32)//32]    SA sampled every 32 full rows;
                                   sa_samp[0] = -1 (bwa convention,
                                   ref: src/bwt_index.cpp:32)
  L2        : int64[5]             cumulative base counts
  primary   : int                  full row of the suffix at position 0

Text = forward genome + reverse complement (ref: bntseq.c:183-190), so a
hit position >= GenomeSize means reverse strand.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from .packer import PackedReference, pack_fasta
from .suffix import build_suffix_array, bwt_from_sa

OCC_INTERVAL = 128
SA_INTERVAL = 32
# v2: arrays live in a raw <prefix>.mci.bin sidecar (64 B-aligned,
# offsets in the JSON meta) and load as read-only memmaps. The v1
# np.savez zip container streamed ~10 MB/s through zipfile's CRC path
# at load time — ~1 min of startup for a 60 Mb genome, unacceptable
# against the reference's plain fread restore (bwt_restore_bwt,
# ref: src/BWT_Index/bwt.c:642-667).
FORMAT_VERSION = 2


@dataclasses.dataclass
class FMIndex:
    primary: int
    L2: np.ndarray              # int64[5]
    bwt_words: np.ndarray       # uint32[ceil(n/16)]
    ckpt: np.ndarray            # int64[n_blocks+1, 4]
    sa_samp: np.ndarray         # int64[(n+SA)//SA]
    seq_len: int                # n = 2 * genome_size
    ref: PackedReference        # forward-genome codes + chrom metadata
    # Full suffix array over rows 1..n (sa_full[r] = text pos of row r;
    # sa_full[0] = n for the '$' row). Kept when the genome is small
    # enough (4 B/base) so device SA resolution is a single gather
    # instead of the unbounded inverse-Psi walk of bwt_sa
    # (ref: src/BWT_Index/bwt.c:125-136).
    sa_full: Optional[np.ndarray] = None
    # Precomputed 3-step occ table (rows usually a read-only disk
    # memmap): the reference stores Occ checkpoints inside its .bwt
    # artifact at index-build time (bwt_bwtupdate_core,
    # ref: src/BWT_Index/bwtindex.c:53-75) for the same reason — the
    # table is derived data that costs minutes per run at chromosome
    # scale (~2.8 s/Mb host build) if rebuilt on every startup.
    occ3_table: Optional[object] = None

    # ---- metadata helpers ----------------------------------------------
    @property
    def genome_size(self) -> int:
        return self.ref.genome_size

    @property
    def two_genome_size(self) -> int:
        return self.seq_len

    # ---- host-side queries (NumPy oracle; mirrors src/bwt_search.cpp) --
    def bwt_code(self, k_adj: int) -> int:
        """BWT base at $-removed index k_adj (ref: bwt_search.cpp:13-14)."""
        w = int(self.bwt_words[k_adj >> 4])
        return (w >> ((~k_adj & 0xF) << 1)) & 3

    def occ(self, k: int, c: int) -> int:
        """# of base c in BWT full rows [0, k]  (ref: bwt_search.cpp:25-47)."""
        if k == self.seq_len:
            return int(self.L2[c + 1] - self.L2[c])
        if k < 0:
            return 0
        k -= k >= self.primary
        n = int(self.ckpt[k >> 7, c])
        start_w = (k >> 7) << 3          # 8 words per 128-base block
        end_w = k >> 4
        for w in range(start_w, end_w):
            n += _count_code_in_word(int(self.bwt_words[w]), c, 16)
        n += _count_code_in_word(int(self.bwt_words[end_w]), c, (k & 0xF) + 1)
        return n

    def occ4(self, k: int) -> np.ndarray:
        """Occ counts of all 4 bases up to full row k (ref: bwt_search.cpp:49-66)."""
        if k < 0:
            return np.zeros(4, dtype=np.int64)
        k -= k >= self.primary
        cnt = self.ckpt[k >> 7].copy()
        start_w = (k >> 7) << 3
        end_w = k >> 4
        for w in range(start_w, end_w):
            cnt += _count4_in_word(int(self.bwt_words[w]), 16)
        cnt += _count4_in_word(int(self.bwt_words[end_w]), (k & 0xF) + 1)
        return cnt

    def inv_psi(self, k: int) -> int:
        """LF step (ref: bwt_search.cpp:101-107)."""
        x = k - (k > self.primary)
        c = self.bwt_code(x)
        x = int(self.L2[c]) + self.occ(k, c)
        return 0 if k == self.primary else x

    def sa_lookup(self, k: int) -> int:
        """Text position of full row k (ref: bwt_search.cpp:109-119)."""
        sa = 0
        mask = SA_INTERVAL - 1
        while k & mask:
            sa += 1
            k = self.inv_psi(k)
        return sa + int(self.sa_samp[k // SA_INTERVAL])

    # ---- persistence ---------------------------------------------------
    def save(self, prefix: str) -> None:
        arrays = {
            "L2": self.L2,
            "bwt_words": self.bwt_words,
            "ckpt": self.ckpt,
            "sa_samp": self.sa_samp,
            "codes": self.ref.codes,
            "chrom_lengths": np.asarray(self.ref.lengths, dtype=np.int64),
            "chrom_offsets": np.asarray(self.ref.offsets, dtype=np.int64),
        }
        if self.sa_full is not None:
            arrays["sa_full"] = self.sa_full
        table = {}
        off = 0
        # write-then-rename: arrays may be memmaps of the destination
        # file itself (a loaded index being re-saved) — truncating in
        # place would destroy the data under the reader, while a rename
        # leaves live memmaps on the old inode
        with open(prefix + ".mci.bin.tmp", "wb") as f:
            for name, a in arrays.items():
                a = np.ascontiguousarray(a)
                pad = (-off) % 64
                if pad:
                    f.write(b"\0" * pad)
                    off += pad
                table[name] = {"dtype": a.dtype.str, "shape": list(a.shape),
                               "offset": off}
                # tofile streams the buffer — tobytes() would clone it
                # (a 17.6 GB spike for the human-scale sa_full)
                a.tofile(f)
                off += a.nbytes
        os.replace(prefix + ".mci.bin.tmp", prefix + ".mci.bin")
        meta = {
            "version": FORMAT_VERSION,
            "primary": int(self.primary),
            "seq_len": int(self.seq_len),
            "arrays": table,
            "names": self.ref.names,
            "holes": [[h.offset, h.length, h.amb] for h in self.ref.holes],
        }
        if self.occ3_table is not None:
            from .occ3 import occ3_meta
            rows = self.occ3_table.rows
            dst = prefix + ".occ3.bin"
            # re-saving a loaded index: rows may already BE a memmap of
            # the destination file — truncating it for rewrite would
            # destroy the data under the reader
            same_file = (isinstance(rows, np.memmap)
                         and getattr(rows, "filename", None) is not None
                         and os.path.abspath(rows.filename)
                         == os.path.abspath(dst))
            if not same_file:
                np.ascontiguousarray(rows).tofile(dst + ".tmp")
                os.replace(dst + ".tmp", dst)
            meta["occ3"] = occ3_meta(self.occ3_table)
        with open(prefix + ".mci.json", "w") as f:
            json.dump(meta, f)


def _count_code_in_word(word: int, c: int, nbases: int) -> int:
    """# of 2-bit crumbs equal to c among the first `nbases` (big-end first)."""
    n = 0
    for i in range(nbases):
        if (word >> ((15 - i) << 1)) & 3 == c:
            n += 1
    return n


def _count4_in_word(word: int, nbases: int) -> np.ndarray:
    out = np.zeros(4, dtype=np.int64)
    for i in range(nbases):
        out[(word >> ((15 - i) << 1)) & 3] += 1
    return out


def pack_words(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes into uint32 words, 16/word, bwa bit order."""
    n = int(codes.size)
    padded = np.zeros((n + 15) // 16 * 16, dtype=np.uint32)
    padded[:n] = codes
    crumbs = padded.reshape(-1, 16)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) << 1
    return (crumbs << shifts[None, :]).sum(axis=1, dtype=np.uint32)


def _build_artifacts_native(text: np.ndarray, n: int):
    """Direct-write native build: full SA straight into its final buffer
    (int32 when it fits, ~4 B/base) + one O(1)-memory streaming pass for
    BWT words / Occ checkpoints / primary. Avoids every O(n) NumPy
    temporary of the fallback path — the build-RSS fix for chromosome-
    and human-scale genomes (the reference builds in 10 MB blocks for
    the same reason, ref: src/BWT_Index/bwt_gen.c:1436,1601)."""
    try:
        import ctypes as C

        from ..native import _ptr, load_lib
        lib = load_lib()
        if not hasattr(lib, "_safull_bound"):
            lib.mc_build_sa_full.argtypes = [C.c_void_p, C.c_int64,
                                             C.c_void_p]
            lib.mc_build_sa_full64.argtypes = [C.c_void_p, C.c_int64,
                                               C.c_void_p]
            lib.mc_derive_bwt.argtypes = [C.c_void_p, C.c_int32, C.c_void_p,
                                          C.c_int64, C.c_void_p, C.c_void_p,
                                          C.c_void_p]
            lib._safull_bound = True
    except Exception:
        return None
    t = np.ascontiguousarray(text, dtype=np.uint8)
    is64 = n + 1 >= 2**31
    sa_full = np.empty(n + 1, dtype=np.int64 if is64 else np.int32)
    if is64:
        lib.mc_build_sa_full64(_ptr(t), C.c_int64(n), _ptr(sa_full))
    else:
        lib.mc_build_sa_full(_ptr(t), C.c_int64(n), _ptr(sa_full))
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    bwt_words = np.zeros((n + 15) // 16, dtype=np.uint32)
    ckpt = np.zeros((n_blocks + 1, 4), dtype=np.int64)
    aux = np.zeros(1, dtype=np.int64)
    lib.mc_derive_bwt(_ptr(sa_full), C.c_int32(1 if is64 else 0), _ptr(t),
                      C.c_int64(n), _ptr(bwt_words), _ptr(ckpt), _ptr(aux))
    sa_samp = sa_full[::SA_INTERVAL].astype(np.int64)
    sa_samp[0] = -1
    return int(aux[0]), bwt_words, ckpt, sa_samp, sa_full


def build_index(fasta_path: str, prefix: Optional[str] = None,
                packed: Optional[PackedReference] = None,
                keep_sa64: bool = False) -> FMIndex:
    """Full offline build (ref: src/BWT_Index/bwtindex.c:77-148 flow).

    keep_sa64: retain the int64 sa_full even for >=2^31-row texts (the
    big-genome x64 device path needs it; costs 8 B/base of artifact)."""
    ref = packed if packed is not None else pack_fasta(fasta_path)
    text = ref.fwd_rc_codes()
    n = int(text.size)
    built = _build_artifacts_native(text, n)
    if built is not None:
        primary, bwt_words, ckpt, sa_samp, sa_full = built
        if sa_full.dtype == np.int64 and not keep_sa64:
            sa_full = None
    else:
        sa = build_suffix_array(text)
        bwt, primary = bwt_from_sa(text, sa)
        bwt_words = pack_words(bwt)
        # Occ checkpoints every 128 entries of the $-removed BWT:
        # per-symbol block sums + cumsum (no [n,4] materialization).
        n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
        ckpt = np.zeros((n_blocks + 1, 4), dtype=np.int64)
        starts = np.arange(0, n, OCC_INTERVAL)
        for c in range(4):
            block = np.add.reduceat((bwt == c).astype(np.int32), starts)
            ckpt[1:, c] = np.cumsum(block, dtype=np.int64)
        # SA sampled every 32 full rows; full SA = [n] + sa.
        n_sa = (n + SA_INTERVAL) // SA_INTERVAL
        sa_samp = np.empty(n_sa, dtype=np.int64)
        sa_samp[0] = -1
        rows = np.arange(1, n_sa) * SA_INTERVAL
        sa_samp[1:] = sa[rows - 1]  # full row r -> sa[r-1]
        sa_full = None
        if n < 2**31:
            sa_full = np.empty(n + 1, dtype=np.int32)
            sa_full[0] = n
            sa_full[1:] = sa

    counts = np.bincount(text, minlength=4)[:4]
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(counts)

    idx = FMIndex(primary=primary, L2=L2, bwt_words=bwt_words, ckpt=ckpt,
                  sa_samp=sa_samp, seq_len=n, ref=ref, sa_full=sa_full)
    if prefix:
        if (os.environ.get("MC_PERSIST_OCC3")
                and sa_full is not None and sa_full.dtype == np.int32):
            # optionally persist the 18 B/text-base seeding table
            # (mirrors the reference interleaving Occ checkpoints into
            # the stored .bwt, ref: src/BWT_Index/bwtindex.c:53-75).
            # Off by default: the production path now derives the table
            # ON DEVICE from the resident SA + packed text
            # (ops/fm3_device._occ3_row_chunks), so the artifact only
            # serves hosts without a device-resident full SA.
            from .occ3 import build_occ3
            idx.occ3_table = build_occ3(sa_full, text)
        idx.save(prefix)
    return idx


def load_index(prefix: str) -> FMIndex:
    from .packer import Hole
    with open(prefix + ".mci.json") as f:
        meta = json.load(f)
    if "arrays" in meta:   # v2: raw sidecar, zero-copy memmaps
        mm = {}
        for name, spec in meta["arrays"].items():
            mm[name] = np.memmap(prefix + ".mci.bin",
                                 dtype=np.dtype(spec["dtype"]), mode="r",
                                 offset=int(spec["offset"]),
                                 shape=tuple(spec["shape"]))
        dat, files = mm, set(mm)
        primary, seq_len = int(meta["primary"]), int(meta["seq_len"])
    else:                  # v1 legacy: np.savez container
        dat = np.load(prefix + ".mci.npz")
        files = set(dat.files)
        primary, seq_len = int(dat["primary"]), int(dat["seq_len"])
    ref = PackedReference(
        names=list(meta["names"]),
        lengths=[int(x) for x in dat["chrom_lengths"]],
        offsets=[int(x) for x in dat["chrom_offsets"]],
        codes=dat["codes"],
        holes=[Hole(int(o), int(l), a) for o, l, a in meta["holes"]],
    )
    occ3_table = None
    bin_path = prefix + ".occ3.bin"
    if "occ3" in meta and os.path.exists(bin_path):
        from .occ3 import occ3_from_meta
        m = meta["occ3"]
        rows = np.memmap(bin_path, dtype=np.int32, mode="r",
                         shape=(int(m["nw3"]), 72))
        occ3_table = occ3_from_meta(m, rows)
    return FMIndex(primary=primary, L2=np.asarray(dat["L2"]),
                   bwt_words=dat["bwt_words"], ckpt=dat["ckpt"],
                   sa_samp=dat["sa_samp"], seq_len=seq_len, ref=ref,
                   sa_full=dat["sa_full"] if "sa_full" in files else None,
                   occ3_table=occ3_table)


def index_exists(prefix: str) -> bool:
    return os.path.exists(prefix + ".mci.json") and (
        os.path.exists(prefix + ".mci.bin")
        or os.path.exists(prefix + ".mci.npz"))
