"""The x64 big-genome index (`big_x64` under `-shards N`): texts of 2^31
rows or more (genomes above ~1.07 Gbp fwd+rc), PyTorch port of
mapcaller_tpu/parallel/big_index.py. The reference's index types are
uint64 end to end (ref: src/BWT_Index/bwt.h:44), so it maps such genomes
in one address space.

The 288-byte occ3 row stays int32: each shard's counts are stored
relative to the shard's own first row, and an int64 base3[n, 64] table
(each shard's absolute counts at its first row) recombines them. The
interval state (x0, x1, x2), the row indices and correction rows, the SA
entries, hit locations and diagonals are int64. The SA is split along the
same rows as the occ3 table: SA shard s holds the 16 * per entries of the
rows of occ3 shard s, as int64. Full SA only, as the reference's big path
(:16-19); no sampled-SA walk.

The tables are built a shard at a time on the shard's own device
(build_big_index): the shard's SA entries from the host index, as int64,
then its relative occ3 rows from them and the text words
(ops/fm3_device.occ3_block), the running counts carried on as the next
shard's base. No table is ever whole on one device, and no single-card
table (the 1-step rows, the int32 occ3 rows, the whole SA) is built.

Plain routed versions (CPU tensors): big_routed_gather3 for the scan
(ops/seed_scan_device.seed_scan3_big_plain) and the routed gather of the
int64 SA (ops/routed.Routed, as the reference's _routed_rows64, :97-107)
for the hits (ops/chain_kernels.chain_hits_big_plain). The CUDA kernels
are the 64-bit instantiations in csrc/seed_scan.cu and csrc/chain.cu:
seed_scan3_big, chain_hits_big and chain_classify_pack_big.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..ops.chain_device import ChainCtx
from ..ops.chain_kernels import (big_out_sizes, chain_classify_pack_big,
                                 chain_hits_big, chain_scan_seeds)
from ..ops.device_util import need
from ..ops.fm3_device import c3_first_of, decode3, occ3_block
from ..ops.fm_search import MIN_SEED_LEN, _check_shape, _decode_counts_ovf
from ..ops.routed import Routed
from ..ops.seed_scan_device import seed_scan3_big
from .sharded_index import ShardedChainKernel

# occ3 rows a device build step takes at a time (bounds its transients)
BUILD_CHUNK_ROWS = 1 << 22
# csrc/seed_scan.cu: int64 a row of a shard's base table, the offsets of
# its rev3 prefix and its group sums
B3X, B3X_REV, B3X_GRP = 136, 64, 132
_D64 = np.arange(64)
_REV3 = 63 - ((_D64 & 3) * 16 + (_D64 & 12) + (_D64 >> 4))


@dataclasses.dataclass
class BigShardedFM3:
    """The index a kernel launched on one shard device reads: the occ3
    rows and the SA as Routed tables (shard s on its device), and base3,
    c3_first and L2 (int64) on this device; the row constants are Python
    ints, which may pass 2^31. pfx_k and pfx_base are 0: no prefix skip
    (the reference's pfx_k, :68-70)."""
    occ3: Routed               # int32[per, 72] shards, shard-relative
    base3: torch.Tensor        # int64[n, 64]
    base3x: torch.Tensor       # int64[n, B3X]: base_table(base3)
    c3_first: torch.Tensor     # int64[64]
    L2: torch.Tensor           # int64[5]
    sa: Routed                 # int64[16 * per] shards
    primary: int
    row_p1: int
    row_p2: int
    t0: int
    t1: int
    tail1: int
    tail2a: int
    tail2b: int
    seq_len: int
    pfx_k: int = 0
    pfx_base: int = 0


def big_routed_gather3(bfm: BigShardedFM3, i: torch.Tensor):
    """gather3 over the shard-relative rows: row i >> 4 from its shard
    (zeros outside every shard, as the reference's psum answers), its
    counts plus the owning shard's base counts (base3[w // per], the shard
    clipped to the table), the symbol bytes as they are (:73-94)."""
    w = i >> 4
    cnt, syms, m = decode3(bfm.occ3[w], i)
    shard = torch.clamp(torch.div(w, bfm.occ3.per, rounding_mode="floor"),
                        0, bfm.occ3.n - 1)
    return cnt + bfm.base3[shard], syms, m


def shard_rows(arr: np.ndarray, n_shards: int, pad_value=0):
    """Pad and split a table into n_shards equal axis-0 slices ->
    (np[n_shards, rps, ...], rps) (the reference's shard_rows, :305)."""
    m = arr.shape[0]
    rps = -(-m // n_shards)
    out = np.full((n_shards * rps,) + arr.shape[1:], pad_value,
                  dtype=arr.dtype)
    out[:m] = arr
    return out.reshape((n_shards, rps) + arr.shape[1:]), rps


def base_table(base3: torch.Tensor) -> torch.Tensor:
    """Each shard's base table for the 64-bit scan kernel, int64[n, B3X]:
    its 64 base counts; at B3X_REV + w, w in 0..64, their sum over the
    trinucleotides d with rev3(d) < w (the base part of the scan's x0
    order sum); at B3X_GRP + c their sum over the d with last base c (the
    base part of the derived 1-step counts)."""
    n = base3.shape[0]
    inv = torch.as_tensor(np.argsort(_REV3))       # inv[r]: d with rev3 r
    rev = torch.zeros((n, 65), dtype=torch.int64, device=base3.device)
    rev[:, 1:] = torch.cumsum(base3[:, inv.to(base3.device)], dim=1)
    grp = base3.reshape(n, 16, 4).sum(dim=1)
    pad = torch.zeros((n, B3X_GRP - B3X_REV - 65), dtype=torch.int64,
                      device=base3.device)
    return torch.cat([base3, rev, pad, grp], dim=1)


def big_layout(seq_len: int, n: int):
    """(nw3, per, sps): the occ3 rows of a text of seq_len rows (guard
    rows included), the rows a shard and the SA entries a shard."""
    nw3 = (seq_len + 16) // 16 + 2
    per = -(-nw3 // n)
    return nw3, per, 16 * per


def build_big_index(idx: FMIndex, ctxs: Dict[torch.device, ChainCtx],
                    devices: Sequence,
                    chunk_rows: int = BUILD_CHUNK_ROWS
                    ) -> Dict[torch.device, BigShardedFM3]:
    """The x64 tables of idx over `devices` (shard s on devices[s]), a
    shard at a time: SA shard s, int64, from the host index's SA (an
    int64 copy of that shard only), then occ3 shard s from it on its
    device, chunk_rows rows at a time, with counts relative to the shard
    (ops/fm3_device.occ3_block from zero counts), the counts carried on
    as the next shard's base. The rows past the table's nw3 are zero rows
    and their shards' base counts 0, as the reference's padded split.
    ctxs: the chain context (text words) on each distinct device.
    -> the BigShardedFM3 of each distinct device."""
    need(idx.sa_full is not None, "big_x64: the x64 big-genome path needs "
                                  "the index's full SA")
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    nrows = idx.seq_len
    nw3, per, sps = big_layout(nrows, n)
    occ_shards, sa_shards = [], []
    base3 = torch.zeros((n, 64), dtype=torch.int64)
    carry = torch.zeros(64, dtype=torch.int64)
    rows_p = {}
    for s, d in enumerate(devs):
        words = ctxs[d].text_words
        lo, hi = s * sps, min((s + 1) * sps, nrows + 1)
        sa = torch.zeros(sps, dtype=torch.int64, device=d)
        if hi > lo:
            sa[:hi - lo].copy_(torch.from_numpy(
                np.array(idx.sa_full[lo:hi], dtype=np.int64)))
        rows = torch.zeros((per, 72), dtype=torch.int32, device=d)
        m = max(0, min(per, nw3 - s * per))
        if m:
            base3[s] = carry
            rel = None
            for r0 in range(0, m, chunk_rows):
                r1 = min(r0 + chunk_rows, m)
                p = sa[r0 * 16:r1 * 16]
                j = torch.arange(lo + r0 * 16, lo + r1 * 16,
                                 dtype=torch.int64, device=d)
                p = torch.where(j <= nrows, p, -1)
                for k in (1, 2):
                    hit = torch.nonzero(p == k)
                    if hit.numel():
                        rows_p[k] = lo + r0 * 16 + int(hit[0, 0])
                rows[r0:r1], rel = occ3_block(p, words, nrows, rel)
            carry = carry + rel.cpu().to(torch.int64)
        occ_shards.append(rows)
        sa_shards.append(sa)
    words0 = ctxs[devs[0]].text_words
    pos = torch.tensor([0, 1, nrows - 1, nrows - 2], dtype=torch.int64,
                       device=words0.device)
    t0, t1, tl1, tl2 = ((words0[pos >> 4] >> ((15 - (pos & 15)) * 2)) & 3
                        ).tolist()
    c3f = c3_first_of(words0, nrows, 16 * chunk_rows)
    consts = dict(primary=int(idx.primary), row_p1=rows_p[1],
                  row_p2=rows_p[2], t0=t0, t1=t1, tail1=tl1, tail2a=tl2,
                  tail2b=tl1, seq_len=int(nrows))
    occ3, sa = Routed(occ_shards, per), Routed(sa_shards, sps)
    L2 = torch.tensor(np.asarray(idx.L2), dtype=torch.int64)
    base3x = base_table(base3)
    return {d: BigShardedFM3(occ3=occ3, base3=base3.to(d),
                             base3x=base3x.to(d), c3_first=c3f.to(d),
                             L2=L2.to(d), sa=sa, **consts)
            for d in dict.fromkeys(devs)}


class BigShardChainKernel:
    """The chain stage of one shard device's reads on the x64 path (the
    reference's build_big_chain_kernel, :204-302, on this device's B/N
    reads): the 64-bit scan, the seed-freq scan, the 64-bit hits and the
    64-bit classify+pack. Call with (packed uint8[B, max_len/4], rlens
    int32[B]) on the device -> (the packed output: int32[out_len], whose
    first big_out_sizes(B, H2)[0] words are chain_classify_pack_big's out
    and whose rest is its int64 side output wide[B + H2]; pd int64[B], a
    view of it; mmp int32[B, 4])."""

    def __init__(self, bfm: BigShardedFM3, ctx: ChainCtx, max_len: int,
                 batch: int, slow_hits_x4: int = 2):
        _check_shape(batch, max_len)
        self.fm = bfm
        self.ctx = ctx
        self.max_len = max_len
        self.batch = batch
        self.max_seeds = max_len // (MIN_SEED_LEN + 1) + 2
        self.H = batch * max(9, slow_hits_x4) // 4
        self.H2 = batch * slow_hits_x4 // 4
        self.n32, self.n64 = big_out_sizes(batch, self.H2)
        self.out_len = self.n32 + 2 * self.n64

    def _scan_packed(self, packed: torch.Tensor, rlens: torch.Tensor):
        return seed_scan3_big(self.fm, packed, rlens, self.max_len,
                              self.max_seeds)

    def _hits(self, n_seeds, s_rpos, s_len, s_x0, s_freq):
        scan = chain_scan_seeds(s_freq, n_seeds, self.H)
        return scan.off, chain_hits_big(self.fm, scan, n_seeds, s_rpos,
                                        s_len, s_x0, s_freq, self.H)

    def __call__(self, packed: torch.Tensor, rlens: torch.Tensor):
        B = self.batch
        (n_seeds, s_rpos, s_len, s_x0, s_freq,
         overflow) = self._scan_packed(packed, rlens)
        off, hits = self._hits(n_seeds, s_rpos, s_len, s_x0, s_freq)
        buf = torch.empty(self.out_len, dtype=torch.int32,
                          device=packed.device)
        wide = buf[self.n32:].view(torch.int64)
        mmp = chain_classify_pack_big(self.ctx, packed, rlens, off, hits,
                                      overflow, self.max_len,
                                      buf[:self.n32], wide, self.H2)
        return buf, wide[:B], mmp

    def collect(self, dev_packed: torch.Tensor):
        """Host decode of one shard's packed output -> SeedChainKernel.
        collect's tuple, pd and the hits' locations int64."""
        p = dev_packed.cpu().numpy()
        B, H2 = self.batch, self.H2
        meta1 = p[:B]
        hit_w = p[B:B + H2]
        o = B + H2
        counts, overflow = _decode_counts_ovf(
            p[o:o + B // 2], p[o + B // 2:o + B // 2 + B // 32], B)
        o += B // 2 + B // 32
        total, buf_ovf = int(p[o]), bool(p[o + 1])
        wide = np.ascontiguousarray(p[self.n32:]).view(np.int64)
        n = min(total, H2)
        return (meta1 & 3, wide[:B], (meta1 >> 2) & 0x3F,
                (meta1 >> 8) & 0x1FF, (meta1 >> 17) & 0x1FF, counts,
                (hit_w[:n] >> 9) & 0x1FF, wide[B:B + n], hit_w[:n] & 0x1FF,
                overflow, buf_ovf)


class BigShardedChainKernel(ShardedChainKernel):
    """The x64 chain stage of a batch of BG reads over N shard devices:
    parallel/sharded_index.ShardedChainKernel's call and collect with a
    BigShardChainKernel a shard (pd int64[BG]). BG % (32 N) == 0."""

    kernel_class = BigShardChainKernel
