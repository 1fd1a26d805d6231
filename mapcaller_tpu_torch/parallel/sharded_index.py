"""`-shards N`: the occ3 index split over N devices (PyTorch port of
mapcaller_tpu/parallel/sharded_index.py).

The occ3 rows are split along the BWT-row axis into N contiguous shards,
one a device, and so is the SA: the full SA, or without it the 1-step occ
rows and the sampled SA that the inverse-Psi walk reads (ops/routed.py).
The seeding state machine is unchanged (ops/fm_search._seed_scan3); only
its row fetches are routed: row w is read from shard w // per.

The reference runs the scan as one lockstep program over a device mesh
and routes every step's gathers through an all-gather of the queries and
a psum of the answers (:115-132), two collectives a step. The port's scan
kernel runs each read to its end on a lane group of its own, with no
lockstep step at which a collective could sit; so the routing moves into
the row fetch.
One process addresses the N devices: a kernel takes a table of the
shards' base addresses and reads each row from its shard, on the same
card or, with peer access, from another card's memory. Each shard device
maps its B/N reads of a batch: the routed scan, the hit expansion, the
routed SA resolve, then classify+pack (ShardChainKernel), and the host
joins the N packed outputs in read order. The text words and the small
tables stay replicated on each device.

The plain routed versions (CPU tensors): routed_gather3 for the scan,
ops/fm_device.sa_resolve over Routed SA tables for the resolve; the CUDA
kernels are the routed instantiations of the scan and hits kernels
(ops/seed_scan_device.seed_scan3_routed, ops/chain_kernels.
chain_hits_routed).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..ops.chain_device import ChainCtx
from ..ops.chain_kernels import chain_hits_routed, chain_scan_seeds
from ..ops.device_util import issue_on, need
from ..ops.fm3_device import DeviceFM3, decode3, occ3_parts
from ..ops.fm_device import DeviceFMIndex
from ..ops.fm_search import SeedChainKernel, _check_shape
from ..ops.routed import Routed
from ..ops.seed_scan_device import seed_scan3_routed


@dataclasses.dataclass
class ShardedFM3:
    """A DeviceFM3 whose occ3 rows are a Routed table, as a kernel
    launched on one device of the shards sees it: fm is the 1-step index
    with its SA tables routed (sa_full, or occ_rows and sa_samp for the
    walk) and L2 on that device; c3_first too. pfx_k and pfx_base are 0:
    the sharded scan runs without the fused prefix skip, as the
    reference's (:100)."""
    fm: DeviceFMIndex
    occ3: Routed
    c3_first: torch.Tensor
    row_p1: int
    row_p2: int
    t0: int
    t1: int
    tail1: int
    tail2a: int
    tail2b: int
    pfx_k: int = 0
    pfx_base: int = 0

    @property
    def L2(self):
        return self.fm.L2

    @property
    def primary(self):
        return self.fm.primary

    @property
    def seq_len(self):
        return self.fm.seq_len


def shard_occ3_rows(fm3: DeviceFM3, devices: Sequence) -> Routed:
    """Pad and split the occ3 rows (without the prefix-skip rows) of a
    built table into len(devices) shards, shard s on devices[s]."""
    rows = fm3.occ3_rows
    if fm3.pfx_base:
        rows = rows[:fm3.pfx_base]
    return Routed.split(rows, devices)


def routed_gather3(sfm: ShardedFM3, i: torch.Tensor):
    """gather3 over the sharded rows: each row from its shard (the plain
    routed gather, ops/routed.Routed)."""
    return decode3(sfm.occ3[i >> 4], i)


_CONSTS = ("c3_first", "row_p1", "row_p2", "t0", "t1", "tail1", "tail2a",
           "tail2b")


def shard_index(fm3: DeviceFM3, devices: Sequence) -> Dict[torch.device,
                                                             ShardedFM3]:
    """Split the occ3 rows and the SA tables of a built fm3 over `devices`
    (shard s on devices[s], each its own allocation) -> the ShardedFM3 a
    kernel on each distinct device reads (see _sharded)."""
    devs = [torch.device(d) for d in devices]
    return _sharded(fm3.fm, shard_occ3_rows(fm3, devs),
                    {k: getattr(fm3, k) for k in _CONSTS}, devs)


def build_shard_index(idx: FMIndex, fm: DeviceFMIndex, devices: Sequence,
                      text_words: torch.Tensor | None = None
                      ) -> Dict[torch.device, ShardedFM3]:
    """shard_index of the occ3 table of idx without building the whole
    table on one device: the rows are built on fm's device one shard at a
    time (ops/fm3_device.occ3_parts, from fm's full SA and text_words)
    and each copied to its shard's device before the next is built, so
    fm's device holds one shard's build beside its own tables."""
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    nw3 = (idx.seq_len + 16) // 16 + 2
    per = -(-nw3 // n)
    chunks, rows, consts = occ3_parts(idx, fm, text_words, per)
    need(rows == nw3, f"occ3 table of {rows} rows, expected {nw3}")
    shards = [torch.zeros((per, 72), dtype=torch.int32, device=d)
              for d in devs]
    for r0, part in chunks:
        shards[r0 // per][:part.shape[0]].copy_(part)
        del part
    return _sharded(fm, Routed(shards, per), consts, devs)


def _sharded(fm: DeviceFMIndex, occ3: Routed, consts: dict,
             devs: List[torch.device]) -> Dict[torch.device, ShardedFM3]:
    """The ShardedFM3 of each distinct device of devs over the sharded
    occ3 rows: with fm's full SA, the full SA split; without it, the
    1-step occ rows and the sampled SA split; L2, c3_first and the
    constants on each device."""
    routed = (dict(sa_full=Routed.split(fm.sa_full, devs)) if fm.has_full_sa
              else dict(occ_rows=Routed.split(fm.occ_rows, devs),
                        sa_samp=Routed.split(fm.sa_samp, devs)))
    out = {}
    for d in dict.fromkeys(devs):
        stubs = dict(occ_rows=fm.occ_rows[:0].to(d),
                     sa_samp=fm.sa_samp[:0].to(d),
                     sa_full=fm.sa_full[:0].to(d))
        stubs.update(routed)
        out[d] = ShardedFM3(
            fm=dataclasses.replace(fm, L2=fm.L2.to(d), **stubs), occ3=occ3,
            **dict(consts, c3_first=consts["c3_first"].to(d)))
    return out


def replicate_ctx(ctx: ChainCtx, devices: Sequence) -> Dict[torch.device,
                                                              ChainCtx]:
    """The chain context (text words, chromosome ends) on each distinct
    device; ctx itself on its own."""
    out = {}
    for d in dict.fromkeys(torch.device(x) for x in devices):
        out[d] = ctx if d == ctx.text_words.device else ChainCtx(
            ctx.text_words.to(d), ctx.bkeys.to(d), ctx.seq_len)
    return out


class ShardChainKernel(SeedChainKernel):
    """The chain stage of one shard device's reads: SeedChainKernel with
    the routed scan and the routed hits (the reference's
    build_sharded_chain_kernel, :287-406, on this device's B/N reads).
    Its packed output, pd and mmp are SeedChainKernel's for its B reads."""

    def __init__(self, sfm3: ShardedFM3, ctx: ChainCtx, max_len: int,
                 batch: int, slow_hits_x4: int = 5):
        super().__init__(sfm3, ctx, max_len, batch, slow_hits_x4)
        self.use_occ3 = True
        self.fm1 = sfm3.fm
        self.compact_lanes = 0
        # int32 words of the packed output vector
        self.out_len = (2 * batch + 2 * self.H2 + batch // 2 + batch // 32
                        + 2)

    def _scan_packed(self, packed: torch.Tensor, rlens: torch.Tensor):
        return seed_scan3_routed(self.fm, packed, rlens, self.max_len,
                                 self.max_seeds)

    def _hits(self, n_seeds, s_rpos, s_len, s_x0, s_freq):
        scan = chain_scan_seeds(s_freq, n_seeds, self.H)
        return scan.off, chain_hits_routed(self.fm1, scan, n_seeds, s_rpos,
                                           s_len, s_x0, s_freq, self.H)


class ShardedChainKernel:
    """The chain stage of a batch of BG reads over N shard devices: shard
    device s maps reads [s * BG/N, (s + 1) * BG/N) with its
    ShardChainKernel. Call with (packed uint8[BG, max_len/4], rlens
    int32[BG]) on the backend's device -> (the N packed output vectors
    end to end, pd int32[BG], mmp int32[BG, 4]), all on that device;
    collect decodes the host copy into SeedChainKernel.collect's tuple
    for the BG reads, in read order: the SLOW reads' hits shard after
    shard, each shard's in hit order, which is the order by read that the
    reference's host compaction gives (its stable sort by read,
    device_backend.py:834-845). BG % (32 N) == 0. kernel_class: the
    chain stage of one shard (the x64 path's is parallel/big_index.
    BigShardChainKernel)."""

    kernel_class = ShardChainKernel

    def __init__(self, sfm3s: Dict[torch.device, ShardedFM3],
                 ctxs: Dict[torch.device, ChainCtx], devices: Sequence,
                 max_len: int, batch_global: int, tier: int = 2):
        self.devs = [torch.device(d) for d in devices]
        n = len(self.devs)
        if batch_global % (32 * n):
            raise ValueError(f"batch {batch_global} must be a multiple of "
                             f"32 x {n} shards")
        self.B = batch_global // n
        _check_shape(self.B, max_len)
        self.BG = batch_global
        self.kernels: List[ShardChainKernel] = [
            self.kernel_class(sfm3s[d], ctxs[d], max_len, self.B, tier)
            for d in self.devs]
        self.out_len = self.kernels[0].out_len

    def __call__(self, packed: torch.Tensor, rlens: torch.Tensor):
        dev0 = packed.device
        outs, pds, mmps = [], [], []
        for s, (kern, d) in enumerate(zip(self.kernels, self.devs)):
            sl = slice(s * self.B, (s + 1) * self.B)
            with issue_on(d):
                out, pd, mmp = kern(packed[sl].to(d), rlens[sl].to(d))
            outs.append(out)
            pds.append(pd)
            mmps.append(mmp)

        def join(ts):
            return torch.cat([t.to(dev0) for t in ts])

        return join(outs), join(pds), join(mmps)

    def collect(self, dev_packed: torch.Tensor):
        """Host decode of the joined vector -> SeedChainKernel.collect's
        (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen, overflow,
        buffer_overflow) for the BG reads."""
        p = dev_packed.cpu()
        parts = [k.collect(p[s * self.out_len:(s + 1) * self.out_len])
                 for s, k in enumerate(self.kernels)]
        cols = [np.concatenate([pt[j] for pt in parts]) for j in range(10)]
        return (*cols, any(pt[10] for pt in parts))
