"""Genome-sharded evidence planes of the x64 big-genome path (`big_x64`
under `-shards N`): PyTorch port of mapcaller_tpu/pipeline/big_profile.py.

The single-card planes (pipeline/device_profile.DevicePlanes) hold 40 B a
genome base on one device; a genome whose text passes 2^31 rows needs
more than one card's memory for them beside the index. Here every plane
is split along the genome over the shard devices of the index
(parallel/big_index.py): the padded stride Pg = n * Pl, Pl a multiple of
400 (lcm of the caller's 100-base blocks and the 16 bases of a text
word, so neither straddles a seam) and Pg >= L + 2; shard s holds
positions [s * Pl, (s + 1) * Pl) of every plane on its device, and no
tensor of genome length sits on one device. The fold and the scan run
the single-card kernels a shard through their slice forms
(ops/calling_kernels: evidence_finalize with the carries of the shards
before, caller_scan with a valid length and the seam's run state); the
other programs run as eager PyTorch over each shard's slice:

  apply      a batch's FAST-read evidence: each endpoint and mismatch
             goes to the shard that owns its position (:103-187)
  merge      the host profile's sparse slow-read deltas, routed alike
             (:189-289)
  finalize   per-shard prefix sums, each shard carrying in the prefixes
             at the end of the shard before it (:291-361)
  scan       the caller's scan per shard: the run-length state carried
             across each seam from the shard before, candidates and runs
             joined in shard order, which is position order, so the
             CAND_CAP / RUN_CAP truncation equals the single-card scan's
             (:363-530)
  fetch, NOR and download_raw_into: each shard answers the positions it
             owns (:532-682)

One process addresses every shard, so the reference's all-gathers and
psums are plain reads of the other shards' tensors: no torch.distributed.
Positions are int64; a shard's local offsets are below Pl.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from ..calling.scan_device import (BLOCK_SIZE, CAND_CAP, INT32_MAX, RUN_CAP,
                                   LazyBlockDepth)
from ..ops import calling_kernels
from ..ops.device_util import upload
from ..ops.evidence import first_mate_lanes
from .device_profile import STATS, DeviceEvidence

_GRAN = 400   # lcm(BLOCK_SIZE, 16)


@dataclasses.dataclass
class ShardPlanes:
    """One shard's slice of the planes: positions [off, off + Pl)."""
    acgt: torch.Tensor         # int32[4, Pl]
    exact_diff: torch.Tensor   # int32[Pl]
    f_diff: torch.Tensor       # int32[4, Pl]
    multi_diff: torch.Tensor   # int32[Pl]
    off: int

    @classmethod
    def zeros(cls, Pl: int, off: int, device) -> "ShardPlanes":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)
        return cls(z(4, Pl), z(Pl), z(4, Pl), z(Pl), off)


class ShardedBlockDepth(LazyBlockDepth):
    """LazyBlockDepth over the shards' block depths (Pl / 100 blocks a
    shard): block b lives in shard b // nbl at local block b % nbl."""

    def __init__(self, parts: List[torch.Tensor], nb: int):
        super().__init__(parts[0], nb)
        self._parts = parts
        self._nbl = parts[0].shape[0]

    def gather(self, blocks: np.ndarray) -> np.ndarray:
        """The depths of blocks (int64, each < nb), in their order."""
        out = np.zeros(blocks.size, dtype=np.int64)
        sh = blocks // self._nbl
        for s, part in enumerate(self._parts):
            sel = np.nonzero(sh == s)[0]
            if sel.size:
                idx = upload(blocks[sel] - s * self._nbl, part.device)
                out[sel] = part[idx].cpu().numpy()
        return out

    def prefetch(self, blocks) -> None:
        if self._dense is not None:
            return
        blocks = np.unique(np.asarray(blocks, dtype=np.int64))
        blocks = blocks[(blocks >= 0) & (blocks < self.nb)]
        missing = np.array([b for b in blocks.tolist()
                            if b not in self._cache], dtype=np.int64)
        if missing.size:
            self._cache.update(zip(missing.tolist(),
                                   self.gather(missing).tolist()))

    def dense(self) -> np.ndarray:
        if self._dense is None:
            self._dense = np.concatenate(
                [p.cpu().numpy() for p in self._parts])[:self.nb].astype(
                    np.int64)
        return self._dense


def _evidence_terms(adm, pd, mmp, rlens, b_first, L: int, two_l: int):
    """The plane adds of a batch's admitted FAST reads (the contributions
    of ops/evidence.scatter_fast_evidence): a list of (plane, row, global
    position, on, value), row None for a 1-D plane. int64 positions."""
    i64 = torch.int64
    pd, rlens, mmp = pd.to(i64), rlens.to(i64), mmp.to(i64)
    ori = pd < L
    g_start = torch.clamp(torch.where(ori, pd, two_l - pd - rlens), 0, L - 1)
    end = torch.clamp(g_start + rlens, max=L)
    fpl = torch.where(b_first, torch.where(ori, 0, 3), torch.where(ori, 1, 2))
    terms = [("exact_diff", None, g_start, adm, 1),
             ("exact_diff", None, end, adm, -1),
             ("f_diff", fpl, g_start, adm, 1),
             ("f_diff", fpl, end, adm, -1)]
    for k in range(mmp.shape[1]):
        e = mmp[:, k]
        on = adm & (e >= 0)
        r = e >> 2
        p = torch.clamp(torch.where(ori, pd + r, two_l - 1 - (pd + r)), 0,
                        L - 1)
        terms += [("exact_diff", None, p, on, -1),
                  ("exact_diff", None, p + 1, on, 1),
                  ("acgt", torch.where(ori, e & 3, 3 - (e & 3)), p, on, 1)]
    return terms


def _scatter_local(sp: ShardPlanes, Pl: int, plane: str, row, g, on,
                   val) -> None:
    """Add val at the positions g that this shard owns (row: the plane
    row of a 2-D plane)."""
    li = g - sp.off
    ok = on & (li >= 0) & (li < Pl)
    # the other lanes add 0 at a spread of slots: many atomic adds to one
    # address serialize on the card
    lane = torch.arange(li.shape[0], dtype=li.dtype, device=li.device)
    li = torch.where(ok, li, lane % Pl)
    if row is not None:
        li = li + torch.where(ok, row, 0) * Pl
    vals = torch.where(ok, val, 0).to(torch.int32)
    getattr(sp, plane).view(-1).index_add_(0, li, vals)


class BigDeviceEvidence(DeviceEvidence):
    """DeviceEvidence over genome-sharded planes (see the module
    docstring), with its contract: apply_batch / reconcile_batch /
    finalize / scan / fetch_columns / nor_blocks / download_raw_into."""

    def __init__(self, backend, cfg, host_profile):
        self.be = backend
        self.cfg = cfg
        self.host_profile = host_profile
        self.L = backend.idx.genome_size
        self.two_l = backend.idx.seq_len
        self.devs = list(backend.shard_devs)
        self.n = len(self.devs)
        self.device = backend.device
        self.Pl = -(-(self.L + 2) // (self.n * _GRAN)) * _GRAN
        self.Pg = self.n * self.Pl
        self.planes = [ShardPlanes.zeros(self.Pl, s * self.Pl, d)
                       for s, d in enumerate(self.devs)]
        # each shard's forward-genome codes from its slice of the text
        # words (16 bases a word, so the slice starts at word off / 16);
        # positions past L read as 0
        words = backend.chain_ctx.text_words
        sh = (15 - torch.arange(16, dtype=torch.int64,
                                device=words.device)) * 2
        self._codes = []
        for sp, d in zip(self.planes, self.devs):
            w = words[sp.off // 16:(sp.off + self.Pl) // 16]
            c = ((w[:, None] >> sh[None, :]) & 3).reshape(-1)
            c = torch.cat([c, torch.zeros(self.Pl - c.shape[0],
                                          dtype=c.dtype, device=c.device)])
            pos = sp.off + torch.arange(self.Pl, device=c.device)
            self._codes.append(torch.where(pos < self.L, c, 0).to(
                torch.int32).to(d))
        self._final = None
        self._scan = None
        self._scan_pending = None

    # ------------------------------------------------------------------
    def apply_batch(self, token, fast_bits: np.ndarray,
                    pair_end: bool) -> None:
        """Add the batch's admitted FAST reads (fast_bits, uint32 words)
        to the shards that own their positions; token: the submit_chain
        token (pd int64, mmp and read lengths of the BG reads)."""
        B = int(token.rl_dev.shape[0])
        fb = np.zeros((B + 31) // 32, dtype=np.int32)
        fb[:fast_bits.size] = fast_bits.view(np.int32)
        with record_function("evidence_apply"):
            for sp, d in zip(self.planes, self.devs):
                bidx = torch.arange(B, dtype=torch.int64, device=d)
                sel = upload(fb, d)
                adm = ((sel[bidx >> 5] >> (bidx & 31)) & 1) == 1
                for plane, row, g, on, val in _evidence_terms(
                        adm, token.pd.to(d), token.mmp.to(d),
                        token.rl_dev.to(d), first_mate_lanes(bidx, pair_end),
                        self.L, self.two_l):
                    _scatter_local(sp, self.Pl, plane, row, g, on, val)
        STATS.applies += 1

    def _merge_host_deltas(self) -> None:
        """Add the host profile's slow-read evidence (its sparse nonzero
        entries) to the shards that own their positions, once, then zero
        the host copies."""
        p = self.host_profile
        L = self.L
        if hasattr(p, "any_host_evidence") and not p.any_host_evidence():
            return

        def nz(arr):
            a = np.asarray(arr).reshape(-1)
            i = np.nonzero(a)[0]
            return i.astype(np.int64), a[i].astype(np.int32)

        ia, va = nz(p.acgt)                       # host acgt is [4, L]
        parts = [("acgt", ia // L, ia % L, va),
                 ("exact_diff", None, *nz(p.exact_diff))]
        for k, name in enumerate(("F1_diff", "R2_diff", "F2_diff",
                                  "R1_diff")):
            i, v = nz(getattr(p, name))
            parts.append(("f_diff", np.full(i.size, k, np.int64), i, v))
        parts.append(("multi_diff", None, *nz(p.multi_diff)))
        for sp, d in zip(self.planes, self.devs):
            for plane, row, g, v in parts:
                mine = (g >= sp.off) & (g < sp.off + self.Pl)
                if not mine.any():
                    continue
                li = g[mine] - sp.off
                if row is not None:
                    li = li + row[mine] * self.Pl
                getattr(sp, plane).view(-1).index_add_(
                    0, upload(li, d), upload(v[mine], d))
        p.acgt[:] = 0
        p.exact_diff[:] = 0
        for name in ("F1_diff", "R2_diff", "F2_diff", "R1_diff",
                     "multi_diff"):
            getattr(p, name)[:] = 0

    def finalize(self):
        """Merge the host deltas, then fold each shard's planes -> a list
        over the shards of (acgt int32[4, Pl] capped with the exact
        coverage credited to the reference base, F int32[4, Pl], multi
        int32[Pl] capped, cov int32[Pl], ccov int64[Pl] the shard's
        inclusive coverage prefix), and cov_tot int64[n] each shard's
        coverage total (host). The prefix sums of shard s start from the
        totals of the shards before it."""
        if self._final is None:
            with record_function("evidence_finalize"):
                self._merge_host_deltas()
                self._final = self._fold()
        return self._final

    def _fold(self):
        """finalize's fold of the shards' planes as they stand (uncached):
        evidence_finalize a shard in shard order, each shard's six int32
        prefixes carried in from the shard before (on the card, no host
        sync), its coverage prefix local."""
        outs, carries, carry = [], [], None
        for sp, rc, d in zip(self.planes, self._codes, self.devs):
            fin = calling_kernels.evidence_finalize(
                sp.acgt, sp.exact_diff, sp.f_diff, sp.multi_diff, self.Pl,
                codes=rc, carry=None if carry is None else carry.to(d),
                lead=False)
            outs.append(tuple(fin[:5]))
            carry = fin.carry
            carries.append(carry)
        # each shard's coverage total: its carry's last word
        tots = [int(c[6]) for c in carries]
        return outs, np.asarray(tots, dtype=np.int64)

    # ------------------------------------------------------------------
    def start_scan(self) -> None:
        """No-op: scan() runs the sharded scan and reads its results."""

    def scan(self):
        """The caller scan over the shards (cached): each shard's block
        depths, candidates and run starts, joined in shard order ->
        (block_depth ShardedBlockDepth, cand_idx, run_start, run_val,
        scalars int64[4] = (n_cand, n_runs, n_aligned, total_cov)), the
        tables truncated at CAND_CAP / RUN_CAP as the single-card scan's."""
        if self._scan is not None:
            return self._scan
        outs, _ = self.finalize()
        somatic = bool(self.cfg.somatic)
        fb = np.float32(0.01 if somatic else self.cfg.frequency_thr)
        ad = int(self.cfg.min_allele_depth)
        Pl, L = self.Pl, self.L
        scans, seam = [], None         # the run state at the seam before
        with record_function("caller_scan"):
            # every shard's scan queued before the first copy to the host
            for s, ((acgt, _F, multi, cov, _cc), rc, d) in enumerate(
                    zip(outs, self._codes, self.devs)):
                scans.append(calling_kernels.caller_scan(
                    acgt, multi, cov, rc, ad, fb, somatic, valid=L - s * Pl,
                    seam=None if seam is None else seam.to(d)))
                seam = scans[-1].seam
            counts = np.array([r.small.tolist() for r in scans],
                              dtype=np.int64)
            cands, runs, rvals = [], [], []
            for s, (r, (nc, nr, _, _)) in enumerate(zip(scans, counts)):
                kc, kr = min(int(nc), CAND_CAP), min(int(nr), RUN_CAP)
                packed = torch.cat([r.cand_idx[:kc], r.run_start[:kr],
                                    r.run_val[:kr]]).cpu().numpy()
                cands.append(packed[:kc].astype(np.int64) + s * Pl)
                runs.append(packed[kc:kc + kr].astype(np.int64) + s * Pl)
                rvals.append(packed[kc + kr:])
        n_cand, n_runs, n_aligned, total_cov = counts.sum(0).tolist()
        bds = [r.block_depth for r in scans]
        STATS.scans += 1
        nb = (L + BLOCK_SIZE - 1) // BLOCK_SIZE
        self._scan = (ShardedBlockDepth(bds, nb),
                      np.concatenate(cands)[:CAND_CAP],
                      np.concatenate(runs)[:RUN_CAP],
                      np.concatenate(rvals)[:RUN_CAP],
                      np.array([n_cand, n_runs, n_aligned, total_cov],
                               dtype=np.int64))
        return self._scan

    # ------------------------------------------------------------------
    def fetch_columns(self, positions: np.ndarray, prefix_pts: np.ndarray,
                      bd_blocks: np.ndarray = None):
        """Evidence columns (A, C, G, T, multi, F1, R2, F2, R1, cov) at
        positions, each from the shard that owns it, and the global
        exclusive coverage prefix at prefix_pts (the totals of the shards
        before the owner plus its local prefix). With bd_blocks and after
        scan(), the block depths there seed the ShardedBlockDepth cache."""
        outs, tots = self.finalize()
        Pl, L = self.Pl, self.L
        p = np.clip(np.asarray(positions, dtype=np.int64), 0, L - 1)
        pp = np.clip(np.asarray(prefix_pts, dtype=np.int64), 0, L)
        cols = np.zeros((p.size, 10), dtype=np.int64)
        pref = np.zeros(pp.size, dtype=np.int64)
        before = np.concatenate([[0], np.cumsum(tots)])
        with record_function("fetch_columns"):
            for s, ((acgt, F, multi, cov, ccov), d) in enumerate(
                    zip(outs, self.devs)):
                sel = np.nonzero(p // Pl == s)[0]
                if sel.size:
                    li = upload(p[sel] - s * Pl, d)
                    cols[sel] = torch.stack(
                        [acgt[0][li], acgt[1][li], acgt[2][li], acgt[3][li],
                         multi[li], F[0][li], F[1][li], F[2][li], F[3][li],
                         cov[li]], dim=1).cpu().numpy()
                selp = np.nonzero(pp // Pl == s)[0]
                if selp.size:
                    lip = pp[selp] - s * Pl
                    loc = np.zeros(selp.size, dtype=np.int64)
                    nz = np.nonzero(lip > 0)[0]
                    if nz.size:
                        loc[nz] = ccov[upload(lip[nz] - 1, d)].cpu().numpy()
                    pref[selp] = before[s] + loc
        STATS.fetches += 1
        if bd_blocks is not None and self._scan is not None:
            lbd = self._scan[0]
            b = np.unique(np.asarray(bd_blocks, dtype=np.int64))
            b = b[(b >= 0) & (b < lbd.nb)]
            if b.size:
                lbd.insert(b, lbd.gather(b))
        return cols, pref

    def nor_blocks(self, emitted: np.ndarray, brk: np.ndarray):
        """gVCF NOR blocks over the shards: each shard's segment minima of
        its normal positions (covered, no record emitted there), combined
        by a minimum over the shards, and the coverage at each segment's
        first position from the shard that owns it -> (first_pos,
        min_cov, cov_at_first) per key 0..brk.size, INT32_MAX for an
        empty segment (the single-card contract)."""
        outs, _ = self.finalize()
        Pl, L = self.Pl, self.L
        nseg = brk.size + 2
        bk = np.sort(np.asarray(brk, dtype=np.int64)) if brk.size else \
            np.array([L], dtype=np.int64)
        em = np.asarray(emitted, dtype=np.int64)
        first = np.full(nseg, INT32_MAX, dtype=np.int64)
        mincov = np.full(nseg, INT32_MAX, dtype=np.int64)
        for s, ((_a, _F, _m, cov, _c), d) in enumerate(zip(outs, self.devs)):
            off = s * Pl
            gpos = off + torch.arange(Pl, dtype=torch.int64, device=d)
            covm = torch.where(gpos < L, cov, 0)
            em_s = np.clip(em, 0, L - 1) - off
            em_s = em_s[(em_s >= 0) & (em_s < Pl)]
            em_mask = torch.zeros(Pl, dtype=torch.bool, device=d)
            if em_s.size:
                em_mask[upload(em_s, d)] = True
            normal = (covm > 0) & ~em_mask
            key = torch.searchsorted(upload(bk, d), gpos, right=True)
            seg = torch.where(normal, torch.clamp(key, max=nseg - 1),
                              nseg - 1)

            def seg_min(vals):
                out = torch.full((nseg,), INT32_MAX, dtype=torch.int64,
                                 device=d)
                return out.scatter_reduce_(0, seg, torch.where(
                    normal, vals.to(torch.int64), INT32_MAX), "amin")

            first = np.minimum(first, seg_min(gpos).cpu().numpy())
            mincov = np.minimum(mincov, seg_min(covm).cpu().numpy())
        # an empty segment reads the coverage at L - 1, as the single-card
        # kernel's clamped gather does
        fc = np.clip(first, 0, L - 1)
        covf = np.zeros(nseg, dtype=np.int64)
        for s, ((_a, _F, _m, cov, _c), d) in enumerate(zip(outs, self.devs)):
            sel = np.nonzero(fc // Pl == s)[0]
            if sel.size:
                covf[sel] = cov[upload(fc[sel] - s * Pl, d)].cpu().numpy()
        return first, mincov, covf

    def download_raw_into(self, profile) -> None:
        """Add the shards' raw planes, joined along the genome, into the
        host profile's diff arrays (the single-card contract: the planes'
        [0, L + 2) prefix; the padded tail holds zeros)."""
        L = self.L
        if profile.F1_diff is None:
            profile.alloc_diffs()

        def whole(name):
            return np.concatenate([getattr(sp, name).cpu().numpy()
                                   for sp in self.planes], axis=-1)

        profile.exact_diff += whole("exact_diff")[:L + 1]
        fd = whole("f_diff")
        profile.F1_diff += fd[0, :L + 1]
        profile.R2_diff += fd[1, :L + 1]
        profile.F2_diff += fd[2, :L + 1]
        profile.R1_diff += fd[3, :L + 1]
        profile.multi_diff += whole("multi_diff")[:L + 1]
        profile.acgt += whole("acgt")[:, :L]
        STATS.downloads += 1
