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
tensor of genome length sits on one device. Every program runs the
port's kernels a shard, through their slice forms:

  apply      a batch's FAST-read evidence: K2's slice form
             (ops/mesh_kernels.apply_slice), a launch a shard a batch, each
             endpoint and mismatch added by the shard that owns its
             position (:103-187)
  merge      the host profile's sparse slow-read deltas: the four lists
             and their segments (a (shard, list, row) each) uploaded once
             a device, one host_merge launch a device over its shards
             (ops/mesh_kernels.host_merge) (:189-289)
  finalize   per-shard prefix sums, each shard carrying in the prefixes
             at the end of the shard before it: evidence_finalize with the
             carry of the shard before (:291-361)
  scan       the caller's scan per shard: caller_scan with the run-length
             state carried across each seam from the shard before,
             candidates and runs joined in shard order, which is position
             order, so the CAND_CAP / RUN_CAP truncation equals the
             single-card scan's (:363-530)
  fetch      the positions, prefix points and blocks in the caller's
             order, each answered by the shard that owns it:
             caller_fetch_slice, one upload, one launch and one download
             a device (a launch a 16 shards past 16 on one device)
             (:532-601)
  NOR        each shard's segment minima of its normal positions
             (nor_blocks_slice, keyed by the global breaks), combined on
             the host (:603-667); download_raw_into reads the shards'
             planes (:669-682)

ops/calling_kernels and ops/mesh_kernels hold each kernel's plain
version, which CPU tensors take. One process addresses every shard, so
the reference's all-gathers and psums are plain reads of the other
shards' tensors: no torch.distributed. Positions are int64; a shard's
local offsets are below Pl.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..calling.scan_device import (BLOCK_SIZE, CAND_CAP, INT32_MAX, RUN_CAP,
                                   LazyBlockDepth)
from ..ops import calling_kernels, mesh_kernels
from ..ops.device_util import download, upload
from .device_profile import (STATS, DeviceEvidence, host_delta_lists,
                             merge_strides, zero_host_deltas)

_GRAN = 400   # lcm(BLOCK_SIZE, 16)
_NONE = np.zeros(0, dtype=np.int64)


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
    shard): block b lives in shard b // nbl at local block b % nbl;
    `fetch(blocks)` reads the depths of global blocks off the shards
    (BigDeviceEvidence's fetch)."""

    def __init__(self, parts: List[torch.Tensor], nb: int, fetch):
        super().__init__(parts[0], nb)
        self._parts = parts
        self._fetch = fetch

    def gather(self, blocks: np.ndarray) -> np.ndarray:
        """The depths of blocks (int64, each < nb), in their order."""
        return self._fetch(np.asarray(blocks, dtype=np.int64))

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
        token (pd int64, mmp and read lengths of the BG reads). One K2
        slice-form launch a shard; the admit bits go up once a device."""
        B = int(token.rl_dev.shape[0])
        fb = np.zeros((B + 31) // 32, dtype=np.int32)
        fb[:fast_bits.size] = fast_bits.view(np.int32)
        ins = {}
        for sp, d in zip(self.planes, self.devs):
            if d not in ins:
                # pd int64 (the x64 chain stage's), or int32 from the
                # single-card kernels' routes under big_x64
                ins[d] = (token.pd.to(d, torch.int64), token.mmp.to(d),
                          token.rl_dev.to(d), upload(fb, d))
            mesh_kernels.apply_slice(sp, sp.off, *ins[d], self.L,
                                     pair_end)
        STATS.applies += 1

    def _merge_host_deltas(self) -> None:
        """Add the host profile's slow-read evidence (its sparse nonzero
        entries) to the shards that own their positions, once, then zero
        the host copies: the lists at the single-card flat indices
        (device_profile.host_delta_lists) through _merge_lists."""
        p = self.host_profile
        if hasattr(p, "any_host_evidence") and not p.any_host_evidence():
            return
        self._merge_lists(*host_delta_lists(p, self.L))
        zero_host_deltas(p)

    def _merge_lists(self, deltas, ends) -> None:
        """host_merge of the packed lists (host, host_delta_lists) into
        every shard: one call a device over the shards it holds (the lists
        and their segments, a (shard, list, row) each, up in one copy;
        one launch)."""
        gstrides = merge_strides(self.L)
        for mine in self._device_shards().values():
            mesh_kernels.host_merge(
                [(self.planes[s], self.planes[s].off) for s in mine], deltas,
                ends, gstrides)

    def finalize(self):
        """Merge the host deltas, then fold each shard's planes -> a list
        over the shards of (acgt int32[4, Pl] capped with the exact
        coverage credited to the reference base, F int32[4, Pl], multi
        int32[Pl] capped, cov int32[Pl], ccov int64[Pl] the shard's
        inclusive coverage prefix), and cov_tot int64[n] each shard's
        coverage total (host). The prefix sums of shard s start from the
        totals of the shards before it."""
        if self._final is None:
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
        self._scan = (ShardedBlockDepth(
            bds, nb, lambda b: self._fetch(_NONE, _NONE, b, bds)[2]),
                      np.concatenate(cands)[:CAND_CAP],
                      np.concatenate(runs)[:RUN_CAP],
                      np.concatenate(rvals)[:RUN_CAP],
                      np.array([n_cand, n_runs, n_aligned, total_cov],
                               dtype=np.int64))
        return self._scan

    # ------------------------------------------------------------------
    def _device_shards(self):
        """{device: the shards it holds, in order}."""
        out = {}
        for s, d in enumerate(self.devs):
            out.setdefault(d, []).append(s)
        return out

    def _fetch(self, p: np.ndarray, pp: np.ndarray, blocks: np.ndarray,
               bds=None):
        """The columns at positions p (each in [0, L)), the global
        coverage prefix at points pp (each in [0, L]) and the depths of
        blocks (each < the block count; bds the shards' block depths) ->
        (cols int64[P, 10], pref int64[Q], depths int64[nbd]): one
        caller_fetch_slice launch a device over the shards it holds (up
        to FETCH_MAX_SHARDS; past that a launch a FETCH_MAX_SHARDS of
        them), the indices up in one copy a launch in the caller's order
        and the output down in it, every launch queued before the copies
        to the host. With more than one launch (shards on several
        devices, or too many on one), each launch takes its shards'
        elements (one selection a launch on the host), and its output
        goes back to their places."""
        outs, tots = self.finalize()
        Pl = self.Pl
        P, Q = p.size, pp.size
        if not (P or Q or blocks.size):
            return (np.zeros((0, 10), np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        before = np.concatenate([[0], np.cumsum(tots)])
        cap = calling_kernels.FETCH_MAX_SHARDS
        groups = [(d, mine[i:i + cap])
                  for d, mine in self._device_shards().items()
                  for i in range(0, len(mine), cap)]
        one = len(groups) == 1
        if one:
            sels = [None]
        else:
            # the launch of each element, by the shard that holds it
            group_of = np.zeros(self.n, dtype=np.int64)
            for i, (_, mine) in enumerate(groups):
                group_of[mine] = i
            own = [group_of[x // g] for x, g in ((p, Pl), (pp, Pl),
                                                 (blocks, Pl // BLOCK_SIZE))]
            sels = [[np.nonzero(o == i)[0] for o in own]
                    for i in range(len(groups))]
        jobs = []
        for (d, mine), sel in zip(groups, sels):
            x = (p, pp, blocks) if sel is None else (
                p[sel[0]], pp[sel[1]], blocks[sel[2]])
            if not any(a.size for a in x):
                continue
            jobs.append((sel, x, calling_kernels.caller_fetch_slice(
                [outs[s] for s in mine], [s * Pl for s in mine],
                [int(before[s]) for s in mine],
                upload(np.concatenate(x), d), x[0].size, x[1].size, self.L,
                [bds[s] for s in mine] if x[2].size else None)))
        got = download([o for _, _, o in jobs])
        if one:
            o = got[0]
            return (o[:10 * P].reshape(P, 10), o[10 * P:10 * P + Q],
                    o[10 * P + Q:])
        cols = np.zeros((P, 10), dtype=np.int64)
        pref = np.zeros(Q, dtype=np.int64)
        depths = np.zeros(blocks.size, dtype=np.int64)
        for (sel, x, _), o in zip(jobs, got):
            k, q = x[0].size, x[1].size
            cols[sel[0]] = o[:10 * k].reshape(k, 10)
            pref[sel[1]] = o[10 * k:10 * k + q]
            depths[sel[2]] = o[10 * k + q:]
        return cols, pref, depths

    def fetch_columns(self, positions: np.ndarray, prefix_pts: np.ndarray,
                      bd_blocks: np.ndarray = None):
        """Evidence columns (A, C, G, T, multi, F1, R2, F2, R1, cov) at
        positions, each from the shard that owns it, and the global
        exclusive coverage prefix at prefix_pts (the totals of the shards
        before the owner plus its local prefix). With bd_blocks and after
        scan(), the block depths there ride the same launches and seed the
        ShardedBlockDepth cache."""
        L = self.L
        p = np.clip(np.asarray(positions, dtype=np.int64), 0, L - 1)
        pp = np.clip(np.asarray(prefix_pts, dtype=np.int64), 0, L)
        b, bds = _NONE, None
        if bd_blocks is not None and self._scan is not None:
            lbd = self._scan[0]
            b = np.unique(np.asarray(bd_blocks, dtype=np.int64))
            b = b[(b >= 0) & (b < lbd.nb)]
            bds = lbd._parts
        cols, pref, depths = self._fetch(p, pp, b, bds)
        STATS.fetches += 1
        if b.size:
            self._scan[0].insert(b, depths)
        return cols, pref

    def nor_blocks(self, emitted: np.ndarray, brk: np.ndarray):
        """gVCF NOR blocks over the shards: each shard's segment minima of
        its normal positions (covered, below L, no record emitted there;
        nor_blocks_slice, keyed by the global breaks), one copy a shard,
        combined on the host: a segment's first position and the coverage
        there from the first shard that has one, its least coverage the
        minimum over the shards -> (first_pos, min_cov, cov_at_first) int64
        per key 0..brk.size, INT32_MAX for an empty segment (the
        single-card contract), whose coverage is the one at L - 1, as the
        single-card kernel's clamped read gives below 2^31."""
        outs, _ = self.finalize()
        Pl, L = self.Pl, self.L
        nseg = brk.size + 2
        bk = np.sort(np.asarray(brk, dtype=np.int64)) if brk.size else \
            np.array([L], dtype=np.int64)
        em = np.sort(np.clip(np.asarray(emitted, dtype=np.int64), 0, L - 1))
        ups, jobs = {}, []
        for s, (fin, d) in enumerate(zip(outs, self.devs)):
            off = s * Pl
            valid = min(L - off, Pl)
            if valid <= 0:            # a padded tail shard holds no position
                continue
            if d not in ups:          # one upload a device
                ups[d] = upload(np.concatenate([em, bk]), d)
            lo, hi = np.searchsorted(em, [off, off + valid])
            jobs.append((s, calling_kernels.nor_blocks_slice(
                fin[3], valid, ups[d][lo:hi], ups[d][em.size:], nseg, off)))
        first = np.full(nseg, INT32_MAX, dtype=np.int64)
        mincov = np.full(nseg, INT32_MAX, dtype=np.int64)
        covf = np.zeros(nseg, dtype=np.int64)
        found = np.zeros(nseg, dtype=bool)
        last = (L - 1) // Pl
        for (s, _), r in zip(jobs, download([out for _, out in jobs])):
            r = r.astype(np.int64)
            f, m, c = r[:nseg], r[nseg:2 * nseg], r[2 * nseg:]
            take = ~found & (f != INT32_MAX)
            first[take] = s * Pl + f[take]
            covf[take] = c[take]
            found |= take
            mincov = np.minimum(mincov, m)
            if s == last:
                covf[~found] = c[~found]
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
