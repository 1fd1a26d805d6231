"""Device-resident evidence planes, updated on the card (PyTorch port of
mapcaller_tpu/pipeline/device_profile.py; ref contract:
src/AlignmentProfile.cpp:41-242).

Layout (int32, genome_size = L):

  acgt        [4, L+1]   mismatch point adds (uncapped; capped at the
                         finalize fold, exact for +1 streams)
  exact_diff  [L+2]      +1/-1 endpoints of exact-match coverage; holes
                         punched at mismatch positions of fast reads
  f_diff      [4, L+2]   F1/R2/F2/R1 orientation range endpoints
  multi_diff  [L+2]      multi-hit span endpoints

The per-batch apply consumes the batch's device-resident chain outputs
(diagonal pd, packed mismatch positions, read lengths) for FAST-class
reads plus a host bitmask of which of them were admitted (uniquely
mapped AND passed the PCR-duplicate gate, whose strictly sequential
per-start counter stays in the C++ host leg, so every device update is a
commutative add). SLOW-read evidence accumulates in the host diff arrays
as before; its sparse nonzero deltas merge into the device planes once,
at finalize.

Extra slots (the +1/+2) are scatter dump targets for masked-out lanes.

The per-batch apply, the dense undo of a speculation and the sparse
reject correction are one kernel each on the card: K2,
`evidence_apply_bits_kernel` (csrc/chain.cu), through
ops/mesh_kernels.apply_bits, which this module calls as an attribute of
that module (a tap on it reaches these calls). Its plain version is the
eager scatter of ops/evidence.py, which the CPU runs. The
`build_*_kernel` functions bind the static arguments of the reference's
jitted `build_*` functions and return a function that updates the planes
in place: the apply and the correction through K2's wrapper, the host
merge through `host_merge_kernel` (csrc/chain.cu, ops/mesh_kernels.
host_merge: the four lists and their row segments, uploaded as one
buffer, in one launch). The finalize fold is `evidence_finalize_kernel`
(csrc/calling.cu) through ops/calling_kernels.evidence_finalize, whose
plain version the CPU runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import calling_kernels, mesh_kernels
from ..ops.calling_kernels import MAX_ALLELE_COUNT  # noqa: F401
from ..ops.chain_device import CLASS_FAST
from ..ops.device_util import need, upload


class EvidenceStats:
    """Which evidence path a run took: `applies` stand-alone per-batch
    applies, `folded` speculative applies inside the chain dispatch,
    `corrections` sparse reject retractions, `undos` dense retractions of
    a speculation (tier rerun or too many rejects), `scans` caller scans,
    `fetches` column fetches, `downloads` full plane downloads to the
    host profile,
    `overflow_fallbacks` calling runs whose CAND_CAP/RUN_CAP tables
    overflowed (and so downloaded the planes). Counted on every
    device."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.applies = self.folded = self.corrections = self.undos = 0
        self.scans = self.fetches = self.downloads = 0
        self.overflow_fallbacks = 0


STATS = EvidenceStats()


@dataclasses.dataclass
class DevicePlanes:
    acgt: torch.Tensor
    exact_diff: torch.Tensor
    f_diff: torch.Tensor
    multi_diff: torch.Tensor
    L: int

    @classmethod
    def zeros(cls, L: int, device="cuda") -> "DevicePlanes":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32,
                               device=torch.device(device))
        return cls(acgt=z(4, L + 1), exact_diff=z(L + 2), f_diff=z(4, L + 2),
                   multi_diff=z(L + 2), L=L)


def build_apply_kernel(L: int, two_l: int, B: int, pair_end: bool,
                       source: str = "bits", sign: int = 1):
    """fn(planes, pd[B], mmp[B,S], rlens[B], sel) -> planes, in place.
    Applies (sign=+1) or retracts (sign=-1) FAST reads' evidence:
    coverage + orientation range endpoints, mismatch holes, read-base
    point adds. source='bits': sel is the host admit bitmask int32[B/32];
    source='meta': sel is the chain kernel's packed output vector and the
    admitted set is every device-classified FAST read (the speculative
    fold, corrected later by build_correct_kernel). One K2 call
    (mesh_kernels.apply_bits); the text is the genome and its reverse
    complement, two_l = 2L."""
    need(two_l == 2 * L, "build_apply_kernel: the text must be 2L long")

    def kernel(planes: DevicePlanes, pd, mmp, rlens, sel):
        need(pd.shape[0] == B, f"build_apply_kernel: {B} reads expected")
        return mesh_kernels.apply_bits(planes, pd, mmp, rlens, sel,
                                       pair_end, sign, source)

    return kernel


def reject_words(rej: np.ndarray, B: int) -> np.ndarray:
    """int32[ceil(B/32)] admit words with the bits of the read indices
    rej (< B) set."""
    words = np.zeros((B + 31) // 32, dtype=np.uint32)
    rej = np.asarray(rej, dtype=np.int64)
    np.bitwise_or.at(words, rej >> 5,
                     np.uint32(1) << (rej & 31).astype(np.uint32))
    return words.view(np.int32)


def build_correct_kernel(L: int, two_l: int, B: int, pair_end: bool):
    """fn(planes, pd[B], mmp[B,S], rlens[B], rej_idx[R]) -> planes, in
    place. Sparse retraction for the folded apply: rej_idx holds the read
    indices (< B) whose speculative evidence must be subtracted (host
    dup-gate rejects, splice-forced slow reads), set as admit bits for
    one K2 call with sign -1. The reference pads rej_idx to a static R
    with B; here R is the count itself."""
    retract = build_apply_kernel(L, two_l, B, pair_end, sign=-1)

    def kernel(planes: DevicePlanes, pd, mmp, rlens, rej_idx):
        words = reject_words(rej_idx.cpu().numpy(), B)
        return retract(planes, pd, mmp, rlens, upload(words, pd.device))

    return kernel


def merge_strides(L: int):
    """The row strides of the host merge's four lists' indices (acgt,
    exact_diff, f_diff, multi_diff): the single-card planes' rows."""
    return (L + 1, L + 2, L + 2, L + 2)


def host_delta_lists(p, L: int):
    """The host profile's slow-read evidence (its sparse nonzero diff
    entries + point adds, found by eight scans of its arrays) as the host
    merge's four lists at the single-card planes' flat indices (row *
    merge_strides(L)[k] + position) -> (the lists packed for one upload,
    mesh_kernels.pack_deltas; their ends)."""
    sa, _, sf, _ = merge_strides(L)

    def nz(arr, offset=0):
        a = np.asarray(arr).reshape(-1)
        i = np.nonzero(a)[0]
        return i + offset, a[i].astype(np.int32)

    ia, va = nz(p.acgt)
    ia = (ia // L) * sa + (ia % L)   # host [4, L]; device stride L+1
    fparts = [nz(getattr(p, name), k * sf) for k, name in enumerate(
        ("F1_diff", "R2_diff", "F2_diff", "R1_diff"))]
    lists = [(ia, va), nz(p.exact_diff),
             (np.concatenate([x[0] for x in fparts]),
              np.concatenate([x[1] for x in fparts])), nz(p.multi_diff)]
    ends = np.cumsum([i.size for i, _ in lists]).tolist()
    return mesh_kernels.pack_deltas(lists), ends


def zero_host_deltas(p) -> None:
    """Zero the host profile's slow-read arrays once they are merged, so a
    later download does not add them twice."""
    for name in ("acgt", "exact_diff", "F1_diff", "R2_diff", "F2_diff",
                 "R1_diff", "multi_diff"):
        getattr(p, name)[:] = 0


def build_host_merge_kernel(L: int):
    """fn(planes, deltas, ends) -> planes, in place: add the host
    profile's sparse nonzero deltas (slow-read evidence) into the planes:
    deltas the four lists at the planes' flat indices, packed
    (host_delta_lists, on the host), ends their ends. One copy and one
    host_merge_kernel launch (mesh_kernels.host_merge, one shard at off
    0: a segment a plane row)."""
    gstrides = merge_strides(L)

    def kernel(planes: DevicePlanes, deltas, ends):
        mesh_kernels.host_merge([(planes, 0)], deltas, ends, gstrides)
        return planes

    return kernel


def build_finalize_kernel(L: int):
    """fn(planes, ref_codes) -> (acgt_final int32[4,L] capped with exact
    coverage credited to the reference base, F int32[4,L], multi int32[L]
    capped, cov int32[L], cov_prefix int64[L+1]); mirrors
    Profile.finalize_diffs. cov_prefix is int64: the reference's int32
    prefix wraps once the summed coverage passes 2^31 and equals this one
    wherever it does not. ops/calling_kernels.evidence_finalize."""

    def kernel(planes: DevicePlanes, ref_codes):
        return tuple(calling_kernels.evidence_finalize(
            planes.acgt, planes.exact_diff, planes.f_diff, planes.multi_diff,
            L, codes=ref_codes)[:5])

    return kernel


def make_device_evidence(backend, cfg, host_profile):
    """DeviceEvidence factory: per-replica planes for a multi-device
    backend (`-devices N`, parallel/devices.MultiDeviceEvidence), the
    genome-sharded planes of the x64 big-genome path (big_x64 under
    `-shards N`, pipeline/big_profile.BigDeviceEvidence), else the
    single-card planes (also under `-shards N`, whose planes stay on the
    backend's device)."""
    if getattr(backend, "big", False):
        from .big_profile import BigDeviceEvidence
        return BigDeviceEvidence(backend, cfg, host_profile)
    if getattr(backend, "is_multi_device", False):
        from ..parallel.devices import MultiDeviceEvidence
        return MultiDeviceEvidence(backend, cfg, host_profile)
    return DeviceEvidence(backend, cfg, host_profile)


class DeviceEvidence:
    """Owns the device planes for one run: per-batch apply of fast-read
    evidence, the finalize fold (which first merges the host-side
    slow-read deltas), the caller scan and sparse column fetches. The
    gVCF NOR blocks reduce on the card too; -monomorphic and -obs/-obr
    download the planes (pipeline/engine.py)."""

    CORRECT_CAP = 1024

    def __init__(self, backend, cfg, host_profile):
        self.be = backend
        self.cfg = cfg
        self.host_profile = host_profile
        self.L = backend.idx.genome_size
        self.two_l = backend.idx.seq_len
        self.device = backend.device
        self.planes = DevicePlanes.zeros(self.L, self.device)
        self._final = None
        self._ref_codes = None
        self._scan = None
        self._scan_pending = None

    def _words(self, bits: np.ndarray, B: int) -> torch.Tensor:
        """uint32 admit words, zero-padded to ceil(B/32), on the device as
        int32."""
        w = np.zeros((B + 31) // 32, dtype=np.int32)
        w[:bits.size] = bits.view(np.int32)
        return upload(w, self.device)

    def apply_batch(self, token, fast_bits: np.ndarray,
                    pair_end: bool) -> None:
        """token: the submit_chain token of the batch just processed by
        the host; fast_bits: admitted fast reads (unique-mapped AND
        passed the host-side duplicate gate), uint32 words. One K2
        call."""
        B = int(token.rl_dev.shape[0])
        mesh_kernels.apply_bits(self.planes, token.pd, token.mmp,
                                token.rl_dev, self._words(fast_bits, B),
                                bool(pair_end))
        STATS.applies += 1

    def _undo_speculation(self, token, pair_end: bool) -> None:
        """Retract every FAST read of the speculative dispatch, by the
        classes in its packed output vector on the card (K2, source
        "meta", sign -1)."""
        dev0, pd0, mmp0 = token.spec
        mesh_kernels.apply_bits(self.planes, pd0, mmp0, token.rl_dev,
                                dev0, bool(pair_end), -1, "meta")
        STATS.undos += 1

    def reconcile_batch(self, token, fast_bits: np.ndarray,
                        pair_end: bool) -> None:
        """Post-host step for a batch. Classic tokens (no fold) run the
        stand-alone apply. Folded tokens (submit_chain(evidence=...))
        already hold the speculative apply of every device-FAST read;
        here the host's rejects (dup-gate losers, oracle-spliced reads)
        are retracted sparsely (one K2 call on their bits, sign -1), and
        the common no-reject batch costs no device work at all. A tier
        rerun (collect_chain swapped the token's outputs) densely undoes
        the stale speculation and falls back to the classic apply with
        the rerun's outputs."""
        if token.spec is None:
            return self.apply_batch(token, fast_bits, pair_end)
        dev0 = token.spec[0]
        B = int(token.rl_dev.shape[0])
        if token.dev is not dev0:   # tier rerun invalidated the speculation
            self._undo_speculation(token, pair_end)
            return self.apply_batch(token, fast_bits, pair_end)
        # the classes of the speculative dispatch, as collect_chain
        # downloaded them
        fast_ix = np.nonzero(token.cls0[:B] == CLASS_FAST)[0]
        fb = np.zeros((B + 31) // 32, dtype=np.uint32)
        fb[:fast_bits.size] = fast_bits.view(np.uint32)
        admitted = ((fb[fast_ix >> 5] >> (fast_ix & 31)) & 1) == 1
        rej = fast_ix[~admitted]
        if rej.size == 0:
            return
        if rej.size > self.CORRECT_CAP:   # pathological: redo densely
            self._undo_speculation(token, pair_end)
            return self.apply_batch(token, fast_bits, pair_end)
        mesh_kernels.apply_bits(self.planes, token.pd, token.mmp,
                                token.rl_dev,
                                upload(reject_words(rej, B), self.device),
                                bool(pair_end), -1)
        STATS.corrections += 1

    # ------------------------------------------------------------------
    def _ref_codes_dev(self) -> torch.Tensor:
        """Forward-genome codes int32[L] from the device text words
        (int64 holding uint32, 16 crumbs per word in bwa order): the
        plain version of the codes the finalize kernel reads itself."""
        return calling_kernels.ref_codes_plain(self.be.chain_ctx.text_words,
                                               self.L)

    def _merge_host_deltas(self) -> None:
        """Add the host profile's slow-read evidence (sparse nonzero diff
        entries + point adds) into the device planes, once (one upload of
        the lists and their segments, one host_merge launch), then zero
        the host copies so a
        later download does not add them twice."""
        p = self.host_profile
        if hasattr(p, "any_host_evidence") and not p.any_host_evidence():
            # every read applied on the card: skip eight O(L) scans
            return
        build_host_merge_kernel(self.L)(self.planes,
                                        *host_delta_lists(p, self.L))
        zero_host_deltas(p)

    def finalize(self):
        """Merge host deltas + fold diffs on the card ->
        (acgt, F, multi, cov, cov_prefix), all device-resident; one
        evidence_finalize launch, which also writes the reference codes
        the scan reads (self._ref_codes) from the text words."""
        if self._final is None:
            self._merge_host_deltas()
            pl = self.planes
            fin = calling_kernels.evidence_finalize(
                pl.acgt, pl.exact_diff, pl.f_diff, pl.multi_diff, self.L,
                words=self.be.chain_ctx.text_words)
            self._ref_codes = fin.codes
            self._final = tuple(fin[:5])
        return self._final

    def start_scan(self) -> None:
        """Queue the finalize and the caller scan on the card without
        waiting for them; engine.finalize calls it as soon as the
        evidence is complete, so the host's post-mapping work overlaps
        the device's. scan() reads the results."""
        if self._scan is not None or self._scan_pending is not None:
            return
        from ..calling.scan_device import build_scan_kernel
        acgt, F, multi, cov, cov_prefix = self.finalize()
        freq_base = 0.01 if self.cfg.somatic else self.cfg.frequency_thr
        kern = build_scan_kernel(self.L, bool(self.cfg.somatic))
        self._scan_pending = kern(acgt, multi, cov, self._ref_codes,
                                  int(self.cfg.min_allele_depth),
                                  np.float32(freq_base))
        STATS.scans += 1

    def scan(self):
        """Caller scan (cached); returns (block_depth LazyBlockDepth —
        device-resident, sparse host access, cand_idx, run_start, run_val
        — each at least as long as its count unless it overflowed its
        capacity, scalars int64[4] = (n_cand, n_runs, n_aligned,
        total_cov)). Two copies to the host: the scalars, then the tables'
        used prefixes."""
        if self._scan is not None:
            return self._scan
        from ..calling.scan_device import (BLOCK_SIZE, CAND_CAP, RUN_CAP,
                                           LazyBlockDepth)
        self.start_scan()
        bd, cand_idx, run_start, run_val, small = self._scan_pending
        self._scan_pending = None
        scal4 = small.cpu().numpy().astype(np.int64)
        k1 = min(int(scal4[0]), CAND_CAP)
        k2 = min(int(scal4[1]), RUN_CAP)
        packed = torch.cat([cand_idx[:k1], run_start[:k2],
                            run_val[:k2]]).cpu().numpy()
        nb = (self.L + BLOCK_SIZE - 1) // BLOCK_SIZE
        self._scan = (LazyBlockDepth(bd, nb), packed[:k1],
                      packed[k1:k1 + k2], packed[k1 + k2:], scal4)
        return self._scan

    def fetch_columns(self, positions: np.ndarray, prefix_pts: np.ndarray,
                      bd_blocks: np.ndarray = None):
        """Gather evidence columns + cov-prefix values (one upload of the
        indices, one caller_fetch, one packed copy to the host). When
        bd_blocks is given and scan() has run, the block-depth values at
        those blocks ride the same copy and seed the LazyBlockDepth
        cache."""
        acgt, F, multi, cov, cov_prefix = self.finalize()
        P, Q = len(positions), len(prefix_pts)
        parts = [np.asarray(positions, dtype=np.int64),
                 np.asarray(prefix_pts, dtype=np.int64)]
        bd = None
        if bd_blocks is not None and self._scan is not None:
            lbd = self._scan[0]
            bd_blocks = np.unique(bd_blocks)
            bd_blocks = bd_blocks[(bd_blocks >= 0) & (bd_blocks < lbd.nb)]
            if bd_blocks.size:
                bd = lbd._arr
                parts.append(bd_blocks.astype(np.int64))
        packed = calling_kernels.caller_fetch(
            acgt, multi, F, cov, cov_prefix,
            upload(np.concatenate(parts), self.device), P, Q,
            bd).cpu().numpy()
        STATS.fetches += 1
        if bd is not None:
            self._scan[0].insert(bd_blocks, packed[10 * P + Q:])
        return packed[:10 * P].reshape(P, 10), packed[10 * P:10 * P + Q]

    def nor_blocks(self, emitted: np.ndarray, brk: np.ndarray):
        """gVCF NOR-block reduction on the card: returns (first_pos,
        min_cov, cov_at_first) per block key 0..brk.size. emitted =
        positions whose own record excludes them from 'normal'; brk =
        every record-appending position. Both are sorted here and go up
        in one copy."""
        acgt, F, multi, cov, cov_prefix = self.finalize()
        nseg = brk.size + 2       # keys 0..brk.size, then the dump segment
        # an empty break list searches [L]: every position gets key 0
        bk = np.sort(np.asarray(brk, dtype=np.int64)) if brk.size else \
            np.array([self.L], dtype=np.int64)
        em = np.sort(np.asarray(emitted, dtype=np.int64))
        args = upload(np.concatenate([em, bk]), self.device)
        packed = calling_kernels.nor_blocks(cov, args[:em.size],
                                            args[em.size:], nseg)
        packed = packed.cpu().numpy()
        return packed[:nseg], packed[nseg:2 * nseg], packed[2 * nseg:]

    def download_raw_into(self, profile) -> None:
        """Add the device planes' raw (unfolded, uncapped) contributions
        into the host profile's diff arrays, for the -monomorphic /
        -obs / -pfm / capacity-overflow paths, so saturation happens once
        on the final fold."""
        L = self.L
        if profile.F1_diff is None:
            profile.alloc_diffs()
        pl = self.planes
        profile.exact_diff += pl.exact_diff[:L + 1].cpu().numpy()
        fd = pl.f_diff.cpu().numpy()
        profile.F1_diff += fd[0, :L + 1]
        profile.R2_diff += fd[1, :L + 1]
        profile.F2_diff += fd[2, :L + 1]
        profile.R1_diff += fd[3, :L + 1]
        profile.multi_diff += pl.multi_diff[:L + 1].cpu().numpy()
        profile.acgt += pl.acgt[:, :L].cpu().numpy()
        STATS.downloads += 1

    def download_into(self, profile) -> None:
        """Fallback path: fold everything into the host Profile arrays
        (profile.finalize_diffs completes the fold on the host)."""
        self.download_raw_into(profile)
