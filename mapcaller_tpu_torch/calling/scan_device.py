"""Device-side variant-caller scan over the device-resident evidence
planes (PyTorch port of mapcaller_tpu/calling/scan_device.py; ref:
src/VariantCalling.cpp:106-120 block depth, :550-680 scan).

The genome-axis math runs on the card; only sparse results cross to the
host: SUB candidate indices (a conservative superset of the host
threshold — exact float64 thresholds are re-applied on the host), gap/CNV
run boundaries, and exact int64 scalar reductions. The per-100bp
block-depth array stays on the card (LazyBlockDepth): every host consumer
indexes it only at sparse positions (indel keys, breakpoint candidates —
device_call.py, caller.identify_sv). A second call gathers full evidence
columns (acgt / multi / F planes / cov / cov prefix) at the sparse
positions every downstream consumer (record emission, VCF writer, SV
scoring) reads.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.device_util import upload

BLOCK_SIZE = 100
CAND_CAP = 1 << 17
RUN_CAP = 1 << 20
INT32_MAX = 0x7FFFFFFF
DUMP = 4096          # dump slots past a compacted table


class LazyBlockDepth:
    """Device-resident per-100bp block depths with sparse host access.

    The dense array (GenomeSize/100 entries) is only ever indexed at a
    handful of sparse positions on the host (ref: VariantCalling.cpp uses
    BlockDepthArr at indel/breakpoint loci, :576-597 and :229-282), so it
    stays on the card; ``prefetch`` batches one gather for a block set,
    ``__getitem__`` serves cached values (gathering one-off on a miss),
    and ``dense()``/``astype`` materialize the full array for tests and
    fallback paths."""

    def __init__(self, arr: torch.Tensor, nb: int):
        self._arr = arr            # int32 tensor on the card, len >= nb
        self.nb = nb
        self._cache: Dict[int, int] = {}
        self._dense = None

    def prefetch(self, blocks) -> None:
        if self._dense is not None:
            return
        blocks = np.unique(np.asarray(blocks, dtype=np.int64))
        blocks = blocks[(blocks >= 0) & (blocks < self.nb)]
        missing = [int(b) for b in blocks.tolist() if b not in self._cache]
        if not missing:
            return
        idx = upload(np.asarray(missing, dtype=np.int64), self._arr.device)
        vals = self._arr[idx].cpu().tolist()
        self._cache.update(zip(missing, (int(v) for v in vals)))

    def insert(self, blocks, vals) -> None:
        """Seed the cache with values gathered elsewhere (fetched on a
        shared copy, see DeviceEvidence.fetch_columns)."""
        self._cache.update(zip((int(b) for b in np.asarray(blocks)),
                               (int(v) for v in np.asarray(vals))))

    def __getitem__(self, b) -> int:
        b = int(b)
        if self._dense is not None:
            return int(self._dense[b])
        if b not in self._cache:
            if not 0 <= b < self.nb:
                raise IndexError(b)
            self.prefetch(np.asarray([b]))
        return self._cache[b]

    def dense(self) -> np.ndarray:
        if self._dense is None:
            self._dense = self._arr[:self.nb].cpu().numpy().astype(np.int64)
        return self._dense

    def astype(self, dtype) -> np.ndarray:
        return self.dense().astype(dtype)

    def __len__(self) -> int:
        return self.nb


def build_scan_kernel(L: int, somatic: bool):
    """fn(acgt int32[4,L], multi int32[L], cov int32[L], ref_codes
    int32[L], min_allele_depth int, freq_base float32 value) ->
    (block_depth int32[nb], cand_idx int32[CAND_CAP], run_start
    int32[RUN_CAP], run_val int32[RUN_CAP], small int64[4] = (n_cand,
    n_runs, n_aligned, total_cov)). Compaction is a scatter with dump
    slots, so nothing here waits for the device (and nothing is copied
    from the host); the tables hold -1 (0 for run_val) past their
    counts."""
    nb = (L + BLOCK_SIZE - 1) // BLOCK_SIZE
    i32 = torch.int32

    def compact(mask, dest, vals, cap, fill, spread):
        # unselected positions store into a dump region past the table,
        # spread by position: millions of stores to one address
        # serialize on the card
        out = torch.full((cap + DUMP,), fill, dtype=i32, device=mask.device)
        slot = torch.where(mask, torch.clamp(dest, max=cap), cap + spread)
        return out.scatter_(0, slot, vals)[:cap]

    def kernel(acgt, multi, cov, ref_codes, min_allele_depth, freq_base):
        dev = cov.device
        pad = nb * BLOCK_SIZE - L
        covp = torch.cat([cov, torch.zeros(pad, dtype=i32, device=dev)])
        sums = covp.reshape(nb, BLOCK_SIZE).sum(1, dtype=i32)
        block_depth = torch.where(sums > 0, sums // BLOCK_SIZE, 0)

        ad = int(min_allele_depth)
        if somatic:
            cov_thr = torch.full((L,), ad, dtype=i32, device=dev)
        else:
            bd_pos = block_depth[:, None].expand(nb, BLOCK_SIZE).reshape(
                -1)[:L]
            cov_thr = torch.clamp(bd_pos >> 1, min=ad)
        rc = ref_codes[:L]
        nonref_max = torch.full((L,), -1, dtype=i32, device=dev)
        for c in range(4):
            nonref_max = torch.maximum(nonref_max,
                                       torch.where(rc == c, -1, acgt[c]))
        # conservative superset of max(ceil_f64(cov*freq_base), ad): the
        # float32 product minus 1 covers rounding differences. The factor
        # is a float32 value, and a float32 tensor times a Python scalar
        # multiplies in float32
        fb = float(np.float32(freq_base))
        sup_thr = torch.clamp((cov.to(torch.float32) * fb).to(i32) - 1,
                              min=ad)
        cand_mask = (cov >= cov_thr) & (nonref_max >= sup_thr)
        dest = torch.cumsum(cand_mask, 0, dtype=torch.int64) - 1
        n_cand = cand_mask.sum()
        pos = torch.arange(L, dtype=i32, device=dev)
        spread = pos.to(torch.int64) % DUMP
        cand_idx = compact(cand_mask, dest, pos, CAND_CAP, -1, spread)

        # gap/CNV run boundaries (ref: cpp:632-651 semantics, on the host)
        state = torch.where(cov > 0, 2, torch.where(multi > 0, 1, 0)).to(i32)
        newrun = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            state[1:] != state[:-1]])
        rdest = torch.cumsum(newrun, 0, dtype=torch.int64) - 1
        n_runs = newrun.sum()
        run_start = compact(newrun, rdest, pos, RUN_CAP, -1, spread)
        run_val = compact(newrun, rdest, state, RUN_CAP, 0, spread)

        aligned = cov > 0
        n_aligned = aligned.sum()
        total_cov = torch.where(aligned, cov, 0).sum(dtype=torch.int64)
        small = torch.stack([n_cand, n_runs, n_aligned, total_cov])
        return block_depth, cand_idx, run_start, run_val, small

    return kernel


def build_fetch_kernel(L: int):
    """fn(acgt, multi, F, cov, cov_prefix, positions, prefix_pts) ->
    (cols int32[P, 10] = (A, C, G, T, multi, F1, R2, F2, R1, cov),
    cov_prefix values int64[Q])."""

    def kernel(acgt, multi, F, cov, cov_prefix, positions, prefix_pts):
        p = torch.clamp(positions, 0, L - 1)
        cols = torch.stack([acgt[0][p], acgt[1][p], acgt[2][p], acgt[3][p],
                            multi[p], F[0][p], F[1][p], F[2][p], F[3][p],
                            cov[p]], dim=1)
        pref = cov_prefix[torch.clamp(prefix_pts, 0, L)]
        return cols, pref

    return kernel


class _SparseVec:
    """1-D plane view backed by fetched columns; fails fast on
    positions outside the fetched set."""

    def __init__(self, cols: Dict[int, np.ndarray], k: int):
        self._cols = cols
        self._k = k

    def __getitem__(self, g):
        return int(self._cols[int(g)][self._k])


class _SparseAcgt:
    def __init__(self, cols: Dict[int, np.ndarray]):
        self._cols = cols

    def __getitem__(self, key):
        k, g = key
        col = self._cols[int(g)]
        if isinstance(k, slice):
            return col[:4]
        return int(col[k])


class SparseProfile:
    """Duck-typed stand-in for pipeline.profile.Profile when the planes
    live on the card: every consumer reads either host-side event dicts
    or evidence columns fetched for the sparse position set."""

    def __init__(self, host_profile, cols: Dict[int, np.ndarray],
                 cov_prefix: Dict[int, int], genome_size: int):
        self.n = genome_size
        self._cols = cols
        self._cov_prefix = cov_prefix
        self.insert_map = host_profile.insert_map
        self.delete_map = host_profile.delete_map
        self.break_point = host_profile.break_point
        # the duplicate-gate counter stays host-authoritative (dense)
        self.read_count = host_profile.read_count
        self.acgt = _SparseAcgt(cols)
        self.multi_hit = _SparseVec(cols, 4)
        self.F1 = _SparseVec(cols, 5)
        self.R2 = _SparseVec(cols, 6)
        self.F2 = _SparseVec(cols, 7)
        self.R1 = _SparseVec(cols, 8)

    def column_size(self, g_pos: int) -> int:
        return int(self._cols[int(g_pos)][9])

    def region_cov_sum(self, beg: int, end: int) -> int:
        """sum(cov[beg:end+1]) from the device prefix sums."""
        return self._cov_prefix[end + 1] - self._cov_prefix[beg]


def build_nor_kernel(L: int, NSEG: int):
    """gVCF NOR-block reduction on the card (ref: VariantCalling.cpp:
    652-661 via the RLE formulation of caller._identify_variants_gvcf_vec):
    normal positions (covered, no record emitted there) group by
    key[p] = #record-appending positions <= p; per group the record is
    (first normal position, cov at it, min cov over the group).

    fn(cov int32[L], emitted int64[E] — positions whose own record
    excludes them from 'normal', brk_sorted int64[K] — every
    record-appending position, sorted) -> (first_pos, min_cov,
    cov_at_first) int32[NSEG] each; an empty segment holds INT32_MAX,
    the identity of the reference's segment_min. Segment NSEG-1 is the
    dump for positions that are not normal, so NSEG > K + 1."""

    def kernel(cov, emitted, brk_sorted):
        dev = cov.device
        pos = torch.arange(L, dtype=torch.int64, device=dev)
        em_mask = torch.zeros(L, dtype=torch.bool, device=dev)
        em_mask[torch.clamp(emitted, 0, L - 1)] = True
        normal = (cov > 0) & ~em_mask
        key = torch.searchsorted(brk_sorted, pos, right=True)
        seg = torch.where(normal, torch.clamp(key, max=NSEG - 1), NSEG - 1)

        def seg_min(vals):
            out = torch.full((NSEG,), INT32_MAX, dtype=torch.int32,
                             device=dev)
            return out.scatter_reduce_(0, seg, torch.where(
                normal, vals.to(torch.int32), INT32_MAX), "amin")

        first = seg_min(pos)
        mincov = seg_min(cov)
        covf = cov[torch.clamp(first, 0, L - 1).to(torch.int64)]
        return first, mincov, covf

    return kernel
