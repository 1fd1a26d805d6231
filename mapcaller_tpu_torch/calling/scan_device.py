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

from ..ops import calling_kernels
from ..ops.calling_kernels import (BLOCK_SIZE, CAND_CAP,  # noqa: F401
                                   INT32_MAX, RUN_CAP)
from ..ops.device_util import need, upload


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
    n_runs, n_aligned, total_cov)): ops/calling_kernels.caller_scan (one
    kernel launch on the card; nothing here waits for the device or is
    copied from the host); the tables hold -1 (0 for run_val) past their
    counts."""

    def kernel(acgt, multi, cov, ref_codes, min_allele_depth, freq_base):
        need(cov.shape[0] == L, f"build_scan_kernel: {L} positions expected")
        return calling_kernels.caller_scan(acgt, multi, cov, ref_codes,
                                           min_allele_depth, freq_base,
                                           somatic)[:5]

    return kernel


def build_fetch_kernel(L: int):
    """fn(acgt, multi, F, cov, cov_prefix, positions, prefix_pts) ->
    (cols int32[P, 10] = (A, C, G, T, multi, F1, R2, F2, R1, cov),
    cov_prefix values int64[Q]): ops/calling_kernels.caller_fetch."""

    def kernel(acgt, multi, F, cov, cov_prefix, positions, prefix_pts):
        need(cov.shape[0] == L, f"build_fetch_kernel: {L} positions expected")
        P = positions.shape[0]
        out = calling_kernels.caller_fetch(
            acgt, multi, F, cov, cov_prefix,
            torch.cat([positions, prefix_pts]).to(torch.int64), P,
            prefix_pts.shape[0])
        return out[:10 * P].reshape(P, 10).to(torch.int32), out[10 * P:]

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
    excludes them from 'normal', sorted for the kernel, brk_sorted
    int64[K] — every record-appending position, sorted) -> (first_pos,
    min_cov, cov_at_first) int32[NSEG] each; an empty segment holds
    INT32_MAX, the identity of the reference's segment_min. Segment
    NSEG-1 is the dump for positions that are not normal, so NSEG > K + 1.
    ops/calling_kernels.nor_blocks."""

    def kernel(cov, emitted, brk_sorted):
        need(cov.shape[0] == L, f"build_nor_kernel: {L} positions expected")
        out = calling_kernels.nor_blocks(cov, emitted, brk_sorted, NSEG)
        return out[:NSEG], out[NSEG:2 * NSEG], out[2 * NSEG:]

    return kernel
