"""Genome coordinate bookkeeping.

The concatenated coordinate space is [0, 2L): forward strand then
reverse complement. Mirrors ChromosomeVec / PosChrIdMap logic
(ref: src/bwt_index.cpp:232-258, src/tools.cpp:112-164).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .index.packer import PackedReference


@dataclasses.dataclass
class Genome:
    names: List[str]
    lengths: np.ndarray          # int64[n_chrom]
    fwd_loc: np.ndarray          # int64[n_chrom] forward start offsets
    rev_loc: np.ndarray          # int64[n_chrom] reverse-strand start offsets
    genome_size: int
    two_genome_size: int
    # sorted boundary keys: end position (inclusive) of each chrom segment on
    # both strands -> chromosome index (PosChrIdMap equivalent)
    boundary_keys: np.ndarray    # int64[2*n_chrom] sorted
    boundary_chrom: np.ndarray   # int32[2*n_chrom]

    @classmethod
    def from_packed(cls, ref: PackedReference) -> "Genome":
        n = ref.n_chromosomes
        L = ref.genome_size
        lengths = np.asarray(ref.lengths, dtype=np.int64)
        fwd = np.asarray(ref.offsets, dtype=np.int64)
        rev = 2 * L - (fwd + lengths)
        keys = np.concatenate([fwd + lengths - 1, rev + lengths - 1])
        chroms = np.concatenate([np.arange(n), np.arange(n)]).astype(np.int32)
        order = np.argsort(keys, kind="stable")
        return cls(names=list(ref.names), lengths=lengths, fwd_loc=fwd,
                   rev_loc=rev, genome_size=L, two_genome_size=2 * L,
                   boundary_keys=keys[order], boundary_chrom=chroms[order])

    # lower_bound on PosChrIdMap keys (ref: tools.cpp:112-117)
    def alignment_boundary(self, g_pos: int) -> int:
        i = int(np.searchsorted(self.boundary_keys, g_pos, side="left"))
        if i >= len(self.boundary_keys):
            return int(self.boundary_keys[-1])
        return int(self.boundary_keys[i])

    def boundary_index(self, g_pos: int) -> int:
        """Index into boundary arrays of lower_bound(g_pos); len() if none."""
        return int(np.searchsorted(self.boundary_keys, g_pos, side="left"))

    def check_alignment_validity(self, first_gpos: int, last_gend: int) -> bool:
        """True iff an alignment spanning [first_gpos, last_gend) stays within
        one chromosome segment (ref: tools.cpp:119-130)."""
        if first_gpos < 0 or last_gend > self.two_genome_size:
            return False
        i1 = self.boundary_index(first_gpos)
        i2 = self.boundary_index(last_gend - 1)
        nk = len(self.boundary_keys)
        return i1 < nk and i2 < nk and self.boundary_keys[i1] == self.boundary_keys[i2]

    def determine_coordinate(self, g_pos: int) -> Tuple[int, int]:
        """-> (chrom_idx, 1-based position) (ref: tools.cpp:132-164)."""
        if g_pos < self.genome_size:
            if len(self.names) == 1:
                return 0, int(g_pos) + 1
            i = self.boundary_index(g_pos)
            c = int(self.boundary_chrom[i])
            return c, int(g_pos) + 1 - int(self.fwd_loc[c])
        else:
            if len(self.names) == 1:
                return 0, int(self.two_genome_size - g_pos)
            i = self.boundary_index(g_pos)
            c = int(self.boundary_chrom[i])
            return c, int(self.boundary_keys[i]) - int(g_pos) + 1
