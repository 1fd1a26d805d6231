"""Evidence accumulation (ref: src/AlignmentProfile.cpp).

Host-side representation of the per-base position-frequency matrix and
the indel / breakpoint event tables. The PFM is a struct-of-arrays
(NumPy planes) instead of the reference's 16-byte bitfield records
(ref: structure.h:152-163) — the same layout the device kernels use.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..genome import Genome
from .chaining import AlnCan
from .read import ReadState

MIN_BREAKPOINT_SIZE = 20   # ref: AlignmentProfile.cpp:4
MAX_ALLELE_COUNT = 4095    # ref: structure.h:25

_BASE_PLANE = {"A": 0, "C": 1, "G": 2, "T": 3}
_COMP_PLANE = {"A": 3, "C": 2, "G": 1, "T": 0}


def _zeros_prefaulted(shape, dtype=np.int32):
    """np.zeros + touch every page: first-touch page faults on this VM
    class cost ~10us/page, which would otherwise land inside the random
    single-int writes of the mapping hot loop (mc_native update_profile /
    fast_profile). Paying them once at allocation keeps the per-read
    evidence cost at cache-miss scale.

    Above 2 GB/array the prefault is SKIPPED: genome-scale runs use the
    device/sharded evidence planes, where the host planes stay almost
    untouched (sparse slow-read writes only) — committing e.g. 40 GB of
    zero pages for a 1 Gbp genome is what OOM-killed the first
    HUMAN_SCALE attempt. Untouched np.zeros pages cost nothing."""
    a = np.zeros(shape, dtype=dtype)
    if a.nbytes <= (2 << 30):
        a.reshape(-1)[::1024] = 0
    return a


class Profile:
    def __init__(self, genome_size: int):
        self.n = genome_size
        # acgt[4, L] — A/C/G/T counts; saturating at MAX_ALLELE_COUNT
        self.acgt = _zeros_prefaulted((4, genome_size))
        self.multi_hit = _zeros_prefaulted(genome_size)
        self.read_count = _zeros_prefaulted(genome_size)
        # pair-orientation counters (uint16 in the reference)
        self.F1 = _zeros_prefaulted(genome_size)
        self.R2 = _zeros_prefaulted(genome_size)
        self.F2 = _zeros_prefaulted(genome_size)
        self.R1 = _zeros_prefaulted(genome_size)
        self.break_point: Dict[int, int] = {}
        self.insert_map: Dict[int, Dict[str, int]] = {}
        self.delete_map: Dict[int, Dict[str, int]] = {}
        # diff-array mode (device PFM): F/multi counters accumulate as
        # +1/-1 endpoints, cumsum'd once by finalize_diffs()
        self.F1_diff = self.R2_diff = self.F2_diff = self.R1_diff = None
        self.multi_diff = None
        # host-evidence dirtiness: lets the device merge skip its O(L)
        # nonzero scans when every read's evidence applied on device.
        # host_dirty covers Python writers; dirty_probes are callables
        # for writers Python can't see (the native C++ slow path). With
        # NO probes registered, assume dirty (manual test setups poke
        # the arrays directly).
        self.host_dirty = False
        self.dirty_probes: List = []

    def any_host_evidence(self) -> bool:
        if self.host_dirty or not self.dirty_probes:
            return True
        return any(p() for p in self.dirty_probes)

    def alloc_diffs(self) -> None:
        n1 = self.n + 1
        self.F1_diff = _zeros_prefaulted(n1)
        self.R2_diff = _zeros_prefaulted(n1)
        self.F2_diff = _zeros_prefaulted(n1)
        self.R1_diff = _zeros_prefaulted(n1)
        self.multi_diff = _zeros_prefaulted(n1)
        self.exact_diff = _zeros_prefaulted(n1)

    def finalize_diffs(self, ref_codes: np.ndarray) -> None:
        """Materialize F1/R2/F2/R1/multi from the diff endpoints and fold
        the exact-match coverage into the reference base's acgt plane.
        For a pure +1 stream, capping after the cumsum equals the
        reference's per-increment saturation."""
        if self.F1_diff is None:
            return
        for diff, name in ((self.F1_diff, "F1"), (self.R2_diff, "R2"),
                           (self.F2_diff, "F2"), (self.R1_diff, "R1")):
            np.cumsum(diff[:-1], out=getattr(self, name))
        np.cumsum(self.multi_diff[:-1], out=self.multi_hit)
        np.minimum(self.multi_hit, MAX_ALLELE_COUNT, out=self.multi_hit)
        exact = np.cumsum(self.exact_diff[:-1], dtype=np.int32)
        rc = ref_codes[:self.n]
        for c in range(4):
            plane = self.acgt[c]
            plane += np.where(rc == c, exact, 0)
            np.minimum(plane, MAX_ALLELE_COUNT, out=plane)

    # -- helpers ---------------------------------------------------------
    def region_cov_sum(self, beg: int, end: int) -> int:
        """sum of per-position coverage over [beg, end] inclusive."""
        return int(self.acgt[:, beg:end + 1].sum())

    def column_size(self, g_pos: int) -> int:
        """(ref: tools.cpp:166-169)"""
        return int(self.acgt[:, g_pos].sum())

    def _bump_base(self, g_pos: int, plane: int) -> None:
        if 0 <= g_pos < self.n and self.acgt[plane, g_pos] < MAX_ALLELE_COUNT:
            self.acgt[plane, g_pos] += 1

    def _bump_bp(self, g_pos: int) -> None:
        self.break_point[g_pos] = self.break_point.get(g_pos, 0) + 1

    def _bump_ind(self, table: Dict[int, Dict[str, int]], g_pos: int, seq: str) -> None:
        inner = table.setdefault(g_pos, {})
        inner[seq] = inner.get(seq, 0) + 1

    # -- UpdateProfile (ref: AlignmentProfile.cpp:41-242) ----------------
    def update_profile(self, genome: Genome, b_first_read: bool,
                       read: ReadState, cans: List[AlnCan],
                       max_duplicate: int, max_clip_size: int) -> None:
        self.host_dirty = True
        L = genome.genome_size
        two_l = genome.two_genome_size
        for can in cans:
            if can.score == 0:
                continue
            frags = can.frags
            first, last = frags[0], frags[-1]
            if first.rLen == 0 and first.gLen == 0:
                if first.rPos > MIN_BREAKPOINT_SIZE:
                    g = first.gPos
                    self._bump_bp(g if g < L else two_l - 1 - g)
                if first.rPos > max_clip_size:
                    continue
            if last.rLen == 0 and last.gLen == 0:
                if (read.rlen - last.rPos) > MIN_BREAKPOINT_SIZE:
                    g = last.gPos
                    self._bump_bp(g if g < L else two_l - 1 - g)
                if (read.rlen - last.rPos) > max_clip_size:
                    continue
            if can.orientation:
                g_start = first.gPos
            else:
                g_start = two_l - (first.gPos + first.gLen)
            if self.read_count[g_start] < max_duplicate:
                self.read_count[g_start] += 1
            else:
                continue

            span = np.arange(g_start, min(g_start + read.rlen, L))
            if b_first_read:
                tgt = self.F1 if can.orientation else self.R1
            else:
                tgt = self.R2 if can.orientation else self.F2
            tgt[span] += 1

            if can.orientation:
                for fp in frags:
                    r_pos, g_pos = fp.rPos, fp.gPos
                    if fp.bSimple:
                        for j in range(fp.rLen):
                            b = read.seq[r_pos + j]
                            if b in _BASE_PLANE:
                                self._bump_base(g_pos + j, _BASE_PLANE[b])
                    elif fp.gLen == 0:  # ins
                        self._bump_ind(self.insert_map, g_pos - 1, fp.aln1)
                    elif fp.rLen == 0:  # del
                        self._bump_ind(self.delete_map, g_pos - 1, fp.aln2)
                    else:
                        self._walk_aln(fp.aln1, fp.aln2, g_pos, comp=False)
            else:
                for fp in frags:
                    if fp.bSimple:
                        r_pos = fp.rPos
                        g_pos = two_l - 1 - fp.gPos
                        for j in range(fp.rLen):
                            b = read.seq[r_pos + j]
                            if b in _COMP_PLANE:
                                self._bump_base(g_pos - j, _COMP_PLANE[b])
                    elif fp.gLen == 0:  # ins
                        g_pos = two_l - fp.gPos
                        self._bump_ind(self.insert_map, g_pos - 1, fp.aln1)
                    elif fp.rLen == 0:  # del
                        g_pos = two_l - fp.gPos - fp.gLen
                        self._bump_ind(self.delete_map, g_pos - 1, fp.aln2)
                    else:
                        g_pos = two_l - (fp.gPos + fp.gLen)
                        self._walk_aln(fp.aln1, fp.aln2, g_pos, comp=False)

    def _walk_aln(self, aln1: str, aln2: str, g_pos: int, comp: bool) -> None:
        """Walk a '-'-padded alignment pair accumulating bases/indels.
        Reverse-strand blocks were already complemented by
        ProcessNormalPair, so bases are counted as-is
        (ref: AlignmentProfile.cpp:133-167, 202-238)."""
        j = 0
        n = len(aln1)
        while j < n:
            if aln2[j] == "-":  # ins
                e = j + 1
                while e < n and aln2[e] == "-":
                    e += 1
                self._bump_ind(self.insert_map, g_pos - 1, aln1[j:e])
                j = e
            elif aln1[j] == "-":  # del
                e = j + 1
                while e < n and aln1[e] == "-":
                    e += 1
                self._bump_ind(self.delete_map, g_pos - 1, aln2[j:e])
                g_pos += e - j
                j = e
            else:
                b = aln1[j]
                if b in _BASE_PLANE:
                    self._bump_base(g_pos, _BASE_PLANE[b])
                j += 1
                g_pos += 1

    # -- UpdateMultiHitCount (ref: AlignmentProfile.cpp:244-271) ---------
    def update_multi_hit(self, genome: Genome, cans: List[AlnCan]) -> None:
        self.host_dirty = True
        two_l = genome.two_genome_size
        for can in cans:
            if can.score > 0:
                if can.orientation:
                    g = can.frags[0].gPos
                    g_end = can.frags[-1].gPos + can.frags[-1].gLen
                else:
                    g = two_l - (can.frags[0].gPos + can.frags[0].gLen)
                    g_end = two_l - can.frags[-1].gPos
                g = max(g, 0)
                g_end = min(g_end, self.n)
                if g_end > g:
                    seg = self.multi_hit[g:g_end]
                    np.minimum(seg + 1, MAX_ALLELE_COUNT, out=seg)
