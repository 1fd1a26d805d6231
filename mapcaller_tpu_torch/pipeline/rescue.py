"""Pair rescue via 8-mer window scan
(ref: src/KmerAnalysis.cpp, src/AlignmentRescue.cpp)."""
from __future__ import annotations

from bisect import bisect_left
from typing import List, Tuple

from ..genome import Genome
from .chaining import AlnCan
from .read import ReadState
from .seeding import FragPair

KMER_SIZE = 8          # ref: structure.h:20
KMER_POWER = 0x3FFF    # ref: structure.h:21

_NT4 = {"A": 0, "a": 0, "C": 1, "c": 1, "G": 2, "g": 2, "T": 3, "t": 3}


def create_kmer_vec(seq: str) -> List[Tuple[int, int]]:
    """[(wid, pos)] sorted by wid (ref: KmerAnalysis.cpp:57-103).

    Note the reference treats only literal 'N' as a break (other
    non-ACGT characters map through nst_nt4_table with index 4 -> they
    never appear in practice)."""
    n = len(seq)
    vec: List[Tuple[int, int]] = []
    tail = 0
    count = 0
    while count < KMER_SIZE and tail < n:
        if seq[tail] != "N":
            count += 1
        else:
            count = 0
        tail += 1
    if count == KMER_SIZE:
        head = tail - KMER_SIZE
        wid = 0
        for i in range(head, tail):
            wid = (wid << 2) + _NT4.get(seq[i], 4)
        vec.append((wid, head))
        head += 1
        while tail < n:
            if seq[tail] != "N":
                wid = ((wid & KMER_POWER) << 2) + _NT4.get(seq[tail], 4)
                vec.append((wid, head))
                head += 1
                tail += 1
            else:
                count = 0
                tail += 1
                while count < KMER_SIZE and tail < n:
                    if seq[tail] != "N":
                        count += 1
                    else:
                        count = 0
                    tail += 1
                if count == KMER_SIZE:
                    head = tail - KMER_SIZE
                    wid = 0
                    for i in range(head, tail):
                        wid = (wid << 2) + _NT4.get(seq[i], 4)
                    vec.append((wid, head))
                    head += 1
                else:
                    break
        vec.sort()
    return vec


def identify_common_kmers(max_shift: int, vec1, vec2) -> List[Tuple[int, int, int]]:
    """[(PosDiff, rPos, gPos)] sorted by (PosDiff, rPos)
    (ref: KmerAnalysis.cpp:105-131)."""
    wids2 = [w for w, _ in vec2]
    out: List[Tuple[int, int, int]] = []
    for wid, pos in vec1:
        k = bisect_left(wids2, wid)
        while k < len(vec2) and vec2[k][0] == wid:
            gpos = vec2[k][1]
            if abs(gpos - pos) < max_shift:
                out.append((gpos - pos, pos, gpos))
            k += 1
    out.sort()
    return out


def gen_simple_pairs_from_common_kmers(thr: int, g_pos: int,
                                       kmer_pairs) -> List[FragPair]:
    """Collapse runs of consecutive common k-mers into seeds
    (ref: KmerAnalysis.cpp:133-163)."""
    out: List[FragPair] = []
    num = len(kmer_pairs)
    i = 0
    while i < num:
        pd, rpos, gpos = kmer_pairs[i]
        n_pos = rpos + 1
        j = i + 1
        while j < num and kmer_pairs[j][1] == n_pos and kmer_pairs[j][0] == pd:
            n_pos += 1
            j += 1
        l = KMER_SIZE + (j - 1 - i)
        if l >= thr:
            out.append(FragPair(True, rpos, gpos + g_pos, l, l, pd + g_pos))
        i = j
    return out


def identify_best_aln_can(pairs: List[FragPair]) -> AlnCan:
    """Best single-diagonal run (ref: AlignmentRescue.cpp:3-26)."""
    best = AlnCan(0, [])
    num = len(pairs)
    i = 0
    while i < num:
        score = pairs[i].rLen
        j = i + 1
        while j < num and pairs[j].PosDiff == pairs[i].PosDiff:
            score += pairs[j].rLen
            j += 1
        if j - i >= 1 and score > best.score:
            best = AlnCan(score, [p.copy() for p in pairs[i:j]])
        i = j
    return best


def alignment_rescue(genome: Genome, ref_chars, est_dist: int,
                     read1: ReadState, read2: ReadState) -> int:
    """(ref: AlignmentRescue.cpp:28-111)"""
    score1 = max((c.score for c in read1.cans), default=0)
    score2 = max((c.score for c in read2.cans), default=0)
    if score1 < (read1.rlen >> 2) and score2 < (read2.rlen >> 2):
        return 0
    if score1 - score2 > (read2.rlen >> 2):
        strategy = 1
    elif score2 - score1 > (read1.rlen >> 2):
        strategy = 2
    else:
        strategy = 3

    n_paired = 0
    num1, num2 = len(read1.cans), len(read2.cans)

    def try_fix(anchor: ReadState, other: ReadState, other_score: int,
                anchor_thr: int, n_other: int, left_of: bool) -> int:
        nonlocal n_paired
        kmer1 = create_kmer_vec(other.seq)
        added = 0
        for idx, can in enumerate(anchor.cans[:len(anchor.cans)]):
            if can.score < anchor_thr or can.PairedAlnCanIdx != -1:
                continue
            if left_of:
                left_end = can.frags[0].PosDiff
                right_end = can.frags[0].PosDiff + est_dist + other.rlen
            else:
                left_end = can.frags[0].PosDiff - est_dist
                right_end = can.frags[0].PosDiff + other.rlen
            if right_end > genome.two_genome_size:
                right_end = genome.two_genome_size
            i1 = genome.boundary_index(left_end)
            i2 = genome.boundary_index(right_end)
            nk = len(genome.boundary_keys)
            c1 = genome.boundary_chrom[i1] if i1 < nk else -1
            c2 = genome.boundary_chrom[i2] if i2 < nk else -2
            if c1 != c2:
                continue
            slen = right_end - left_end
            if slen < other.rlen:
                continue
            seg = bytes(ref_chars[left_end:left_end + slen]).decode()
            kmer2 = create_kmer_vec(seg)
            kp = identify_common_kmers(slen, kmer1, kmer2)
            sp = gen_simple_pairs_from_common_kmers(10, left_end, kp)
            if not sp:
                continue
            best = identify_best_aln_can(sp)
            if best.score > other_score:
                n_paired += 1
                can.PairedAlnCanIdx = n_other + added
                best.PairedAlnCanIdx = idx
                other.cans.append(best)
                added += 1
        return added

    if strategy in (1, 3):
        try_fix(read1, read2, score2, score1 >> 1, num2, True)
    if strategy in (2, 3):
        try_fix(read2, read1, score1, score2 >> 1, num1, False)
    return n_paired
