"""Chain -> full read alignment (ref: src/ReadAlignment.cpp).

Turns each candidate's exact-seed chain into a complete alignment:
de-overlap seeds, insert "normal pairs" (gap blocks) between/around
them, run the gapped aligner on each, trim and quality-veto end blocks,
score, and select the best candidate.
"""
from __future__ import annotations

from typing import Callable, List

from ..dna import revcomp_str
from ..genome import Genome
from .read import ReadState
from .seeding import FragPair

MIN_ALN_BLOCK_SIZE = 5  # ref: ReadAlignment.cpp:2


def sort_frags_by_read_pos(frags: List[FragPair]) -> None:
    frags.sort(key=lambda f: (f.rPos, f.gPos))  # ref: ReadAlignment.cpp:23-27


def remove_overlaps(frags: List[FragPair]) -> bool:
    """(ref: ReadAlignment.cpp:38-65)"""
    overlap = False
    for i in range(len(frags) - 1):
        a, b = frags[i], frags[i + 1]
        if a.rPos == b.rPos:
            overlap = True
            a.rLen = a.gLen = 0
        elif a.gPos >= b.gPos or (a.gPos + a.gLen) > b.gPos:
            overlap = True
            overlap_size = a.gPos + a.gLen - b.gPos
            a.rLen -= overlap_size
            if a.rLen < 0:
                a.rLen = 0
            a.gLen -= overlap_size
            if a.gLen < 0:
                a.gLen = 0
    return overlap


def remove_null_frag_pairs(frags: List[FragPair]) -> List[FragPair]:
    return [f for f in frags if f.rLen != 0]  # ref: ReadAlignment.cpp:29-36


def identify_normal_pairs(rlen: int, frags: List[FragPair]) -> List[FragPair]:
    """Insert non-simple gap blocks between seeds and at both ends
    (ref: ReadAlignment.cpp:67-108)."""
    num = len(frags)
    inserted: List[FragPair] = []
    for i in range(num - 1):
        a, b = frags[i], frags[i + 1]
        r_gaps = b.rPos - (a.rPos + a.rLen)
        if r_gaps < 0:
            r_gaps = 0
        g_gaps = b.gPos - (a.gPos + a.gLen)
        if g_gaps < 0:
            g_gaps = 0
        if r_gaps > 0 or g_gaps > 0:
            fp = FragPair(False, a.rPos + a.rLen, a.gPos + a.gLen,
                          r_gaps, g_gaps, 0)
            fp.PosDiff = fp.gPos - fp.rPos
            inserted.append(fp)
    if inserted:
        frags.extend(inserted)
        frags.sort(key=lambda f: (f.rPos, f.gPos))
    if frags[0].rPos > 0:
        pd = frags[0].PosDiff
        head = FragPair(False, 0, pd, frags[0].rPos, frags[0].rPos, pd)
        frags.insert(0, head)
    last = frags[-1]
    if last.rPos + last.rLen < rlen:
        tail = FragPair(False, last.rPos + last.rLen, last.gPos + last.gLen,
                        rlen - (last.rPos + last.rLen),
                        rlen - (last.rPos + last.rLen), last.PosDiff)
        frags.append(tail)
    return frags


def cal_frag_pair_mismatches(n: int, a: str, b: str) -> int:
    return sum(1 for i in range(n) if a[i] != b[i])


def process_normal_pair(genome: Genome, ref_chars, seq: str, fp: FragPair,
                        aligner: Callable[[str, str], tuple]) -> None:
    """Fill aln1/aln2 and run the gapped aligner when needed
    (ref: ReadAlignment.cpp:155-191)."""
    if fp.rLen > 0:
        fp.aln1 = seq[fp.rPos:fp.rPos + fp.rLen]
    else:
        fp.aln1 = "-" * fp.gLen
    if fp.gLen > 0:
        fp.aln2 = bytes(ref_chars[fp.gPos:fp.gPos + fp.gLen]).decode()
    else:
        fp.aln2 = "-" * fp.rLen
    if fp.gPos >= genome.genome_size:  # reverse strand block
        if fp.rLen > 0:
            fp.aln1 = revcomp_str(fp.aln1)
        if fp.gLen > 0:
            fp.aln2 = revcomp_str(fp.aln2)
    if fp.rLen > 0 and fp.gLen > 0:
        run = fp.rLen != fp.gLen
        if not run:
            n = cal_frag_pair_mismatches(fp.rLen, fp.aln1, fp.aln2)
            run = n > 1 and n >= int(fp.rLen * 0.2)
        if run:
            fp.aln1, fp.aln2 = aligner(fp.aln1, fp.aln2)


def check_local_alignment_quality(fp: FragPair) -> bool:
    """(ref: ReadAlignment.cpp:193-232)"""
    aln_type = -1
    n = mis = status = 0
    for i in range(len(fp.aln1)):
        if fp.aln1[i] == "-":
            if aln_type != 0:
                aln_type = 0
                status += 1
        elif fp.aln2[i] == "-":
            if aln_type != 1:
                aln_type = 1
                status += 1
        else:
            n += 1
            if fp.aln1[i] != fp.aln2[i]:
                mis += 1
            if aln_type != 2:
                aln_type = 2
                status += 1
    if status >= 4 or (mis >= 3 and mis >= int(n * 0.3)):
        return False
    return True


def evaluate_alignment_score(frags: List[FragPair]) -> int:
    """Score = matched bases (ref: ReadAlignment.cpp:234-245)."""
    score = 0
    for f in frags:
        if f.bSimple:
            score += f.rLen
        elif len(f.aln1) > 0:
            score += sum(1 for i in range(len(f.aln1)) if f.aln1[i] == f.aln2[i])
    return score


def find_mismatch_number(frags: List[FragPair]) -> int:
    """(ref: ReadAlignment.cpp:247-262)"""
    mismatch = 0
    for f in frags:
        if not f.bSimple:
            for i in range(len(f.aln1)):
                if f.aln1[i] != f.aln2[i] and f.aln1[i] != "-" and f.aln2[i] != "-":
                    mismatch += 1
    return mismatch


def remove_heading_gaps(first: bool, fp: FragPair) -> None:
    """(ref: ReadAlignment.cpp:264-283)"""
    r_shrink = g_shrink = 0
    j = 0
    n = len(fp.aln1)
    while j < n:
        if fp.aln1[j] == "-":
            g_shrink += 1
        elif fp.aln2[j] == "-":
            r_shrink += 1
        else:
            break
        j += 1
    if j > 0:
        fp.aln1 = fp.aln1[j:]
        fp.aln2 = fp.aln2[j:]
        fp.rLen -= r_shrink
        fp.gLen -= g_shrink
        if first:
            fp.rPos += r_shrink
            fp.gPos += g_shrink


def remove_tailing_gaps(first: bool, fp: FragPair) -> None:
    """(ref: ReadAlignment.cpp:285-304)"""
    r_shrink = g_shrink = 0
    n = len(fp.aln1)
    j = n - 1
    while j >= 0:
        if fp.aln1[j] == "-":
            g_shrink += 1
        elif fp.aln2[j] == "-":
            r_shrink += 1
        else:
            break
        j -= 1
    j += 1
    if j < n:
        fp.aln1 = fp.aln1[:j]
        fp.aln2 = fp.aln2[:j]
        fp.rLen -= r_shrink
        fp.gLen -= g_shrink
        if first:
            fp.rPos += r_shrink
            fp.gPos += g_shrink


def produce_read_alignment(genome: Genome, ref_chars, read: ReadState,
                           aligner: Callable, max_mismatch_rate: float) -> bool:
    """(ref: ReadAlignment.cpp:306-430)"""
    max_mm_thr = int(read.rlen * max_mismatch_rate)
    for can_idx, can in enumerate(read.cans):
        if can.score == 0:
            continue
        sort_frags_by_read_pos(can.frags)
        if remove_overlaps(can.frags):
            can.frags = remove_null_frag_pairs(can.frags)
        can.frags = identify_normal_pairs(read.rlen, can.frags)
        first, last = can.frags[0], can.frags[-1]
        if not genome.check_alignment_validity(first.gPos, last.gPos + last.gLen):
            can.score = 0
            continue
        b_head = b_tail = True
        tail_idx = len(can.frags) - 1
        for i, fp in enumerate(can.frags):
            if fp.bSimple:
                continue
            process_normal_pair(genome, ref_chars, read.seq, fp, aligner)
            if i == 0:
                if fp.gPos < genome.genome_size:
                    remove_heading_gaps(True, fp)
                else:
                    remove_tailing_gaps(True, fp)
                if len(fp.aln1) >= MIN_ALN_BLOCK_SIZE and not check_local_alignment_quality(fp):
                    b_head = False
                    fp.rLen = fp.gLen = 0
                    fp.aln1 = fp.aln2 = ""
                    fp.rPos = can.frags[i + 1].rPos
                    fp.gPos = can.frags[i + 1].gPos
            elif i == tail_idx:
                if fp.gPos < genome.genome_size:
                    remove_tailing_gaps(False, fp)
                else:
                    remove_heading_gaps(False, fp)
                if len(fp.aln1) >= MIN_ALN_BLOCK_SIZE and not check_local_alignment_quality(fp):
                    b_tail = False
                    fp.rLen = fp.gLen = 0
                    fp.rPos = can.frags[i - 1].rPos + can.frags[i - 1].rLen
                    fp.gPos = can.frags[i - 1].gPos + can.frags[i - 1].gLen
                    fp.aln1 = fp.aln2 = ""
            else:
                if (fp.rLen >= MIN_ALN_BLOCK_SIZE and fp.gLen >= MIN_ALN_BLOCK_SIZE
                        and not check_local_alignment_quality(fp)):
                    can.score = 0
                    break
        if can.score == 0:
            continue
        if not b_head and not b_tail:
            can.score = 0
        else:
            can.score = evaluate_alignment_score(can.frags)
            if can.score == 0:
                continue
            if (can.score < int(read.rlen * (1 - max_mismatch_rate))
                    and find_mismatch_number(can.frags) > max_mm_thr):
                can.score = 0
            else:
                can.orientation = can.frags[0].gPos < genome.genome_size
                if not can.orientation:
                    can.frags.reverse()
                if can.score > read.score:
                    read.score = can.score
                    read.best_idx = can_idx
                elif can.score > read.sub_score:
                    read.sub_score = can.score
    for can in read.cans:
        if can.score < read.score:
            can.score = 0
    return read.score > 0
