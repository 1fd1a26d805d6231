"""Seed chaining: cluster simple pairs by diagonal into alignment
candidates (ref: src/ReadMapping.cpp:160-242)."""
from __future__ import annotations

import dataclasses
from typing import List

from ..genome import Genome
from .seeding import FragPair

MAX_POS_DIFF_DEFAULT = 30  # -indel (ref: main.cpp:178)


@dataclasses.dataclass
class AlnCan:
    """Alignment candidate (ref: structure.h:125-133)."""
    score: int
    frags: List[FragPair]
    orientation: bool = True
    SamFlag: int = 0
    PairedAlnCanIdx: int = -1


def identify_closest_fragment_pairs(beg: int, end: int,
                                    pairs: List[FragPair]) -> AlnCan:
    """Tandem-repeat tie-break: keep the single best same-diagonal run
    (ref: ReadMapping.cpp:160-192)."""
    best_score = 0
    boundary = (beg, beg)
    i = beg
    s = pairs[beg].rLen
    j = beg + 1
    while j < end:
        if pairs[j].PosDiff != pairs[i].PosDiff:
            if s > best_score:
                best_score = s
                boundary = (i, j)
            i = j
            s = pairs[j].rLen
        else:
            s += pairs[j].rLen
        j += 1
    if s > best_score:
        best_score = s
        boundary = (i, j)
    return AlnCan(best_score, [p.copy() for p in pairs[boundary[0]:boundary[1]]])


def simple_pair_clustering(genome: Genome, rlen: int, pairs: List[FragPair],
                           max_pos_diff: int = MAX_POS_DIFF_DEFAULT) -> List[AlnCan]:
    """(ref: ReadMapping.cpp:194-226). `pairs` must be sorted by
    (PosDiff, rPos) and include the terminal sentinel."""
    cans: List[AlnCan] = []
    num = len(pairs)
    head = 0
    gpos_end = genome.alignment_boundary(pairs[0].gPos)
    score = pairs[0].rLen
    score_thr = rlen >> 2
    i, j = 0, 1
    while j < num:
        if pairs[j].gPos > gpos_end or abs(pairs[j].PosDiff - pairs[i].PosDiff) > max_pos_diff:
            if score > score_thr:
                if score_thr < (score >> 1):
                    score_thr = score >> 1
                if score >= rlen:  # tandem repeats
                    cans.append(identify_closest_fragment_pairs(head, j, pairs))
                else:
                    cans.append(AlnCan(score, [p.copy() for p in pairs[head:j]]))
            head = j
            gpos_end = genome.alignment_boundary(pairs[j].gPos)
            score = pairs[j].rLen
        else:
            score += pairs[j].rLen
        i += 1
        j += 1
    return cans


def remove_redundant_aln_can(cans: List[AlnCan]) -> None:
    """Zero out every candidate below the max score
    (ref: ReadMapping.cpp:228-242)."""
    if len(cans) > 1:
        max_score = 0
        for c in cans:
            if c.score > max_score:
                max_score = c.score
        for c in cans:
            if c.score < max_score:
                c.score = 0


def check_aln_number(cans: List[AlnCan]) -> int:
    return sum(1 for c in cans if c.score > 0)


def reset_paired_idx(cans: List[AlnCan]) -> None:
    for c in cans:
        c.PairedAlnCanIdx = -1
