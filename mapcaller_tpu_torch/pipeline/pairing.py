"""Mate pairing: concordance scoring and discordant-pair evidence
(ref: src/ReadMapping.cpp:244-394)."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .chaining import AlnCan, remove_redundant_aln_can

MIN_INVERSION_SIZE = 1000       # ref: ReadMapping.cpp:7
MAX_PAIRED_DISTANCE = 2000      # ref: ReadMapping.cpp:8
MAX_INVERSION_SIZE = 10000000   # ref: ReadMapping.cpp:9
MIN_TRANSLOCATION_SIZE = 1000   # ref: ReadMapping.cpp:10


def check_paired_alignment_distance(esti_distance: int, cans1: List[AlnCan],
                                    cans2: List[AlnCan]) -> int:
    """Pick the best concordant candidate combination by PosDiff distance
    (ref: ReadMapping.cpp:244-303)."""
    num1, num2 = len(cans1), len(cans2)
    if num1 * num2 > 100:
        remove_redundant_aln_can(cans1)
        remove_redundant_aln_can(cans2)
    paired: List[Tuple[int, int, int]] = []
    max_score = 0
    for i in range(num1):
        if cans1[i].score == 0:
            continue
        idx2 = -1
        p_score = 0
        for j in range(num2):
            if cans2[j].score == 0 or cans2[j].frags[0].PosDiff < cans1[i].frags[0].PosDiff:
                continue
            my_dist = cans2[j].frags[0].PosDiff - cans1[i].frags[0].PosDiff
            if my_dist < esti_distance and cans2[j].score > p_score:
                idx2 = j
                p_score = cans2[j].score
        if idx2 != -1:
            p_score = cans1[i].score + cans2[idx2].score
            if p_score >= max_score:
                max_score = p_score
                paired.append((i, idx2, p_score))
    n = 0
    if max_score > 0:
        for i, j, s in paired:
            if s == max_score:
                n += 1
                cans1[i].PairedAlnCanIdx = j
                cans2[j].PairedAlnCanIdx = i
    return n


def mask_unpaired_aln_can(cans1: List[AlnCan], cans2: List[AlnCan]) -> None:
    """(ref: ReadMapping.cpp:305-322)"""
    max_score = 0
    for c in cans1:
        if c.PairedAlnCanIdx != -1:
            s = c.score + cans2[c.PairedAlnCanIdx].score
            if s > max_score:
                max_score = s
    for c in cans1:
        if c.PairedAlnCanIdx == -1 or (c.score + cans2[c.PairedAlnCanIdx].score) < max_score:
            c.score = 0
    for c in cans2:
        if c.PairedAlnCanIdx == -1 or (c.score + cans1[c.PairedAlnCanIdx].score) < max_score:
            c.score = 0


@dataclasses.dataclass
class CoordinatePair:
    dist: int = 0
    gPos1: int = 0
    gPos2: int = 0


def get_paired_aln_can_dist(cans1: List[AlnCan], cans2: List[AlnCan]) -> CoordinatePair:
    """(ref: ReadMapping.cpp:343-359)"""
    cp = CoordinatePair()
    for c in cans1:
        if c.score > 0 and c.PairedAlnCanIdx != -1 and cans2[c.PairedAlnCanIdx].score > 0:
            cp.gPos1 = c.frags[0].gPos
            cp.gPos2 = cans2[c.PairedAlnCanIdx].frags[0].gPos
            cp.dist = abs(cp.gPos2 - cp.gPos1)
            break
    return cp


def gen_coordinate_pair(cans1: List[AlnCan], cans2: List[AlnCan]) -> CoordinatePair:
    """(ref: ReadMapping.cpp:361-394)"""
    cp = get_paired_aln_can_dist(cans1, cans2)
    if cp.dist != 0:
        return cp
    g1 = [c.frags[0].gPos for c in cans1 if c.score > 0]
    g2 = [c.frags[0].gPos for c in cans2 if c.score > 0]
    if len(g1) == 1 and len(g2) == 1:  # discordant
        cp.gPos1, cp.gPos2 = g1[0], g2[0]
        cp.dist = abs(cp.gPos2 - cp.gPos1)
    elif len(g1) == 0 and len(g2) >= 1:  # one-end anchored
        cp.gPos1 = -1
        cp.dist = cp.gPos2 = g2[0]
    elif len(g1) >= 1 and len(g2) == 0:
        cp.dist = cp.gPos1 = g1[0]
        cp.gPos2 = -1
    else:
        cp.dist = 0
    return cp
