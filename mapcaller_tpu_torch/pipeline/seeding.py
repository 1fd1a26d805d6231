"""Seeding: greedy maximal-exact-match search over the FM-index.

Host-side oracle mirroring BWT_Search / IdentifySimplePairs exactly
(ref: src/bwt_search.cpp:121-164, src/ReadMapping.cpp:125-158).
The device (batched JAX) implementation in ops/fm_search.py is tested
against this oracle.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..index.fmindex import FMIndex

OCC_THR = 50          # ref: bwt_search.cpp:3
MIN_SEED_LEN = 16     # ref: structure.h:23


@dataclasses.dataclass
class FragPair:
    """A read-block <-> genome-block pair (ref: structure.h:113-123)."""
    bSimple: bool
    rPos: int
    gPos: int
    rLen: int
    gLen: int
    PosDiff: int
    aln1: str = ""
    aln2: str = ""

    def copy(self) -> "FragPair":
        return FragPair(self.bSimple, self.rPos, self.gPos, self.rLen,
                        self.gLen, self.PosDiff, self.aln1, self.aln2)


def bwt_search(idx: FMIndex, seq: np.ndarray, start: int, stop: int):
    """-> (match_len, locations or None).

    Extends from `start` while the bidirectional interval stays non-empty;
    keeps the seed iff len >= MIN_SEED_LEN and freq <= OCC_THR
    (ref: bwt_search.cpp:121-164).
    """
    p = int(seq[start])
    x0 = int(idx.L2[p]) + 1
    x1 = int(idx.L2[3 - p]) + 1
    x2 = int(idx.L2[p + 1] - idx.L2[p])

    pos = start + 1
    while pos < stop:
        c = int(seq[pos])
        if c > 3:
            break
        tk = idx.occ4(x1 - 1)
        tl = idx.occ4(x1 - 1 + x2)
        ok_x1 = [int(idx.L2[i]) + 1 + int(tk[i]) for i in range(4)]
        ok_x2 = [int(tl[i] - tk[i]) for i in range(4)]
        ok_x0 = [0, 0, 0, 0]
        ok_x0[3] = x0 + (1 if (x1 <= idx.primary and x1 + x2 - 1 >= idx.primary) else 0)
        ok_x0[2] = ok_x0[3] + ok_x2[3]
        ok_x0[1] = ok_x0[2] + ok_x2[2]
        ok_x0[0] = ok_x0[1] + ok_x2[1]
        i = 3 - c
        if ok_x2[i] == 0:
            break
        x0, x1, x2 = ok_x0[i], ok_x1[i], ok_x2[i]
        pos += 1

    length = pos - start
    if length < MIN_SEED_LEN:
        return length, None
    if x2 > OCC_THR:
        return length, None
    locs = [idx.sa_lookup(x0 + i) for i in range(x2)]
    return length, locs


def identify_simple_pairs(idx: FMIndex, seq: np.ndarray) -> List[FragPair]:
    """Greedy seeding over the read; returns seeds sorted by
    (PosDiff, rPos) with the terminal sentinel appended
    (ref: ReadMapping.cpp:125-158)."""
    rlen = int(seq.shape[0])
    pairs: List[FragPair] = []
    pos = 0
    stop_pos = rlen - MIN_SEED_LEN
    while pos < stop_pos:
        if int(seq[pos]) > 3:
            pos += 1
            continue
        length, locs = bwt_search(idx, seq, pos, rlen)
        if locs is not None:
            for loc in locs:
                pd = loc - pos
                if pd > 0:
                    pairs.append(FragPair(True, pos, loc, length, length, pd))
        pos += length + 1
    pairs.sort(key=lambda f: (f.PosDiff, f.rPos))
    two_l = idx.seq_len
    pairs.append(FragPair(True, 0, two_l, 0, 0, two_l))  # sentinel
    return pairs
