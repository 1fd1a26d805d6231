"""Needleman-Wunsch gapped aligner — host oracle.

Scoring contract of the reference's default aligner
(ref: src/nw_alignment.cpp:3-6): match +1 / mismatch -1,
OPEN_GAP -1, EXTEND_GAP -0.5, NEW_GAP -1.5, with the exact traceback
tie-breaking of nw_alignment.cpp:59-74 (prefer horizontal gap, then
vertical gap, then diagonal).

All scores are multiples of 0.5 and exactly representable, so we use
integer arithmetic scaled by 2 — bit-identical decisions to the
reference's float32 comparisons.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..dna import NT4_TABLE

MAX_PENALTY = -131072   # -65536 * 2
OPEN_GAP = -2           # -1   * 2
EXTEND_GAP = -1         # -0.5 * 2
NEW_GAP = -3            # -1.5 * 2


def nw_alignment(s1: str, s2: str) -> Tuple[str, str]:
    """Global affine-gap alignment; returns '-'-padded strings.

    Matches nw_alignment(m, s1, n, s2) (ref: nw_alignment.cpp:18-83)
    including its in-place '-'-insertion traceback semantics.
    """
    m = len(s1) + 1
    n = len(s2) + 1
    c1 = NT4_TABLE[np.frombuffer(s1.encode(), dtype=np.uint8)].astype(np.int32)
    c2 = NT4_TABLE[np.frombuffer(s2.encode(), dtype=np.uint8)].astype(np.int32)

    r = np.empty((m, n), dtype=np.int64)
    t = np.empty((m, n), dtype=np.int64)
    s = np.empty((m, n), dtype=np.int64)
    r[0, 0] = t[0, 0] = s[0, 0] = 0
    i_idx = np.arange(1, m, dtype=np.int64)
    j_idx = np.arange(1, n, dtype=np.int64)
    r[1:, 0] = MAX_PENALTY
    s[1:, 0] = t[1:, 0] = OPEN_GAP + i_idx * EXTEND_GAP
    t[0, 1:] = MAX_PENALTY
    s[0, 1:] = r[0, 1:] = OPEN_GAP + j_idx * EXTEND_GAP

    # anti-diagonal vectorized fill (same recurrence, same values)
    match = np.where(c1[:, None] == c2[None, :], 2, -2).astype(np.int64)
    for i in range(1, m):
        ri = r[i]
        ti = t[i]
        si = s[i]
        rim = r[i - 1]
        tim = t[i - 1]
        sim = s[i - 1]
        mi = match[i - 1]
        # row-wise: t and the diagonal/vertical parts vectorize; r needs a
        # left-to-right scan, done with a running loop in C-like order.
        ti[1:] = np.maximum(tim[1:] + EXTEND_GAP, sim[1:] + NEW_GAP)
        diag = sim[:-1] + mi
        prev_r = ri[0]
        prev_s = si[0]
        for j in range(1, n):
            rv = max(prev_r + EXTEND_GAP, prev_s + NEW_GAP)
            sv = max(diag[j - 1], rv, ti[j])
            ri[j] = rv
            si[j] = sv
            prev_r = rv
            prev_s = sv

    # traceback (ref: nw_alignment.cpp:59-74)
    a1 = list(s1)
    a2 = list(s2)
    i, j = m - 1, n - 1
    while i > 0 or j > 0:
        if s[i, j] == r[i, j]:
            a1.insert(i, "-")
            j -= 1
        elif s[i, j] == t[i, j]:
            a2.insert(j, "-")
            i -= 1
        else:
            i -= 1
            j -= 1
    return "".join(a1), "".join(a2)
