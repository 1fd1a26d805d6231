"""ksw2 gapped aligner — host oracle.

Element-wise NumPy transliteration of the reference's ksw_extz2_sse
anti-diagonal difference DP (ref: src/ksw2_alignment.cpp:70-248,
copyright Heng Li, re-derived here from its observable semantics):

* scores: match +1 / mismatch -1 (the SSE kernel reads only mat[0] and
  mat[1] of the 5x5 matrix, ksw2_alignment.cpp:114-115), gap open 2,
  gap extend 1, full band (w = max(qlen, tlen)), wildcard base code 4
  scores 0.
* all state arrays are int8 with wraparound, exactly as the 16-lane SSE
  kernel computes them; only the direction-flag matrix `p` and the
  per-diagonal [st, en] windows feed the backtrack, so the H-row max
  bookkeeping of the original is omitted (its results are unused by
  ksw2_alignment, ksw2_alignment.cpp:250-272).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..dna import NT4_TABLE

_Q = 2          # gap open (ref: ksw2_alignment.cpp:260)
_E = 1          # gap extend
_QE = _Q + _E
_QE2 = 2 * _QE
_MCH = 1        # mat[0]
_MIS = -1       # mat[1]
_MAX_SC = _MCH + _QE2
_WILD = 4       # m - 1


def _extz2(query: np.ndarray, target: np.ndarray):
    """-> (p_flags, off, off_end). query/target are uint8 code arrays."""
    qlen, tlen = int(query.size), int(target.size)
    w = max(qlen, tlen)
    wl = wr = w
    tlen_ = (tlen + 15) // 16
    # C: ((w+1 < tlen ? ... : tlen) + 15)/16 + 1 __m128i units; with the
    # full band w = max(qlen, tlen) this always resolves to tlen.
    n_col = ((tlen + 15) // 16 + 1) * 16
    nt16 = tlen_ * 16

    u = np.zeros(nt16, dtype=np.int8)
    v = np.zeros(nt16, dtype=np.int8)
    x = np.zeros(nt16, dtype=np.int8)
    y = np.zeros(nt16, dtype=np.int8)
    s8 = np.zeros(nt16 + 16, dtype=np.int8)
    sf = np.zeros(nt16 + 16, dtype=np.uint8)
    sf[:tlen] = target
    qr = np.zeros(qlen + 16, dtype=np.uint8)
    qr[:qlen] = query[::-1]

    n_diag = qlen + tlen - 1
    p = np.zeros((n_diag, n_col), dtype=np.uint8)
    off = np.zeros(n_diag, dtype=np.int64)
    off_end = np.zeros(n_diag, dtype=np.int64)

    last_st = last_en = -1
    for r in range(n_diag):
        st, en = 0, tlen - 1
        if st < r - qlen + 1:
            st = r - qlen + 1
        if en > r:
            en = r
        if st < (r - wr + 1) >> 1:
            st = (r - wr + 1) >> 1
        if en > (r + wl) >> 1:
            en = (r + wl) >> 1
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        # boundary conditions (ref: ksw2_alignment.cpp:159-165)
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1 = int(x[st - 1])
                v1 = int(v[st - 1])
            else:
                x1 = v1 = 0
        else:
            x1 = 0
            v1 = _Q if r else 0
        if en >= r:
            y[r] = 0
            u[r] = _Q if r else 0
        # score fission: 16-wide unaligned stores from st0 (cpp:167-176)
        t0 = st0
        while t0 <= en0:
            sq = sf[t0:t0 + 16]
            stq = qr[qlen - 1 - r + t0: qlen - 1 - r + t0 + 16]
            mask = (sq == _WILD) | (stq == _WILD)
            val = np.where(sq == stq, _MCH, _MIS).astype(np.int8)
            val[mask] = 0
            s8[t0:t0 + 16] = val
            t0 += 16
        # core loop, element-wise over [st, en] (cpp:184-199)
        idx = np.arange(st, en + 1)
        z = (s8[st:en + 1].astype(np.int8) + np.int8(_QE2)).astype(np.int8)
        xt1 = np.empty(en - st + 1, dtype=np.int8)
        vt1 = np.empty(en - st + 1, dtype=np.int8)
        xt1[0] = x1
        vt1[0] = v1
        if en > st:
            xt1[1:] = x[st:en]
            vt1[1:] = v[st:en]
        a = (xt1 + vt1).astype(np.int8)
        ut = u[st:en + 1].copy()
        b = (y[st:en + 1] + ut).astype(np.int8)
        d = (a > z).astype(np.uint8)           # flag 1
        z = np.maximum(z, a)                    # signed max
        d = np.where(b > z, np.uint8(2), d)     # flag 2
        zu = np.maximum(z.view(np.uint8), b.view(np.uint8))  # unsigned max
        zu = np.minimum(zu, np.uint8(_MAX_SC))  # unsigned min
        z = zu.view(np.int8)
        u[st:en + 1] = (z - vt1).astype(np.int8)
        v[st:en + 1] = (z - ut).astype(np.int8)
        z = (z - np.int8(_Q)).astype(np.int8)
        a = (a - z).astype(np.int8)
        b = (b - z).astype(np.int8)
        apos = a > 0
        bpos = b > 0
        x[st:en + 1] = np.where(apos, a, np.int8(0))
        y[st:en + 1] = np.where(bpos, b, np.int8(0))
        d |= np.where(apos, np.uint8(0x08), np.uint8(0))
        d |= np.where(bpos, np.uint8(0x10), np.uint8(0))
        off[r] = st
        off_end[r] = en
        p[r, 0:en - st + 1] = d
        last_st, last_en = st, en
    return p, off, off_end


def _backtrack(p, off, off_end, i0: int, j0: int) -> str:
    """(ref: ksw2_alignment.cpp:25-68)"""
    i, j = i0, j0
    state = 0
    cigar = []
    while i >= 0 and j >= 0:
        force_state = -1
        r = i + j
        if i < off[r]:
            force_state = 2
        if i > off_end[r]:
            force_state = 1
        tmp = int(p[r, i - off[r]]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            cigar.append("M")
            i -= 1
            j -= 1
        elif state in (1, 3):
            cigar.append("D")
            i -= 1
        else:
            cigar.append("I")
            j -= 1
    if i >= 0:
        cigar.append("D" * (i + 1))
    if j >= 0:
        cigar.append("I" * (j + 1))
    return "".join(cigar)


def ksw2_alignment(s1: str, s2: str) -> Tuple[str, str]:
    """Wrapper matching ksw2_alignment(m, s1, n, s2)
    (ref: ksw2_alignment.cpp:250-272): s1 = query/read block,
    s2 = target/reference block; returns '-'-padded strings."""
    if len(s1) == 0 or len(s2) == 0:
        return s1, s2
    q = NT4_TABLE[np.frombuffer(s1.encode(), dtype=np.uint8)]
    t = NT4_TABLE[np.frombuffer(s2.encode(), dtype=np.uint8)]
    p, off, off_end = _extz2(q, t)
    cigar = _backtrack(p, off, off_end, len(s2) - 1, len(s1) - 1)
    a1 = list(s1)
    a2 = list(s2)
    pos = 0
    for ch in reversed(cigar):
        if ch == "D":
            a1.insert(pos, "-")
        elif ch == "I":
            a2.insert(pos, "-")
        pos += 1
    return "".join(a1), "".join(a2)
