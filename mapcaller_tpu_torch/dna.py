"""DNA encoding utilities.

2-bit base codes follow the reference convention A=0 C=1 G=2 T=3,
everything else 4 (ambiguous) — ref: src/BWT_Index/bntseq.c:40
(nst_nt4_table).
"""
from __future__ import annotations

import numpy as np

# nst_nt4_table equivalent: byte -> code
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _b, _c in [(b"A", 0), (b"a", 0), (b"C", 1), (b"c", 1),
               (b"G", 2), (b"g", 2), (b"T", 3), (b"t", 3)]:
    NT4_TABLE[_b[0]] = _c

CODE2CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A=0 C=1 G=2 T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return NT4_TABLE[arr]


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string (4 -> 'N')."""
    return CODE2CHAR[np.minimum(codes, 4)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array; code 4 (N) maps to 4.

    Matches GetComplementaryBase (ref: src/tools.cpp:3-17) which maps
    non-ACGT to 'N'.
    """
    out = codes[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out


def revcomp_str(seq: str) -> str:
    return decode(revcomp_codes(encode(seq)))


class Lrand48:
    """POSIX lrand48 LCG, used by the reference to replace N bases with
    random ACGT deterministically (seed 11) — ref: src/BWT_Index/bntseq.c:145,174.
    """

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x >> 17  # 31-bit non-negative
