"""Per-read mutable state (ref: structure.h:142-150 ReadItem_t)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..dna import encode, revcomp_str
from .chaining import AlnCan


@dataclasses.dataclass
class ReadState:
    header: str
    seq: str
    qual: Optional[str]
    score: int = 0
    sub_score: int = 0
    best_idx: int = -1
    cans: List[AlnCan] = dataclasses.field(default_factory=list)
    pre_seeds: Optional[list] = None   # device-computed FragPair list
    is_reversed: bool = False          # mate-2 revcomp already applied

    @property
    def rlen(self) -> int:
        return len(self.seq)

    def codes(self) -> np.ndarray:
        return encode(self.seq)

    def reverse_orientation(self) -> None:
        """In-place revcomp of seq + reversal of qual
        (ref: src/tools.cpp:45-55); applied to mate 2 before seeding."""
        self.seq = revcomp_str(self.seq)
        if self.qual is not None:
            self.qual = self.qual[::-1]
