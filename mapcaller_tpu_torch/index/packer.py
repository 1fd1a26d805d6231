"""FASTA -> packed reference.

Re-expresses the reference's bns_fasta2bntseq (ref: src/BWT_Index/bntseq.c:158-214):
concatenate all chromosomes into one code array, replacing ambiguous
bases with deterministic lrand48(seed=11) random bases, and record
chromosome names/offsets/lengths plus ambiguity holes.

Unlike the reference we keep a single flat uint8 code array (the
forward strand); the fwd+revcomp text for the BWT is derived on demand.
"""
from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator, List, Tuple

import numpy as np

from ..dna import NT4_TABLE, Lrand48


@dataclasses.dataclass
class Hole:
    offset: int   # concatenated forward-genome position
    length: int
    amb: str      # the ambiguous character seen


@dataclasses.dataclass
class PackedReference:
    names: List[str]
    lengths: List[int]
    offsets: List[int]           # concatenated forward start offsets
    codes: np.ndarray            # uint8[GenomeSize], values 0..3 (N randomized)
    holes: List[Hole]

    @property
    def genome_size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def two_genome_size(self) -> int:
        return 2 * self.genome_size

    @property
    def n_chromosomes(self) -> int:
        return len(self.names)

    def fwd_rc_codes(self) -> np.ndarray:
        """Text for the BWT: forward genome followed by its reverse
        complement (ref: bntseq.c:183-190). Cached — multiple consumers
        (SA build, occ3 build, mismatch words) would otherwise each
        materialize their own 2n-byte copy."""
        cached = getattr(self, "_fwd_rc", None)
        if cached is None or cached.shape[0] != 2 * self.genome_size:
            rc = (3 - self.codes[::-1]).astype(np.uint8)
            cached = np.concatenate([self.codes, rc])
            object.__setattr__(self, "_fwd_rc", cached)
        return cached

    def ref_sequence_codes(self) -> np.ndarray:
        """Codes of RefSequence[0..2L): fwd genome + revcomp
        (ref: src/bwt_index.cpp:196-215)."""
        return self.fwd_rc_codes()


def _open_maybe_gz(path: str):
    f = open(path, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    f.seek(0)
    return io.TextIOWrapper(f)


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) per record; name is the first
    whitespace-delimited token after '>'."""
    name = None
    chunks: List[str] = []
    with _open_maybe_gz(path) as fh:
        for line in fh:
            line = line.rstrip("\n\r")
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def pack_fasta(path: str, seed: int = 11) -> PackedReference:
    rng = Lrand48(seed)
    names: List[str] = []
    lengths: List[int] = []
    offsets: List[int] = []
    holes: List[Hole] = []
    parts: List[np.ndarray] = []
    total = 0
    for name, seq in iter_fasta(path):
        raw = np.frombuffer(seq.encode(), dtype=np.uint8)
        codes = NT4_TABLE[raw].copy()
        amb = codes >= 4
        if amb.any():
            idxs = np.nonzero(amb)[0]
            # hole bookkeeping: a run is contiguous iff same raw char repeats
            run_start = None
            last_char = -1
            for i in idxs:
                ch = int(raw[i])
                if run_start is not None and i == run_start[0] + run_start[1] and ch == last_char:
                    run_start = (run_start[0], run_start[1] + 1)
                    holes[-1].length += 1
                else:
                    holes.append(Hole(total + int(i), 1, chr(ch)))
                    run_start = (int(i), 1)
                last_char = ch
                codes[i] = rng.next() & 3
        names.append(name)
        lengths.append(int(codes.shape[0]))
        offsets.append(total)
        total += int(codes.shape[0])
        parts.append(codes)
    if not parts:
        raise ValueError(f"no sequences found in {path}")
    return PackedReference(names, lengths, offsets,
                           np.concatenate(parts).astype(np.uint8), holes)
