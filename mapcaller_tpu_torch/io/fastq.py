"""FASTA/FASTQ (+.gz) chunked reader.

Mirrors GetData.cpp behavior (ref: src/GetData.cpp:22-145): format
sniffing by first byte ('@' => FASTQ), header trimmed at first
space / '/' / non-printable, chunks of READ_CHUNK_SIZE reads,
paired input either as two separate files or interleaved.
"""
from __future__ import annotations

import dataclasses
import gzip
from typing import Iterator, List, Optional

READ_CHUNK_SIZE = 200  # ref: structure.h:24


@dataclasses.dataclass
class Read:
    header: str
    seq: str
    qual: Optional[str]

    @property
    def rlen(self) -> int:
        return len(self.seq)


def check_read_format(path: str) -> bool:
    """True => FASTQ (ref: GetData.cpp:22-30)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        b = f.read(1)
    return b == b"@"


def _trim_header(line: str) -> str:
    """Strip leading '@'/'>' run and cut at space, '/', or non-printable
    (ref: GetData.cpp:3-20)."""
    i = 0
    n = len(line)
    while i < n and line[i] in "@>":
        i += 1
    j = i
    limit = min(n, 100)
    while j < limit:
        c = line[j]
        if c == " " or c == "/" or not c.isprintable():
            break
        j += 1
    return line[i:j]


def iter_reads(path: str, fastq: Optional[bool] = None) -> Iterator[Read]:
    if fastq is None:
        fastq = check_read_format(path)
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as fh:
        if fastq:
            while True:
                h = fh.readline()
                if not h:
                    break
                s = fh.readline().rstrip("\n\r")
                fh.readline()
                q = fh.readline().rstrip("\n\r")
                if not s:
                    break
                yield Read(_trim_header(h.rstrip("\n\r")), s, q)
        else:
            name = None
            chunks: List[str] = []
            for line in fh:
                line = line.rstrip("\n\r")
                if line.startswith(">"):
                    if name is not None and chunks:
                        yield Read(name, "".join(chunks), None)
                    name = _trim_header(line)
                    chunks = []
                elif line:
                    chunks.append(line)
            if name is not None and chunks:
                yield Read(name, "".join(chunks), None)


def iter_chunks(path1: str, path2: Optional[str] = None,
                chunk_size: int = READ_CHUNK_SIZE) -> Iterator[List[Read]]:
    """Yield chunks of reads; with path2 the chunk interleaves mates
    (r1, r2, r1, r2, ...) like the reference's GetNextChunk."""
    if path2 is None:
        it = iter_reads(path1)
        buf: List[Read] = []
        for r in it:
            buf.append(r)
            if len(buf) == chunk_size:
                yield buf
                buf = []
        if buf:
            yield buf
    else:
        it1, it2 = iter_reads(path1), iter_reads(path2)
        buf = []
        for r1 in it1:
            r2 = next(it2, None)
            if r2 is None:
                break
            buf.extend((r1, r2))
            if len(buf) >= chunk_size:
                yield buf
                buf = []
        if buf:
            yield buf


def write_fastq(path: str, reads: List[Read]) -> None:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as f:
        for r in reads:
            f.write(f"@{r.header}\n{r.seq}\n+\n{r.qual or 'I' * len(r.seq)}\n")
