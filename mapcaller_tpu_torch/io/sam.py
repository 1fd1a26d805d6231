"""SAM record generation (ref: src/SamReport.cpp).

Flag computation, MAPQ model, CIGAR from FragPair chains, mate
coordinates / TLEN, NM/AS/XS tags.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from ..dna import revcomp_str
from ..genome import Genome
from ..pipeline.chaining import AlnCan
from ..pipeline.read import ReadState
from ..pipeline.seeding import FragPair

MAPQ_COEF = 30   # ref: SamReport.cpp:4
MAX_MAPQ = 60    # ref: SamReport.cpp:5


def sam_headers(genome: Genome, version: str) -> List[str]:
    """(ref: ReadMapping.cpp:101-123)"""
    out = [f"@PG\tID:MapCaller\tPN:MapCaller\tVN:{version}"]
    for i, name in enumerate(genome.names):
        out.append(f"@SQ\tSN:{name}\tLN:{int(genome.lengths[i])}")
    return out


def evaluate_mapq(read: ReadState) -> int:
    """(ref: SamReport.cpp:86-101); note the reference computes the score
    ratio in float32 then promotes to double for the log term."""
    if read.score == 0 or read.score == read.sub_score:
        return 0
    if read.sub_score == 0 or read.score - read.sub_score > 5:
        return MAX_MAPQ
    ratio = np.float32(read.score - read.sub_score) / np.float32(read.score)
    inner = np.float32(MAPQ_COEF) * (np.float32(1) - ratio)
    mapq = int(float(inner) * math.log(read.score) + 0.4999)
    return min(mapq, MAX_MAPQ)


def set_single_flags(read: ReadState, unique_only: bool) -> None:
    """(ref: SamReport.cpp:7-24)"""
    if read.score > read.sub_score or not unique_only:
        c = read.cans[read.best_idx]
        c.SamFlag = 0 if c.orientation else 0x10
    elif read.score > 0:
        for c in read.cans:
            if c.score > 0:
                c.SamFlag = 0 if c.orientation else 0x10
    else:
        read.cans[0].SamFlag = 0x4


def set_paired_flags(read1: ReadState, read2: ReadState) -> None:
    """(ref: SamReport.cpp:26-84)"""
    def one_side(rd: ReadState, other: ReadState, base_flag: int, fwd_is_0x20: bool):
        if rd.score > rd.sub_score:
            c = rd.cans[rd.best_idx]
            c.SamFlag = base_flag
            c.SamFlag |= (0x20 if c.orientation else 0x10) if fwd_is_0x20 else \
                         (0x10 if c.orientation else 0x20)
            j = c.PairedAlnCanIdx
            if j != -1 and other.cans[j].score > 0:
                c.SamFlag |= 0x2
            else:
                c.SamFlag |= (0x10 if c.orientation else 0x20) if fwd_is_0x20 else \
                             (0x20 if c.orientation else 0x10)
                c.SamFlag |= 0x8
        elif rd.score > 0:
            for c in rd.cans:
                if c.score > 0:
                    c.SamFlag = base_flag
                    c.SamFlag |= (0x20 if c.orientation else 0x10) if fwd_is_0x20 else \
                                 (0x10 if c.orientation else 0x20)
                    j = c.PairedAlnCanIdx
                    if j != -1 and other.cans[j].score > 0:
                        c.SamFlag |= 0x2
                    else:
                        c.SamFlag |= 0x8

    one_side(read1, read2, 0x41, True)
    one_side(read2, read1, 0x81, False)


def get_aln_coordinate(genome: Genome, orientation: bool,
                       frags: List[FragPair]):
    """(ref: SamReport.cpp:121-149) -> (chrom_idx, 1-based pos)"""
    for f in frags:
        if f.gLen > 0:
            if orientation:
                return genome.determine_coordinate(f.gPos)
            return genome.determine_coordinate(f.gPos + f.gLen - 1)
    return (0, 0)


def generate_cigar(rlen: int, orientation: bool, frags: List[FragPair]) -> str:
    """(ref: SamReport.cpp:172-316)"""
    parts: List[str] = []
    state = " "
    c = 0

    def flush():
        nonlocal c
        if c > 0:
            parts.append(f"{c}{state}")
        c = 0

    if not frags[0].bSimple:
        if orientation:
            if frags[0].rPos != 0:
                parts.append(f"{frags[0].rPos}S")
        else:
            s = rlen - (frags[0].rPos + frags[0].rLen)
            if s > 0:
                parts.append(f"{s}S")
    for f in frags:
        if f.bSimple:
            if state != "M":
                flush()
                state = "M"
            c += f.rLen
        elif len(f.aln1) > 0:
            for j in range(len(f.aln1)):
                if f.aln1[j] == "-":
                    st = "D"
                elif f.aln2[j] == "-":
                    st = "I"
                else:
                    st = "M"
                if state != st:
                    flush()
                    state = st
                c += 1
        elif f.rLen > 0:
            if state != "I":
                flush()
                state = "I"
            c += f.rLen
        elif f.gLen > 0:
            if state != "D":
                flush()
                state = "D"
            c += f.gLen
    flush()
    last = frags[-1]
    if len(frags) > 1 and not last.bSimple:
        if orientation:
            s = rlen - (last.rPos + last.rLen)
            if s > 0:
                parts.append(f"{s}S")
        else:
            if last.rPos != 0:
                parts.append(f"{last.rPos}S")
    return "".join(parts)


def single_sam_records(genome: Genome, read: ReadState, unique_only: bool,
                       fastq: bool) -> List[str]:
    """(ref: SamReport.cpp:324-375)"""
    out: List[str] = []
    q = read.qual if fastq else "*"
    if read.score == 0:
        out.append(f"{read.header}\t4\t*\t0\t0\t*\t*\t0\t0\t{read.seq}\t{q}\tAS:i:0\tXS:i:0")
        return out
    set_single_flags(read, unique_only)
    mapq = evaluate_mapq(read)
    rseq = rqual = None
    for i in range(read.best_idx, len(read.cans)):
        c = read.cans[i]
        if c.score == read.score:
            if not c.orientation and rseq is None:
                rseq = revcomp_str(read.seq)
                if fastq:
                    rqual = read.qual[::-1]
            cig = generate_cigar(read.rlen, c.orientation, c.frags)
            ci, pos = get_aln_coordinate(genome, c.orientation, c.frags)
            seq = read.seq if c.orientation else rseq
            qq = (read.qual if c.orientation else rqual) if fastq else "*"
            out.append(f"{read.header}\t{c.SamFlag}\t{genome.names[ci]}\t{pos}\t{mapq}\t"
                       f"{cig}\t*\t0\t0\t{seq}\t{qq}\tNM:i:{read.rlen - c.score}\t"
                       f"AS:i:{read.score}\tXS:i:{read.sub_score}")
            if unique_only:
                break
    return out


def paired_sam_records(genome: Genome, read1: ReadState, read2: ReadState,
                       unique_only: bool, fastq: bool) -> List[str]:
    """(ref: SamReport.cpp:377-488)"""
    out: List[str] = []
    set_paired_flags(read1, read2)

    def unmapped_record(rd: ReadState, other: ReadState, frag_bit: int):
        flag = 0x1 | 0x4 | frag_bit
        if other.score == 0:
            flag |= 0x8
        elif other.cans:
            oc = other.cans[other.best_idx]
            flag |= 0x10 | 0x20  # reference sets both bits (SamReport.cpp:398-399)
        q = rd.qual if fastq else "*"
        out.append(f"{rd.header}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t{rd.seq}\t{q}\tAS:i:0\tXS:i:0")

    def mapped_records(rd: ReadState, other: ReadState, is_first: bool):
        mapq = evaluate_mapq(rd)
        rseq = rqual = None
        start = rd.best_idx
        for i in range(start, len(rd.cans)):
            c = rd.cans[i]
            if c.score != rd.score:
                continue
            if not c.orientation and rseq is None:
                rseq = revcomp_str(rd.seq)
                if fastq:
                    rqual = rd.qual[::-1]
            cig = generate_cigar(rd.rlen, c.orientation, c.frags)
            ci, pos = get_aln_coordinate(genome, c.orientation, c.frags)
            j = c.PairedAlnCanIdx
            seq = rd.seq if c.orientation else rseq
            qq = (rd.qual if c.orientation else rqual) if fastq else "*"
            if j != -1 and other.score > 0 and other.cans[j].score == other.score:
                oc = other.cans[j]
                oci, opos = get_aln_coordinate(genome, oc.orientation, oc.frags)
                if is_first:
                    dist = opos - pos + (read2.rlen if c.orientation else -read1.rlen)
                else:
                    c1 = other.cans[j]
                    dist = -(pos - opos + (read2.rlen if c1.orientation else -read1.rlen))
                out.append(f"{rd.header}\t{c.SamFlag}\t{genome.names[ci]}\t{pos}\t{mapq}\t"
                           f"{cig}\t=\t{opos}\t{dist}\t{seq}\t{qq}\tNM:i:{rd.rlen - c.score}\t"
                           f"AS:i:{rd.score}\tXS:i:{rd.sub_score}")
            else:
                out.append(f"{rd.header}\t{c.SamFlag}\t{genome.names[ci]}\t{pos}\t{mapq}\t"
                           f"{cig}\t*\t0\t0\t{seq}\t{qq}\tNM:i:{rd.rlen - c.score}\t"
                           f"AS:i:{rd.score}\tXS:i:{rd.sub_score}")
            if unique_only:
                break

    if read1.score == 0:
        unmapped_record(read1, read2, 0x40)
    else:
        mapped_records(read1, read2, True)
    if read2.score == 0:
        unmapped_record(read2, read1, 0x80)
    else:
        mapped_records(read2, read1, False)
    return out
