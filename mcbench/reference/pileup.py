"""The plain reference: what a sample's VCF should say, worked out from
the truth of how the sample was made, with NumPy alone.

Every read's origin on the mutant, its errors and the mutant's map back
to the reference are known (gen.py), so each read base lands on the
reference position it came from. That pileup, the bases counted at each
position, is what a perfect mapper hands the caller; the caller's rules
(the reference MapCaller's, VariantCalling.cpp: a SNV where a non-
reference base reaches max(5, ceil(0.2 x depth))) then give the calls.
The comparison (check.py) holds the program's VCF to it at the
positions where mapping has one right answer: planted SNVs and small
indels away from other indels and structural events, and covered
positions away from every event.

Imports nothing of the program and takes nothing it made.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MIN_ALLELE_DEPTH = 5       # -ad, the caller's default
FREQUENCY_THR = 0.2        # FrequencyThr
MAX_WRITTEN_INDEL = 5      # the VCF writer leaves out longer indels
CLEAN_INDEL = 200          # bp kept clear of any indel
CLEAN_SV = 1000            # bp kept clear of any structural event
MIN_CALL_DEPTH = 15        # depth at which a planted SNV must be called


@dataclasses.dataclass
class Truth:
    cov: np.ndarray          # int32 [T]: read bases on each reference position
    snp_pos: np.ndarray      # clean planted SNVs the caller must report
    snp_alt: np.ndarray
    snp_counts: np.ndarray   # int64 [4, n]: bases counted there (NTFREQ)
    indel_pos: np.ndarray    # clean planted indels of at most 5 bp
    indel_len: np.ndarray    # + insertion, - deletion
    event_near: np.ndarray   # bool [T]: within reach of an indel or SV
    planted: np.ndarray      # int8 [T]: the ALT code of every planted SNV,
                             # -1 elsewhere


def _near(T: int, lo: np.ndarray, hi: np.ndarray, pad: int) -> np.ndarray:
    d = np.zeros(T + 1, dtype=np.int32)
    np.add.at(d, np.clip(lo - pad, 0, T), 1)
    np.add.at(d, np.clip(hi + pad, 0, T), -1)
    return np.cumsum(d[:T]) > 0


def pileup(T: int, mutant, reads, drop_mate: int = -1) -> Truth:
    """The truth pileup of a sample over reference positions [0, T).
    drop_mate 0 or 1 leaves that mate of every pair out (the control)."""
    rl = reads.read_len
    Lm = mutant.codes.size
    mates = [k for k in (0, 1) if k != drop_mate]
    starts = np.concatenate([reads.mate_start[k] for k in mates])
    d = (np.bincount(starts, minlength=Lm + 1)[:Lm + 1]
         - np.bincount(starts + rl, minlength=Lm + 1)[:Lm + 1])
    cov_m = np.cumsum(d[:Lm])
    on = mutant.m2r >= 0
    cov = np.bincount(mutant.m2r[on], weights=cov_m[on],
                      minlength=T)[:T].astype(np.int32)

    near = (_near(T, mutant.indel_pos, mutant.indel_pos + np.abs(
                mutant.indel_len) + 1, CLEAN_INDEL)
            | _near(T, mutant.sv_lo, mutant.sv_hi, CLEAN_SV))
    planted = np.full(T, -1, dtype=np.int8)
    planted[mutant.snp_pos] = mutant.snp_alt

    # clean SNVs: one mutant base each, on the forward strand
    r2m = np.full(T, -1, dtype=np.int64)
    fwd = on & ~mutant.flip
    r2m[mutant.m2r[fwd]] = np.nonzero(fwd)[0]
    keep = ~near[mutant.snp_pos] & (r2m[mutant.snp_pos] >= 0)
    pos, alt = mutant.snp_pos[keep], mutant.snp_alt[keep]
    m = r2m[pos]
    counts = np.zeros((4, pos.size), dtype=np.int64)
    counts[mutant.codes[m], np.arange(pos.size)] = cov_m[m]
    # each sequencing error moves one count from the true base
    mate_of_err = _mate_of_errors(reads)
    em, eb = reads.err_m, reads.err_b
    sel = np.isin(mate_of_err, mates)
    em, eb = em[sel], eb[sel]
    order = np.argsort(m, kind="stable")
    ms = m[order]
    i = np.searchsorted(ms, em)
    hit = (i < ms.size) & (ms[np.minimum(i, ms.size - 1)] == em)
    col = order[i[hit]]
    np.add.at(counts, (mutant.codes[em[hit]], col), -1)
    np.add.at(counts, (eb[hit], col), 1)

    depth = counts.sum(0)
    need = np.maximum(MIN_ALLELE_DEPTH,
                      np.ceil(depth * FREQUENCY_THR)).astype(np.int64)
    callable_ = (depth >= MIN_CALL_DEPTH) & (counts[alt, np.arange(alt.size)]
                                             >= need)

    short = np.abs(mutant.indel_len) <= MAX_WRITTEN_INDEL
    # an indel is clean when no other indel or SV lies within reach
    ip, il = mutant.indel_pos, mutant.indel_len
    gap_prev = np.diff(ip, prepend=-10 ** 9)
    gap_next = np.diff(ip, append=10 ** 12)
    alone = (gap_prev > CLEAN_INDEL) & (gap_next > CLEAN_INDEL)
    sv_near = _near(T, mutant.sv_lo, mutant.sv_hi, CLEAN_SV)[
        np.clip(ip, 0, T - 1)]
    ik = short & alone & ~sv_near & (cov[np.clip(ip, 0, T - 1)]
                                     >= MIN_CALL_DEPTH)
    return Truth(cov, pos[callable_], alt[callable_],
                 counts[:, callable_], ip[ik], il[ik], near, planted)


def _mate_of_errors(reads) -> np.ndarray:
    """Which mate each entry of reads.err_m belongs to: gen.py lists
    mate 1's errors first."""
    out = np.ones(reads.err_m.size, dtype=np.int64)
    out[:reads.n_err_mate1] = 0
    return out


def clean_positions(truth: Truth, n: int, seed: int,
                    min_depth: int = 10) -> np.ndarray:
    """n positions drawn from the seed among those with depth >=
    min_depth, away from every indel and SV, not a planted SNV or next
    to one: each has one right answer, a reference block."""
    ok = (truth.cov >= min_depth) & ~truth.event_near
    snp = truth.planted >= 0
    ok &= ~snp & ~np.roll(snp, 1) & ~np.roll(snp, -1)
    cand = np.nonzero(ok)[0]
    if cand.size == 0:
        return cand
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(cand, size=min(n, cand.size), replace=False))
