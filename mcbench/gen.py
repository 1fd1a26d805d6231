"""The benchmark's inputs, made in bulk from seeds: a synthetic genome, a
mutant of it and paired-end reads of the mutant.

A vectorised copy of the semantics of mapcaller_tpu_torch/simulator.py
(`mutate_genome`, SVsim's events and rates; `simulate_paired_reads`,
wgsim-style pairs), which loops in Python once a read and once an event.
The program only ever sees the FASTA and FASTQ files written here; the
truth kept in `Mutant` and `Reads` is for the plain reference
(reference/pileup.py) alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

# SVsim's event sizes (simulator.mutate_genome): (low, high) of
# rng.integers, footprints as pick_pos reserves them
SMALL_INDEL = (1, 11)
LARGE_INDEL = (11, 31)
SPAN = {"snp": 1, "small": 12, "large": 32}
INV_SIZE = (1000, 2000)
TNL_SIZE, TNL_DIST = (1000, 2000), (10000, 11000)
CNV_SIZE, CNV_DUP = (300, 1300), (2, 10)


def synth_genome(length: int, seed: int) -> np.ndarray:
    """Uniform random bases, codes A=0 C=1 G=2 T=3."""
    return np.random.default_rng(seed).integers(0, 4, size=length,
                                                dtype=np.uint8)


def write_fasta(path: str, name: str, codes: np.ndarray,
                width: int = 70) -> None:
    n = codes.size
    full = n // width
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        if full:
            rows = np.empty((full, width + 1), dtype=np.uint8)
            rows[:, :width] = ACGT[codes[:full * width]].reshape(full, width)
            rows[:, width] = 10
            rows.tofile(f)
        if n > full * width:
            f.write(ACGT[codes[full * width:]].tobytes() + b"\n")


@dataclasses.dataclass
class Mutant:
    codes: np.ndarray        # uint8, the mutant of the territory
    m2r: np.ndarray          # int64 a mutant base: its reference position,
                             # -1 inside an inserted sequence
    flip: np.ndarray         # bool a mutant base: inside an inversion
    snp_pos: np.ndarray      # int64, reference positions (0-based)
    snp_alt: np.ndarray      # uint8 codes
    indel_pos: np.ndarray    # int64, the anchor base before the event
    indel_len: np.ndarray    # int64, + insertion / - deletion
    sv_lo: np.ndarray        # int64, reference span of each structural
    sv_hi: np.ndarray        # event, [lo, hi)


def _free(lo: np.ndarray, hi: np.ndarray, p: np.ndarray,
          span: np.ndarray) -> np.ndarray:
    """Which footprints [p - 1, p + span] keep a base clear of every
    reserved footprint [lo, hi] (sorted, disjoint, inclusive)."""
    if lo.size == 0:
        return np.ones(p.shape, dtype=bool)
    i = np.searchsorted(lo, p + span + 2)
    prev_hi = np.where(i > 0, hi[np.maximum(i - 1, 0)], -10)
    return prev_hi < p - 2


def _place(rng, L: int, lo: np.ndarray, hi: np.ndarray, n: int,
           span_of) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Place n events clear of the reserved footprints and of each other,
    in rounds of bulk draws (pick_pos's rule, its retries as rounds).
    span_of(k) draws k spans. Returns (positions, spans, lo, hi) with the
    new footprints reserved."""
    got_p, got_s = [], []
    need = n
    for _ in range(16):
        if need <= 0:
            break
        span = span_of(need)
        p = rng.integers(1, np.maximum(2, L - span - 1))
        ok = _free(lo, hi, p, span)
        p, span = p[ok], span[ok]
        order = np.argsort(p, kind="stable")
        p, span = p[order], span[order]
        # among this round's draws, a footprint that touches the one
        # before it is dropped
        keep = np.ones(p.size, dtype=bool)
        keep[1:] = p[1:] - 1 > p[:-1] + span[:-1] + 1
        p, span = p[keep], span[keep]
        got_p.append(p)
        got_s.append(span)
        nlo = np.concatenate([lo, p - 1])
        nhi = np.concatenate([hi, p + span])
        o = np.argsort(nlo, kind="stable")
        lo, hi = nlo[o], nhi[o]
        need -= p.size
    p = np.concatenate(got_p) if got_p else np.zeros(0, np.int64)
    s = np.concatenate(got_s) if got_s else np.zeros(0, np.int64)
    return p[:n], s[:n], lo, hi


def mutate(ref: np.ndarray, rates: Dict[str, float], seed: int) -> Mutant:
    """SVsim's mutant of `ref` (rates per Mb: snp, small_indel,
    large_indel, inv, tnl, cnv): SNPs, 1-10 bp and 11-30 bp indels,
    inversions, translocations and duplications, placed clear of each
    other, large events first."""
    rng = np.random.default_rng(seed)
    L = int(ref.size)
    mb = L / 1e6
    lo = np.zeros(0, np.int64)
    hi = np.zeros(0, np.int64)
    sv = []                                    # (p, kind, a, b)

    def reserve(span):
        # pick_pos: up to 100 draws of a start clear of every footprint
        nonlocal lo, hi
        for _ in range(100):
            p = int(rng.integers(1, max(2, L - span - 1)))
            if _free(lo, hi, np.array([p]), np.array([span]))[0]:
                i = int(np.searchsorted(lo, p - 1))
                lo = np.insert(lo, i, p - 1)
                hi = np.insert(hi, i, p + span)
                return p
        return None

    for _ in range(int(round(mb * rates.get("inv", 0.0)))):
        size = int(rng.integers(*INV_SIZE))
        p = reserve(size)
        if p is not None:
            sv.append((p, "inv", size, 0))
    for _ in range(int(round(mb * rates.get("tnl", 0.0)))):
        size, dist = int(rng.integers(*TNL_SIZE)), int(rng.integers(*TNL_DIST))
        p = reserve(2 * size + dist)
        if p is not None:
            sv.append((p, "tnl", size, dist))
    for _ in range(int(round(mb * rates.get("cnv", 0.0)))):
        size = int(rng.integers(*CNV_SIZE))
        p = reserve(size)
        if p is not None:
            sv.append((p, "dup", size, int(rng.integers(*CNV_DUP))))

    n_snp = int(mb * rates.get("snp", 0.0))
    snp_pos, _, lo, hi = _place(rng, L, lo, hi, n_snp,
                                lambda k: np.full(k, SPAN["snp"]))
    indel = []
    for kind, sizes_lohi in (("small", SMALL_INDEL), ("large", LARGE_INDEL)):
        n = int(mb * rates.get(f"{kind}_indel", 0.0))
        p, _, lo, hi = _place(rng, L, lo, hi, n,
                              lambda k, kind=kind: np.full(k, SPAN[kind]))
        size = rng.integers(*sizes_lohi, size=p.size)
        ins = rng.integers(0, 2, size=p.size).astype(bool)
        indel.append((p, np.where(ins, size, -size)))
    indel_pos = np.concatenate([x[0] for x in indel])
    indel_len = np.concatenate([x[1] for x in indel])
    o = np.argsort(indel_pos, kind="stable")
    indel_pos, indel_len = indel_pos[o], indel_len[o]

    base = ref.copy()
    snp_pos = np.sort(snp_pos)
    snp_alt = ((base[snp_pos].astype(np.int64)
                + rng.integers(1, 4, size=snp_pos.size)) % 4).astype(np.uint8)
    base[snp_pos] = snp_alt

    # pieces of the mutant in order: (reference lo, length, dir) with dir
    # 1 forward, -1 reverse complement, 0 inserted (its codes beside)
    events = sorted([(int(p), "indel", int(n), 0)
                     for p, n in zip(indel_pos, indel_len)] + sv)
    pieces: List[Tuple[int, int, int]] = []
    inserts: List[np.ndarray] = []
    cur = 0
    sv_lo, sv_hi = [], []
    for p, kind, a, b in events:
        if kind == "indel":
            pieces.append((cur, p + 1 - cur, 1))
            if a > 0:
                ins = rng.integers(0, 4, size=a).astype(np.uint8)
                pieces.append((-1, a, 0))
                inserts.append(ins)
                cur = p + 1
            else:
                cur = p + 1 - a
        elif kind == "inv":
            pieces += [(cur, p - cur, 1), (p, a, -1)]
            cur = p + a
            sv_lo.append(p), sv_hi.append(p + a)
        elif kind == "tnl":
            q = p + b + a
            pieces += [(cur, p - cur, 1), (q, a, 1), (p + a, q - p - a, 1),
                       (p, a, 1)]
            cur = q + a
            sv_lo.append(p), sv_hi.append(q + a)
        else:
            pieces.append((cur, p - cur, 1))
            pieces += [(p, a, 1)] * b
            cur = p + a
            sv_lo.append(p), sv_hi.append(p + a)
    pieces.append((cur, L - cur, 1))

    codes, m2r, flip = [], [], []
    ins_i = 0
    for lo_, n, d in pieces:
        if n <= 0:
            continue
        if d == 1:
            codes.append(base[lo_:lo_ + n])
            m2r.append(np.arange(lo_, lo_ + n, dtype=np.int64))
            flip.append(np.zeros(n, dtype=bool))
        elif d == -1:
            codes.append((3 - base[lo_:lo_ + n])[::-1])
            m2r.append(np.arange(lo_ + n - 1, lo_ - 1, -1, dtype=np.int64))
            flip.append(np.ones(n, dtype=bool))
        else:
            codes.append(inserts[ins_i])
            ins_i += 1
            m2r.append(np.full(n, -1, dtype=np.int64))
            flip.append(np.zeros(n, dtype=bool))
    return Mutant(np.concatenate(codes), np.concatenate(m2r),
                  np.concatenate(flip), snp_pos, snp_alt, indel_pos,
                  indel_len, np.array(sv_lo, np.int64),
                  np.array(sv_hi, np.int64))


@dataclasses.dataclass
class Reads:
    n_pairs: int
    read_len: int
    start: np.ndarray        # int64 a pair: fragment start on the mutant
    frag: np.ndarray         # int64 a pair: fragment length
    mate_start: np.ndarray   # int64 [2, n]: each mate's forward start
    mate_rev: np.ndarray     # bool [2, n]: the mate is reverse complemented
    seq: np.ndarray          # uint8 [2, n, read_len], codes as sequenced
    err_m: np.ndarray        # int64: mutant position of each error
    err_b: np.ndarray        # uint8: its base on the forward strand
    n_err_mate1: int         # err_m lists mate 1's errors first


def simulate_reads(mcodes: np.ndarray, n_pairs: int, read_len: int,
                   frag_mean: float, frag_sd: float, err_rate: float,
                   seed: int) -> Reads:
    """wgsim-style pairs (simulate_paired_reads): a fragment of normal
    length at a uniform start, mate 1 from its left end forward or from
    its right end reverse complemented, mate 2 the other end, each base
    replaced by another with probability err_rate."""
    rng = np.random.default_rng(seed)
    Lm = int(mcodes.size)
    frag = np.clip(rng.normal(frag_mean, frag_sd, size=n_pairs),
                   read_len + 10, Lm - 2).astype(np.int64)
    start = (rng.random(n_pairs) * (Lm - frag)).astype(np.int64)
    fwd_first = rng.integers(0, 2, size=n_pairs).astype(bool)
    left, right = start, start + frag - read_len
    mate_start = np.stack([np.where(fwd_first, left, right),
                           np.where(fwd_first, right, left)])
    mate_rev = np.stack([~fwd_first, fwd_first])
    win = np.lib.stride_tricks.sliding_window_view(mcodes, read_len)
    seq = np.empty((2, n_pairs, read_len), dtype=np.uint8)
    err_m, err_b = [], []
    for k in range(2):
        s = win[mate_start[k]]
        rev = mate_rev[k]
        s[rev] = 3 - s[rev, ::-1]
        flat = s.reshape(-1)
        n_err = rng.binomial(flat.size, err_rate)
        pos = np.unique(rng.integers(0, flat.size, size=n_err))
        flat[pos] = (flat[pos] + rng.integers(1, 4, size=pos.size)) % 4
        row, off = pos // read_len, pos % read_len
        r = rev[row]
        err_m.append(mate_start[k][row] + np.where(r, read_len - 1 - off, off))
        err_b.append(np.where(r, 3 - flat[pos], flat[pos]).astype(np.uint8))
        seq[k] = s
    return Reads(n_pairs, read_len, start, frag, mate_start, mate_rev, seq,
                 np.concatenate(err_m), np.concatenate(err_b),
                 int(err_m[0].size))


def _digits(x: np.ndarray, width: int) -> np.ndarray:
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((x[:, None] // p[None, :]) % 10 + 48).astype(np.uint8)


def write_fastq(reads: Reads, name: str, path1: str, path2: str) -> int:
    """Both mates' FASTQ, headers `@{name}_{start+1}_{end}_{k}/{1,2}` as
    simulate_paired_reads names them (numbers zero-padded to one width),
    qualities all 'I'. Returns the bytes written."""
    n, rl = reads.n_pairs, reads.read_len
    wp = len(str(int((reads.start + reads.frag).max(initial=1))))
    wk = len(str(max(n - 1, 1)))
    head = np.frombuffer(f"@{name}_".encode(), np.uint8)
    fields = [(reads.start + 1, wp), (reads.start + reads.frag, wp),
              (np.arange(n, dtype=np.int64), wk)]
    W = head.size + 2 * wp + wk + 2 + 3 + rl + 3 + rl + 1
    written = 0
    for k, path in enumerate((path1, path2)):
        rec = np.empty((n, W), dtype=np.uint8)
        rec[:, :head.size] = head
        c = head.size
        for i, (x, w) in enumerate(fields):
            rec[:, c:c + w] = _digits(x, w)
            c += w
            if i < 2:
                rec[:, c] = ord("_")
                c += 1
        rec[:, c:c + 3] = np.frombuffer(f"/{k + 1}\n".encode(), np.uint8)
        c += 3
        rec[:, c:c + rl] = ACGT[reads.seq[k]]
        c += rl
        rec[:, c:c + 3] = np.frombuffer(b"\n+\n", np.uint8)
        c += 3
        rec[:, c:c + rl] = ord("I")
        c += rl
        rec[:, c] = 10
        with open(path, "wb") as f:
            rec.tofile(f)
        written += rec.nbytes
    return written
