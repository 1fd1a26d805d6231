"""The comparison that decides `correct`: a sample's VCF (or gVCF) held to
the plain reference's truth (reference/pileup.py).

Numbers, each a share (0 is a perfect match), each held to a limit that
the traffic file states:

  snp_missed     clean planted SNVs that the VCF does not report with
                 their ALT (the evidence planes and the caller scan)
  snp_false      SNV records away from every indel and SV that are not a
                 planted SNV with its ALT
  count_gap      median over the clean SNVs reported of sum |NTFREQ -
                 truth| / truth depth (every read counted once, on its
                 base)
  indel_missed   clean planted indels of at most 5 bp with no INS / DEL
                 record of their length within 10 bp (the host leg's
                 gapped alignment)
  nor_missed     (gVCF) positions drawn from the seed, covered and away
                 from every event, that no reference block spans
  nor_depth_gap  (gVCF) median over blocks that start at a clean
                 position of |DP - truth depth| / truth depth
  reads_lost     |reads the program counted - reads sent| / reads sent
  vcf_differs    window samples whose VCF differs from the warm-up's
                 (a fresh engine) in any byte
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

INDEL_SLACK = 10


@dataclasses.dataclass
class Records:
    snp_pos: np.ndarray      # 0-based
    snp_alt: np.ndarray      # object: ALT strings
    snp_nt: np.ndarray       # int64 [4, n] NTFREQ
    ind_pos: np.ndarray      # 0-based anchor
    ind_len: np.ndarray      # + insertion, - deletion
    blk_lo: np.ndarray       # 0-based, inclusive
    blk_hi: np.ndarray
    blk_dp: np.ndarray


def _info(field: str) -> Dict[str, str]:
    out = {}
    for kv in field.split(";"):
        k, _, v = kv.partition("=")
        out[k] = v
    return out


def parse_vcf(text: str) -> Records:
    snp_pos, snp_alt, snp_nt = [], [], []
    ind_pos, ind_len = [], []
    blk_lo, blk_hi, blk_dp = [], [], []
    for line in text.splitlines():
        if not line or line[0] == "#":
            continue
        f = line.split("\t")
        pos = int(f[1]) - 1
        info = _info(f[7])
        t = info.get("TYPE")
        if t == "snv":
            snp_pos.append(pos)
            snp_alt.append(f[4])
            snp_nt.append([int(x) for x in info["NTFREQ"].split(",")])
        elif t == "ins":
            ind_pos.append(pos)
            ind_len.append(len(f[4]) - 1)
        elif t == "del":
            ind_pos.append(pos)
            ind_len.append(1 - len(f[3]))
        elif f[6] == "REF" and "END" in info:
            blk_lo.append(pos)
            blk_hi.append(int(info["END"]) - 1)
            blk_dp.append(int(info["DP"]))
    i64 = lambda x: np.asarray(x, dtype=np.int64)
    return Records(i64(snp_pos), np.asarray(snp_alt, dtype=object),
                   i64(snp_nt).reshape(-1, 4).T, i64(ind_pos), i64(ind_len),
                   i64(blk_lo), i64(blk_hi), i64(blk_dp))


def compare(rec: Records, truth, gvcf: bool,
            nor_sample: Optional[np.ndarray] = None) -> Dict[str, float]:
    """The numbers of one VCF against the truth (reference/pileup.Truth)."""
    T = truth.cov.size
    acgt = np.array(list("ACGT"), dtype=object)
    out: Dict[str, float] = {}

    reported = dict(zip(rec.snp_pos.tolist(), range(rec.snp_pos.size)))
    idx = np.array([reported.get(p, -1) for p in truth.snp_pos.tolist()],
                   dtype=np.int64)
    want = acgt[truth.snp_alt]
    found = idx >= 0
    match = found.copy()
    match[found] = rec.snp_alt[idx[found]] == want[found]
    n = truth.snp_pos.size
    out["snp_missed"] = float((n - match.sum()) / n) if n else 0.0

    inside = rec.snp_pos < T
    p = rec.snp_pos[inside]
    away = ~truth.event_near[p]
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    alts = rec.snp_alt[inside][away]
    wrong = [int(truth.planted[q]) != code.get(a, -2)
             for q, a in zip(p[away].tolist(), alts.tolist())]
    out["snp_false"] = float(np.mean(wrong)) if wrong else 0.0

    if match.any():
        got = rec.snp_nt[:, idx[match]]
        ref = truth.snp_counts[:, match]
        gap = np.abs(got - ref).sum(0) / np.maximum(ref.sum(0), 1)
        out["count_gap"] = float(np.median(gap))
    else:
        out["count_gap"] = 1.0

    m = truth.indel_pos.size
    if m:
        hit = 0
        order = np.argsort(rec.ind_pos, kind="stable")
        rp, rl = rec.ind_pos[order], rec.ind_len[order]
        for q, ln in zip(truth.indel_pos.tolist(), truth.indel_len.tolist()):
            a = np.searchsorted(rp, q - INDEL_SLACK)
            b = np.searchsorted(rp, q + INDEL_SLACK, side="right")
            hit += bool(np.any(rl[a:b] == ln))
        out["indel_missed"] = float((m - hit) / m)
    else:
        out["indel_missed"] = 0.0

    if gvcf:
        s = nor_sample if nor_sample is not None else np.zeros(0, np.int64)
        if s.size and rec.blk_lo.size:
            order = np.argsort(rec.blk_lo, kind="stable")
            lo, hi = rec.blk_lo[order], rec.blk_hi[order]
            j = np.searchsorted(lo, s, side="right") - 1
            spanned = (j >= 0) & (hi[np.maximum(j, 0)] >= s)
            out["nor_missed"] = float(1.0 - spanned.mean())
        else:
            out["nor_missed"] = 1.0 if s.size else 0.0
        lo = rec.blk_lo
        ok = (lo < T)
        ok[ok] &= ~truth.event_near[lo[ok]] & (truth.cov[lo[ok]] >= 10)
        if ok.any():
            c = truth.cov[lo[ok]].astype(np.float64)
            out["nor_depth_gap"] = float(np.median(
                np.abs(rec.blk_dp[ok] - c) / c))
        else:
            out["nor_depth_gap"] = 1.0
    return out


def reference_records(truth) -> Records:
    """The reference in the program's place: the records a perfect mapper
    and the caller's rules give from the truth pileup (the clean SNVs and
    indels, reference blocks over the covered runs between them)."""
    acgt = np.array(list("ACGT"), dtype=object)
    T = truth.cov.size
    brk = np.zeros(T, dtype=bool)
    brk[truth.snp_pos] = True
    brk[np.clip(truth.indel_pos, 0, T - 1)] = True
    normal = (truth.cov > 0) & ~brk
    # a block: a maximal run of normal positions
    edge = np.diff(np.concatenate([[0], normal.astype(np.int8), [0]]))
    lo = np.nonzero(edge == 1)[0]
    hi = np.nonzero(edge == -1)[0] - 1
    return Records(truth.snp_pos.astype(np.int64), acgt[truth.snp_alt],
                   truth.snp_counts, truth.indel_pos.astype(np.int64),
                   truth.indel_len.astype(np.int64), lo.astype(np.int64),
                   hi.astype(np.int64), truth.cov[lo].astype(np.int64))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is within its limit; a number without a
    limit fails."""
    return all(k in limits and v <= limits[k] for k, v in numbers.items())
