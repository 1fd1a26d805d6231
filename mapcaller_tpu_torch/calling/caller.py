"""Variant calling (ref: src/VariantCalling.cpp).

Single pass over the accumulated evidence tables producing SUB / INS /
DEL / UMR / CNV / gVCF-NOR / monomorphic records, plus breakpoint
clustering and INV/TNL detection from discordant-pair histograms.

This is the production caller with the reference's exact thresholds and
quirks. The dense genome-axis math (_identify_variants_vec) is
vectorized NumPy on host; a scalar per-position oracle backs the
property tests.
"""
from __future__ import annotations

import dataclasses
import math
from bisect import bisect_left, bisect_right
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..genome import Genome
from ..pipeline.profile import Profile

MAX_QSCORE = 30            # ref: VariantCalling.cpp:3
BLOCK_SIZE = 100           # ref: VariantCalling.cpp:4
BP_FREQ_THR = 3            # ref: VariantCalling.cpp:5
INV_TNL_THR_RATIO = 0.5    # ref: VariantCalling.cpp:6
GENOTYPE_RATIO = 0.50      # ref: VariantCalling.cpp:7

VAR_SUB, VAR_INS, VAR_DEL, VAR_INV, VAR_TNL, VAR_CNV, VAR_UMR = 0, 1, 2, 3, 4, 5, 6
VAR_NOR, VAR_MON = 10, 11

GENOTYPE_LABEL = ["*", "0", "1", "0/0", "0/1", "1/1", "1/2"]  # cpp:19


@dataclasses.dataclass
class Variant:
    gPos: int
    VarType: int
    DP: int = 0
    ALTstr: str = ""
    AD_ref: int = 0
    AD_alt: int = 0
    GenoType: int = 0
    qscore: int = 0


def cal_block_read_depth(profile: Profile, genome_size: int) -> np.ndarray:
    """Mean depth per 100-bp block (ref: VariantCalling.cpp:106-120)."""
    cov = profile.acgt.sum(axis=0, dtype=np.int32)
    # per-pos cov <= 4*4095 and blocks are 100 wide, so int32 block sums
    sums = np.add.reduceat(cov, np.arange(0, genome_size, BLOCK_SIZE))
    return np.where(sums > 0, sums // BLOCK_SIZE, 0).astype(np.int64)


def get_area_ind_frequency(g_pos: int, ind_map: Dict[int, Dict[str, int]],
                           keys: List[int]) -> Tuple[int, str]:
    """±5 bp dominant-sequence vote (ref: VariantCalling.cpp:64-95).
    `keys` is the sorted key list of ind_map."""
    freq = 0
    max_freq = 0
    max_pos = 0
    ind_str = ""
    lo = bisect_left(keys, g_pos - 5)
    hi = bisect_right(keys, g_pos + 5)
    for k in keys[lo:hi]:
        if abs(k - g_pos) <= 5:
            for seq in sorted(ind_map[k].keys()):
                cnt = ind_map[k][seq]
                freq += cnt
                if max_freq < cnt:
                    ind_str = seq
                    max_freq = cnt
                    max_pos = k
                elif max_freq == cnt and len(seq) > len(ind_str):
                    ind_str = seq
                    max_pos = k
    if g_pos == max_pos:
        return freq, ind_str
    return 0, ind_str


def cal_quality_score(a: int, b: int) -> int:
    """(ref: VariantCalling.cpp:97-104)"""
    if a >= b:
        return MAX_QSCORE
    qs = int(-100 * math.log10(1.0 - (1.0 * a / b))) & 0xFF
    if qs > MAX_QSCORE:
        qs = MAX_QSCORE
    return qs


def determine_genotype(ploidy: int, cov: int, alt_read_count: int, alt_num: int) -> int:
    """(ref: VariantCalling.cpp:529-548)"""
    genotype = 0
    if ploidy == 1:
        genotype = 1 if alt_read_count < int(cov * GENOTYPE_RATIO) else 2
    elif ploidy == 2:
        if alt_num == 0:
            genotype = 3
        elif alt_num == 1:
            genotype = 4 if alt_read_count < int(cov * GENOTYPE_RATIO) else 5
        elif alt_num == 2:
            genotype = 6
    return genotype


def identify_variants(cfg: Config, genome: Genome, profile: Profile,
                      ref_codes: np.ndarray, block_depth: np.ndarray
                      ) -> List[Variant]:
    """The genome scan (ref: VariantCalling.cpp:550-680).

    All modes run vectorized scans; the scalar mirror stays as the
    property-test oracle. The gVCF NOR-block chain state (a block merges
    until ANY other record is appended) vectorizes as an RLE keyed by
    the cumulative count of record-emitting positions."""
    if cfg.gvcf or cfg.monomorphic:
        return _identify_variants_gvcf_vec(cfg, genome, profile, ref_codes,
                                           block_depth)
    return _identify_variants_vec(cfg, genome, profile, ref_codes,
                                  block_depth)


def _identify_variants_vec(cfg: Config, genome: Genome, profile: Profile,
                           ref_codes: np.ndarray, block_depth: np.ndarray
                           ) -> List[Variant]:
    """Vectorized genome scan, bit-equivalent to the scalar mirror for
    non-gVCF/monomorphic modes (property-tested against it)."""
    out: List[Variant] = []
    L = genome.genome_size
    acgt = profile.acgt                       # int32[4, L]
    cov = acgt.sum(axis=0, dtype=np.int32)    # per-pos <= 4*4095
    multi = profile.multi_hit
    freq_base = 0.01 if cfg.somatic else cfg.frequency_thr
    ad = np.int32(cfg.min_allele_depth)

    # --- SUB candidates (ref: cpp:599-630) ------------------------------
    # cov >= cov_thr is sparse at realistic depth/threshold ratios, so
    # gather the covered columns once and do the allele math on those.
    bd32 = block_depth.astype(np.int32)
    if cfg.somatic:
        cov_thr = np.full(L, ad, dtype=np.int32)
    else:
        cov_thr = np.maximum(np.repeat(bd32 >> 1, BLOCK_SIZE)[:L], ad)
    rc = ref_codes[:L]
    cand = np.nonzero(cov >= cov_thr)[0]
    acgt_k = acgt[:, cand]                    # [4, K]
    cov_k = cov[cand]
    rc_k = rc[cand].astype(np.int32)
    freq_thr = np.maximum(
        np.ceil(cov_k.astype(np.float64) * freq_base).astype(np.int32), ad)
    qual = np.empty((4, cand.size), dtype=bool)   # base qualifies as ALT
    for c in range(4):
        qual[c] = (acgt_k[c] >= freq_thr) & (rc_k != c)
    n_alt = qual.sum(axis=0, dtype=np.int32)
    # first/second qualifying base in ACGT order (scalar builds vec in
    # base order and uses vec[0], vec[1])
    first = np.argmax(qual, axis=0).astype(np.int32)
    qual2 = qual.copy()
    np.put_along_axis(qual2, first[None, :], False, axis=0)
    second = np.argmax(qual2, axis=0).astype(np.int32)
    cnt1 = np.take_along_axis(acgt_k, first[None, :], axis=0)[0]
    cnt2 = np.take_along_axis(acgt_k, second[None, :], axis=0)[0]
    is1 = n_alt == 1
    is2 = (n_alt == 2) & ((cnt1 + cnt2) >= (cov_k // 2))
    sub_k = np.nonzero(is1 | is2)[0]
    if sub_k.size:
        rb_s = rc_k[sub_k]
        ad_ref_s = np.where(
            rb_s < 4,
            np.take_along_axis(acgt_k[:, sub_k],
                               np.minimum(rb_s, 3)[None, :], axis=0)[0],
            0)
        rows = zip(cand[sub_k].tolist(), cov_k[sub_k].tolist(),
                   is1[sub_k].tolist(), cnt1[sub_k].tolist(),
                   cnt2[sub_k].tolist(), first[sub_k].tolist(),
                   second[sub_k].tolist(), ad_ref_s.tolist())
        for g, cv, one, c1, c2, b1, b2, ad_ref in rows:
            if one:
                alt_cnt = c1
                alt_str = "ACGT"[b1]
                gt = determine_genotype(cfg.ploidy, cv, alt_cnt, 1)
            else:
                alt_cnt = c1 + c2
                alt_str = f"{'ACGT'[b1]},{'ACGT'[b2]}"
                gt = determine_genotype(cfg.ploidy, cv, alt_cnt, 2)
            if gt == 0:
                continue
            v = Variant(g, VAR_SUB, DP=cv, AD_alt=alt_cnt, AD_ref=ad_ref,
                        GenoType=gt, ALTstr=alt_str)
            v.qscore = (int(35.0 * alt_cnt / (cv * 0.05)) if cfg.somatic
                        else int(35.0 * alt_cnt / cv)) & 0xFF
            out.append(v)

    # --- INS/DEL (ref: cpp:576-597) --------------------------------------
    # GetAreaIndFrequency returns nonzero only when g_pos is itself the
    # dominant key of its +-5 window, so only map keys can emit records.
    for var_type, ind_map in ((VAR_INS, profile.insert_map),
                              (VAR_DEL, profile.delete_map)):
        keys = sorted(ind_map.keys())
        ratio = 0.25 if var_type == VAR_INS else 0.35
        for g in keys:
            if not (0 <= g < L):
                continue
            freq, ind_str = get_area_ind_frequency(g, ind_map, keys)
            c_thr = int(block_depth[g // BLOCK_SIZE]) >> 1
            if c_thr < cfg.min_allele_depth:
                c_thr = cfg.min_allele_depth
            if cfg.somatic and c_thr > cfg.min_allele_depth:
                c_thr = cfg.min_allele_depth
            thr = int(c_thr * ratio)
            if thr < cfg.min_allele_depth:
                thr = cfg.min_allele_depth
            if freq < thr:
                continue
            v = Variant(g, var_type)
            v.DP = int(block_depth[g // BLOCK_SIZE])
            v.AD_alt = freq
            if v.DP < v.AD_alt:
                v.DP = v.AD_alt
            v.ALTstr = ind_str
            v.AD_ref = v.DP - v.AD_alt
            v.GenoType = determine_genotype(cfg.ploidy, v.DP, v.AD_alt, 1)
            cv = int(cov[g])
            v.qscore = (int(100.0 * v.AD_alt / cv) & 0xFF) if cv > 0 else 0
            out.append(v)

    # --- UMR / CNV run-lengths (ref: cpp:632-651) -------------------------
    # gap counts maximal runs of (cov==0 & multi==0); dup counts maximal
    # runs of (cov==0 & multi>0); each is flushed by ANY other state. A
    # run still open when the scan hits GenomeSize is never flushed.
    state = np.where(cov > 0, 2, np.where(multi > 0, 1, 0)).astype(np.int8)
    changes = np.nonzero(np.diff(state))[0] + 1
    starts = np.concatenate([[0], changes])
    ends = np.concatenate([changes, [L]])
    run_vals = state[starts]
    run_lens = ends - starts
    flushed = ends < L               # trailing run is never flushed
    gap_m = flushed & (run_vals == 0) & (run_lens >= cfg.min_unmapped_size)
    dup_m = flushed & (run_vals == 1) & (run_lens > cfg.min_cnv_size)
    for s, ln in zip(starts[gap_m].tolist(), run_lens[gap_m].tolist()):
        out.append(Variant(s, VAR_UMR, DP=ln & 0xFFFF))
    for s, ln in zip(starts[dup_m].tolist(), run_lens[dup_m].tolist()):
        out.append(Variant(s, VAR_CNV, DP=ln & 0xFFFF))

    out.sort(key=lambda v: (v.gPos, v.VarType))
    return out


def _identify_variants_gvcf_vec(cfg: Config, genome: Genome,
                                profile: Profile, ref_codes: np.ndarray,
                                block_depth: np.ndarray) -> List[Variant]:
    """Vectorized gVCF/monomorphic scan, bit-equivalent to the scalar
    mirror (property-tested). SUB/INS/DEL/UMR/CNV discovery matches
    _identify_variants_vec; the per-position state the scalar loop
    carries vectorizes as:

      normal[p]   = cov > 0 and no INS/DEL/SUB record emitted at p
      brk[p]      = any record appended while scanning position p
                    (INS/DEL/SUB at p, or a gap/dup run flushed at p)
      NOR blocks  = maximal groups of normal positions sharing
                    cumsum(brk)[p] — a block merges across non-normal,
                    non-emitting positions exactly like the scalar
                    out[-1].VarType == NOR chain (cpp:652-669)
    """
    out: List[Variant] = []
    L = genome.genome_size
    acgt = profile.acgt
    cov = acgt.sum(axis=0, dtype=np.int32)
    multi = profile.multi_hit
    freq_base = 0.01 if cfg.somatic else cfg.frequency_thr
    ad = np.int32(cfg.min_allele_depth)
    brk = np.zeros(L + 1, dtype=bool)
    emitted_at = np.zeros(L, dtype=bool)   # INS/DEL/SUB at p => not normal

    # --- SUB records (identical math to _identify_variants_vec) ---------
    bd32 = block_depth.astype(np.int32)
    if cfg.somatic:
        cov_thr = np.full(L, ad, dtype=np.int32)
    else:
        cov_thr = np.maximum(np.repeat(bd32 >> 1, BLOCK_SIZE)[:L], ad)
    rc = ref_codes[:L]
    cand = np.nonzero(cov >= cov_thr)[0]
    acgt_k = acgt[:, cand]
    cov_k = cov[cand]
    rc_k = rc[cand].astype(np.int32)
    freq_thr = np.maximum(
        np.ceil(cov_k.astype(np.float64) * freq_base).astype(np.int32), ad)
    qual = np.empty((4, cand.size), dtype=bool)
    for c in range(4):
        qual[c] = (acgt_k[c] >= freq_thr) & (rc_k != c)
    n_alt = qual.sum(axis=0, dtype=np.int32)
    first = np.argmax(qual, axis=0).astype(np.int32)
    qual2 = qual.copy()
    np.put_along_axis(qual2, first[None, :], False, axis=0)
    second = np.argmax(qual2, axis=0).astype(np.int32)
    cnt1 = np.take_along_axis(acgt_k, first[None, :], axis=0)[0]
    cnt2 = np.take_along_axis(acgt_k, second[None, :], axis=0)[0]
    is1 = n_alt == 1
    is2 = (n_alt == 2) & ((cnt1 + cnt2) >= (cov_k // 2))
    sub_k = np.nonzero(is1 | is2)[0]
    for ki in sub_k.tolist():
        g = int(cand[ki])
        cv = int(cov_k[ki])
        if is1[ki]:
            alt_cnt = int(cnt1[ki])
            alt_str = "ACGT"[first[ki]]
            gt = determine_genotype(cfg.ploidy, cv, alt_cnt, 1)
        else:
            alt_cnt = int(cnt1[ki] + cnt2[ki])
            alt_str = f"{'ACGT'[first[ki]]},{'ACGT'[second[ki]]}"
            gt = determine_genotype(cfg.ploidy, cv, alt_cnt, 2)
        if gt == 0:
            continue
        rb = int(rc_k[ki])
        v = Variant(g, VAR_SUB, DP=cv, AD_alt=alt_cnt,
                    AD_ref=int(acgt_k[min(rb, 3), ki]) if rb < 4 else 0,
                    GenoType=gt, ALTstr=alt_str)
        v.qscore = (int(35.0 * alt_cnt / (cv * 0.05)) if cfg.somatic
                    else int(35.0 * alt_cnt / cv)) & 0xFF
        out.append(v)
        brk[g] = True
        emitted_at[g] = True

    # --- INS/DEL records (identical to the vec path + chain flags) ------
    for var_type, ind_map, ratio in ((VAR_INS, profile.insert_map, 0.25),
                                     (VAR_DEL, profile.delete_map, 0.35)):
        keys = sorted(ind_map.keys())
        for g in keys:
            if not (0 <= g < L):
                continue
            freq, ind_str = get_area_ind_frequency(g, ind_map, keys)
            c_thr = int(block_depth[g // BLOCK_SIZE]) >> 1
            if c_thr < cfg.min_allele_depth:
                c_thr = cfg.min_allele_depth
            if cfg.somatic and c_thr > cfg.min_allele_depth:
                c_thr = cfg.min_allele_depth
            thr = int(c_thr * ratio)
            if thr < cfg.min_allele_depth:
                thr = cfg.min_allele_depth
            if freq < thr:
                continue
            v = Variant(g, var_type)
            v.DP = int(block_depth[g // BLOCK_SIZE])
            v.AD_alt = freq
            if v.DP < v.AD_alt:
                v.DP = v.AD_alt
            v.ALTstr = ind_str
            v.AD_ref = v.DP - v.AD_alt
            v.GenoType = determine_genotype(cfg.ploidy, v.DP, v.AD_alt, 1)
            cv = int(cov[g])
            v.qscore = (int(100.0 * v.AD_alt / cv) & 0xFF) if cv > 0 else 0
            out.append(v)
            brk[g] = True
            emitted_at[g] = True

    # --- UMR / CNV runs; flushes append records AT the run-end position -
    state = np.where(cov > 0, 2, np.where(multi > 0, 1, 0)).astype(np.int8)
    changes = np.nonzero(np.diff(state))[0] + 1
    starts = np.concatenate([[0], changes])
    ends = np.concatenate([changes, [L]])
    run_vals = state[starts]
    run_lens = ends - starts
    flushed = ends < L
    gap_m = flushed & (run_vals == 0) & (run_lens >= cfg.min_unmapped_size)
    dup_m = flushed & (run_vals == 1) & (run_lens > cfg.min_cnv_size)
    for s, ln, e in zip(starts[gap_m].tolist(), run_lens[gap_m].tolist(),
                        ends[gap_m].tolist()):
        out.append(Variant(s, VAR_UMR, DP=ln & 0xFFFF))
        brk[e] = True
    for s, ln, e in zip(starts[dup_m].tolist(), run_lens[dup_m].tolist(),
                        ends[dup_m].tolist()):
        out.append(Variant(s, VAR_CNV, DP=ln & 0xFFFF))
        brk[e] = True

    normal = (cov > 0) & ~emitted_at

    if cfg.gvcf:
        keyv = np.cumsum(brk[:L])
        if cfg.monomorphic:
            # a MON record follows every NOR at the same position, so
            # every NOR block is a single position
            npos = np.nonzero(normal)[0]
            for p in npos.tolist():
                cv = int(cov[p])
                out.append(Variant(p, VAR_NOR, DP=cv, AD_alt=cv))
        else:
            npos = np.nonzero(normal)[0]
            if npos.size:
                kn = keyv[npos]
                newblk = np.concatenate([[True], np.diff(kn) != 0])
                bstarts = np.nonzero(newblk)[0]
                mins = np.minimum.reduceat(cov[npos], bstarts)
                for bi, s in enumerate(bstarts.tolist()):
                    p = int(npos[s])
                    out.append(Variant(p, VAR_NOR, DP=int(cov[p]),
                                       AD_alt=int(mins[bi])))
    if cfg.monomorphic:
        npos = np.nonzero(normal)[0]
        gts = {}
        for p in npos.tolist():
            cv = int(cov[p])
            gt = gts.get(cv)
            if gt is None:
                gt = determine_genotype(cfg.ploidy, cv, 0, 0)
                gts[cv] = gt
            rb = int(ref_codes[p])
            v = Variant(p, VAR_MON, DP=cv, GenoType=gt,
                        AD_ref=int(acgt[rb, p]) if rb < 4 else 0)
            out.append(v)

    out.sort(key=lambda v: (v.gPos, v.VarType))
    return out


def _identify_variants_scalar(cfg: Config, genome: Genome, profile: Profile,
                              ref_codes: np.ndarray, block_depth: np.ndarray
                              ) -> List[Variant]:
    """Scalar mirror of the reference loop, kept for gVCF/monomorphic
    modes and as the oracle for the vectorized scan. Sequential like the
    reference (which hard-sets iThreadNum=1, cpp:717) because the
    gap/dup run-length logic carries state."""
    out: List[Variant] = []
    L = genome.genome_size
    acgt = profile.acgt
    cov_all = acgt.sum(axis=0, dtype=np.int64)
    multi = profile.multi_hit
    ins_keys = sorted(profile.insert_map.keys())
    del_keys = sorted(profile.delete_map.keys())
    # positions that can possibly produce records — everything else only
    # advances the gap/dup run-length counters, handled vectorized below.
    gap = dup = 0
    freq_base = 0.01 if cfg.somatic else cfg.frequency_thr

    # candidate mask to keep the python loop sparse: positions that can
    # emit a SUB/INS/DEL record. Everything else only advances the
    # gap/dup run-length counters, which the vectorized fast path below
    # reproduces exactly.
    if cfg.gvcf or cfg.monomorphic:
        interesting = np.ones(L, dtype=bool)
    else:
        bd_pos = np.repeat(block_depth, BLOCK_SIZE)[:L]
        cov_thr_v = np.maximum(bd_pos >> 1, cfg.min_allele_depth)
        if cfg.somatic:
            cov_thr_v = np.full(L, cfg.min_allele_depth, dtype=np.int64)
        freq_thr_v = np.maximum(np.ceil(cov_all * freq_base).astype(np.int64),
                                cfg.min_allele_depth)
        rc = ref_codes[:L].astype(np.int32)
        nonref_max = np.full(L, -1, dtype=np.int32)
        for c in range(4):
            np.maximum(nonref_max, np.where(rc == c, -1, acgt[c]),
                       out=nonref_max)
        interesting = (cov_all >= cov_thr_v) & (nonref_max >= freq_thr_v)
        for k in ins_keys + del_keys:
            lo = max(0, k - 5)
            interesting[lo:min(L, k + 6)] = True

    # per-position run state: 0 = gap (cov==0, multi==0), 1 = dup
    # (cov==0, multi>0), 2 = covered (flushes both counters)
    state_arr = np.where(cov_all > 0, 2,
                         np.where(multi > 0, 1, 0)).astype(np.int8)

    cand_idx = np.nonzero(interesting)[0]
    cand_pos = 0
    g_pos = 0
    while g_pos < L:
        if not interesting[g_pos]:
            # fast path: no record can be emitted here — replay the
            # gap/dup counter semantics (ref: cpp:632-651) over runs.
            while cand_pos < cand_idx.size and cand_idx[cand_pos] < g_pos:
                cand_pos += 1
            nxt = int(cand_idx[cand_pos]) if cand_pos < cand_idx.size else L
            pos = g_pos
            for st, length in _runs_int(state_arr[g_pos:nxt]):
                if st == 0:
                    if dup > 0:
                        if dup > cfg.min_cnv_size:
                            out.append(Variant(pos - dup, VAR_CNV, DP=dup & 0xFFFF))
                        dup = 0
                    gap += length
                elif st == 1:
                    if gap > 0:
                        if gap >= cfg.min_unmapped_size:
                            out.append(Variant(pos - gap, VAR_UMR, DP=gap & 0xFFFF))
                        gap = 0
                    dup += length
                else:  # covered: flush both at the first position
                    if gap > 0:
                        if gap >= cfg.min_unmapped_size:
                            out.append(Variant(pos - gap, VAR_UMR, DP=gap & 0xFFFF))
                        gap = 0
                    if dup > 0:
                        if dup > cfg.min_cnv_size:
                            out.append(Variant(pos - dup, VAR_CNV, DP=dup & 0xFFFF))
                        dup = 0
                pos += length
            g_pos = nxt
            continue
        # scalar mirror of the loop body
        cov = int(cov_all[g_pos])
        b_normal = True
        ref_base = int(ref_codes[g_pos])
        cov_thr = int(block_depth[g_pos // BLOCK_SIZE]) >> 1
        if cov_thr < cfg.min_allele_depth:
            cov_thr = cfg.min_allele_depth
        if cfg.somatic and cov_thr > cfg.min_allele_depth:
            cov_thr = cfg.min_allele_depth
        ins_thr = int(cov_thr * 0.25)
        if ins_thr < cfg.min_allele_depth:
            ins_thr = cfg.min_allele_depth
        del_thr = int(cov_thr * 0.35)
        if del_thr < cfg.min_allele_depth:
            del_thr = cfg.min_allele_depth
        ins_freq, ins_str = get_area_ind_frequency(g_pos, profile.insert_map, ins_keys)
        del_freq, del_str = get_area_ind_frequency(g_pos, profile.delete_map, del_keys)

        if ins_freq >= ins_thr:
            v = Variant(g_pos, VAR_INS)
            v.DP = int(block_depth[g_pos // BLOCK_SIZE])
            v.AD_alt = ins_freq
            if v.DP < v.AD_alt:
                v.DP = v.AD_alt
            v.ALTstr = ins_str
            v.AD_ref = v.DP - v.AD_alt
            v.GenoType = determine_genotype(cfg.ploidy, v.DP, v.AD_alt, 1)
            v.qscore = (int(100.0 * v.AD_alt / cov) & 0xFF) if cov > 0 else 0
            b_normal = False
            out.append(v)
        if del_freq >= del_thr:
            v = Variant(g_pos, VAR_DEL)
            v.DP = int(block_depth[g_pos // BLOCK_SIZE])
            v.AD_alt = del_freq
            if v.DP < v.AD_alt:
                v.DP = v.AD_alt
            v.ALTstr = del_str
            v.AD_ref = v.DP - v.AD_alt
            v.GenoType = determine_genotype(cfg.ploidy, v.DP, v.AD_alt, 1)
            v.qscore = (int(100.0 * v.AD_alt / cov) & 0xFF) if cov > 0 else 0
            b_normal = False
            out.append(v)
        # SUB
        if cov >= cov_thr:
            freq_thr = int(math.ceil(cov * freq_base))
            if freq_thr < cfg.min_allele_depth:
                freq_thr = cfg.min_allele_depth
            vec = []
            for code, base in enumerate("ACGT"):
                if ref_base != code and int(acgt[code, g_pos]) >= freq_thr:
                    vec.append((base, int(acgt[code, g_pos])))
            ad_ref = int(acgt[ref_base, g_pos]) if ref_base < 4 else 0
            if len(vec) == 1:
                gt = determine_genotype(cfg.ploidy, cov, vec[0][1], 1)
                if gt != 0:
                    v = Variant(g_pos, VAR_SUB, DP=cov, AD_alt=vec[0][1],
                                AD_ref=ad_ref, GenoType=gt, ALTstr=vec[0][0])
                    v.qscore = (int(35.0 * v.AD_alt / (cov * 0.05)) if cfg.somatic
                                else int(35.0 * v.AD_alt / cov)) & 0xFF
                    b_normal = False
                    out.append(v)
            elif len(vec) == 2 and (vec[0][1] + vec[1][1]) >= int(cov * GENOTYPE_RATIO):
                ad_alt = vec[0][1] + vec[1][1]
                gt = determine_genotype(cfg.ploidy, cov, ad_alt, 2)
                if gt != 0:
                    v = Variant(g_pos, VAR_SUB, DP=cov, AD_alt=ad_alt,
                                AD_ref=ad_ref, GenoType=gt,
                                ALTstr=f"{vec[0][0]},{vec[1][0]}")
                    v.qscore = (int(35.0 * v.AD_alt / (cov * 0.05)) if cfg.somatic
                                else int(35.0 * v.AD_alt / cov)) & 0xFF
                    b_normal = False
                    out.append(v)
        # gap / dup run-length state (ref: cpp:632-651)
        if cov == 0 and int(multi[g_pos]) == 0:
            b_normal = False
            gap += 1
        elif gap > 0:
            if gap >= cfg.min_unmapped_size:
                out.append(Variant(g_pos - gap, VAR_UMR, DP=gap & 0xFFFF))
            gap = 0
        if cov == 0 and int(multi[g_pos]) > 0:
            b_normal = False
            dup += 1
        elif dup > 0:
            if dup > cfg.min_cnv_size:
                out.append(Variant(g_pos - dup, VAR_CNV, DP=dup & 0xFFFF))
            dup = 0
        if cfg.gvcf and b_normal and cov > 0:
            if not out or out[-1].VarType != VAR_NOR:
                out.append(Variant(g_pos, VAR_NOR, DP=cov, AD_alt=cov))
            else:
                if out[-1].AD_alt > cov:
                    out[-1].AD_alt = cov
        if cfg.monomorphic and b_normal and cov > 0:
            v = Variant(g_pos, VAR_MON, DP=cov,
                        GenoType=determine_genotype(cfg.ploidy, cov, 0, 0))
            v.AD_ref = int(acgt[ref_base, g_pos]) if ref_base < 4 else 0
            out.append(v)
        g_pos += 1

    out.sort(key=lambda v: (v.gPos, v.VarType))
    return out


def _runs_int(arr: np.ndarray):
    """Yield (value, run_length) over an integer array."""
    if arr.size == 0:
        return
    changes = np.nonzero(np.diff(arr))[0] + 1
    starts = np.concatenate([[0], changes])
    ends = np.concatenate([changes, [arr.size]])
    for s, e in zip(starts, ends):
        yield int(arr[s]), int(e - s)


def _runs(mask: np.ndarray):
    """Yield (value, run_length) over a boolean array."""
    if mask.size == 0:
        return
    changes = np.nonzero(np.diff(mask))[0] + 1
    starts = np.concatenate([[0], changes])
    ends = np.concatenate([changes, [mask.size]])
    for s, e in zip(starts, ends):
        yield bool(mask[s]), int(e - s)


def remove_consecutive_genomic_variant(variants: List[Variant]) -> List[Variant]:
    """(ref: VariantCalling.cpp:682-694)"""
    out: List[Variant] = []
    for v in variants:
        if out and out[-1].VarType == VAR_NOR and v.VarType == VAR_NOR:
            continue
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# Breakpoints / INV / TNL (ref: VariantCalling.cpp:173-347)
# ---------------------------------------------------------------------------

def identify_break_point_candidates(profile: Profile, two_genome_size: int,
                                    avg_read_length: int) -> List[int]:
    bp = dict(profile.break_point)
    bp[two_genome_size] = bp.get(two_genome_size, 0) + 0
    total_freq = 0
    p_pos, p_cnt = 0, 0
    cans: List[int] = []
    for pos in sorted(bp.keys()):
        cnt = bp[pos]
        if pos - p_pos > avg_read_length:
            if total_freq >= BP_FREQ_THR:
                cans.append(p_pos)
            p_pos = pos
            total_freq = p_cnt = cnt
        else:
            total_freq += cnt
            if p_cnt < cnt:
                p_pos = pos
                p_cnt = cnt
    return cans


def cal_region_cov(profile: Profile, genome_size: int, beg: int, end: int) -> int:
    """(ref: VariantCalling.cpp:207-217)"""
    if beg < 0:
        beg = 0
    if end > genome_size:
        end = genome_size - 1
    if end < beg:
        return 0
    cov = profile.region_cov_sum(beg, end)
    return cov // (end - beg + 1)


def _window_score(sites: List[Tuple[int, int]], lo: int, hi: int,
                  two_genome_size: int, upper_lo: bool = False) -> Optional[int]:
    """Longest run of near-equal dist/1000 values among sites with
    gPos in the window (ref: VariantCalling.cpp:235-268)."""
    keys = [s[0] for s in sites]
    i1 = bisect_right(keys, lo) if upper_lo else bisect_left(keys, lo)
    i2 = bisect_left(keys, hi)
    if i1 >= len(sites) or i2 >= len(sites):
        return None
    vec = sorted(s[1] // 1000 for s in sites[i1:i2])
    vec.append(two_genome_size)
    best = 0
    score = 1
    for j in range(1, len(vec)):
        if vec[j] - vec[j - 1] > 1:
            if score > best:
                best = score
            score = 1
        else:
            score += 1
    return best


def identify_sv(profile: Profile, genome: Genome, bp_cans: List[int],
                sites: List[Tuple[int, int]], var_type: int,
                block_depth: np.ndarray, fragment_size: int,
                avg_read_length: int) -> List[Variant]:
    """Shared body of IdentifyInversions / IdentifyTranslocations
    (ref: VariantCalling.cpp:219-347; the two functions are
    structurally identical)."""
    out: List[Variant] = []
    L = genome.genome_size
    for g_pos in bp_cans:
        l_cov = cal_region_cov(profile, L, g_pos - fragment_size,
                               g_pos - (avg_read_length >> 1))
        cov_thr = int(block_depth[int(g_pos // BLOCK_SIZE)]) >> 1
        l_score = _window_score(sites, g_pos - fragment_size,
                                g_pos - (avg_read_length >> 1),
                                genome.two_genome_size)
        if l_score is None or l_score < cov_thr or l_score < int(l_cov * INV_TNL_THR_RATIO):
            continue
        r_cov = cal_region_cov(profile, L, g_pos, g_pos + fragment_size)
        r_score = _window_score(sites, g_pos, g_pos + fragment_size,
                                genome.two_genome_size, upper_lo=True)
        if r_score is None or r_score < cov_thr or r_score < int(r_cov * INV_TNL_THR_RATIO):
            continue
        if l_score > 0 and r_score > 0:
            v = Variant(g_pos, var_type)
            v.DP = profile.column_size(g_pos)
            v.AD_alt = max(l_score, r_score)
            v.qscore = cal_quality_score(v.AD_alt, cov_thr)
            out.append(v)
    return out
