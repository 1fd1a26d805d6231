"""VCF writer (ref: src/VariantCalling.cpp:139-171, 409-500)."""
from __future__ import annotations

from typing import List, TextIO

import numpy as np

from ..calling.caller import (GENOTYPE_LABEL, VAR_CNV, VAR_DEL, VAR_INS,
                              VAR_INV, VAR_MON, VAR_NOR, VAR_SUB, VAR_TNL,
                              VAR_UMR, Variant)
from ..config import Config
from ..genome import Genome
from ..pipeline.profile import Profile


def write_meta(f: TextIO, cfg: Config, genome: Genome, version: str,
               cmd_line: str) -> None:
    """(ref: VariantCalling.cpp:139-171)"""
    f.write("##fileformat=VCFv4.2\n")
    f.write(f"##reference={cfg.ref_fasta or cfg.index_prefix}\n")
    f.write(f"##source=MapCaller {version}\n")
    f.write(f'##command_line="{cmd_line}"\n')
    f.write('##ALT=<ID=NON_REF,Description="Represents any possible alternative allele at this location">\n')
    f.write('##INFO=<ID=RC,Number=1,Type=Integer,Description="Number of reads with start coordinate at this position.">\n')
    f.write('##INFO=<ID=NTFREQ,Number=4,Type=Integer,Description="base depth">\n')
    f.write('##INFO=<ID=END,Number=1,Type=Integer,Description="Last position(inclusive) of the reported block">\n')
    f.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Read depth">\n')
    f.write('##INFO=<ID=TYPE,Number=A,Type=String,Description="The type of allele, either snv, ins, del, or BP(breakpoint).">\n')
    f.write('##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths for the ref and alt alleles in the order listed">\n')
    f.write('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Approximate read depth">\n')
    f.write('##FORMAT=<ID=AF,Number=A,Type=Float,Description="Allele fractions of alternate alleles">\n')
    f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
    f.write('##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Normalized, Phred - scaled likelihoods for genotypes as defined in the VCF specification">\n')
    if cfg.gvcf:
        f.write('##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Minimum depth in gVCF output block.">\n')
    f.write('##FORMAT=<ID=F1R2,Number=R,Type=Integer,Description="Count of reads in F1R2 pair orientation supporting each allele">\n')
    f.write('##FORMAT=<ID=F2R1,Number=R,Type=Integer,Description="Count of reads in F2R1 pair orientation supporting each allele">\n')
    f.write('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">\n')
    f.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
    f.write('##FILTER=<ID=REF,Description="Genotyping model thinks this site is reference.">\n')
    f.write('##FILTER=<ID=BreakPoint,Description="It is predicted as a breakpoint">\n')
    f.write(f'##FILTER=<ID=DUP,Description="Duplicated regions(>={cfg.min_cnv_size}bp).">\n')
    f.write(f'##FILTER=<ID=Gaps,Description="Region without any read alignment(>={cfg.min_unmapped_size}bp).">\n')
    f.write('##FILTER=<ID=q10,Description="Confidence score below 10">\n')
    if cfg.apply_filter:
        f.write('##FILTER=<ID=bad_haplotype,Description="Variants with variable frequencies on same haplotype">\n')
        f.write('##FILTER=<ID=str_contraction,Description="Variant appears in repetitive region">\n')
    for i, name in enumerate(genome.names):
        f.write(f"##contig=<ID={name},length={int(genome.lengths[i])}>\n")
    f.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{cfg.sample_id}\n")


def _check_nearby_variant(variants: List[Variant], i: int, dist: int) -> bool:
    """(ref: VariantCalling.cpp:349-365)"""
    n = len(variants)
    if i == 0:
        return i + 1 < n and variants[i + 1].gPos - variants[i].gPos <= dist
    if i == n - 1:
        return variants[i].gPos - variants[i - 1].gPos <= dist
    return (variants[i + 1].gPos - variants[i].gPos <= dist
            or variants[i].gPos - variants[i - 1].gPos <= dist)


def _check_bad_haplotype(variants: List[Variant], i: int, dist: int) -> bool:
    """(ref: VariantCalling.cpp:367-393)"""
    n = len(variants)
    for j in range(i + 1, n):
        if variants[j].gPos - variants[i].gPos > dist:
            break
        if variants[j].VarType == 0:
            diff = abs(variants[i].AD_alt - variants[j].AD_alt)
            big = (variants[i].AD_alt >> 2 if variants[i].AD_alt > variants[j].AD_alt
                   else variants[j].AD_alt >> 2)
            if diff > 5 and big:
                return True
            break
    for j in range(i - 1, -1, -1):
        if variants[i].gPos - variants[j].gPos > dist:
            break
        if variants[j].VarType == 0:
            diff = abs(variants[i].AD_alt - variants[j].AD_alt)
            big = (int(variants[i].AD_alt * 0.33) if variants[i].AD_alt > variants[j].AD_alt
                   else int(variants[j].AD_alt * 0.33))
            if diff > 10 and big:
                return True
            break
    return False


def _determine_filter(cfg: Config, profile: Profile, variants: List[Variant],
                      i: int) -> str:
    """(ref: VariantCalling.cpp:409-427)"""
    v = variants[i]
    parts = []
    if v.qscore < 10:
        parts.append("q10")
    elif v.VarType == VAR_SUB and v.AD_alt < 10 and _check_nearby_variant(variants, i, 10):
        parts.append("q10")
    elif v.VarType in (VAR_INS, VAR_DEL) and v.AD_alt < 5 and _check_nearby_variant(variants, i, 10):
        parts.append("q10")
    if cfg.apply_filter:
        if int(profile.multi_hit[v.gPos]) > int(profile.column_size(v.gPos) * 0.05):
            parts.append("str_contraction")
        if _check_bad_haplotype(variants, i, 100):
            parts.append("bad_haplotype")
    return ";".join(parts) if parts else "PASS"


def _f32_2f(x: float) -> str:
    """printf %.2f of a value that passed through a C float variable."""
    return f"{float(np.float32(x)):.2f}"


def write_variants(f: TextIO, cfg: Config, genome: Genome, profile: Profile,
                   ref_chars: np.ndarray, variants: List[Variant]):
    """(ref: VariantCalling.cpp:429-500). Returns per-type counts."""
    counts = [0] * 256
    n = len(variants)
    for i, v in enumerate(variants):
        g = v.gPos
        ci, pos = genome.determine_coordinate(g)
        chrom = genome.names[ci]
        ref_c = chr(ref_chars[g])
        if v.VarType < 3:
            filter_str = _determine_filter(cfg, profile, variants, i)
        else:
            filter_str = "."
        rc = int(profile.read_count[g])
        A, C, G, T = (int(profile.acgt[k, g]) for k in range(4))
        F1, R2, F2, R1 = (int(profile.F1[g]), int(profile.R2[g]),
                          int(profile.F2[g]), int(profile.R1[g]))
        gt = GENOTYPE_LABEL[v.GenoType]
        if v.VarType == VAR_SUB:
            counts[VAR_SUB] += 1
            af = _f32_2f(1.0 * v.AD_alt / v.DP)
            f.write(f"{chrom}\t{pos}\t.\t{ref_c}\t{v.ALTstr}\t{v.qscore}\t{filter_str}\t"
                    f"RC={rc};NTFREQ={A},{C},{G},{T};TYPE=snv\tGT:GQ:DP:AD:AF:F1R2:F2R1\t"
                    f"{gt}:{v.qscore}:{v.DP}:{v.AD_ref},{v.AD_alt}:{af}:{F1},{R2}:{F2},{R1}\n")
        elif v.VarType == VAR_INS:
            if len(v.ALTstr) > 5:
                continue
            counts[VAR_INS] += 1
            af = _f32_2f(1.0 * v.AD_alt / v.DP)
            f.write(f"{chrom}\t{pos}\t.\t{ref_c}\t{ref_c}{v.ALTstr}\t{v.qscore}\t{filter_str}\t"
                    f"RC={rc};TYPE=ins\tGT:GQ:DP:AD:AF:F1R2:F2R1\t"
                    f"{gt}:{v.qscore}:{v.DP}:{v.AD_ref},{v.AD_alt}:{af}:{F1},{R2}:{F2},{R1}\n")
        elif v.VarType == VAR_DEL:
            if len(v.ALTstr) > 5:
                continue
            counts[VAR_DEL] += 1
            af = _f32_2f(1.0 * v.AD_alt / v.DP)
            f.write(f"{chrom}\t{pos}\t.\t{ref_c}{v.ALTstr}\t{ref_c}\t{v.qscore}\t{filter_str}\t"
                    f"RC={rc};TYPE=del\tGT:GQ:DP:AD:AF:F1R2:F2R1\t"
                    f"{gt}:{v.qscore}:{v.DP}:{v.AD_ref},{v.AD_alt}:{af}:{F1},{R2}:{F2},{R1}\n")
        elif v.VarType == VAR_TNL:
            counts[VAR_TNL] += 1
            f.write(f"{chrom}\t{pos}\t.\t{ref_c}\t<TNL>\t30\tBreakPoint\tTYPE=BP\tGT:GQ:DP:AD\t.:.:0:.\n")
        elif v.VarType == VAR_INV:
            counts[VAR_INV] += 1
            f.write(f"{chrom}\t{pos}\t.\t{ref_c}\t<INV>\t30\tBreakPoint\tTYPE=BP\tGT:GQ:DP:AD\t.:.:0:.\n")
        elif v.VarType == VAR_CNV:
            if v.DP >= cfg.min_cnv_size:
                f.write(f"{chrom}\t{pos}\t.\t{ref_c}\t<*>\t0\tDUP\tEND={pos + v.DP - 1}\tGT:GQ:DP:AD\t.:.:0:.\n")
        elif v.VarType == VAR_UMR:
            if v.DP >= cfg.min_unmapped_size:
                f.write(f"{chrom}\t{pos}\t.\t{ref_c}\t<*>\t0\tGaps\tEND={pos + v.DP - 1}\tGT:GQ:DP:AD\t.:.:0:.\n")
        elif v.VarType == VAR_NOR:
            g_end = int(genome.fwd_loc[ci]) + int(genome.lengths[ci]) - 1
            if i + 1 < n and variants[i + 1].gPos < g_end:
                g_end = variants[i + 1].gPos - 1
            end_pos = genome.determine_coordinate(g_end)[1]
            f.write(f"{chrom}\t{pos}\t.\t{ref_c}\t<*>\t0\tREF\tEND={end_pos};DP={v.DP};MIN_DP={v.AD_alt}\t"
                    f"GT:GQ:DP:AD\t.:.:0:.\n")
        elif v.VarType == VAR_MON:
            f.write(f"{chrom}\t{pos}\t.\t{ref_c}\t.\t0\tREF\tDP={v.DP};RC={rc};NTFREQ={A},{C},{G},{T}\t"
                    f"GT:F1R2:F2R1\t{gt}:{F1},{R2}:{F2},{R1}\n")
    return counts
