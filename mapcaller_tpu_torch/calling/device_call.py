"""Variant calling from the device-resident evidence planes (a copy of
mapcaller_tpu/calling/device_call.py; host code).

Dense candidate discovery runs on the card (scan_device.build_scan_kernel
over the evidence planes, ref: src/VariantCalling.cpp:550-680); this module
turns the sparse downloads into the exact record set the host caller
produces: SUB records re-check the float64 thresholds the device mask
conservatively supersets, INS/DEL records use the host event maps +
downloaded coverage columns, UMR/CNV records replay the run-length
semantics (incl. the never-flushed trailing run, cpp:632-651).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import stage_prof
from ..config import Config
from ..genome import Genome
from .caller import (BLOCK_SIZE, VAR_CNV, VAR_DEL, VAR_INS, VAR_NOR,
                     VAR_SUB, VAR_UMR, Variant, determine_genotype,
                     get_area_ind_frequency, identify_break_point_candidates)
from .scan_device import CAND_CAP, RUN_CAP, SparseProfile


def device_identify(engine, cfg: Config, genome: Genome
                    ) -> Optional[Tuple[np.ndarray, SparseProfile,
                                        List[Variant]]]:
    """Returns (block_depth, sparse_profile, variants) or None when the
    device result capacity overflowed (caller falls back to the full
    plane download)."""
    dev = engine.device_evidence
    L = genome.genome_size
    host_prof = engine.profile
    # host-side prep first: the finalize and scan queued by
    # engine.finalize may still run on the card, so the event-map sorts
    # and breakpoint clustering here overlap them
    with stage_prof.span("call_prep"):
        ins_keys = sorted(host_prof.insert_map.keys())
        del_keys = sorted(host_prof.delete_map.keys())
        bp_cans = identify_break_point_candidates(
            host_prof, genome.two_genome_size, engine.stats.avg_read_length)

    with stage_prof.span("call_device"):
        bd, cand_idx, run_start, run_val, scalars = dev.scan()
    n_cand, n_runs = int(scalars[0]), int(scalars[1])
    if n_cand > CAND_CAP or n_runs > RUN_CAP:
        return None
    with stage_prof.span("call_prep"):
        cand = cand_idx[:n_cand].astype(np.int64)
        run_start = run_start[:n_runs].astype(np.int64)
        run_val = run_val[:n_runs]

        positions = set(cand.tolist())
        positions.update(k for k in ins_keys if 0 <= k < L)
        positions.update(k for k in del_keys if 0 <= k < L)
        positions.update(int(s) for s in run_start.tolist())
        positions.update(int(g) for g in bp_cans if 0 <= g < L)

        prefix_pts = set()
        frag = engine.stats.fragment_size
        arl = engine.stats.avg_read_length
        for g in bp_cans:
            for beg, end in ((g - frag, g - (arl >> 1)), (g, g + frag)):
                b = max(beg, 0)
                e = L - 1 if end > L else end
                if e >= b:
                    prefix_pts.add(b)
                    prefix_pts.add(e + 1)

        pos_arr = np.array(sorted(positions), dtype=np.int64)
        pref_arr = np.array(sorted(prefix_pts), dtype=np.int64)
    # block depths stay device-resident: every consumer below (and
    # identify_sv back in run_calling) indexes them only at positions
    # in pos_arr, so their values ride the same packed copy as the
    # evidence columns instead of an O(L/100) dense download
    with stage_prof.span("call_device"):
        cols, pref = dev.fetch_columns(
            pos_arr if pos_arr.size else np.zeros(1, np.int64),
            pref_arr if pref_arr.size else np.zeros(1, np.int64),
            bd_blocks=pos_arr // BLOCK_SIZE if pos_arr.size else None)
    with stage_prof.span("call_records"):
        col_map = {int(g): cols[i] for i, g in enumerate(pos_arr)}
        pref_map = {int(g): int(pref[i]) for i, g in enumerate(pref_arr)}
        sparse = SparseProfile(host_prof, col_map, pref_map, L)
        block_depth = bd
        ref_codes = engine.idx.ref.ref_sequence_codes()
        out: List[Variant] = []

        # --- SUB records: exact float64 thresholds over the device
        # superset (mirror of caller._identify_variants_vec,
        # cpp:599-630) ---------------------------------------------------
        if cand.size:
            acgt_k = cols[np.searchsorted(pos_arr, cand)][:, :4].T  # [4, K]
            cov_k = cols[np.searchsorted(pos_arr, cand)][:, 9].astype(np.int32)
            rc_k = ref_codes[cand].astype(np.int32)
            freq_base = 0.01 if cfg.somatic else cfg.frequency_thr
            ad = np.int32(cfg.min_allele_depth)
            freq_thr = np.maximum(
                np.ceil(cov_k.astype(np.float64) * freq_base).astype(np.int32),
                ad)
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
            if sub_k.size:
                rb_s = rc_k[sub_k]
                ad_ref_s = np.where(
                    rb_s < 4,
                    np.take_along_axis(acgt_k[:, sub_k],
                                       np.minimum(rb_s, 3)[None, :],
                                       axis=0)[0],
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
                    v = Variant(g, VAR_SUB, DP=cv, AD_alt=alt_cnt,
                                AD_ref=ad_ref, GenoType=gt, ALTstr=alt_str)
                    v.qscore = (int(35.0 * alt_cnt / (cv * 0.05))
                                if cfg.somatic
                                else int(35.0 * alt_cnt / cv)) & 0xFF
                    out.append(v)

        # --- INS/DEL records (mirror, cpp:576-597) -----------------------
        for var_type, ind_map, keys in (
                (VAR_INS, host_prof.insert_map, ins_keys),
                (VAR_DEL, host_prof.delete_map, del_keys)):
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
                cv = int(col_map[g][9])
                v.qscore = (int(100.0 * v.AD_alt / cv) & 0xFF) if cv > 0 else 0
                out.append(v)

        # --- UMR / CNV run-lengths (mirror, cpp:632-651) ------------------
        ends = np.append(run_start[1:], L)
        run_lens = ends - run_start
        flushed = ends < L               # trailing run is never flushed
        gap_m = flushed & (run_val == 0) & (run_lens >= cfg.min_unmapped_size)
        dup_m = flushed & (run_val == 1) & (run_lens > cfg.min_cnv_size)
        for s, ln in zip(run_start[gap_m].tolist(), run_lens[gap_m].tolist()):
            out.append(Variant(int(s), VAR_UMR, DP=int(ln) & 0xFFFF))
        for s, ln in zip(run_start[dup_m].tolist(), run_lens[dup_m].tolist()):
            out.append(Variant(int(s), VAR_CNV, DP=int(ln) & 0xFFFF))

    # --- gVCF NOR blocks on device (mirror of the NOR-block RLE in
    # caller._identify_variants_gvcf_vec; cpp:652-661) --------------------
    if cfg.gvcf:
        with stage_prof.span("call_records"):
            emitted = np.array(sorted({v.gPos for v in out
                                       if v.VarType in (VAR_SUB, VAR_INS,
                                                        VAR_DEL)}),
                               dtype=np.int32)
            brk = set(emitted.tolist())
            brk.update(int(e) for e, m in zip(ends.tolist(),
                                              (gap_m | dup_m).tolist()) if m)
            brk = np.array(sorted(brk), dtype=np.int32)
        with stage_prof.span("call_device"):
            first, mincov, covf = dev.nor_blocks(emitted, brk)
        with stage_prof.span("call_records"):
            BIG = 0x7FFFFFFF
            nor_pos = []
            for k in range(brk.size + 1):
                if first[k] != BIG:
                    v = Variant(int(first[k]), VAR_NOR, DP=int(covf[k]),
                                AD_alt=int(mincov[k]))
                    out.append(v)
                    nor_pos.append(int(first[k]))
            # the VCF writer reads evidence columns at NOR positions too
            missing = [g for g in nor_pos if g not in col_map]
        if missing:
            with stage_prof.span("call_device"):
                mcols, _ = dev.fetch_columns(
                    np.array(missing, dtype=np.int64), np.zeros(1, np.int64))
            for i, g in enumerate(missing):
                col_map[g] = mcols[i]

    with stage_prof.span("call_records"):
        out.sort(key=lambda v: (v.gPos, v.VarType))
    return block_depth, sparse, out
