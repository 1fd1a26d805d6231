"""Mapping engine: per-chunk driver + run statistics.

Host-backend mirror of the reference's worker-thread body
(ref: src/ReadMapping.cpp:416-646) and the post-mapping statistics
(ref: ReadMapping.cpp:648-813). The device backend replaces the
seed/extend hot path with batched device kernels but reuses this
driver's orchestration.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .. import stage_prof
from ..config import Config
from ..dna import CODE2CHAR
from ..genome import Genome
from ..index.fmindex import FMIndex
from ..ops.nw_host import nw_alignment
from ..ops.ksw2_host import ksw2_alignment
from ..io.sam import paired_sam_records, single_sam_records
from .alignment import produce_read_alignment
from .chaining import (check_aln_number, remove_redundant_aln_can,
                       reset_paired_idx, simple_pair_clustering)
from .pairing import (MAX_INVERSION_SIZE, MIN_INVERSION_SIZE,
                      MIN_TRANSLOCATION_SIZE, check_paired_alignment_distance,
                      gen_coordinate_pair, mask_unpaired_aln_can)
from .profile import Profile
from .read import ReadState
from .rescue import alignment_rescue
from .seeding import identify_simple_pairs


@dataclasses.dataclass
class RunStats:
    total_reads: int = 0
    total_mapped: int = 0
    total_paired: int = 0
    total_paired_distance: int = 0
    read_length_sum: int = 0
    avg_dist: int = 1000          # ref: ReadMapping.cpp:20
    avg_cov: int = 0
    avg_read_length: int = 0
    fragment_size: int = 500


class MappingEngine:
    def __init__(self, idx: FMIndex, cfg: Config, backend: Optional[object] = None,
                 use_native: Optional[bool] = None):
        self.idx = idx
        self.cfg = cfg
        self.genome = Genome.from_packed(idx.ref)
        self.ref_chars = CODE2CHAR[idx.ref.ref_sequence_codes()]
        self.profile = Profile(self.genome.genome_size) if cfg.vcf_output else None
        self.stats = RunStats(fragment_size=cfg.fragment_size)
        self.inv_sites: List[Tuple[int, int]] = []   # (gPos, dist)
        self.tnl_sites: List[Tuple[int, int]] = []
        self.aligner = nw_alignment if cfg.use_nw else ksw2_alignment
        # persistent DiscordPair state (mirrors the function-local struct
        # reused across iterations in ReadMapping.cpp:420; its stale gPos
        # is observable through the brace bug at ReadMapping.cpp:502)
        self._discord_gpos = 0
        self.backend = backend  # optional device batch runner
        self.device_evidence = None  # device evidence planes (stream path)
        self.native = None      # optional C++ chunk processor
        if use_native is None:
            use_native = cfg.use_native
        if use_native:
            # a native build or load failure raises: no silent switch to
            # the (much slower) Python pipeline
            from ..native import NativeEngine
            prof = self.profile if self.profile is not None else Profile(1)
            self.native = NativeEngine(self.genome, prof, self.ref_chars, cfg)
        stage_prof.reset()

    def reset_run(self) -> None:
        """In-place reset for engine reuse (long-running / multi-run
        use): zero the genome-sized planes instead of reallocating them
        — on this VM class re-faulting multi-GB fresh allocations costs
        tens of seconds per run, while memset of resident pages runs at
        RAM speed. The C++ ctx keeps its borrowed plane pointers (they
        don't move) and clears its own per-run accumulators. The stage
        registry restarts here too (stage_prof)."""
        stage_prof.reset()
        with stage_prof.span("reset"):
            self._reset_run()

    def _reset_run(self) -> None:
        p = self.profile
        if p is not None:
            for a in (p.acgt, p.multi_hit, p.read_count,
                      p.F1, p.R2, p.F2, p.R1,
                      p.F1_diff, p.R2_diff, p.F2_diff, p.R1_diff,
                      p.multi_diff, getattr(p, "exact_diff", None)):
                if a is not None:
                    a[...] = 0
            p.break_point.clear()
            p.insert_map.clear()
            p.delete_map.clear()
            p.host_dirty = False
            p.dirty_probes.clear()
        self.stats = RunStats(fragment_size=self.cfg.fragment_size)
        self.inv_sites.clear()
        self.tnl_sites.clear()
        self._discord_gpos = 0
        self.device_evidence = None
        if self.native is not None:
            self.native.reset_run()

    def enable_diff_profile(self) -> None:
        """Stream fast path: O(1)/read evidence accumulation — exact-match
        coverage and range counters as +1/-1 diff endpoints, materialized
        once at finalize (see csrc/mc_native.cpp mc_set_diff_mode)."""
        if self.profile is None or self.profile.F1_diff is not None:
            return
        self.native.enable_diff_mode(self.profile)

    # ------------------------------------------------------------------
    def preseed_submit(self, reads: List[ReadState], pair_end: bool):
        """Enqueue device seeding for a super-batch (async dispatch).
        Mate-2 reads are reverse-complemented first, exactly as the
        per-read path does (ref: ReadMapping.cpp:451)."""
        if self.backend is None:
            return None
        if pair_end and len(reads) % 2 == 0:
            for j in range(1, len(reads), 2):
                if not reads[j].is_reversed:
                    reads[j].reverse_orientation()
                    reads[j].is_reversed = True
        codes = [r.codes() for r in reads]
        return (reads, self.backend.submit(codes))

    def preseed_wait(self, token) -> None:
        if token is None:
            return
        reads, pending = token
        seeds = self.backend.collect(pending)
        for r, s in zip(reads, seeds):
            r.pre_seeds = s

    def preseed(self, reads: List[ReadState], pair_end: bool) -> None:
        self.preseed_wait(self.preseed_submit(reads, pair_end))

    def _map_one(self, read: ReadState) -> None:
        if read.pre_seeds is not None:
            from .seeding import FragPair
            rp, gp, ln = read.pre_seeds
            pairs = [FragPair(True, int(r), int(g), int(l), int(l),
                              int(g) - int(r))
                     for r, g, l in zip(rp, gp, ln)]
            pairs.sort(key=lambda f: (f.PosDiff, f.rPos))
            pairs.append(FragPair(True, 0, self.idx.seq_len, 0, 0,
                                  self.idx.seq_len))
        else:
            pairs = identify_simple_pairs(self.idx, read.codes())
        read.cans = simple_pair_clustering(self.genome, read.rlen, pairs,
                                           self.cfg.max_pos_diff)

    def _seed_arrays(self, read: ReadState):
        if read.pre_seeds is not None:
            return read.pre_seeds
        pairs = identify_simple_pairs(self.idx, read.codes())[:-1]
        return (np.array([p.rPos for p in pairs], dtype=np.int32),
                np.array([p.gPos for p in pairs], dtype=np.int64),
                np.array([p.rLen for p in pairs], dtype=np.int32))

    def process_chunk_native(self, reads: List[ReadState], pair_end: bool) -> List[str]:
        cfg = self.cfg
        is_paired = pair_end and len(reads) % 2 == 0
        if is_paired:
            for j in range(1, len(reads), 2):
                if not reads[j].is_reversed:
                    reads[j].reverse_orientation()
                    reads[j].is_reversed = True
        triples = [self._seed_arrays(r) for r in reads]
        counts = np.array([len(t[0]) for t in triples], dtype=np.int32)
        if len(triples):
            rpos = np.concatenate([t[0] for t in triples]).astype(np.int32)
            gpos = np.concatenate([t[1] for t in triples]).astype(np.int64)
            slen = np.concatenate([t[2] for t in triples]).astype(np.int32)
        else:
            rpos = np.zeros(0, np.int32)
            gpos = np.zeros(0, np.int64)
            slen = np.zeros(0, np.int32)
        sam_text, st = self.native.process_chunk(
            reads, is_paired, self.stats.avg_dist, counts, rpos, gpos, slen)
        s = self.stats
        s.total_reads += len(reads)
        s.total_mapped += st["mapped"]
        s.total_paired += st["paired"]
        s.total_paired_distance += st["dist_sum"]
        s.read_length_sum += st["rlen_sum"]
        if s.total_paired > 1000:
            s.avg_dist = int(s.total_paired_distance / s.total_paired + 0.5)
        self.inv_sites.extend(st["inv"])
        self.tnl_sites.extend(st["tnl"])
        return sam_text.splitlines()

    def process_chunk_paired(self, reads: List[ReadState]) -> List[str]:
        cfg = self.cfg
        genome = self.genome
        L = genome.genome_size
        two_l = genome.two_genome_size
        mapped_num = paired_num = 0
        my_dist_sum = my_rlen_sum = 0

        for i in range(0, len(reads) - 1, 2):
            r1, r2 = reads[i], reads[i + 1]
            self._map_one(r1)
            if not r2.is_reversed:
                r2.reverse_orientation()
                r2.is_reversed = True
            self._map_one(r2)
            reset_paired_idx(r1.cans)
            reset_paired_idx(r2.cans)

            est = int(self.stats.avg_dist * 1.5)
            n = check_paired_alignment_distance(est, r1.cans, r2.cans)
            if n == 0:
                n = alignment_rescue(genome, self.ref_chars, est, r1, r2)
            if n == 0:
                remove_redundant_aln_can(r1.cans)
                remove_redundant_aln_can(r2.cans)
            else:
                mask_unpaired_aln_can(r1.cans, r2.cans)

            if produce_read_alignment(genome, self.ref_chars, r1, self.aligner,
                                      cfg.max_mismatch_rate):
                mapped_num += 1
            if produce_read_alignment(genome, self.ref_chars, r2, self.aligner,
                                      cfg.max_mismatch_rate):
                mapped_num += 1

            cp = gen_coordinate_pair(r1.cans, r2.cans)
            if cp.dist != 0 and cp.gPos1 != -1 and cp.gPos2 != -1:
                if cp.gPos1 < L and cp.gPos2 >= L:
                    if cfg.vcf_output:
                        dist = abs(two_l - cp.gPos1 - cp.gPos2)
                        if MIN_INVERSION_SIZE < dist < MAX_INVERSION_SIZE:
                            self._discord_gpos = cp.gPos1
                            self.inv_sites.append((self._discord_gpos, dist))
                elif cp.gPos1 >= L and cp.gPos2 < L:
                    if cfg.vcf_output:
                        dist = abs(two_l - cp.gPos1 - cp.gPos2)
                        if MIN_INVERSION_SIZE < dist < MAX_INVERSION_SIZE:
                            self._discord_gpos = cp.gPos2
                        # push happens regardless (brace bug,
                        # ReadMapping.cpp:502) with possibly stale gPos
                        self.inv_sites.append((self._discord_gpos, dist))
                elif cp.dist > MIN_TRANSLOCATION_SIZE:
                    if cfg.vcf_output:
                        if cp.gPos1 < L and cp.gPos2 < L:
                            self.tnl_sites.append((cp.gPos1, cp.dist))
                            self.tnl_sites.append((cp.gPos2, cp.dist))
                            self._discord_gpos = cp.gPos2
                        elif cp.gPos1 >= L and cp.gPos2 >= L:
                            self.tnl_sites.append((two_l - cp.gPos1, cp.dist))
                            self.tnl_sites.append((two_l - cp.gPos2, cp.dist))
                            self._discord_gpos = two_l - cp.gPos2
                else:
                    my_rlen_sum += r1.rlen + r2.rlen
                    paired_num += 1
                    my_dist_sum += cp.dist

        sam: List[str] = []
        if cfg.sam_file or cfg.bam_file:
            for i in range(0, len(reads) - 1, 2):
                sam.extend(paired_sam_records(genome, reads[i], reads[i + 1],
                                              cfg.unique_only, reads[i].qual is not None))
        st = self.stats
        st.total_reads += len(reads)
        st.total_mapped += mapped_num
        st.total_paired += paired_num
        st.total_paired_distance += my_dist_sum
        st.read_length_sum += my_rlen_sum
        if st.total_paired > 1000:
            st.avg_dist = int(st.total_paired_distance / st.total_paired + 0.5)

        if cfg.vcf_output:
            for i, rd in enumerate(reads):
                if rd.score == 0:
                    continue
                if check_aln_number(rd.cans) == 1:
                    self.profile.update_profile(genome, i % 2 == 0, rd, rd.cans,
                                                cfg.max_duplicate, cfg.max_clip_size)
                else:
                    self.profile.update_multi_hit(genome, rd.cans)
        return sam

    def process_chunk_single(self, reads: List[ReadState]) -> List[str]:
        cfg = self.cfg
        genome = self.genome
        mapped_num = 0
        for rd in reads:
            self._map_one(rd)
            remove_redundant_aln_can(rd.cans)
            if produce_read_alignment(genome, self.ref_chars, rd, self.aligner,
                                      cfg.max_mismatch_rate):
                mapped_num += 1
        sam: List[str] = []
        if cfg.sam_file or cfg.bam_file:
            for rd in reads:
                sam.extend(single_sam_records(genome, rd, cfg.unique_only,
                                              rd.qual is not None))
        self.stats.total_reads += len(reads)
        self.stats.total_mapped += mapped_num
        if cfg.vcf_output:
            for rd in reads:
                if rd.score == 0:
                    continue
                if check_aln_number(rd.cans) == 1:
                    self.profile.update_profile(genome, True, rd, rd.cans,
                                                cfg.max_duplicate, cfg.max_clip_size)
                else:
                    self.profile.update_multi_hit(genome, rd.cans)
        return sam

    def process_chunk(self, reads: List[ReadState], pair_end: bool) -> List[str]:
        if self.native is not None:
            return self.process_chunk_native(reads, pair_end)
        if pair_end and len(reads) % 2 == 0:
            return self.process_chunk_paired(reads)
        return self.process_chunk_single(reads)

    # ------------------------------------------------------------------
    def finalize(self) -> None:
        """Post-mapping statistics (ref: ReadMapping.cpp:627-643,767-790)."""
        cfg = self.cfg
        if self.device_evidence is not None and (
                cfg.monomorphic or cfg.obs_pos >= 0 or cfg.obr_beg >= 0):
            # modes whose record emission walks dense planes: download
            # them into the host profile and take the legacy path
            self.device_evidence.download_into(self.profile)
            self.device_evidence = None
        if (self.profile is not None and self.profile.F1_diff is not None
                and self.device_evidence is None):
            self.profile.finalize_diffs(self.idx.ref.ref_sequence_codes())
        if (cfg.vcf_output and self.device_evidence is not None
                and hasattr(self.device_evidence, "start_scan")):
            # dispatch the caller scan + its speculative D2H now so the
            # link round trip overlaps the host-side stats/sort work
            # below and the event-map prep in device_identify
            self.device_evidence.start_scan()
        self.tnl_sites.sort(key=lambda p: p[0])
        self.inv_sites.sort(key=lambda p: p[0])
        st = self.stats
        if self.cfg.vcf_output and self.device_evidence is not None:
            _, _, _, _, scalars = self.device_evidence.scan()
            n_aligned = int(scalars[2])
            if n_aligned > 0:
                st.avg_cov = int(int(scalars[3]) / n_aligned + 0.5)
        elif self.cfg.vcf_output and self.profile is not None:
            cov = self.profile.acgt.sum(axis=0)
            aligned = cov > 0
            n_aligned = int(aligned.sum())
            if n_aligned > 0:
                st.avg_cov = int(cov[aligned].sum() / n_aligned + 0.5)
        if st.total_reads > 0 and st.total_paired > 0:
            st.avg_dist = int(st.total_paired_distance / st.total_paired + 0.5)
            st.avg_read_length = int(st.read_length_sum / (st.total_paired * 2) + 0.5)
            st.fragment_size = st.avg_dist + st.avg_read_length
        else:
            st.avg_dist = st.avg_read_length = 0

    def materialize_profile(self) -> None:
        """Download the device evidence planes into the host profile and
        fold (tests, observe dumps, fallback modes); no-op otherwise."""
        if self.device_evidence is not None:
            self.device_evidence.download_into(self.profile)
            self.device_evidence = None
            if self.profile.F1_diff is not None:
                self.profile.finalize_diffs(self.idx.ref.ref_sequence_codes())

    def duplication_rate(self) -> Tuple[int, int]:
        """(ref: ReadMapping.cpp:670-687)"""
        rc = self.profile.read_count
        mask = rc > 0
        n = int(mask.sum())
        total = int(rc[mask].sum()) - n
        return total, n
