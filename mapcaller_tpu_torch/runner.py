"""Top-level run driver: load index -> Mapping -> VariantCalling
(ref: src/main.cpp:344-393 orchestration)."""
from __future__ import annotations

import os
import random
import string
import sys
import time

from . import stage_prof
from .cli import VERSION_STR
from .config import Config
from .index.fmindex import FMIndex, build_index, index_exists, load_index
from .io.fastq import iter_chunks
from .io.sam import sam_headers
from .pipeline.engine import MappingEngine
from .pipeline.read import ReadState


def _log(cfg: Config, msg: str) -> None:
    with open(cfg.log_file, "a") as f:
        f.write(msg + "\n")
    sys.stderr.write(msg + "\n")


def run_pipeline(cfg: Config, cmd_line: str) -> int:
    from . import tune_host_allocator
    tune_host_allocator()
    t_start = time.time()
    temp_prefix = None
    if cfg.ref_fasta is not None and cfg.index_prefix is None:
        temp_prefix = "".join(random.choices(string.ascii_lowercase, k=10))
        sys.stderr.write("Build index from the reference...\n")
        build_index(cfg.ref_fasta, temp_prefix)
        cfg.index_prefix = temp_prefix
    if cfg.index_prefix is None or not index_exists(cfg.index_prefix):
        sys.stderr.write("Warning! Please specify a valid reference index!\n")
        return 1
    sys.stderr.write("Load the genome index files...\n")
    idx = load_index(cfg.index_prefix)

    engine = make_engine(idx, cfg)
    metrics = {"version": VERSION_STR, "command": cmd_line}
    try:
        t0 = time.time()
        if cfg.pfm_resume:
            from .pipeline.checkpoint import load_pfm
            load_pfm(engine, cfg.pfm_resume)
            sys.stderr.write(f"Resumed evidence profile from "
                             f"[{cfg.pfm_resume}]; skipping mapping.\n")
        else:
            run_mapping(engine, cfg, t_start)
        metrics["mapping_seconds"] = round(time.time() - t0, 3)
        if engine.profile is not None and (cfg.obs_pos >= 0 or cfg.obr_beg >= 0):
            from .tools import observe
            observe(engine.genome, engine.profile, engine.ref_chars,
                    cfg.obs_pos, cfg.obr_beg, cfg.obr_end)
        if cfg.vcf_output:
            t0 = time.time()
            metrics["variant_counts"] = run_calling(engine, cfg, cmd_line)
            metrics["calling_seconds"] = round(time.time() - t0, 3)
        # checkpoint AFTER calling: save_pfm downloads the device planes
        # into the host profile, which would otherwise send this run's
        # own calling to the host caller
        if cfg.pfm_out and not cfg.pfm_resume:
            from .pipeline.checkpoint import save_pfm
            t0 = time.time()
            save_pfm(engine, cfg.pfm_out)
            metrics["pfm_save_seconds"] = round(time.time() - t0, 3)
    finally:
        if temp_prefix:
            for ext in (".mci.npz", ".mci.bin", ".mci.json", ".occ3.bin"):
                try:
                    os.remove(temp_prefix + ext)
                except OSError:
                    pass
    st = engine.stats
    total_s = time.time() - t_start
    metrics.update(total_reads=st.total_reads, mapped=st.total_mapped,
                   paired=st.total_paired * 2, avg_coverage=st.avg_cov,
                   fragment_size=st.fragment_size,
                   reads_per_sec=round(st.total_reads / max(total_s, 1e-9), 1),
                   total_seconds=round(total_s, 3))
    be = engine.backend
    if be is not None:
        metrics.update(device=str(be.device),
                       n_oracle_reads=be.n_oracle_reads,
                       n_tier_reruns=be.n_tier_reruns)
    _log(cfg, f"All done! It took {int(total_s)} seconds to complete the data analysis.")
    import json as _json
    with open(cfg.log_file, "a") as f:
        f.write(_json.dumps(metrics) + "\n")   # structured summary line
    return 0


def make_engine(idx: FMIndex, cfg: Config):
    """The mapping engine with the device backend on cfg.device, unless
    -backend host asks for the host NumPy/C++ oracle path. A backend that
    cannot be built raises: there is no silent move to the host path."""
    backend = None
    if cfg.backend in ("auto", "device"):
        ndev = cfg.devices
        if ndev == 0:        # -devices auto: every visible card
            import torch
            ndev = (torch.cuda.device_count() if cfg.device == "cuda"
                    else 1)
        if ndev > 1 and cfg.index_shards > 1:
            raise ValueError(
                "-devices N (read data parallelism) and -shards N "
                "(index sharding) are separate scale axes; pick one")
        if ndev > 1:
            from .parallel.devices import MultiDeviceBackend
            backend = MultiDeviceBackend(idx, cfg, ndev)
        else:
            from .pipeline.device_backend import DeviceBackend
            backend = DeviceBackend(idx, cfg)
    return MappingEngine(idx, cfg, backend=backend)


def run_mapping(engine: MappingEngine, cfg: Config, t_start: float) -> None:
    with stage_prof.span("map"):
        _map(engine, cfg, t_start)
    if engine.native is not None:
        stage_prof.take_host_leg(engine.native.threads)
    stage_prof.emit()


def _map(engine: MappingEngine, cfg: Config, t_start: float) -> None:
    sam_fh = None
    bam_writer = None
    headers = sam_headers(engine.genome, VERSION_STR)
    if cfg.bam_file:
        from .io.bam import BamWriter
        bam_writer = BamWriter(cfg.bam_file, engine.genome, headers)
    elif cfg.sam_file:
        out_path = cfg.sam_file
        sam_fh = sys.stdout if out_path == "-" else open(out_path, "w")
        for line in headers:
            sam_fh.write(line + "\n")

    # writers must flush/close even if mapping raises (a truncated BAM
    # without its BGZF EOF marker is worse than a missing one)
    try:
        _run_mapping_body(engine, cfg, t_start, sam_fh, bam_writer)
    finally:
        if sam_fh and sam_fh is not sys.stdout:
            sam_fh.close()
        if bam_writer:
            bam_writer.close()
    with stage_prof.span("finalize"):
        _finish_mapping(engine, cfg, t_start)


def _run_mapping_body(engine: MappingEngine, cfg: Config, t_start: float,
                      sam_fh, bam_writer) -> None:
    if engine.native is not None and engine.backend is not None:
        # fast path: native parsing/processing + device seeding, overlapped
        from .pipeline.stream import run_stream_mapping
        if (cfg.vcf_output and cfg.device_evidence
                and not engine.backend.device_evidence_ok):
            _log(cfg, "The device evidence planes do not fit the free "
                      "device memory; evidence accumulates in host memory.")

        def sam_sink(text: str) -> None:
            if sam_fh:
                sam_fh.write(text)
            elif bam_writer:
                for line in text.splitlines():
                    bam_writer.write_sam_line(line)

        run_stream_mapping(engine, cfg, t_start,
                           sam_sink if (sam_fh or bam_writer) else None)
        return

    n_lib = len(cfg.read_files1)
    super_batch = max(cfg.batch_size, 1)
    for lib in range(n_lib):
        f1 = cfg.read_files1[lib]
        f2 = cfg.read_files2[lib] if lib < len(cfg.read_files2) else None
        pair_end = f2 is not None or cfg.pair_interleaved

        def submit(buffered):
            if engine.backend is None:
                return None
            flat = [rd for ch in buffered for rd in ch]
            return engine.preseed_submit(flat, pair_end and len(flat) % 2 == 0)

        def process(buffered, token):
            engine.preseed_wait(token)
            for ch in buffered:
                sam_lines = engine.process_chunk(ch, pair_end)
                if sam_fh:
                    for line in sam_lines:
                        sam_fh.write(line + "\n")
                elif bam_writer:
                    for line in sam_lines:
                        bam_writer.write_sam_line(line)
            sys.stderr.write(f"\r{engine.stats.total_reads} "
                             f"{'paired-end' if pair_end else 'singled-end'} reads processed "
                             f"in {int(time.time() - t_start)} seconds...")

        # one super-batch in flight: the device seeds batch k+1 while the
        # host runs the post-seeding pipeline for batch k
        pending = None
        buffered = []
        buffered_n = 0
        for chunk in iter_chunks(f1, f2):
            buffered.append([ReadState(r.header, r.seq, r.qual) for r in chunk])
            buffered_n += len(chunk)
            if buffered_n >= super_batch:
                token = submit(buffered)
                if pending is not None:
                    process(*pending)
                pending = (buffered, token)
                buffered = []
                buffered_n = 0
        if buffered:
            token = submit(buffered)
            if pending is not None:
                process(*pending)
            pending = (buffered, token)
        if pending is not None:
            process(*pending)
    sys.stderr.write("\n")


def _finish_mapping(engine: MappingEngine, cfg: Config,
                    t_start: float) -> None:
    engine.finalize()
    st = engine.stats
    _log(cfg, f"All the {st.total_reads} reads have been processed in "
              f"{int(time.time() - t_start)} seconds.")
    if st.total_reads > 0:
        pct = int(10000 * st.total_mapped / st.total_reads + 0.00005) / 100.0
        _log(cfg, f"{st.total_mapped:12d} ({pct:6.2f}%) reads are mapped properly.")
    if st.total_reads > 0 and st.total_paired > 0:
        pct = int(10000 * (st.total_paired * 2) / st.total_reads + 0.00005) / 100.0
        _log(cfg, f"{st.total_paired * 2:12d} ({pct:6.2f}%) reads are mapped in pairs.")
    if cfg.vcf_output:
        _log(cfg, f"\tEstimated AvgCoverage = {st.avg_cov}")
        dup_total, dup_n = engine.duplication_rate()
        if dup_n > 0:
            _log(cfg, f"\tDuplication rate={100.0 * dup_total / dup_n:4.2f}%")
    if st.total_reads > 0 and st.total_paired > 0:
        _log(cfg, f"\tAverage read length = {st.avg_read_length}, Estimated fragment "
                  f"size = {st.fragment_size}, insert size = {st.avg_dist - st.avg_read_length}")


def run_calling(engine: MappingEngine, cfg: Config, cmd_line: str) -> dict:
    with stage_prof.span("call"):
        counts = _call(engine, cfg, cmd_line)
    stage_prof.emit()
    return counts


def _call(engine: MappingEngine, cfg: Config, cmd_line: str) -> dict:
    from .calling.caller import (VAR_DEL, VAR_INS, VAR_INV, VAR_SUB, VAR_TNL,
                                 cal_block_read_depth, identify_break_point_candidates,
                                 identify_sv, identify_variants,
                                 remove_consecutive_genomic_variant)
    from .io.vcf import write_meta, write_variants
    t0 = time.time()
    genome = engine.genome
    profile = engine.profile
    _log(cfg, f"Identify all variants (min_alt_allele_depth={cfg.min_allele_depth})...")
    if engine.device_evidence is not None:
        from .calling.device_call import device_identify
        res = device_identify(engine, cfg, genome)
        if res is None:   # capacity overflow: host caller on host planes
            from .pipeline.device_profile import STATS
            STATS.overflow_fallbacks += 1
            with stage_prof.span("call_device"):
                engine.device_evidence.download_into(profile)
                engine.device_evidence = None
                if profile.F1_diff is not None:
                    profile.finalize_diffs(engine.idx.ref.ref_sequence_codes())
        else:
            block_depth, profile, variants = res
    with stage_prof.span("call_records"):
        if engine.device_evidence is None:
            block_depth = cal_block_read_depth(profile, genome.genome_size)
            variants = identify_variants(cfg, genome, profile,
                                         engine.idx.ref.ref_sequence_codes(),
                                         block_depth)
        if cfg.gvcf:
            variants = remove_consecutive_genomic_variant(variants)

    with stage_prof.span("call_sv"):
        bp_cans = identify_break_point_candidates(profile, genome.two_genome_size,
                                                  engine.stats.avg_read_length)
        st = engine.stats
        if bp_cans and engine.inv_sites:
            invs = identify_sv(profile, genome, bp_cans, engine.inv_sites, 3,
                               block_depth, st.fragment_size, st.avg_read_length)
            variants = sorted(variants + invs, key=lambda v: (v.gPos, v.VarType))
        if bp_cans and engine.tnl_sites:
            tnls = identify_sv(profile, genome, bp_cans, engine.tnl_sites, 4,
                               block_depth, st.fragment_size, st.avg_read_length)
            variants = sorted(variants + tnls, key=lambda v: (v.gPos, v.VarType))

    _log(cfg, f"\tWrite all the predicted sample variations to file [{cfg.vcf_file}]...")
    with stage_prof.span("call_write"), open(cfg.vcf_file, "w") as f:
        write_meta(f, cfg, genome, VERSION_STR, cmd_line)
        counts = write_variants(f, cfg, genome, profile, engine.ref_chars, variants)
    _log(cfg, f"\t{counts[VAR_SUB]}(snp); {counts[VAR_INS]}(ins); {counts[VAR_DEL]}(del); "
              f"{counts[VAR_TNL] >> 1}(trans); {counts[VAR_INV] >> 1}(inversion)")
    _log(cfg, f"variant calling has been done in {int(time.time() - t0)} seconds.")
    return {"snv": counts[VAR_SUB], "ins": counts[VAR_INS],
            "del": counts[VAR_DEL], "translocation": counts[VAR_TNL] >> 1,
            "inversion": counts[VAR_INV] >> 1}
