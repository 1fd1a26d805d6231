"""Command-line interface (ref: src/main.cpp).

Same flag surface as the reference binary:
  python -m mapcaller_tpu_torch.cli index ref.fa prefix
  python -m mapcaller_tpu_torch.cli -i prefix -f r1.fq [-f2 r2.fq]
      [-sam out.sam] [-vcf out.vcf] ...
Tables and batches go to Config.device (the CUDA card by default).
"""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from . import __version__
from .config import Config

VERSION_STR = "0.9.9.41"  # output-compatible version tag (ref: main.cpp:12)


def _usage(prog: str) -> None:
    sys.stderr.write(f"MapCaller-torch v{__version__} (output-compatible with MapCaller v{VERSION_STR})\n\n")
    sys.stderr.write(f"Usage: {prog} -i Index_Prefix -f <ReadFile_A1 ...> [-f2 <ReadFile_A2 ...>]\n\n")
    sys.stderr.write("""Options: -i STR        index prefix
         -r STR        reference filename (format:fa)
         -f            files with #1 mates reads (fa/fq/fq.gz)
         -f2           files with #2 mates reads
         -t INT        number of threads [16]
         -size         sequencing fragment size [500]
         -indel INT    maximal indel size [30]
         -ad INT       minimal ALT allele count [5]
         -dup INT      maximal PCR duplicates [5]
         -maxmm FLOAT  maximal mismatch rate in read alignment [0.05]
         -maxclip INT  maximal clip size at either ends [5]
         -sam STR      SAM output filename
         -bam STR      BAM output filename
         -alg STR      gapped alignment algorithm (nw|ksw2)
         -vcf STR      VCF output filename [output.vcf]
         -gvcf         GVCF mode
         -log STR      log filename [job.log]
         -monomorphic  report all loci without potential alternates
         -min_cnv INT  minimal cnv size to be reported [50]
         -min_gap INT  minimal gap (unmapped) size to be reported [50]
         -ploidy INT   1:monoploid, 2:diploid [2]
         -m            output multiple alignments
         -somatic      detect somatic mutations
         -no_vcf       no VCF output
         -p            paired-end reads interlaced in the same file
         -filter       apply variant filters
         -id STR       assign sample id
         -backend STR  auto|device|host (GPU batch kernels vs NumPy oracle)
         -devices N    data-parallel read mapping over N local chips (auto = all)
         -pfm PATH     checkpoint the post-mapping evidence profile to PATH
         -pfm_resume PATH  skip mapping; run variant calling from a saved profile
         -v            version
""")


def parse_args(argv: List[str]) -> Optional[Config]:
    """(ref: main.cpp:212-342)"""
    cfg = Config()
    i = 1
    n = len(argv)
    while i < n:
        p = argv[i]
        def nxt():
            nonlocal i
            i += 1
            return argv[i]
        if p == "-i" and i + 1 < n:
            cfg.index_prefix = nxt()
        elif p == "-r" and i + 1 < n:
            cfg.ref_fasta = nxt()
        elif p == "-f":
            while i + 1 < n and not argv[i + 1].startswith("-"):
                cfg.read_files1.append(nxt())
        elif p == "-f2":
            while i + 1 < n and not argv[i + 1].startswith("-"):
                cfg.read_files2.append(nxt())
        elif p == "-lib" and i + 1 < n:
            with open(nxt()) as fh:
                for line in fh:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split()
                    cfg.read_files1.append(parts[0])
                    if len(parts) > 1:
                        cfg.read_files2.append(parts[1])
        elif p == "-t" and i + 1 < n:
            cfg.n_threads = max(1, int(nxt()))
        elif p == "-dup" and i + 1 < n:
            v = int(nxt())
            if v <= 15:
                cfg.max_duplicate = v
        elif p == "-filter":
            cfg.apply_filter = True
        elif p in ("-id", "-label") and i + 1 < n:
            cfg.sample_id = nxt()
        elif p == "-size" and i + 1 < n:
            cfg.fragment_size = int(nxt())
        elif p == "-indel" and i + 1 < n:
            cfg.max_pos_diff = min(100, int(nxt()))
        elif p == "-min_cnv" and i + 1 < n:
            cfg.min_cnv_size = int(nxt())
        elif p == "-min_gap" and i + 1 < n:
            cfg.min_unmapped_size = int(nxt())
        elif p == "-ad" and i + 1 < n:
            cfg.min_allele_depth = int(nxt())
        elif p == "-ploidy" and i + 1 < n:
            cfg.ploidy = min(2, int(nxt()))
        elif p == "-sam" and i + 1 < n:
            cfg.sam_file = nxt()
        elif p == "-bam" and i + 1 < n:
            cfg.bam_file = nxt()
        elif p == "-log" and i + 1 < n:
            cfg.log_file = nxt()
        elif p == "-alg" and i + 1 < n:
            cfg.use_nw = nxt() != "ksw2"
        elif p == "-maxmm" and i + 1 < n:
            cfg.max_mismatch_rate = float(nxt())
        elif p == "-maxclip" and i + 1 < n:
            cfg.max_clip_size = int(nxt())
        elif p == "-vcf" and i + 1 < n:
            cfg.vcf_file = nxt()
        elif p == "-gvcf":
            cfg.gvcf = True
        elif p == "-monomorphic":
            cfg.monomorphic = True
        elif p == "-no_vcf":
            cfg.vcf_output = False
        elif p == "-somatic":
            cfg.somatic = True
        elif p in ("-pair", "-p"):
            cfg.pair_interleaved = True
        elif p == "-m":
            cfg.unique_only = False
        elif p == "-backend" and i + 1 < n:
            cfg.backend = nxt()
        elif p == "-shards" and i + 1 < n:
            # genome-shard the occ3 index over N devices (human scale)
            cfg.index_shards = int(nxt())
        elif p == "-pfm" and i + 1 < n:
            # checkpoint the post-mapping evidence profile
            cfg.pfm_out = nxt()
        elif p == "-pfm_resume" and i + 1 < n:
            # skip mapping; run calling from a saved profile
            cfg.pfm_resume = nxt()
        elif p == "-devices" and i + 1 < n:
            # data-parallel read mapping over N local chips (auto = all)
            v = nxt()
            cfg.devices = 0 if v == "auto" else max(1, int(v))
        elif p in ("-v", "--version"):
            sys.stderr.write(f"MapCaller v{VERSION_STR}\n\n")
            return None
        elif p == "-obs" and i + 1 < n:
            cfg.obs_pos = int(nxt())
        elif p == "-obr" and i + 2 < n:
            cfg.obr_beg = int(nxt())
            cfg.obr_end = int(nxt())
        elif p in ("-d", "-debug"):
            pass  # accepted like the reference (main.cpp:308)
        else:
            sys.stderr.write(f"Warning! Unknow parameter: {p}\n")
            _usage(argv[0])
            return None
        i += 1
    cfg.__post_init__()
    if cfg.gvcf and cfg.monomorphic:
        cfg.gvcf = False
    return cfg


def run(cfg: Config, cmd_line: str) -> int:
    from .runner import run_pipeline
    return run_pipeline(cfg, cmd_line)


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv
    if len(argv) == 1 or argv[1] == "-h":
        _usage(argv[0])
        return 0
    if argv[1] == "index":
        if len(argv) == 4:
            from .index.fmindex import build_index
            t0 = time.time()
            build_index(argv[2], argv[3])
            sys.stderr.write(f"[index] built in {time.time() - t0:.2f} sec\n")
            return 0
        sys.stderr.write(f"usage: {argv[0]} index ref.fa prefix\n")
        return 1
    if argv[1] == "update":
        # the reference self-updates via `git pull` (main.cpp:194-198);
        # deliberately not reproduced (SURVEY.md section 2a)
        sys.stderr.write("update: use your package manager / git checkout "
                         "to update MapCaller\n")
        return 0
    if argv[1] == "sim":
        # SVsim-equivalent fixture generator (ref: src/sv_simulator/SVsim.cpp)
        if len(argv) >= 4:
            from .simulator import mutate_genome, write_paired_fastq
            prefix = argv[3]
            seed = int(argv[4]) if len(argv) > 4 else 23
            n_pairs = int(argv[5]) if len(argv) > 5 else 0
            vs = mutate_genome(argv[2], prefix + ".mut.fa", prefix + ".vcf",
                               seed=seed)
            sys.stderr.write(f"[sim] {len(vs)} truth variants -> "
                             f"{prefix}.mut.fa / {prefix}.vcf\n")
            if n_pairs > 0:
                write_paired_fastq(prefix + ".mut.fa", prefix + "_1.fq",
                                   prefix + "_2.fq", n_pairs, seed=seed + 1)
                sys.stderr.write(f"[sim] {n_pairs} read pairs -> "
                                 f"{prefix}_1.fq / {prefix}_2.fq\n")
            return 0
        sys.stderr.write(f"usage: {argv[0]} sim ref.fa out_prefix [seed] [n_pairs]\n")
        return 1
    cfg = parse_args(argv)
    if cfg is None:
        return 0
    if not cfg.read_files1 and not cfg.pfm_resume:
        sys.stderr.write("Warning! Please specify a valid read input!\n")
        _usage(argv[0])
        return 0
    if cfg.read_files2 and len(cfg.read_files1) != len(cfg.read_files2):
        sys.stderr.write("Warning! Paired-end reads input numbers do not match!\n")
        return 0
    if (cfg.pfm_out or cfg.pfm_resume) and not cfg.vcf_output:
        sys.stderr.write("Warning! -pfm/-pfm_resume require the evidence "
                         "profile; remove -no_vcf.\n")
        return 1
    cmd_line = " ".join(argv)
    return run(cfg, cmd_line)


if __name__ == "__main__":
    sys.exit(main())
