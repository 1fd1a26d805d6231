"""Test-fixture simulators.

1. simulate_paired_reads: wgsim-style paired-end read simulator used to
   regenerate the stripped toy reads (reference fixtures test/r1.fq,
   test/r2.fq were wgsim-style; see read headers referenced at
   ReadMapping.cpp:567).
2. mutate_genome: SVsim-equivalent mutation simulator
   (ref: src/sv_simulator/SVsim.cpp) producing a mutant genome + truth VCF.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .dna import decode, encode, revcomp_codes
from .index.packer import iter_fasta
from .io.fastq import Read, write_fastq


def simulate_paired_reads(fasta_path: str, n_pairs: int, read_len: int = 100,
                          frag_mean: int = 500, frag_sd: int = 50,
                          err_rate: float = 0.005, seed: int = 17,
                          name_prefix: Optional[str] = None
                          ) -> Tuple[List[Read], List[Read]]:
    rng = np.random.default_rng(seed)
    chroms = [(name, encode(seq)) for name, seq in iter_fasta(fasta_path)]
    lens = np.array([c[1].size for c in chroms], dtype=np.float64)
    probs = lens / lens.sum()
    r1s: List[Read] = []
    r2s: List[Read] = []
    qual = "I" * read_len
    for k in range(n_pairs):
        ci = int(rng.choice(len(chroms), p=probs))
        name, codes = chroms[ci]
        L = codes.size
        frag = int(np.clip(rng.normal(frag_mean, frag_sd), read_len + 10, L - 2))
        start = int(rng.integers(0, L - frag))
        fragment = codes[start:start + frag]
        fwd_first = bool(rng.integers(0, 2))
        a = fragment[:read_len].copy()
        b = revcomp_codes(fragment[-read_len:]).copy()
        if not fwd_first:
            a, b = revcomp_codes(fragment[-read_len:]).copy(), fragment[:read_len].copy()
        for arr in (a, b):
            errs = rng.random(read_len) < err_rate
            if errs.any():
                idx = np.nonzero(errs)[0]
                arr[idx] = (arr[idx] + rng.integers(1, 4, size=idx.size)) % 4
        hdr = f"{name_prefix or name}_{start + 1}_{start + frag}_{k}"
        r1s.append(Read(hdr + "/1", decode(a), qual))
        r2s.append(Read(hdr + "/2", decode(b), qual))
    return r1s, r2s


def write_paired_fastq(fasta_path: str, out1: str, out2: str, n_pairs: int,
                       **kw) -> None:
    r1s, r2s = simulate_paired_reads(fasta_path, n_pairs, **kw)
    write_fastq(out1, r1s)
    write_fastq(out2, r2s)


@dataclasses.dataclass
class TruthVariant:
    chrom: str
    pos: int       # 1-based
    ref: str
    alt: str
    svtype: str


def mutate_genome(fasta_path: str, out_fasta: str, out_vcf: str,
                  snp_per_mb: int = 3000, small_indel_per_mb: int = 200,
                  large_indel_per_mb: int = 50, inv_per_mb: float = 1.0,
                  tnl_per_mb: float = 1.0, cnv_per_mb: float = 1.0,
                  seed: int = 23) -> List[TruthVariant]:
    """SVsim-equivalent mutation simulator (ref: SVsim.cpp:16-21 rates,
    GenMutantSeq :158-260): SNPs, small (1-10 bp) and large (11-30 bp)
    indels, inversions (1-2 kb revcomp), translocations (1-2 kb swap at
    +10-11 kb) and CNVs (0.3-1.3 kb duplicated 2-9x), seeded."""
    rng = np.random.default_rng(seed)
    variants: List[TruthVariant] = []
    out_seqs = []
    for name, seq in iter_fasta(fasta_path):
        codes = encode(seq)
        L = codes.size
        n_snp = int(L / 1e6 * snp_per_mb)
        n_small = int(L / 1e6 * small_indel_per_mb)
        n_large = int(L / 1e6 * large_indel_per_mb)
        n_inv = int(round(L / 1e6 * inv_per_mb))
        n_tnl = int(round(L / 1e6 * tnl_per_mb))
        n_cnv = int(round(L / 1e6 * cnv_per_mb))
        events = []  # (pos, kind, payload)
        used = set()

        def pick_pos(span):
            for _ in range(100):
                p = int(rng.integers(1, max(2, L - span - 1)))
                if all(p + d not in used for d in range(-span - 1, span + 2)):
                    for d in range(-1, span + 1):
                        used.add(p + d)
                    return p
            return None

        # large events first so the small ones avoid their footprint
        for _ in range(n_inv):
            size = int(rng.integers(1000, 2000))
            p = pick_pos(size)
            if p is None or p + size >= L:
                continue
            events.append((p, "INVERT", size))
        for _ in range(n_tnl):
            size = int(rng.integers(1000, 2000))
            dist = int(rng.integers(10000, 11000))
            p = pick_pos(size + dist + size)
            if p is None or p + dist + 2 * size >= L:
                continue
            events.append((p, "TRANSLOCATE", (size, dist)))
        for _ in range(n_cnv):
            size = int(rng.integers(300, 1300))
            p = pick_pos(size)
            if p is None or p + size >= L:
                continue
            dup = int(rng.integers(2, 10))
            events.append((p, "DUPLICATE", (size, dup)))
        for _ in range(n_snp):
            p = pick_pos(1)
            if p is None:
                continue
            alt = (int(codes[p]) + int(rng.integers(1, 4))) % 4
            events.append((p, "SUBSTITUTE", alt))
        for _ in range(n_small):
            p = pick_pos(12)
            if p is None:
                continue
            size = int(rng.integers(1, 11))
            if rng.integers(0, 2):
                ins = rng.integers(0, 4, size=size).astype(np.uint8)
                events.append((p, "INSERT", ins))
            else:
                events.append((p, "DELETE", size))
        for _ in range(n_large):
            p = pick_pos(32)
            if p is None:
                continue
            size = int(rng.integers(11, 31))
            if rng.integers(0, 2):
                ins = rng.integers(0, 4, size=size).astype(np.uint8)
                events.append((p, "INSERT", ins))
            else:
                events.append((p, "DELETE", size))
        events.sort(key=lambda e: e[0])

        parts = []
        cur = 0
        for p, kind, payload in events:
            if p < cur:
                continue  # overlapped by a prior large event
            parts.append(codes[cur:p])
            if kind == "SUBSTITUTE":
                parts.append(np.array([payload], dtype=np.uint8))
                variants.append(TruthVariant(name, p + 1, decode(codes[p:p + 1]),
                                             decode(np.array([payload], dtype=np.uint8)),
                                             "SUBSTITUTE"))
                cur = p + 1
            elif kind == "INSERT":
                parts.append(codes[p:p + 1])
                parts.append(payload)
                variants.append(TruthVariant(name, p + 1, decode(codes[p:p + 1]),
                                             decode(codes[p:p + 1]) + decode(payload),
                                             "INSERT"))
                cur = p + 1
            elif kind == "DELETE":
                size = payload
                parts.append(codes[p:p + 1])
                variants.append(TruthVariant(name, p + 1,
                                             decode(codes[p:p + 1 + size]),
                                             decode(codes[p:p + 1]), "DELETE"))
                cur = p + 1 + size
            elif kind == "INVERT":
                size = payload
                parts.append(revcomp_codes(codes[p:p + size]))
                variants.append(TruthVariant(name, p + 1, decode(codes[p:p + 1]),
                                             "<INV>", f"INVERT;END={p + size}"))
                cur = p + size
            elif kind == "TRANSLOCATE":
                size, dist = payload
                q = p + dist + size  # second block start
                parts.append(codes[q:q + size])
                parts.append(codes[p + size:q])
                parts.append(codes[p:p + size])
                variants.append(TruthVariant(name, p + 1, decode(codes[p:p + 1]),
                                             "<TRA>", f"TRANSLOCATE;END={q + size}"))
                cur = q + size
            else:  # DUPLICATE
                size, dup = payload
                for _ in range(dup):
                    parts.append(codes[p:p + size])
                variants.append(TruthVariant(name, p + 1, decode(codes[p:p + 1]),
                                             "<DUP>", f"DUPLICATE;DUP={dup};END={p + size}"))
                cur = p + size
        parts.append(codes[cur:])
        out_seqs.append((name, decode(np.concatenate(parts))))

    with open(out_fasta, "w") as f:
        for name, s in out_seqs:
            f.write(f">{name}\n")
            for i in range(0, len(s), 70):
                f.write(s[i:i + 70] + "\n")
    with open(out_vcf, "w") as f:
        f.write("##maf version=1\n")
        for v in variants:
            f.write(f"{v.chrom}\t{v.pos}\t.\t{v.ref}\t{v.alt}\t30\tPASS\tSVTYPE={v.svtype}\n")
    return variants


def write_planted_dataset(out_dir: str, L: int = 20000, n_pairs: int = 1500,
                          seed: int = 11) -> Tuple[str, str, str]:
    """Small paired-end fixture: a random L-base genome, a donor copy of
    it with planted SNPs and 1-3 bp insertions and deletions every 1 kb,
    and n_pairs read pairs sampled from the donor, so that calling finds
    the variants and the indel reads go through the gapped-extension DP.
    Writes ref.fa, donor.fa, r1.fq and r2.fq under out_dir and returns
    (ref.fa, r1.fq, r2.fq)."""
    import os
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    parts, cur = [], 0
    for k, p in enumerate(range(1500, L - 1500, 1000)):
        parts.append(codes[cur:p + 1])
        size = 1 + (k // 3) % 3
        if k % 3 == 0:                                   # SNP at p
            parts[-1] = parts[-1].copy()
            parts[-1][-1] = (codes[p] + 1 + k % 2) % 4
            cur = p + 1
        elif k % 3 == 1:                                 # insertion after p
            parts.append(rng.integers(0, 4, size=size).astype(np.uint8))
            cur = p + 1
        else:                                            # deletion after p
            cur = p + 1 + size
    parts.append(codes[cur:])
    paths = [os.path.join(out_dir, f) for f in ("ref.fa", "donor.fa",
                                                 "r1.fq", "r2.fq")]
    for path, seq in ((paths[0], codes), (paths[1], np.concatenate(parts))):
        s = decode(seq)
        with open(path, "w") as f:
            f.write(">chr1\n")
            for i in range(0, len(s), 70):
                f.write(s[i:i + 70] + "\n")
    write_paired_fastq(paths[1], paths[2], paths[3], n_pairs,
                       frag_mean=300, frag_sd=30, seed=seed + 1)
    return paths[0], paths[2], paths[3]


def write_ecoli_set(out_dir: str, n_pairs: int = 100_000
                    ) -> Tuple[str, str, str]:
    """The E. coli-scale map-and-call set: a 4.6 Mb random genome (seed
    99), mutated with SNPs and small/large indels (seed 7, no
    inversions, translocations or CNVs), and n_pairs 100 bp read pairs
    from the mutant (seed 5) — the seeds of the reference package's
    bench.py. Writes ecoli.fa, ecoli_mut.fa, truth.vcf, r1.fq and r2.fq
    under out_dir and returns (ecoli.fa, r1.fq, r2.fq)."""
    import os
    fa = os.path.join(out_dir, "ecoli.fa")
    s = decode(np.random.default_rng(99).integers(0, 4, size=4_600_000)
               .astype(np.uint8))
    with open(fa, "w") as f:
        f.write(">EcoliSynth\n")
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    mut = os.path.join(out_dir, "ecoli_mut.fa")
    mutate_genome(fa, mut, os.path.join(out_dir, "truth.vcf"), seed=7,
                  inv_per_mb=0, tnl_per_mb=0, cnv_per_mb=0)
    r1, r2 = os.path.join(out_dir, "r1.fq"), os.path.join(out_dir, "r2.fq")
    write_paired_fastq(mut, r1, r2, n_pairs, seed=5)
    return fa, r1, r2
