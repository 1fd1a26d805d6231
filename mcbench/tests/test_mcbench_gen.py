"""The benchmark's generator (gen.py) against the program's simulator
(mapcaller_tpu_torch/simulator.py) on a small genome: the same kinds of
reads and mutations, and the same output for the same seed."""
import os
import re

import numpy as np

from mapcaller_tpu_torch import simulator
from mapcaller_tpu_torch.dna import encode
from mcbench import gen

L = 60000
RATES = dict(snp=3000, small_indel=200, large_indel=50, inv=20, tnl=20,
             cnv=20)


def _fastq(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0::4], lines[1::4], lines[3::4]


def test_mutant_maps_back_and_counts_match_simulator(tmp_path):
    ref = gen.synth_genome(L, 3)
    m = gen.mutate(ref, RATES, [9, 1])
    base = ref.copy()
    base[m.snp_pos] = m.snp_alt
    fwd = (m.m2r >= 0) & ~m.flip
    assert np.array_equal(m.codes[fwd], base[m.m2r[fwd]])
    assert np.array_equal(m.codes[m.flip], 3 - base[m.m2r[m.flip]])
    # SNVs and indels as the simulator counts them (it drops an event
    # only when 100 draws find no room; so does gen at this density)
    fa = str(tmp_path / "ref.fa")
    gen.write_fasta(fa, "c", ref)
    truth = simulator.mutate_genome(fa, str(tmp_path / "mut.fa"),
                                    str(tmp_path / "t.vcf"), seed=4,
                                    snp_per_mb=RATES["snp"],
                                    small_indel_per_mb=RATES["small_indel"],
                                    large_indel_per_mb=RATES["large_indel"],
                                    inv_per_mb=RATES["inv"],
                                    tnl_per_mb=RATES["tnl"],
                                    cnv_per_mb=RATES["cnv"])
    kinds = [t.svtype.split(";")[0] for t in truth]
    assert m.snp_pos.size == kinds.count("SUBSTITUTE") == int(L / 1e6 * 3000)
    assert m.indel_pos.size == kinds.count("INSERT") + kinds.count("DELETE")
    n_sv = sum(kinds.count(k) for k in ("INVERT", "TRANSLOCATE",
                                        "DUPLICATE"))
    assert abs(m.sv_lo.size - n_sv) <= 1
    # the mutant's length moves by the indels and the duplications alone
    dup = m.codes.size - L - int(m.indel_len.sum())
    assert dup >= 0 and (dup > 0) == any(k == "DUPLICATE" for k in kinds)


def test_reads_like_simulator(tmp_path):
    ref = gen.synth_genome(L, 5)
    fa = str(tmp_path / "ref.fa")
    gen.write_fasta(fa, "c", ref)
    n, rl = 3000, 150
    r = gen.simulate_reads(ref, n, rl, 500, 50, 0.005, [1, 2])
    p1, p2 = str(tmp_path / "a1.fq"), str(tmp_path / "a2.fq")
    gen.write_fastq(r, "c", p1, p2)
    s1, s2 = simulator.simulate_paired_reads(fa, n, read_len=rl, seed=3)
    h1, q1, qual1 = _fastq(p1)
    h2, q2, _ = _fastq(p2)
    assert len(h1) == len(s1) == n and set(qual1) == {"I" * rl}
    for hs, mate in ((h1, "/1"), (h2, "/2")):
        assert all(h.endswith(mate) for h in hs)
    pat = re.compile(r"^@c_(\d+)_(\d+)_(\d+)/[12]$")
    spans = np.array([[int(x) for x in pat.match(h).groups()[:2]]
                      for h in h1])
    sim_spans = np.array([[int(x) for x in r_.header.split("_")[1:3]]
                          for r_ in s1])
    for sp in (spans, sim_spans):
        frag = sp[:, 1] - sp[:, 0] + 1
        assert frag.min() >= rl + 10 and abs(frag.mean() - 500) < 5
        assert abs(frag.std() - 50) < 5
    # mate 1 is the fragment's left end forward or its right end reverse
    # complemented, mate 2 the other end; errors at about the rate
    comp = np.array([3, 2, 1, 0], np.uint8)
    mism, fwd_first = 0, 0
    for k in range(n):
        a, b = encode(q1[k]), encode(q2[k])
        lo, hi = spans[k, 0] - 1, spans[k, 1]
        left, right = ref[lo:lo + rl], comp[ref[hi - rl:hi]][::-1]
        d_fwd = np.sum(a != left) + np.sum(b != right)
        d_rev = np.sum(a != right) + np.sum(b != left)
        fwd_first += d_fwd < d_rev
        mism += min(d_fwd, d_rev)
    assert abs(mism / (2 * n * rl) - 0.005) < 0.001
    assert 0.45 < fwd_first / n < 0.55
    # the error list is exactly where the reads differ from the genome
    seq = np.where(r.mate_rev[..., None], comp[ref[r.mate_start[..., None]
                   + np.arange(rl)[::-1]]], ref[r.mate_start[..., None]
                   + np.arange(rl)])
    assert int((seq != r.seq).sum()) == r.err_m.size


def test_same_seed_same_bytes(tmp_path):
    ref = gen.synth_genome(L, 5)
    out = []
    for k, seed in enumerate((2 ** 31 + 9, 2 ** 31 + 9, 12)):
        m = gen.mutate(ref, RATES, [seed, 1])
        r = gen.simulate_reads(m.codes, 500, 150, 500, 50, 0.005, [seed, 2])
        p = [str(tmp_path / f"{k}_{i}.fq") for i in (1, 2)]
        gen.write_fastq(r, "c", *p)
        out.append(b"".join(open(x, "rb").read() for x in p))
    assert out[0] == out[1] and out[0] != out[2]
