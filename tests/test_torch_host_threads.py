"""The C++ host leg on -t threads (csrc/mc_native.cpp run_batch) against
one thread, on the CPU: stream batches of 1,024 reads, so six chunks a
batch, the last of 24 reads. Each run's SAM, VCF, run statistics,
discordant sites, host evidence planes and event maps must equal the
-t 1 run's byte for byte, on the classified path, on the host-chaining
path, single-end with an odd last batch (and so an odd last chunk), and
on the classified path against the same genome cut into chromosomes of
2.5 kb, where pairs and rescue windows cross chromosome ends.

The reads make the leg's speculation miss: the running mean fragment
distance first counts after 1,000 pairs, inside the third batch, so the
chunks after that point were mapped at the opening avg_dist of 1,000.
Among them are pairs whose fragments run past 1.5 times the mean (their
mates pair at the opening est and not at the new one) and pairs whose
mate 2 is random (rescued at an est the window search depends on), so
the leg must map those chunks again: host_chunks_redone > 0.

The same reads also hold pairs that read as inversions (both mates on
one strand) and as translocations (over 1 kb apart), for the leg's
discordant-pair sites."""
import dataclasses
import gc
import hashlib
import os

import numpy as np
import pytest
import torch

from mapcaller_tpu_torch import runner, stage_prof
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.index.fmindex import build_index, load_index
from mapcaller_tpu_torch.index.packer import iter_fasta
from mapcaller_tpu_torch.simulator import write_planted_dataset

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py
RUN = dict(batch_size=1024, stream_batch_size=1024, max_read_len=128,
           prefix_skip_k=6, compact_factor=1, device="cpu")
N_PAIRS = 1500
READ_LEN = 100
COMP = str.maketrans("ACGT", "TGCA")
CHROM_LEN = 2500


def _write_reads(d, donor, rng):
    """N_PAIRS pairs from the donor, 0.5% substitutions; every 25th pair
    has a 1.2 kb fragment, every 20th a random mate 2, every 50th both
    mates on the forward strand, 2 kb apart."""
    L = len(donor)
    paths = [os.path.join(d, f) for f in ("r1.fq", "r2.fq", "se.fq")]
    mates = ([], [])
    for k in range(N_PAIRS):
        frag = int(rng.normal(1200 if k % 25 == 11 else
                              2000 if k % 50 == 23 else 300, 20))
        start = int(rng.integers(0, L - frag))
        s1 = donor[start:start + READ_LEN]
        s2 = donor[start + frag - READ_LEN:start + frag]
        if k % 50 != 23:
            s2 = s2.translate(COMP)[::-1]
        if k % 20 == 7:
            s2 = "".join(rng.choice(list("ACGT"), READ_LEN))
        for m, s in enumerate((s1, s2)):
            b = np.frombuffer(s.encode(), dtype=np.uint8).copy()
            hit = rng.random(b.size) < 0.005
            b[hit] = np.frombuffer(b"ACGT", dtype=np.uint8)[
                rng.integers(0, 4, int(hit.sum()))]
            mates[m].append(f"@p{k}/{m + 1}\n{b.tobytes().decode()}\n+\n"
                            f"{'I' * READ_LEN}\n")
    for path, recs in zip(paths, (mates[0], mates[1],
                                  mates[0] + mates[1][:-1])):
        with open(path, "w") as f:
            f.write("".join(recs))
    return paths


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("host_threads"))
    fa, _, _ = write_planted_dataset(d, n_pairs=10)
    donor = "".join(s for _, s in iter_fasta(os.path.join(d, "donor.fa")))
    r1, r2, se = _write_reads(d, donor, np.random.default_rng(5))
    prefix = os.path.join(d, "idx")
    build_index(fa, prefix)
    (_, ref), = iter_fasta(fa)
    cut = os.path.join(d, "chroms.fa")
    with open(cut, "w") as f:
        for k in range(0, len(ref), CHROM_LEN):
            f.write(f">c{k // CHROM_LEN}\n{ref[k:k + CHROM_LEN]}\n")
    build_index(cut, os.path.join(d, "chroms"))
    return d, prefix, r1, r2, se


def _digest(x) -> str:
    b = x if isinstance(x, bytes) else (
        np.ascontiguousarray(x).tobytes() if isinstance(x, np.ndarray)
        else repr(x).encode())
    return hashlib.sha256(b).hexdigest()


def _run(dataset, monkeypatch, path, t):
    """One run as a deployment makes it, on t threads whatever the cores
    this process may use -> (a digest of everything compared, the
    [stage-prof] counters of the C++ leg)."""
    d, prefix, r1, r2, se = dataset
    monkeypatch.setenv("MC_STAGE_PROF", "1")
    out = os.path.join(d, f"{path}_t{t}")
    if path == "chroms":
        prefix = os.path.join(d, "chroms")
    cfg = Config(index_prefix=prefix,
                 read_files1=[se if path == "single" else r1],
                 read_files2=[] if path == "single" else [r2],
                 sam_file=out + ".sam", vcf_file=out + ".vcf",
                 log_file=out + ".log", n_threads=t,
                 device_chain=path != "host", **RUN)
    engine = runner.make_engine(load_index(prefix), cfg)
    # -t cut to the cores would leave one thread on a one-core runner,
    # and the pool and its redo path unchecked: set t itself
    engine.native.threads = t
    engine.native.lib.mc_set_threads(engine.native.ctx, t)
    engine.reset_run()
    runner.run_mapping(engine, cfg, 0.0)
    runner.run_calling(engine, cfg, "mapcaller")
    prof = engine.profile
    with open(out + ".sam", "rb") as f:
        sam = f.read()
    with open(out + ".vcf", "rb") as f:
        vcf = f.read()
    planes = {k: v for k, v in vars(prof).items() if isinstance(v, np.ndarray)}
    events = {k: sorted(v.items()) for k, v in vars(prof).items()
              if isinstance(v, dict)}
    assert planes and all(events.values()) and sam.count(b"\n") > 3000
    got = dict(sam=_digest(sam), vcf=_digest(vcf),
               stats=dataclasses.asdict(engine.stats),
               sites=_digest((engine.inv_sites, engine.tnl_sites)),
               planes={k: _digest(v) for k, v in planes.items()},
               events=_digest(events))
    counts = {k: stage_prof._sums[k] for k in
              ("host_threads", "host_chunks", "host_chunks_redone")}
    del engine, prof, planes, events
    gc.collect()   # the engine's planes and leg threads go now, not later
    return got, counts


_ONE_THREAD = {}


@pytest.mark.parametrize("t", [1, 2, 8])
@pytest.mark.parametrize("path", ["device", "host", "single", "chroms"])
def test_threads_match_one_thread(dataset, monkeypatch, path, t):
    if path not in _ONE_THREAD:
        _ONE_THREAD[path] = _run(dataset, monkeypatch, path, 1)
    want, one = _ONE_THREAD[path]
    got, counts = _run(dataset, monkeypatch, path, t)
    for key in want:
        assert got[key] == want[key], key
    n_reads = 2 * N_PAIRS - (path == "single")
    assert got["stats"]["total_reads"] == n_reads
    # 1,024-read batches: 6 chunks each, the last batch 952 or 951 reads
    assert counts["host_chunks"] == one["host_chunks"] == 2 * 6 + 5
    assert one == dict(host_threads=1, host_chunks=17, host_chunks_redone=0)
    assert counts["host_threads"] == t
    if t > 1 and path != "single":
        assert counts["host_chunks_redone"] > 0
    else:
        assert counts["host_chunks_redone"] == 0
