"""Multi-host run_host in the port (mapcaller_tpu_torch/parallel/
multihost.py) on the CPU: local processes in a gloo process group, each
mapping its input shard with --device cpu (the plain PyTorch versions of
the kernels), then the three collectives (sum all-reduce of the raw
planes, max all-reduce of the aux length, all-gather of the aux stream
with the hi/lo stat words) and one calling pass on rank 0. The 2-process
VCF must equal the port's 1-process VCF and the reference package's
2-process run_host VCF (its processes on JAX's CPU backend, as its own
tests run them) byte for byte, single-end, paired-end and paired-end with
--devices 2 (CPU replicas); the host helpers must equal the reference's.
Fixtures and template: tests/test_multihost.py.

Every spawned process runs under a deadline; a rank that fails gets the
others killed, so no hang outlasts its test."""
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mapcaller_tpu.parallel import multihost as jmh
from mapcaller_tpu_torch.parallel import multihost as mh
from test_multihost import _free_port, _write_fixtures, _write_pe_fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "mapcaller_tpu_torch.parallel.multihost"
JAX = "mapcaller_tpu.parallel.multihost"


def _launch(module, n, fasta, reads, out, reads2=None, devices=1,
            extra=(), timeout=300):
    """n ranks of `module`'s main on a fresh port (mh.launch_ranks: a rank
    that exits non-zero gets the others killed; at the deadline every rank
    still running is killed) -> their exit codes and output tails."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    env.pop("JAX_NUM_PROCESSES", None)
    cmds = []
    for pid in range(n):
        cmds.append([sys.executable, "-m", module, "--pid", str(pid),
                     "--num", str(n), "--coordinator", f"127.0.0.1:{port}",
                     "--fasta", fasta, "--reads", reads, "--out", out,
                     "--devices", str(devices), *extra])
        if reads2 is not None:
            cmds[-1] += ["--reads2", reads2]
    logs = [tempfile.TemporaryFile() for _ in range(n)]
    try:
        rcs = mh.launch_ranks(cmds, logs, timeout, cwd=REPO, env=env)
        tails = []
        for f in logs:
            f.seek(0)
            tails.append(f.read().decode(errors="replace")[-3000:])
    finally:
        for f in logs:
            f.close()
    return rcs, tails


def _run(module, n, fasta, reads, out, **kw):
    rcs, tails = _launch(module, n, fasta, reads, out, **kw)
    assert rcs == [0] * n, tails
    with open(out, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    fa, fq = _write_fixtures(d)
    pfa, r1, r2 = _write_pe_fixtures(d)
    return d, {"se": (fa, fq, None), "pe": (pfa, r1, r2)}


@pytest.fixture(scope="module")
def jax_vcf(fixtures):
    """The reference package's 2-process run_host VCF of a fixture with
    `devices` per process, computed once per (fixture, devices)."""
    d, inputs = fixtures
    cache = {}

    def get(name, devices=1):
        if (name, devices) not in cache:
            fa, reads, reads2 = inputs[name]
            cache[name, devices] = _run(
                JAX, 2, fa, reads, str(d / f"jax_{name}_{devices}.vcf"),
                reads2=reads2, devices=devices, timeout=420)
        return cache[name, devices]
    return get


def _types(vcf: bytes):
    body = [ln for ln in vcf.decode().splitlines() if not ln.startswith("#")]
    return {ln.split("TYPE=")[1].split("\t")[0].split(";")[0]
            for ln in body if "TYPE=" in ln}


@pytest.mark.parametrize("name", ["se", "pe"])
def test_two_processes_match_single_and_jax(fixtures, jax_vcf, name):
    """--device cpu: 1 process and 2 processes write the same VCF bytes,
    and so does the reference's 2-process run (templates
    tests/test_multihost.py:122, :137)."""
    d, inputs = fixtures
    fa, reads, reads2 = inputs[name]
    cpu = ("--device", "cpu")
    one = _run(PORT, 1, fa, reads, str(d / f"{name}_1.vcf"), reads2=reads2,
               extra=cpu)
    two = _run(PORT, 2, fa, reads, str(d / f"{name}_2.vcf"), reads2=reads2,
               extra=cpu)
    assert two == one and len(one) > 200
    assert two == jax_vcf(name)
    assert {"snv", "del"} <= _types(one), _types(one)


def test_two_processes_two_devices_compose(fixtures, jax_vcf):
    """2 processes x --devices 2 (CPU replicas in each process) write the
    1-process 1-device VCF and the reference's 2 x 2 run's (template
    tests/test_multihost.py:154)."""
    d, inputs = fixtures
    fa, r1, r2 = inputs["pe"]
    cpu = ("--device", "cpu")
    one = _run(PORT, 1, fa, r1, str(d / "c_1.vcf"), reads2=r2, extra=cpu)
    two = _run(PORT, 2, fa, r1, str(d / "c_2x2.vcf"), reads2=r2, devices=2,
               extra=cpu)
    assert two == one and len(one) > 200
    assert two == jax_vcf("pe", devices=2)
    assert {"snv", "del"} <= _types(two)


def test_failing_rank_ends_the_run(fixtures):
    """A rank that fails before the collectives (its FASTA is missing)
    exits non-zero and destroys its process group, and the rank waiting
    in the all-reduce for it ends too, long before the group's timeout."""
    d, inputs = fixtures
    fa, fq, _ = inputs["se"]
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for pid, fasta in ((0, fa), (1, str(d / "missing.fa"))):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", PORT, "--pid", str(pid), "--num", "2",
             "--coordinator", f"127.0.0.1:{port}", "--fasta", fasta,
             "--reads", fq, "--out", str(d / "fail.vcf"), "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE))
    t0 = time.time()
    try:
        errs = [p.communicate(timeout=120)[1].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert procs[1].returncode != 0 and "missing.fa" in errs[1], errs[1]
    assert procs[0].returncode != 0, errs[0]
    assert time.time() - t0 < 120
    assert not os.path.exists(d / "fail.vcf")


def test_cuda_default_raises_without_card(fixtures, monkeypatch):
    """run_host maps on "cuda" unless asked for the CPU: with no card
    visible it raises (nothing moves to the CPU) and leaves no process
    group behind."""
    d, inputs = fixtures
    fa, fq, _ = inputs["se"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for devices in (1, 2):
        with pytest.raises((RuntimeError, ValueError), match="CUDA"):
            mh.run_host(0, 1, f"127.0.0.1:{_free_port()}", fa, fq,
                        str(d / "nocard.vcf"), "multihost-test",
                        devices=devices)
        assert not dist.is_initialized()
    assert not os.path.exists(d / "nocard.vcf")


def _profile(break_point, insert_map, delete_map):
    class P:
        pass
    p = P()
    p.break_point, p.insert_map, p.delete_map = (break_point, insert_map,
                                                 delete_map)
    return p


def test_aux_stream_matches_jax():
    """The aux stream (template tests/test_multihost.py:181): indel seqs
    longer than 8 bp (and than one 15-base word), counts up to the int32
    limit, discord sites; the port's words equal the reference's, and
    each package decodes the other's stream to the same maps."""
    long_seq = "ACGTACGTACGTACGTACGTA"          # 21 bp
    p = _profile({123456: 3, 99: 200000, 7: (1 << 31) - 1},
                 {500: {long_seq: 7, "AC": 1}, 9: {"T" * 31: 1 << 30}},
                 {700: {"G" * 40: 2}})
    inv, tnl = [(10, 4), (20, 5)], [(30, 6)]
    words = mh._serialize_aux(p, inv, tnl)
    assert words.dtype == np.int32
    assert np.array_equal(words, jmh._serialize_aux(p, inv, tnl))
    for decode in (mh._decode_aux, jmh._decode_aux):
        q = _profile({}, {}, {})
        inv2, tnl2 = [], []
        decode(words, words.size, q, inv2, tnl2)
        assert (q.break_point, q.insert_map, q.delete_map) == (
            p.break_point, p.insert_map, p.delete_map)
        assert inv2 == inv and tnl2 == tnl


def test_stat_words_above_2_31():
    """The run statistics travel as hi/lo int32 words and are summed in
    Python on rank 0, as the reference's (multihost.py:232-236, :316-321):
    per-host values above 2^31 (read_length_sum of a few Gbp) sum exactly
    over three hosts."""
    class St:
        pass
    hosts = []
    for k in range(3):
        st = St()
        (st.total_reads, st.total_mapped, st.total_paired,
         st.total_paired_distance, st.read_length_sum) = (
            40_000_000 + k, 39_000_000, 19_000_000 + 7 * k,
            (1 << 33) + k, 6_000_000_000 + (1 << 31) * k)
        hosts.append(st)
    rows = np.stack([mh._stat_words(st) for st in hosts])
    assert rows.dtype == np.int32 and rows.shape == (3, 2 * mh.N_STATS)
    # the reference's words: its inline hi/lo split
    for st, row in zip(hosts, rows):
        vals = [st.total_reads, st.total_mapped, st.total_paired,
                st.total_paired_distance, st.read_length_sum]
        want = [w for v in vals for w in (v >> 30, v & ((1 << 30) - 1))]
        assert row.tolist() == want
    sums = mh._sum_stat_words(rows)
    assert sums == [sum(getattr(st, f) for st in hosts) for f in (
        "total_reads", "total_mapped", "total_paired",
        "total_paired_distance", "read_length_sum")]
    assert sums[4] > 1 << 34


def _fasta_wrapped(path, n, rng):
    with open(path, "w") as f:
        for i in range(n):
            s = "".join("ACGT"[c] for c in rng.integers(0, 4, 60 + 37 * i))
            f.write(f">r{i}\n")
            for j in range(0, len(s), 70):
                f.write(s[j:j + 70] + "\n")


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("fmt", ["fastq", "fasta", "interleaved"])
def test_shard_fastq_matches_jax(tmp_path, fmt, n):
    """The port's input shards equal the reference's, file for file: FASTQ
    records, FASTA records wrapped over several lines, and interleaved
    pairs (mates on one host)."""
    rng = np.random.default_rng(3)
    src = str(tmp_path / f"in.{fmt}")
    if fmt == "fasta":
        _fasta_wrapped(src, 11, rng)
    else:
        with open(src, "w") as f:
            for i in range(13):
                s = "".join("ACGT"[c] for c in rng.integers(0, 4, 50))
                f.write(f"@q{i}\n{s}\n+\n{'I' * 50}\n")
    inter = fmt == "interleaved"
    total = 0
    for pid in range(n):
        a, b = str(tmp_path / f"p{pid}"), str(tmp_path / f"j{pid}")
        na = mh._shard_fastq(src, a, pid, n, interleaved=inter)
        nb = jmh._shard_fastq(src, b, pid, n, interleaved=inter)
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
        assert na == nb
        total += na
    assert total == (11 if fmt == "fasta" else 13)
