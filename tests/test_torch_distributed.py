"""merge_engines in the port (mapcaller_tpu_torch/parallel/distributed.py)
on the CPU: N engines map disjoint read shards, each engine's raw planes
come down through its evidence's download_raw_into (DeviceEvidence,
MultiDeviceEvidence under -devices, BigDeviceEvidence under big_x64) or
stay in the host profile (device_evidence=False), the evidence reduces by
sum/merge into the first engine and one calling pass writes the VCF. With
2 and 3 engines, in each of the four evidence modes, the merged VCF must
equal the port's single engine over all reads and the reference package's
merge_engines over the same shards (template tests/test_distributed.py:37,
whose toy genome is absent, so the paired-end fixture of
tests/test_multihost.py is built with numpy)."""
import time

import pytest
import torch

from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.index.fmindex import build_index as jax_build_index
from mapcaller_tpu.parallel.devices import \
    MultiDeviceBackend as JaxMultiDeviceBackend
from mapcaller_tpu.parallel.distributed import \
    merge_engines as jax_merge_engines
from mapcaller_tpu.pipeline.device_backend import DeviceBackend as JaxBackend
from mapcaller_tpu.pipeline.engine import MappingEngine as JaxEngine
from mapcaller_tpu.pipeline.stream import \
    run_stream_mapping as jax_run_stream
from mapcaller_tpu.runner import run_calling as jax_run_calling
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.index.fmindex import build_index
from mapcaller_tpu_torch.parallel.devices import (MultiDeviceBackend,
                                                  MultiDeviceEvidence)
from mapcaller_tpu_torch.parallel.distributed import merge_engines
from mapcaller_tpu_torch.pipeline.big_profile import BigDeviceEvidence
from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
from mapcaller_tpu_torch.pipeline.device_profile import DeviceEvidence
from mapcaller_tpu_torch.pipeline.engine import MappingEngine
from mapcaller_tpu_torch.pipeline.stream import run_stream_mapping
from mapcaller_tpu_torch.runner import run_calling
from test_distributed import _split_fastq
from test_multihost import _write_pe_fixtures

torch.set_num_threads(1)
# the reference test's run settings
RUN = dict(batch_size=256, stream_batch_size=256, max_read_len=128)
CPU = torch.device("cpu")

# mode -> (Config flags of both packages, the port's backend, the
# reference's backend, the port's evidence class or None for host
# evidence)
MODES = {
    "device": ({}, lambda idx, cfg: DeviceBackend(idx, cfg),
               lambda idx, cfg: JaxBackend(idx, cfg), DeviceEvidence),
    "host": (dict(device_evidence=False),
             lambda idx, cfg: DeviceBackend(idx, cfg),
             lambda idx, cfg: JaxBackend(idx, cfg), None),
    "multi": (dict(devices=2),
              lambda idx, cfg: MultiDeviceBackend(idx, cfg,
                                                  devices=[CPU] * 2),
              lambda idx, cfg: JaxMultiDeviceBackend(idx, cfg, 2),
              MultiDeviceEvidence),
    "big": (dict(index_shards=2, big_x64=True),
            lambda idx, cfg: DeviceBackend(idx, cfg,
                                           shard_devices=[CPU] * 2),
            lambda idx, cfg: JaxBackend(idx, cfg), BigDeviceEvidence),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The paired-end fixture (8 kb genome, pair tiling, two SNP pileups
    and a deletion pileup), both packages' indexes of its FASTA, and its
    reads split into 2 and 3 contiguous shards."""
    d = tmp_path_factory.mktemp("torch_distributed")
    fasta, r1, r2 = _write_pe_fixtures(d)
    shards = {}
    for n in (2, 3):
        s1 = [str(d / f"r1_{n}_{i}.fq") for i in range(n)]
        s2 = [str(d / f"r2_{n}_{i}.fq") for i in range(n)]
        _split_fastq(r1, s1)
        _split_fastq(r2, s2)
        shards[n] = list(zip(s1, s2))
    return d, build_index(fasta), jax_build_index(fasta), (r1, r2), shards


def _engine(pkg, data, mode, tag, reads):
    """One engine of package pkg ("port" or "jax") in evidence mode
    `mode`, after the stream over reads (r1, r2); not finalized."""
    d, idx, jidx, _, _ = data
    flags, port_be, jax_be, _ = MODES[mode]
    files = dict(vcf_file=str(d / f"{tag}.vcf"), log_file=str(d / f"{tag}.log"))
    if pkg == "port":
        cfg = Config(device="cpu", **RUN, **flags, **files)
        engine = MappingEngine(idx, cfg, backend=port_be(idx, cfg))
        run = run_stream_mapping
    else:
        cfg = JaxConfig(**RUN, **flags, **files)
        engine = JaxEngine(jidx, cfg, backend=jax_be(jidx, cfg))
        run = jax_run_stream
    cfg.read_files1, cfg.read_files2 = [reads[0]], [reads[1]]
    run(engine, cfg, time.time())
    return engine


def _vcf_body(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("##")]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [2, 3])
def test_merged_vcf_matches_single_and_jax(data, mode, n):
    """n engines on disjoint shards, merged by the port's merge_engines,
    write the VCF of one engine over every read and the reference's
    merge_engines VCF over the same shards; each engine's raw planes came
    down through its own evidence form, once."""
    _, _, _, reads, shards = data
    evidence = MODES[mode][3]
    engines = [_engine("port", data, mode, f"{mode}{n}", s)
               for s in shards[n]]
    if evidence is None:
        assert all(e.device_evidence is None for e in engines)
    else:
        assert all(type(e.device_evidence) is evidence for e in engines)
    root = merge_engines(engines)
    assert root is engines[0]
    assert all(e.device_evidence is None for e in engines)
    run_calling(root, root.cfg, "x")
    merged = _vcf_body(root.cfg.vcf_file)

    one = _engine("port", data, mode, f"{mode}{n}_one", reads)
    one.finalize()
    run_calling(one, one.cfg, "x")

    jengines = [_engine("jax", data, mode, f"j{mode}{n}", s)
                for s in shards[n]]
    jroot = jax_merge_engines(jengines)
    jax_run_calling(jroot, jroot.cfg, "x")

    assert merged == _vcf_body(one.cfg.vcf_file)
    assert merged == _vcf_body(jroot.cfg.vcf_file)
    assert root.stats.total_reads == one.stats.total_reads
    assert root.stats.total_mapped == one.stats.total_mapped
    types = {ln.split("TYPE=")[1].split(";")[0].split("\t")[0]
             for ln in merged if "TYPE=" in ln}
    assert {"snv", "del"} <= types, types
