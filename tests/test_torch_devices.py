"""`-devices N` in the port (mapcaller_tpu_torch/parallel/devices.py) on
the CPU: N replicas of the device backend on ["cpu"] * N, batches
round-robin, the host leg in submission order. The N-replica run must
write the one-replica run's SAM and VCF bytes and the reference package's
`-devices N` bytes (its virtual CPU devices), also where the duplicate
gate binds; the merged evidence planes must equal one device's in every
word; and the flag's refusals hold. Dataset and runs: the reference's
tests/test_devices.py."""
import time

import pytest
import torch

from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.parallel.devices import \
    MultiDeviceBackend as JaxMultiDeviceBackend
from mapcaller_tpu.pipeline.engine import MappingEngine as JaxEngine
from mapcaller_tpu.pipeline.stream import \
    run_stream_mapping as jax_run_stream
from mapcaller_tpu_torch import runner
from mapcaller_tpu_torch.cli import parse_args
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.index.fmindex import load_index
from mapcaller_tpu_torch.parallel.devices import (MultiDeviceBackend,
                                                  MultiDeviceEvidence)
from mapcaller_tpu_torch.pipeline import device_profile
from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
from mapcaller_tpu_torch.pipeline.engine import MappingEngine
from mapcaller_tpu_torch.pipeline.stream import run_stream_mapping
from test_devices import _make_dataset

torch.set_num_threads(1)
NDEV = 4
# the reference test's run settings
RUN = dict(batch_size=256, stream_batch_size=256, max_read_len=128)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The reference test's 20 kb genome with SNPs and a PCR duplicate
    stack spread over the file (so its copies land in batches mapped by
    different replicas), its index saved and loaded by the port, and the
    reference package's -devices 4 SAM and VCF on its virtual CPU
    devices."""
    d = tmp_path_factory.mktemp("torch_devices")
    jidx, f1, f2 = _make_dataset(d)
    prefix = str(d / "idx")
    jidx.save(prefix)
    cfg = JaxConfig(sam_file=str(d / "jax.sam"), vcf_file=str(d / "jax.vcf"),
                    log_file=str(d / "jax.log"), devices=NDEV, **RUN)
    engine = JaxEngine(jidx, cfg,
                       backend=JaxMultiDeviceBackend(jidx, cfg, NDEV))
    cfg.read_files1, cfg.read_files2 = [f1], [f2]
    parts = []
    jax_run_stream(engine, cfg, time.time(), parts.append)
    engine.finalize()
    from mapcaller_tpu.runner import run_calling as jax_run_calling
    jax_run_calling(engine, cfg, "test-devices")
    with open(cfg.vcf_file) as f:
        jvcf = [ln for ln in f.read().splitlines() if not ln.startswith("##")]
    return d, load_index(prefix), f1, f2, "".join(parts).splitlines(), jvcf


def _run(dataset, tag, backend_fn, **flags):
    """The port's stream on the dataset with the backend backend_fn(idx,
    cfg) builds -> (SAM body lines, VCF lines without ##, engine,
    backend, the evidence planes before calling, host copies)."""
    d, idx, f1, f2, _, _ = dataset
    cfg = Config(device="cpu", sam_file=str(d / f"{tag}.sam"),
                 vcf_file=str(d / f"{tag}.vcf"),
                 log_file=str(d / f"{tag}.log"), **RUN, **flags)
    backend = backend_fn(idx, cfg)
    engine = MappingEngine(idx, cfg, backend=backend)
    cfg.read_files1, cfg.read_files2 = [f1], [f2]
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    engine.finalize()
    ev = engine.device_evidence
    planes = {k: getattr(ev.planes, k).clone() for k in
              ("acgt", "exact_diff", "f_diff", "multi_diff")}
    runner.run_calling(engine, cfg, "test-devices")
    with open(cfg.vcf_file) as f:
        vcf = [ln for ln in f.read().splitlines() if not ln.startswith("##")]
    return "".join(parts).splitlines(), vcf, engine, backend, planes


def _replicas(n):
    return lambda idx, cfg: MultiDeviceBackend(idx, cfg,
                                               devices=["cpu"] * n)


@pytest.fixture(scope="module")
def one(dataset):
    return _run(dataset, "one", lambda idx, cfg: DeviceBackend(idx, cfg))


@pytest.mark.parametrize("fold", [False, True])
def test_devices_byte_parity(dataset, one, fold):
    """-devices 4 on four CPU replicas writes one replica's SAM and VCF
    and the reference's -devices 4 bytes, with the evidence applied on
    the batches' owners (stand-alone or folded into the dispatch); every
    replica mapped batches and the merged planes equal one device's."""
    _, _, _, _, jsam, jvcf = dataset
    sam1, vcf1, eng1, _, planes1 = one
    device_profile.STATS.reset()
    samN, vcfN, engN, be, planesN = _run(dataset, f"multi{int(fold)}",
                                         _replicas(NDEV), fold_evidence=fold)
    assert isinstance(engN.device_evidence, MultiDeviceEvidence)
    assert be.n_devices == NDEV and min(be.batches) >= 1
    st = device_profile.STATS
    assert (st.folded > 0) == fold and (st.applies > 0) == (not fold)
    assert samN == sam1
    assert vcfN == vcf1
    assert len(sam1) == engN.stats.total_reads > 3000
    assert len(vcf1) > 3          # header + the planted SNPs called
    assert samN == jsam
    assert vcfN == jvcf
    assert engN.stats.total_reads == eng1.stats.total_reads
    assert engN.stats.total_mapped == eng1.stats.total_mapped
    for k in planes1:
        assert torch.equal(planesN[k], planes1[k]), k
    assert all(r.planes is None for r in engN.device_evidence.reps[1:])


def test_devices_dup_gate_binds(dataset):
    """The duplicate stack exercises the gate: the read count at the
    duplicated start saturates at cfg.max_duplicate in the 4-replica run,
    whose copies were mapped by different replicas."""
    _, _, eng, be, _ = _run(dataset, "gate", _replicas(NDEV))
    assert int(eng.profile.read_count[5000]) == eng.cfg.max_duplicate
    assert sum(be.batches) >= NDEV


def test_devices_bytes_do_not_depend_on_k(dataset, one):
    """Each replica picks its prefix-skip depth K from the free memory it
    sees, so replicas on one card may differ: replicas at K = 6, 0, 8 and
    2 write the one-device bytes (the seed set does not depend on K)."""
    sam1, vcf1, _, _, _ = one

    def mixed(idx, cfg):
        be = MultiDeviceBackend(idx, cfg, devices=["cpu"] * NDEV)
        for r, k in zip(be.bes, (6, 0, 8, 2)):
            r.pfx_k = k
        return be

    sam, vcf, _, be, _ = _run(dataset, "mixed_k", mixed)
    assert [r.fm3.pfx_k for r in be.bes] == [6, 0, 8, 2]
    assert sam == sam1 and vcf == vcf1


def test_devices_runner_builds_replicas(dataset, one):
    """Through the runner: -devices 4 on cfg.device "cpu" takes four CPU
    replicas and writes the one-replica bytes."""
    d, _, f1, f2, _, _ = dataset
    sam1, vcf1, _, _, _ = one
    cfg = Config(device="cpu", index_prefix=str(d / "idx"),
                 read_files1=[f1], read_files2=[f2], devices=NDEV,
                 sam_file=str(d / "run.sam"), vcf_file=str(d / "run.vcf"),
                 log_file=str(d / "run.log"), **RUN)
    made = []
    orig = runner.make_engine

    def spy(idx, c):
        made.append(orig(idx, c))
        return made[-1]

    runner.make_engine, saved = spy, runner.make_engine
    try:
        assert runner.run_pipeline(cfg, "mapcaller") == 0
    finally:
        runner.make_engine = saved
    be = made[0].backend
    assert isinstance(be, MultiDeviceBackend) and be.n_devices == NDEV
    assert all(d_.type == "cpu" for d_ in be.devs)
    with open(cfg.sam_file) as f:
        body = [ln for ln in f.read().splitlines() if not ln.startswith("@")]
    assert body == sam1
    with open(cfg.vcf_file) as f:
        vcf = [ln for ln in f.read().splitlines() if not ln.startswith("##")]
    assert vcf == vcf1


def test_cli_devices_flag():
    cfg = parse_args(["prog", "-i", "x", "-f", "a.fq", "-devices", "4"])
    assert cfg.devices == 4
    cfg = parse_args(["prog", "-i", "x", "-f", "a.fq", "-devices", "auto"])
    assert cfg.devices == 0


def test_devices_shards_exclusive(dataset):
    _, idx, _, _, _, _ = dataset
    cfg = Config(device="cpu", devices=2, index_shards=2, backend="device")
    with pytest.raises(ValueError, match="separate scale axes"):
        runner.make_engine(idx, cfg)


def test_devices_above_visible_cards_raise(dataset, monkeypatch):
    """On "cuda", -devices N takes the first N visible cards and raises
    when fewer are visible; an explicit list must hold N devices."""
    _, idx, _, _, _, _ = dataset
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = Config(device="cuda", devices=2, backend="device")
    with pytest.raises(ValueError, match="-devices 2 but only 1 CUDA"):
        MultiDeviceBackend(idx, cfg)
    with pytest.raises(ValueError, match="-devices 2 but only 1 CUDA"):
        runner.make_engine(idx, cfg)
    with pytest.raises(ValueError, match="3 devices given"):
        MultiDeviceBackend(idx, Config(device="cpu"), 2,
                           devices=["cpu"] * 3)
