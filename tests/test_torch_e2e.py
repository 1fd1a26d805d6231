"""End to end on the CPU: the port (mapcaller_tpu_torch, plain PyTorch
versions of its kernels) must write SAM and VCF byte-identical to the
reference package on a small planted dataset, import neither JAX nor the
reference package, and refuse the options it does not port yet."""
import os
import subprocess
import sys

import pytest
import torch

from mapcaller_tpu import runner as jax_runner
from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu_torch import runner
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.ops import nw_device
from mapcaller_tpu_torch.simulator import write_planted_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's CPU runs are many small tensor ops: one intra-op thread runs
# them several times faster than a thread pool, and leaves the cores to
# the other test workers
torch.set_num_threads(1)
# pinned on both sides: knobs whose value the packages pick by platform
PINNED = dict(batch_size=256, stream_batch_size=256, max_read_len=128,
              prefix_skip_k=6, compact_factor=1)


def _files(d, tag):
    return dict(sam_file=os.path.join(d, f"{tag}.sam"),
                vcf_file=os.path.join(d, f"{tag}.vcf"),
                log_file=os.path.join(d, f"{tag}.log"))


def _read(cfg):
    with open(cfg.sam_file) as f, open(cfg.vcf_file) as g:
        return f.read(), g.read()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The planted dataset, its index (built by the reference package
    and loaded by both), and the reference package's SAM and VCF with
    its Pallas NW in interpret mode and host evidence."""
    d = str(tmp_path_factory.mktemp("torch_e2e"))
    fa, f1, f2 = write_planted_dataset(d)
    prefix = os.path.join(d, "idx")
    build_index(fa, prefix)
    inputs = dict(index_prefix=prefix, read_files1=[f1], read_files2=[f2])
    cfg = JaxConfig(device_extension=True, device_evidence=False,
                    **inputs, **PINNED, **_files(d, "jax"))
    assert jax_runner.run_pipeline(cfg, "mapcaller") == 0
    return d, inputs, _read(cfg)


@pytest.mark.parametrize("device_extension", [True, "auto"])
def test_sam_vcf_equal_reference(data, monkeypatch, device_extension):
    """True sends every DP batch through nw_ops (its plain version on the
    CPU); "auto" keeps the scalar C++ aligner on the CPU."""
    d, inputs, (want_sam, want_vcf) = data
    pairs = []
    plain = nw_device.nw_ops_plain

    def counted(c1, *a):
        pairs.append(c1.shape[0])
        return plain(c1, *a)

    monkeypatch.setattr(nw_device, "nw_ops_plain", counted)
    cfg = Config(device="cpu", device_extension=device_extension,
                 **inputs, **PINNED, **_files(d, f"torch_{device_extension}"))
    assert runner.run_pipeline(cfg, "mapcaller") == 0
    sam, vcf = _read(cfg)
    assert sam == want_sam
    assert vcf == want_vcf
    n_calls = sum(1 for line in vcf.splitlines() if not line.startswith("#"))
    assert n_calls >= 12                  # most of the 16 planted variants
    if device_extension is True:
        assert sum(pairs) > 0
    else:
        assert not pairs


def test_import_isolation(data):
    """A fresh interpreter runs the port end to end on the CPU without
    importing jax or any module of the reference package."""
    d, inputs, (want_sam, _) = data
    cfg = dict(device="cpu", **inputs, **PINNED, **_files(d, "iso"))
    code = (
        "import sys\n"
        "from mapcaller_tpu_torch import runner\n"
        "from mapcaller_tpu_torch.config import Config\n"
        f"assert runner.run_pipeline(Config(**{cfg!r}), 'mapcaller') == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mapcaller_tpu' or m.startswith('mapcaller_tpu.')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=d, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(cfg["sam_file"]) as f:
        assert f.read() == want_sam


@pytest.mark.parametrize("option", [
    dict(compact_factor=2), dict(devices=2), dict(index_shards=2),
    dict(big_x64=True), dict(fold_evidence=True), dict(device_chain=False)])
def test_unported_options_raise(data, option):
    d, inputs, _ = data
    kw = dict(PINNED, **option)
    cfg = Config(device="cpu", **inputs, **kw, **_files(d, "unported"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.run_pipeline(cfg, "mapcaller")


def test_device_ksw2_raises(data):
    """-alg ksw2 has no device DP yet: forcing it raises instead of
    running the scalar aligner under the device flag."""
    d, inputs, _ = data
    cfg = Config(device="cpu", use_nw=False, device_extension=True,
                 **inputs, **PINNED, **_files(d, "ksw2"))
    with pytest.raises(NotImplementedError, match="C1"):
        runner.run_pipeline(cfg, "mapcaller")
