"""End to end on the CPU: the port (mapcaller_tpu_torch, plain PyTorch
versions of its kernels) must write SAM and VCF byte-identical to the
reference package on a small planted dataset — with device evidence (the
default), folded evidence, host evidence, -gvcf, -somatic, -monomorphic,
a -pfm round trip and a forced candidate-table overflow, and on a
repeat-rich set whose hit-buffer overflow reruns a batch — and on each
other single-card path (lane compaction, host chaining, the non-native
path, the 1-step index) the reference's bytes under the same flags;
import neither JAX nor the reference package; and refuse the options it
does not port yet (-devices and -shards: test_torch_devices.py,
test_torch_shards.py)."""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mapcaller_tpu import runner as jax_runner
from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.pipeline.device_backend import DeviceBackend as JaxBackend
from mapcaller_tpu_torch import runner
from mapcaller_tpu_torch.calling import device_call, scan_device
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.dna import decode
from mapcaller_tpu_torch.ops import fm_search, nw_device
from mapcaller_tpu_torch.pipeline import device_profile
from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
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


def _metrics(cfg):
    with open(cfg.log_file) as f:
        return json.loads([ln for ln in f if ln.startswith("{")][-1])


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


@pytest.fixture(scope="module")
def jax_modes(data):
    """The reference package's SAM and VCF, with its default (device)
    evidence, for the calling modes whose VCF differs from the default."""
    d, inputs, _ = data
    out = {}
    for mode in ("gvcf", "somatic", "monomorphic"):
        cfg = JaxConfig(device_extension=True, **{mode: True}, **inputs,
                        **PINNED, **_files(d, f"jax_{mode}"))
        assert jax_runner.run_pipeline(cfg, "mapcaller") == 0
        out[mode] = _read(cfg)
    return out


# mode -> (port flags, reference run, the evidence counts the port's run
# must show: applies, folded, scans, downloads, overflow fallbacks)
MODES = {
    "device": ({}, None, (12, 0, 1, 0, 0)),
    "fold": (dict(fold_evidence=True), None, (0, 12, 1, 0, 0)),
    "host": (dict(device_evidence=False), None, (0, 0, 0, 0, 0)),
    "gvcf": (dict(gvcf=True), "gvcf", (12, 0, 1, 0, 0)),
    "somatic": (dict(somatic=True), "somatic", (12, 0, 1, 0, 0)),
    "monomorphic": (dict(monomorphic=True), "monomorphic", (12, 0, 0, 1, 0)),
    "overflow": ({}, None, (12, 0, 1, 1, 1)),
    "pfm": ({}, None, (12, 0, 1, 1, 0)),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_evidence_modes_equal_reference(data, jax_modes, monkeypatch, mode):
    """Each evidence / calling mode of the port against the reference.
    "overflow" shrinks the port's CAND_CAP so calling takes the plane
    download and the host caller; "pfm" saves the profile after calling,
    then a second run calls from it without mapping."""
    d, inputs, default = data
    flags, ref, counts = MODES[mode]
    want_sam, want_vcf = jax_modes[ref] if ref else default
    if mode == "overflow":
        monkeypatch.setattr(scan_device, "CAND_CAP", 2)
        monkeypatch.setattr(device_call, "CAND_CAP", 2)
    if mode == "pfm":
        flags = dict(pfm_out=os.path.join(d, "torch.pfm"))
    device_profile.STATS.reset()
    cfg = Config(device="cpu", **flags, **inputs, **PINNED,
                 **_files(d, f"torch_{mode}"))
    assert runner.run_pipeline(cfg, "mapcaller") == 0
    st = device_profile.STATS
    assert (st.applies, st.folded, st.scans, st.downloads,
            st.overflow_fallbacks) == counts
    assert _read(cfg) == (want_sam, want_vcf)
    if mode == "pfm":
        device_profile.STATS.reset()
        cfg = Config(device="cpu", pfm_resume=flags["pfm_out"], **inputs,
                     **PINNED, **_files(d, "torch_resume"))
        assert runner.run_pipeline(cfg, "mapcaller") == 0
        assert device_profile.STATS.applies == 0
        with open(cfg.vcf_file) as f:
            assert f.read() == want_vcf


@pytest.fixture(scope="module")
def rerun_data(tmp_path_factory):
    """The reference package's repeat-rich fixture (its fold tests): a
    500-bp unit three times in a 9.5 kb genome and 1024 single-end reads,
    half of them inside the repeat, so a 1024-read batch overflows the
    slow-hit buffer and reruns at the larger tier; and the reference's
    SAM and VCF with its default (device) evidence."""
    d = str(tmp_path_factory.mktemp("torch_rerun"))
    rng = np.random.default_rng(33)
    unit = rng.integers(0, 4, 500).astype(np.uint8)
    genome = np.concatenate([rng.integers(0, 4, 4000).astype(np.uint8),
                             unit, unit, unit,
                             rng.integers(0, 4, 4000).astype(np.uint8)])
    fa = os.path.join(d, "rep.fa")
    with open(fa, "w") as f:
        f.write(f">chr1\n{decode(genome)}\n")
    fq = os.path.join(d, "m.fq")
    with open(fq, "w") as f:
        for k in range(1024):
            if k % 2 == 0:
                p = int(rng.integers(4000, 4000 + 3 * 500 - 100))
            else:
                p = int(rng.integers(0, len(genome) - 100))
            c = genome[p:p + 100].copy()
            if k % 11 == 5:
                c[50] = (c[50] + 1) % 4
            f.write(f"@m{k}\n{decode(c)}\n+\n{'I' * 100}\n")
    prefix = os.path.join(d, "idx")
    build_index(fa, prefix)
    inputs = dict(index_prefix=prefix, read_files1=[fq], batch_size=1024,
                  stream_batch_size=1024, max_read_len=256, prefix_skip_k=6,
                  compact_factor=1)
    cfg = JaxConfig(**inputs, **_files(d, "jax"))
    assert jax_runner.run_pipeline(cfg, "mapcaller") == 0
    return d, inputs, _read(cfg)


@pytest.mark.parametrize("fold", [False, True])
def test_tier_rerun_equal_reference(rerun_data, fold):
    """A tier rerun swaps the token's outputs before the evidence step:
    the plain apply must read the rerun's pd/mmp, and the folded path
    must undo its stale speculation first."""
    d, inputs, want = rerun_data
    device_profile.STATS.reset()
    cfg = Config(device="cpu", fold_evidence=fold, **inputs,
                 **_files(d, f"torch_{fold}"))
    assert runner.run_pipeline(cfg, "mapcaller") == 0
    assert _metrics(cfg)["n_tier_reruns"] > 0, "fixture must rerun a batch"
    st = device_profile.STATS
    assert (st.undos > 0) == fold and (st.folded > 0) == fold
    assert _read(cfg) == want


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
    importing jax or any module of the reference package, nor do the
    multi-host modules (parallel/multihost.py, parallel/distributed.py)
    and the mesh modules (parallel/mesh.py, ops/mesh_kernels.py) import
    them."""
    d, inputs, (want_sam, _) = data
    cfg = dict(device="cpu", **inputs, **PINNED, **_files(d, "iso"))
    code = (
        "import sys\n"
        "from mapcaller_tpu_torch import runner\n"
        "from mapcaller_tpu_torch.config import Config\n"
        "from mapcaller_tpu_torch.parallel import distributed, multihost\n"
        "from mapcaller_tpu_torch.parallel import mesh\n"
        "from mapcaller_tpu_torch.ops import mesh_kernels\n"
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


# path -> (flags for both packages, the port's function the path must
# call); "one_step" makes both backends find no room for the occ3 table
PATHS = {
    "compact": (dict(compact_factor=2), (fm_search, "_seed_scan3_compact")),
    "unchained": (dict(device_chain=False), (DeviceBackend, "submit_packed")),
    "non_native": (dict(use_native=False), (DeviceBackend, "submit")),
    "one_step": ({}, (fm_search, "_seed_scan")),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_paths_equal_reference(data, monkeypatch, path):
    """Each single-card path of the port against the reference package
    under the same flags (whose bytes equal its default's)."""
    d, inputs, default = data
    flags, (owner, name) = PATHS[path]
    if path == "one_step":
        monkeypatch.setattr(JaxBackend, "_occ3_fits",
                            lambda self, idx, cfg: False)
        monkeypatch.setattr(DeviceBackend, "_occ3_fits",
                            lambda self, idx: False)
    kw = dict(PINNED, **flags)
    jcfg = JaxConfig(device_extension=True, **inputs, **kw,
                     **_files(d, f"jax_{path}"))
    assert jax_runner.run_pipeline(jcfg, "mapcaller") == 0
    want = _read(jcfg)
    assert want == default
    calls = []
    orig = getattr(owner, name)

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(owner, name, spy)
    cfg = Config(device="cpu", **inputs, **kw, **_files(d, f"torch_{path}"))
    assert runner.run_pipeline(cfg, "mapcaller") == 0
    assert calls, f"{path}: {name} never ran"
    assert _read(cfg) == want


def _without_full_sa(load):
    """An index loader that drops the full SA of what `load` returns."""
    return lambda prefix: dataclasses.replace(load(prefix), sa_full=None)


@pytest.mark.parametrize("option", [
    dict(big_x64=True, index_shards=2, device_chain=False),
    dict(big_x64=True, index_shards=2, use_native=False),
    dict(big_x64=True, index_shards=2, devices=2),
    dict(big_x64=True, index_shards=2, device_chain=False,
         text_rows=1 << 31),
    dict(big_x64=True, index_shards=2, full_sa=False)],
    ids=["option0", "option1", "option2", "above_2_31", "no_full_sa"])
def test_unported_options_raise(data, monkeypatch, option):
    """The x64 big-genome path (big_x64 under -shards N) with host
    chaining, the non-native seeding path or an index without its full
    SA takes the single-card kernels over the 1-step index, as the
    reference does, the evidence (with device chaining) in the
    genome-sharded planes: SAM and VCF bytes equal the reference's under
    the same flags. A text of 2^31 rows raises there before any table is
    built (the reference cannot build its 1-step index either); -devices
    beside -shards raises as without big_x64 (the scale axes are
    separate)."""
    d, inputs, _ = data
    option = dict(option)
    if "text_rows" in option:
        stub = types.SimpleNamespace(seq_len=option.pop("text_rows"),
                                     sa_full=None)
        with pytest.raises(NotImplementedError,
                           match="int32 \\(text < 2\\^31 rows\\)"):
            DeviceBackend(stub, Config(device="cpu", **option))
        return
    if "devices" in option:
        cfg = Config(device="cpu", **inputs, **PINNED, **option,
                     **_files(d, "unported"))
        with pytest.raises(ValueError, match="separate scale axes"):
            runner.run_pipeline(cfg, "mapcaller")
        return
    tag = "_".join(f"{k}{v}" for k, v in option.items())
    jflags = {}
    if not option.pop("full_sa", True):
        monkeypatch.setattr(jax_runner, "load_index",
                            _without_full_sa(jax_runner.load_index))
        monkeypatch.setattr(runner, "load_index",
                            _without_full_sa(runner.load_index))
        # the reference's genome-sharded planes stage its x64 tables,
        # which need the full SA (mapcaller_tpu/pipeline/big_profile.py:
        # 69): it runs this index with host evidence, whose bytes its
        # device evidence writes elsewhere
        jflags = dict(device_evidence=False)
    device_profile.STATS.reset()
    jcfg = JaxConfig(device_extension=True, **inputs, **PINNED, **option,
                     **jflags, **_files(d, f"jax_{tag}"))
    assert jax_runner.run_pipeline(jcfg, "mapcaller") == 0
    cfg = Config(device="cpu", **inputs, **PINNED, **option,
                 **_files(d, f"torch_{tag}"))
    made = []
    make_engine = runner.make_engine
    monkeypatch.setattr(runner, "make_engine", lambda idx, c: made.append(
        make_engine(idx, c)) or made[-1])
    assert runner.run_pipeline(cfg, "mapcaller") == 0
    be = made[0].backend
    assert be.big and be.fm is not None and be.sharded_invocations == 0
    # with device chaining the evidence is in the genome-sharded planes
    assert (device_profile.STATS.applies > 0) == (
        option.get("device_chain", True) and option.get("use_native", True))
    assert _read(cfg) == _read(jcfg)
