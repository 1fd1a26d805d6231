"""Whole runs of the harness on the CPU (the look for a card skipped, the
program's plain versions) on a tiny cell whose configuration, traffic
and an extra metric are new files alone; engine reuse; the faults of the
timed path that the comparison must catch; the control; the imports."""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from mcbench import control, harness
from mcbench.tests import tiny

torch.set_num_threads(2)
DUMMY = ("dummy.samples", "def read(view):\n    return float(len("
         "view.samples))\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny")),
                          extra_metrics=[DUMMY])


def test_a_new_cell_and_metric_are_files_alone(root, capsys, monkeypatch):
    rc, res, err = tiny.run(root, capsys, monkeypatch, seconds=6.0, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    m = res["metrics"]
    assert m["dummy.samples"]["value"] == res["attempted"] >= 2
    for name in ("stream.parse_s", "host_leg.cpp_s", "calling.job_s"):
        assert m[name]["value"] > 0
    assert list(res)[-1] == "checks"
    lines = err.strip().splitlines()
    assert all(ln.startswith("check ") for ln in lines[-len(res["checks"]):])


@pytest.fixture(scope="module")
def gvcf_root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny_gvcf")),
                          gvcf=True)


@pytest.mark.parametrize("which", ["vcf", "gvcf"])
def test_end_to_end_line(root, gvcf_root, capsys, monkeypatch, which):
    rc, res, err = tiny.run(root if which == "vcf" else gvcf_root, capsys,
                            monkeypatch, seed=2 ** 31 + 77, seconds=6.0)
    assert rc == 0, err[-3000:]
    assert set(res["metrics"]) == {"reads_per_s", "peak_device_gib",
                                   "setup_s"}
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["reads_lost"]["value"] == 0
    assert res["checks"]["vcf_differs"]["value"] == 0
    assert ("nor_depth_gap" in res["checks"]) == (which == "gvcf")


def test_reset_run_engine_writes_a_fresh_engines_vcf(root, tmp_path):
    """A second sample on a reset_run engine writes the VCF a fresh
    engine writes."""
    from mapcaller_tpu_torch import runner
    from mapcaller_tpu_torch.index.fmindex import load_index
    cell = harness.find_cell(root, "tiny.cell")
    ref = harness.genome(cell.config)
    prefix = harness.index_prefix(os.path.join(cell.bench_dir, "cache"),
                                  cell.config, ref)
    samples = []
    for seed in (31, 32):
        d = str(tmp_path / str(seed))
        os.makedirs(d)
        samples.append((harness.make_sample(cell.config, cell.traffic, seed,
                                            ref, d), d))
    (s1, d1), (s2, d2) = samples
    config = tiny.small_batches(harness.program_config)
    cfg, cmd = config(cell.config, cell.traffic, prefix, s1,
                                      d1, "cpu")
    engine = runner.make_engine(load_index(prefix), cfg)
    first = harness.run_sample(engine, cfg, cmd, d1 + "/a.vcf", False, False)
    cfg.read_files1, cfg.read_files2 = [s2.r1], [s2.r2]
    reused = harness.run_sample(engine, cfg, cmd, d2 + "/b.vcf", True, False)
    cfg2, _ = config(cell.config, cell.traffic, prefix, s2,
                                     d2, "cpu")
    fresh = harness.run_sample(runner.make_engine(load_index(prefix), cfg2),
                               cfg2, cmd, d2 + "/c.vcf", False, False)
    vcfs = [open(x["vcf"]).read() for x in (first, reused, fresh)]
    assert vcfs[1] == vcfs[2]
    assert vcfs[0] != vcfs[1]        # another sample, other calls


def _alter_alt(real):
    def write_variants(f, cfg, genome, profile, ref_chars, variants):
        for v in variants:
            if v.VarType == 0 and len(v.ALTstr) == 1:
                v.ALTstr = "ACGT"[("ACGT".index(v.ALTstr) + 1) % 4]
        return real(f, cfg, genome, profile, ref_chars, variants)
    return write_variants


def _half(real):
    def load(path):
        b = real(path)
        lines = b.split(b"\n")
        keep = (len(lines) // 8) * 4
        return b"\n".join(lines[:keep]) + b"\n"
    return load


FAULTS = {
    # a step that returns its state unchanged: the evidence apply (K2)
    "state_unchanged": ("mapcaller_tpu_torch.ops.mesh_kernels",
                        "apply_bits", lambda real: (
                            lambda planes, *a, **k: planes)),
    # half of every batch left out: the program reads half the records
    "half_batch": ("mapcaller_tpu_torch.pipeline.stream", "_load_bytes",
                   _half),
    # an answer altered where it is produced: each SNV's ALT at the writer
    "answer_altered": ("mapcaller_tpu_torch.io.vcf", "write_variants",
                       _alter_alt),
    # engine reuse that keeps the last sample's host planes
    "reset_keeps_state": ("mapcaller_tpu_torch.pipeline.engine",
                          "MappingEngine.reset_run", lambda real: (
                              lambda self: setattr(self, "device_evidence",
                                                   None))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, capsys, monkeypatch,
                                            fault):
    import importlib
    mod_name, attr, make = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    owner = mod
    if "." in attr:
        cls, attr = attr.split(".")
        owner = getattr(mod, cls)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    rc, res, err = tiny.run(root, capsys, monkeypatch, seed=41, seconds=6.0)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]
    assert res["failed"] == res["attempted"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5, 77])
def test_control_fails_and_reference_passes(root, seed):
    r = control.readings(root, "tiny.cell", seed)
    assert r["reference_passes"] and r["control_fails"], r


def test_no_jax_in_the_harness_or_a_cpu_run(root):
    """No module of the benchmark imports a top-level name jax, jaxlib,
    flax or mapcaller_tpu (compared whole), and a whole run in a fresh
    process ends without any of them loaded (the harness checks
    sys.modules after the window and exits 5)."""
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in glob.glob(os.path.join(bench, "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)
    code = ("import sys, json, torch; torch.set_num_threads(2);"
            "from mcbench import harness; from mcbench.tests import tiny;"
            "harness.program_config = tiny.small_batches("
            "harness.program_config);"
            f"rc = harness.main(['--workload', 'tiny.cell', '--seed', '9',"
            f" '--seconds', '5', '--trace', '0'], device='cpu',"
            f" root={root!r});"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})));"
            "sys.exit(rc)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tiny.ROOT, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & set(harness.FORBIDDEN)
    assert "mapcaller_tpu_torch" in loaded


@pytest.mark.chip
def test_a_cell_on_the_card(card, tmp_path):
    """One short run of ecoli.wgs50x through the command as the check
    runs it: correct, and every end-to-end metric there."""
    p = subprocess.run([sys.executable, "mcbench/run.py", "--workload",
                        "ecoli.wgs50x", "--seed", "12345", "--seconds", "10",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tiny.ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
