"""The port's stage registry (mapcaller_tpu_torch/stage_prof.py) on the
CPU, on the planted paired-end dataset (20 kb genome, 3,000 reads,
stream batches of 1,024):

  * MC_STAGE_PROF off: no `[stage-prof]` line, no `mc.*` span in a
    profiler trace, the C++ host leg's counters all zero;
  * on: the last line holds every span and counter, and the reads by
    class add up to the reads mapped;
  * under a profiler each `mc.<key>` span's summed duration equals the
    line's seconds, and each child lies inside its parent;
  * two libraries (`-f` twice) summed in one line;
  * each of the benchmark's readers of the line (mcbench/metrics/), on a
    canned line and on a line of the five mapping stages alone;
  * `call` covers every `call_*` span, with and without -gvcf."""
import contextlib
import json
import os

import pytest
import torch

from mapcaller_tpu_torch import native, runner, stage_prof
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.index.fmindex import build_index, load_index
from mapcaller_tpu_torch.simulator import write_planted_dataset

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(batch_size=1024, stream_batch_size=1024, max_read_len=128,
           prefix_skip_k=6, compact_factor=1, device="cpu")
N_PAIRS = 1500
CHILDREN = {"map": ("load", "evidence_setup", "parse", "submit", "collect",
                    "host_cpp", "evidence", "finalize"),
            "call": ("call_prep", "call_device", "call_records", "call_sv",
                     "call_write")}
KEYS = set(stage_prof.SPANS) | set(stage_prof.COUNTS) | {"host_align"}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stage_spans"))
    fa, f1, f2 = write_planted_dataset(d, n_pairs=N_PAIRS)
    prefix = os.path.join(d, "idx")
    build_index(fa, prefix)
    return d, prefix, f1, f2


def _sample(planted, monkeypatch, capsys, flag, libs=1, gvcf=False,
            trace=False):
    """One sample as the benchmark runs it: an engine built, reset_run,
    run_mapping and run_calling. -> (stderr, engine, profiler events:
    (name, start us, end us) of the `mc.*` spans, or None)."""
    d, prefix, f1, f2 = planted
    if flag:
        monkeypatch.setenv("MC_STAGE_PROF", "1")
    else:
        monkeypatch.delenv("MC_STAGE_PROF", raising=False)
    cfg = Config(index_prefix=prefix, read_files1=[f1] * libs,
                 read_files2=[f2] * libs, gvcf=gvcf,
                 vcf_file=os.path.join(d, "out.vcf"),
                 log_file=os.path.join(d, "job.log"), **RUN)
    engine = runner.make_engine(load_index(prefix), cfg)
    capsys.readouterr()
    with (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) if trace
          else contextlib.nullcontext()) as prof:
        engine.reset_run()
        runner.run_mapping(engine, cfg, 0.0)
        runner.run_calling(engine, cfg, "mapcaller")
    err = capsys.readouterr().err
    spans = None
    if prof is not None:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith("mc.")]
    return err, engine, spans


def _line(err):
    lines = [ln for ln in err.splitlines() if ln.startswith("[stage-prof] ")]
    assert lines, err[-2000:]
    return json.loads(lines[-1].split("] ", 1)[1])


def test_flag_off_leaves_no_line_span_or_count(planted, monkeypatch,
                                                capsys):
    err, engine, spans = _sample(planted, monkeypatch, capsys, False,
                                 trace=True)
    assert engine.stats.total_reads == 2 * N_PAIRS
    assert "[stage-prof]" not in err
    assert spans == []
    assert set(native.prof_fetch().values()) == {0}


def test_flag_on_line_holds_every_key(planted, monkeypatch, capsys):
    err, engine, _ = _sample(planted, monkeypatch, capsys, True)
    line = _line(err)
    assert set(line) == KEYS
    assert (line["reads_fast"] + line["reads_slow"] + line["reads_nocand"]
            == engine.stats.total_reads == 2 * N_PAIRS)
    assert line["reads_fast"] > 0 and line["batches"] == 3
    assert stage_prof.host_leg_ns["align"] > 0
    assert line["host_align"] == round(stage_prof.host_leg_ns["align"] * 1e-9,
                                       3)
    # the mapping line, printed first, already holds mapping's keys
    first = json.loads([ln for ln in err.splitlines()
                        if ln.startswith("[stage-prof] ")][0].split("] ")[1])
    assert first["parse"] == line["parse"] and first["call"] == 0.0


def test_spans_match_the_trace_and_nest(planted, monkeypatch, capsys):
    err, _, spans = _sample(planted, monkeypatch, capsys, True, trace=True)
    line = _line(err)
    for key in stage_prof.SPANS:
        got = sum(e - s for n, s, e in spans if n == "mc." + key) * 1e-6
        assert got == pytest.approx(line[key], rel=0.02, abs=0.002), key
    assert {n for n, _, _ in spans} >= {"mc." + k for k in stage_prof.SPANS
                                        if k != "evidence" or line[k] > 0}
    for parent, kids in CHILDREN.items():
        outer = [(s, e) for n, s, e in spans if n == "mc." + parent]
        assert len(outer) == 1
        for n, s, e in spans:
            if n[3:] in kids:
                assert outer[0][0] <= s and e <= outer[0][1], n


def test_two_libraries_sum_in_one_line(planted, monkeypatch, capsys):
    err1, _, _ = _sample(planted, monkeypatch, capsys, True)
    err2, engine, _ = _sample(planted, monkeypatch, capsys, True, libs=2)
    one, two = _line(err1), _line(err2)
    assert engine.stats.total_reads == 4 * N_PAIRS
    assert two["batches"] == 2 * one["batches"]
    assert (two["reads_fast"] + two["reads_slow"] + two["reads_nocand"]
            == 4 * N_PAIRS)
    for k in ("reads_fast", "reads_slow", "reads_nocand"):
        assert two[k] == 2 * one[k]
    # one line a run_mapping and one a run_calling, whatever the libraries
    assert err2.count("[stage-prof] ") == 2


@pytest.mark.parametrize("gvcf", [False, True], ids=["vcf", "gvcf"])
def test_call_covers_every_call_span(planted, monkeypatch, capsys, gvcf):
    err, _, spans = _sample(planted, monkeypatch, capsys, True, gvcf=gvcf,
                            trace=True)
    line = _line(err)
    kids = CHILDREN["call"]
    assert sum(line[k] for k in kids) <= line["call"] + 0.002
    (c0, c1), = [(s, e) for n, s, e in spans if n == "mc.call"]
    assert {n[3:] for n, s, e in spans if c0 <= s and e <= c1} >= set(kids)
    assert all(n[3:] not in kids or c0 <= s and e <= c1
               for n, s, e in spans)
    # the caller's scan and fetch; -gvcf adds the NOR blocks (and the
    # fetch of columns at NOR positions the first fetch missed)
    n_device = sum(n == "mc.call_device" for n, _, _ in spans)
    assert n_device == 2 if not gvcf else n_device >= 3


# ---- the benchmark's readers of the line ----------------------------------

FIVE = {"parse": 0.5, "submit": 0.1, "collect": 0.02, "host_cpp": 1.25,
        "evidence": 0.03, "batches": 48}
CANNED = dict(FIVE, reset=0.2, map=3.0, load=0.4, evidence_setup=0.05,
              finalize=0.25, call=1.0, call_prep=0.1, call_device=0.05,
              call_records=0.6, call_sv=0.02, call_write=0.2,
              reads_fast=300_000, reads_slow=150_000, reads_nocand=50_000,
              host_align=0.75)


@pytest.mark.parametrize("name,want", [
    # two samples of 500,000 reads: s/Mread sums both over 1 Mread,
    # s/sample is the mean (the samples' values 1x and 3x)
    ("engine.reset_s", 0.4), ("stream.load_s", 1.6),
    ("evidence.sample_s", 0.6), ("host_leg.align_s", 3.0),
    ("seed_chain.slow_share", 30.0), ("calling.device_s", 0.1),
    ("calling.records_s", 1.4), ("calling.sv_s", 0.04),
    ("calling.write_s", 0.4),
])
def test_reader_of_the_line(name, want):
    from mcbench import harness
    bench = os.path.join(REPO, "mcbench")
    read = harness.load_reader(bench, name)
    triple = {k: 3 * v for k, v in CANNED.items()}

    def view(lines):
        return harness.WindowView(
            reads=1_000_000, seconds=20.0, samples=[
                dict(stages=ln, call_s=1.0, reads=500_000) for ln in lines],
            trace=None, genome_length=4_600_000, peaks=None, bench_dir=bench)

    assert read(view([CANNED, triple])) == pytest.approx(want, rel=1e-9)
    assert read(view([FIVE, FIVE])) is None
    assert read(view([CANNED, FIVE])) is None
    assert read(view([None, None])) is None
