"""Each per-layer reader (metrics/<name>.py) on a canned profiler trace
and canned MC_STAGE_PROF lines, and the harness's reading of both."""
import json
import os

import pytest

from mcbench import devtrace, harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE = ('[stage-prof] {"parse": 0.5, "submit": 0.1, "collect": 0.02, '
         '"host_cpp": 1.25, "evidence": 0.03, "batches": 48}')


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def canned_trace():
    """Two samples of 10 s (0-10 s, 10-20 s) and a third not counted;
    each: reset 0-1, mapping 1-7, calling 7-10 (seconds in the sample)."""
    ev = []
    for k in range(3):
        t = k * 10e6
        ev += [_ev("user_annotation", "sample", t, 10e6),
               _ev("user_annotation", "reset", t, 1e6),
               _ev("user_annotation", "mapping", t + 1e6, 6e6),
               _ev("user_annotation", "calling", t + 7e6, 3e6),
               _ev("user_annotation", "seed_scan", t + 2e6, 1e6),
               _ev("kernel", "void (anonymous namespace)::seed_scan3_kernel"
                   "<int>(int const*)", t + 2e6, 2e5),
               _ev("kernel", "(anonymous namespace)::chain_hits_kernel("
                   "int const*)", t + 2.3e6, 1e5),
               # overlaps the scan: busy time counts it once
               _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)",
                   t + 2.1e6, 1.5e5),
               _ev("kernel", "(anonymous namespace)::evidence_finalize_kernel"
                   "(FinIn, FinOut)", t + 7.5e6, 1e3),
               _ev("kernel", "(anonymous namespace)::seed_scan3_big_kernel",
                   t + 8e6, 1e5)]
    ev.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 0})
    return ev


def view(samples=None, trace=True):
    tr = devtrace.from_events(canned_trace(), 2) if trace else None
    samples = samples or [dict(stages=json.loads(STAGE.split("] ", 1)[1]),
                               call_s=3.0, reads=500_000)] * 2
    return harness.WindowView(reads=1_000_000, seconds=20.0, samples=samples,
                              trace=tr, genome_length=4_600_000,
                              peaks={"hbm_bytes_per_s": 3.35e12},
                              bench_dir=BENCH)


def reader(name):
    return harness.load_reader(BENCH, name)


@pytest.mark.parametrize("name,want", [
    ("stream.parse_s", 1.0), ("stream.collect_wait_s", 0.04),
    ("seed_chain.submit_s", 0.2), ("host_leg.cpp_s", 2.5),
    ("evidence.apply_s", 0.06), ("calling.job_s", 3.0),
    # scan 0.2 + hits 0.1 + big scan 0.1 s a sample, two samples, 1 Mread
    ("seed_chain.device_ms", 800.0),
    # busy a sample: the scan and the copy 2.0-2.25 s, the hits 2.3-2.4,
    # the finalize 0.001, the big scan 0.1: 0.451 s of 10
    ("device.idle_share", 100 * (1 - 0.902 / 20)),
])
def test_reader(name, want):
    assert reader(name)(view()) == pytest.approx(want, rel=1e-9)


def test_finalize_roofline():
    nbytes = (40 + 44 + 8) * 4_600_000 + 8 * 287_500 + 8
    got = reader("calling.finalize_roofline")(view())
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 1e-3, rel=1e-9)


@pytest.mark.parametrize("name", [
    "stream.parse_s", "seed_chain.device_ms", "calling.finalize_roofline",
    "device.idle_share", "host_leg.cpp_s"])
def test_nothing_to_read_gives_nothing(name):
    v = view(samples=[dict(stages=None, call_s=1.0, reads=1)], trace=False)
    assert reader(name)(v) is None


def test_stage_line_and_trace_parts():
    assert harness.stage_seconds("x\n[stage-prof] pre a: 0.1s\n" + STAGE +
                                 "\n") == json.loads(STAGE.split("] ", 1)[1])
    assert harness.stage_seconds("no stages\n") is None
    t = devtrace.from_events(canned_trace(), 2)
    assert t.window == (0.0, 20.0)
    assert devtrace.busy_s(t) == pytest.approx(0.902)
    gaps = devtrace.idle_gaps(t)
    # 2.4-7.5 in each mapping span; 8.1-12.0 has its middle in the second
    # sample's reset, 0-2.0 in the first's; 18.1-20 in calling
    assert [g[0] for g in gaps[:5]] == ["mapping", "mapping", "reset",
                                        "reset", "calling"]
    assert [g[1] for g in gaps[:5]] == pytest.approx([5.1, 5.1, 3.9, 2.0,
                                                      1.9])
    top = devtrace.top_ops(t)
    assert "seed_scan3_kernel" in top[0][0] and top[0][1] == pytest.approx(.4)
