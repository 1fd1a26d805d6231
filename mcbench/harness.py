"""The benchmark of mapcaller_tpu_torch: one cell a run.

    python3 mcbench/run.py --workload NAME --seed N --seconds S --trace 0|1

A cell is an entry of BENCHMARK.json's `workloads`: a configuration
(mcbench/configs/<config>.json, a genome deployment) under a traffic mix
(mcbench/traffic/<traffic>.json, a sample's reads and mutations). Both
are data; so is every per-layer metric's reader (mcbench/metrics/
<metric>.py), found by its name.

Set-up: the kernels (built at a checkout's first run), the index of the
configuration's synthetic genome (built once into mcbench/cache/), one
engine on the card (runner.make_engine: the index and the evidence
planes stay resident), the sample made from --seed into TMPDIR, and one
whole sample mapped and called as the warm-up. The window then takes
samples back to back, each `engine.reset_run()`, `runner.run_mapping`,
`runner.run_calling`, as runner.run_pipeline calls them: a resident
deployment taking one sample after another. It ends at the end of the
last sample that finishes within --seconds; reads_per_s is the reads of
those whole samples over the time to that end.

After the window each sample's VCF is held to the plain reference
(check.py, reference/pileup.py) and the numbers compared are printed
with their limits, last on stderr and as the result's last key.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mapcaller_tpu")
GIB = float(1 << 30)


def log(msg: str) -> None:
    sys.stderr.write(f"[mcbench] {msg}\n")
    sys.stderr.flush()


def process_start() -> float:
    """The process's start on the epoch clock (/proc), so that set-up
    counts the interpreter's own start too."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    per_layer: List[dict]       # BENCHMARK.json entries this cell reports
    end_to_end: List[dict]
    bench_dir: str              # <root>/mcbench: its data files and cache


def find_cell(root: str, workload: str) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(root, c["file"]))
    bench_dir = os.path.join(root, "mcbench")
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    moved = {m["name"] for m in e2e}
    pl = [m for m in bench["per_layer"]
          if (workload in m["workloads"] if "workloads" in m
              else m["moves"] in moved)]
    return Cell(workload, int(w["chips"]), config, traffic, pl, e2e,
                bench_dir)


def load_reader(bench_dir: str, name: str):
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mcbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---- the sample -----------------------------------------------------------

def sub_seed(seed: int, k: int):
    return [int(seed) % (1 << 64), k]


@dataclasses.dataclass
class Sample:
    territory: int
    mutant: object
    reads: object
    r1: str
    r2: str
    bytes: int


def genome(config: dict) -> np.ndarray:
    from . import gen
    return gen.synth_genome(int(config["genome_length"]),
                            int(config["genome_seed"]))


def make_sample(config: dict, traffic: dict, seed: int, ref: np.ndarray,
                out_dir: str) -> Sample:
    from . import gen
    T = int(config.get("territory") or ref.size)
    mutant = gen.mutate(ref[:T], traffic["rates"], sub_seed(seed, 1))
    reads = gen.simulate_reads(
        mutant.codes, int(traffic["pairs"]), int(traffic["read_len"]),
        float(traffic["frag_mean"]), float(traffic["frag_sd"]),
        float(traffic["err_rate"]), sub_seed(seed, 2))
    r1, r2 = (os.path.join(out_dir, f"r{k}.fq") for k in (1, 2))
    nbytes = gen.write_fastq(reads, config["chrom"], r1, r2)
    reads.seq = None                      # the reference needs no bases
    return Sample(T, mutant, reads, r1, r2, nbytes)


def index_prefix(cache_dir: str, config: dict, ref: np.ndarray) -> str:
    """The configuration's index in the cache, built at its first use:
    the synthetic genome as FASTA and the default index (occ3 derived on
    the card from the full SA) over it."""
    from . import gen
    d = os.path.join(cache_dir, config["name"])
    prefix = os.path.join(d, "index", "idx")
    if os.path.exists(os.path.join(d, "index", "complete")):
        return prefix
    from mapcaller_tpu_torch.index.fmindex import build_index
    tmp = os.path.join(d, "building")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    fa = os.path.join(tmp, "genome.fa")
    gen.write_fasta(fa, config["chrom"], ref)
    build_index(fa, os.path.join(tmp, "idx"))
    os.remove(fa)
    with open(os.path.join(tmp, "complete"), "w") as f:
        f.write("1\n")
    shutil.rmtree(os.path.join(d, "index"), ignore_errors=True)
    os.replace(tmp, os.path.join(d, "index"))
    return prefix


def program_config(config: dict, traffic: dict, prefix: str, sample: Sample,
                   out_dir: str, device: str):
    """The program's Config as its CLI parses a default run's flags."""
    from mapcaller_tpu_torch.cli import parse_args
    argv = (["mapcaller", "-i", prefix, "-f", sample.r1, "-f2", sample.r2,
             "-vcf", os.path.join(out_dir, "warmup.vcf"),
             "-log", os.path.join(out_dir, "job.log")]
            + list(config.get("cli_flags", []))
            + list(traffic.get("cli_flags", [])))
    cfg = parse_args(argv)
    if cfg is None:
        raise SystemExit(f"the program refused the flags {argv}")
    cfg.device = device
    return cfg, " ".join(argv)


# ---- the window -----------------------------------------------------------

def run_sample(engine, cfg, cmd: str, vcf: str, reset: bool,
               spans: bool) -> dict:
    """One whole sample, mapped and called; its host-clock times and the
    program's stage seconds (MC_STAGE_PROF, when set)."""
    import torch
    from mapcaller_tpu_torch import runner
    rf = (torch.profiler.record_function if spans
          else lambda name: contextlib.nullcontext())
    cfg.vcf_file = vcf
    err = io.StringIO()
    cuda = cfg.device.startswith("cuda")
    t0 = time.perf_counter()
    with rf("sample"), contextlib.redirect_stderr(err):
        if reset:
            with rf("reset"):
                engine.reset_run()
        with rf("mapping"):
            runner.run_mapping(engine, cfg, t0)
        t1 = time.perf_counter()
        with rf("calling"):
            runner.run_calling(engine, cfg, cmd)
            if cuda:
                torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(start=t0, end=t2, seconds=t2 - t0, call_s=t2 - t1, vcf=vcf,
                stages=stage_seconds(err.getvalue()),
                reads=int(engine.stats.total_reads))


def stage_seconds(text: str) -> Optional[dict]:
    """The program's MC_STAGE_PROF line (`[stage-prof] {...}`, one a
    mapping run) in its stderr, or None."""
    stages = None
    for ln in text.splitlines():
        if ln.startswith("[stage-prof] {"):
            stages = json.loads(ln.split("] ", 1)[1])
    return stages


def run_window(engine, cfg, cmd: str, out_dir: str, seconds: float,
               spans: bool) -> tuple:
    """Samples back to back; a sample is counted when it ends within
    `seconds` of the window's start. Returns (counted, not counted)."""
    done: List[dict] = []
    late: List[dict] = []
    t0 = time.perf_counter()
    i = 0
    while True:
        if done and (time.perf_counter() - t0 + done[-1]["seconds"]
                     > seconds):
            break
        s = run_sample(engine, cfg, cmd,
                       os.path.join(out_dir, f"sample{i}.vcf"), True, spans)
        i += 1
        if s["end"] - t0 > seconds:
            late.append(s)
            break
        done.append(s)
    for s in done + late:
        s["start"] -= t0
        s["end"] -= t0
    return done, late


@dataclasses.dataclass
class WindowView:
    """What a per-layer reader reads: the counted samples, the window's
    reads and seconds, the device trace of the window (traced runs), the
    genome's length and the card's peaks."""
    reads: int
    seconds: float
    samples: List[dict]
    trace: Optional[object]
    genome_length: int
    peaks: Optional[dict]
    bench_dir: str


def device_peaks(bench_dir: str, kind: str) -> Optional[dict]:
    table = load_json(os.path.join(bench_dir, "peaks.json"))
    return next((v for k, v in table.items() if k in kind), None)


# ---- correctness ----------------------------------------------------------

def judge(sample: Sample, traffic: dict, vcfs: List[str],
          warm_vcf: str, reads_seen: List[int], seed: int) -> Dict[str, float]:
    """The numbers compared for the window's samples: each VCF against
    the reference's truth (the worst over the samples), the reads the
    program counted, and each VCF's bytes against the warm-up's."""
    from . import check
    from .reference import pileup
    truth = pileup.pileup(sample.territory, sample.mutant, sample.reads)
    gvcf = "-gvcf" in traffic.get("cli_flags", [])
    nor = (pileup.clean_positions(truth, int(traffic.get("nor_sample", 0)),
                                  sub_seed(seed, 3)) if gvcf else None)

    def digest(p):
        with open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    warm = digest(warm_vcf)
    differs = [v for v in vcfs if digest(v) != warm]
    worst: Dict[str, float] = {}
    for v in [vcfs[0]] + differs:
        with open(v) as f:
            nums = check.compare(check.parse_vcf(f.read()), truth, gvcf, nor)
        for k, x in nums.items():
            worst[k] = max(worst.get(k, 0.0), x)
    sent = 2 * sample.reads.n_pairs
    worst["reads_lost"] = max(abs(n - sent) for n in reads_seen) / sent
    worst["vcf_differs"] = float(len(differs))
    return worst


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---- the run --------------------------------------------------------------

def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="mcbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", root: str = ROOT) -> int:
    """The benchmark's run. `device` "cpu" skips the look for a card and
    runs the program's plain versions (the tests' rehearsal); a result
    is then never a device number."""
    t_start = process_start()
    args = parse(argv)
    cell = find_cell(root, args.workload)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available() or (torch.cuda.device_count()
                                             < cell.chips):
            log(f"needs {cell.chips} CUDA card(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
    from mapcaller_tpu_torch import runner, toolchain, tune_host_allocator
    from mapcaller_tpu_torch.index.fmindex import load_index

    if args.trace:
        os.environ["MC_STAGE_PROF"] = "1"
    tune_host_allocator()
    parts: Dict[str, float] = {}
    out_dir = tempfile.mkdtemp(prefix="mcbench-", dir=os.environ.get("TMPDIR"))
    wrote = 0
    try:
        t = time.perf_counter()
        if device == "cuda":
            for name in toolchain.cuda_sources():
                toolchain.ensure_cuda(name)
        toolchain.ensure_native()
        parts["kernels"] = time.perf_counter() - t

        t = time.perf_counter()
        ref = genome(cell.config)
        cache_dir = os.path.join(cell.bench_dir, "cache")
        built = not os.path.exists(os.path.join(
            cache_dir, cell.config["name"], "index", "complete"))
        prefix = index_prefix(cache_dir, cell.config, ref)
        if built:
            d = os.path.dirname(prefix)
            wrote += sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
        idx = load_index(prefix)
        parts["index_build" if built else "index"] = time.perf_counter() - t

        t = time.perf_counter()
        sample = make_sample(cell.config, cell.traffic, args.seed, ref, out_dir)
        wrote += sample.bytes
        parts["reads"] = time.perf_counter() - t

        t = time.perf_counter()
        cfg, cmd = program_config(cell.config, cell.traffic, prefix, sample,
                                  out_dir, device)
        engine = runner.make_engine(idx, cfg)
        parts["engine"] = time.perf_counter() - t

        t = time.perf_counter()
        warm = run_sample(engine, cfg, cmd, os.path.join(out_dir, "warmup.vcf"),
                          False, False)
        parts["warmup"] = time.perf_counter() - t
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.time() - t_start
        log("setup parts s " + json.dumps({k: round(v, 4) for k, v in
                                           parts.items()}))
        log(f"host cores {sorted(os.sched_getaffinity(0))} loadavg "
            f"{os.getloadavg()} torch threads {torch.get_num_threads()}")

        prof = None
        if args.trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else []))
        with prof if prof is not None else contextlib.nullcontext():
            done, late = run_window(engine, cfg, cmd, out_dir, args.seconds,
                                    args.trace == 1)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
        log("samples s " + json.dumps([round(s["seconds"], 4) for s in done])
            + f" late {[round(s['seconds'], 4) for s in late]}")
        if len(done) < 2:
            log(f"only {len(done)} whole sample(s) in {args.seconds} s; "
                "a window needs two")
            return 4
        win_s = done[-1]["end"]
        win_reads = len(done) * 2 * sample.reads.n_pairs
        reads_seen = [warm["reads"]] + [s["reads"] for s in done]
        trace_path = None
        if prof is not None:
            trace_path = os.path.join(out_dir, "trace.json")
            prof.export_chrome_trace(trace_path)
            wrote += os.path.getsize(trace_path)
            del prof
        n_pairs = sample.reads.n_pairs
        del engine, idx
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
        dev = {"platform": "gpu" if device == "cuda" else "cpu",
               "kind": kind, "count": cell.chips,
               "memory_peak_bytes": int(peak)}
        result = {"correct": False, "attempted": len(done), "failed": 0}
        metrics = {}
        if args.trace:
            from . import devtrace
            tr = devtrace.load(trace_path, len(done))
            view = WindowView(win_reads, win_s, done, tr,
                              int(cell.config["genome_length"]),
                              device_peaks(cell.bench_dir, kind),
                              cell.bench_dir)
            for m in cell.per_layer:
                v = load_reader(cell.bench_dir, m["name"])(view)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev["busy_s"] = devtrace.busy_s(tr)
            dev["window_s"] = devtrace.window_s(tr)
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in devtrace.top_ops(tr)],
                "idle_gaps": [[n, s] for n, s in devtrace.idle_gaps(tr)]}
            os.remove(trace_path)
        else:
            e2e = {"reads_per_s": (win_reads / win_s, "reads/s"),
                   "peak_device_gib": (peak / GIB, "GiB"),
                   "setup_s": (setup_s, "s")}
            for m in cell.end_to_end:
                v, unit = e2e[m["name"]]
                metrics[m["name"]] = {"value": v, "unit": unit}
        for s in done:
            wrote += os.path.getsize(s["vcf"])
        wrote += os.path.getsize(warm["vcf"])

        bad = forbidden_modules()
        if bad:
            log(f"modules of JAX or of the JAX package are loaded: {bad}")
            return 5
        log(f"window {win_s:.4f} s, {len(done)} samples of {2 * n_pairs} "
            f"reads; bytes written {wrote}")
        t = time.perf_counter()
        numbers = judge(sample, cell.traffic, [s["vcf"] for s in done],
                        warm["vcf"], reads_seen, args.seed)
        limits = cell.traffic["limits"]
        from .check import verdict
        shown = {k: v for k, v in numbers.items() if k not in limits}
        numbers = {k: v for k, v in numbers.items() if k in limits}
        ok = verdict(numbers, limits)
        log(f"comparison took {time.perf_counter() - t:.2f} s; not "
            f"compared: {json.dumps(shown)}")
        result.update(correct=ok, failed=0 if ok else len(done),
                      metrics=metrics, device=dev)
        checks = {k: {"value": v, "limit": limits.get(k)}
                  for k, v in numbers.items()}
        result["checks"] = checks
        for k, c in checks.items():
            sys.stderr.write(f"check {k} {c['value']!r} limit {c['limit']!r}\n")
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
