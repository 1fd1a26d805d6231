"""Where the main path's time goes on the card: a torch.profiler trace of
one warm map-and-call run.

    python -m mapcaller_tpu_torch.trace_main_path [n_pairs]

Writes the E. coli-scale set (simulator.write_ecoli_set, 100,000 read
pairs by default) and its index into a temporary directory under the
build directory, runs the main path (default CLI flags, on the card) once
to warm up, once timed, and once under torch.profiler, then prints one
JSON line: the card, the timed run's metrics, the device time summed over
the profiled run's kernels and its busy share of the mapping stage, the
device span (first kernel start to last kernel end on the card), calls
and kernel launches of each named range (seed_scan, hits_sa_resolve,
classify in ops/fm_search.py, classify holding the fused classify+pack;
nw_kernel in ops/nw_device.py; ksw2_kernel in ops/ksw2_device.py;
evidence_apply, evidence_correct, evidence_finalize, caller_scan,
fetch_columns in pipeline/device_profile.py; the folded apply runs
inside classify), the device ms and calls of every kernel of the port's
own CUDA sources (csrc/*.cu, matched by kernel name; 0 calls for one
the run did not launch), the ten kernels with the most device time, the
calls of each kind of copy and memset (a host-to-device copy from
pageable memory waits for the stream), and each run's stage seconds
(MC_STAGE_PROF: parse, seed+chain submit, collect, host leg, evidence).
Needs a CUDA card.
"""
from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

RANGES = ("seed_scan", "hits_sa_resolve", "classify", "nw_kernel",
          "ksw2_kernel", "evidence_apply", "evidence_correct",
          "evidence_finalize", "caller_scan", "fetch_columns")


def port_kernels() -> list:
    """Names of the kernels in the port's CUDA sources (csrc/*.cu)."""
    names = []
    for path in sorted(glob.glob(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "csrc", "*.cu"))):
        with open(path) as f:
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)\s*\(", f.read())
    return names


def _device_us(evt, self_only: bool = False) -> float:
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _range_launches(events) -> dict:
    """Device kernels launched inside each named range, summed over its
    calls: the kernels of the range's CPU events and of theirs."""
    out = {}
    for e in events:
        if e.name not in RANGES:
            continue
        todo, n = list(e.cpu_children), 0
        while todo:
            c = todo.pop()
            n += len(getattr(c, "kernels", ()))
            todo.extend(c.cpu_children)
        out[e.name] = out.get(e.name, 0) + n
    return out


def _metrics(log: str) -> dict:
    with open(log) as f:
        return json.loads([ln for ln in f if ln.startswith("{")][-1])


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    argv = sys.argv if argv is None else argv
    if not torch.cuda.is_available():
        sys.stderr.write("trace_main_path: needs a CUDA card\n")
        return 2
    n_pairs = int(argv[1]) if len(argv) > 1 else 100_000
    from . import toolchain
    from .cli import main as cli_main, parse_args
    from .runner import run_pipeline
    from .simulator import write_ecoli_set
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    os.makedirs(toolchain.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=toolchain.BUILD_DIR) as d:
        fa, r1, r2 = write_ecoli_set(d, n_pairs)
        idx = os.path.join(d, "mci")
        if cli_main(["mapcaller", "index", fa, idx]) != 0:
            raise RuntimeError("index build failed")
        log = os.path.join(d, "job.log")
        args = ["mapcaller", "-i", idx, "-f", r1, "-f2", r2,
                "-sam", os.path.join(d, "out.sam"),
                "-vcf", os.path.join(d, "out.vcf"), "-log", log]

        os.environ["MC_STAGE_PROF"] = "1"

        def run():
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = run_pipeline(parse_args(args), " ".join(args))
            if rc != 0:
                raise RuntimeError("main path run failed")
            torch.cuda.synchronize()
            stages = [json.loads(ln.split("] ", 1)[1])
                      for ln in err.getvalue().splitlines()
                      if ln.startswith("[stage-prof] {")]
            return dict(_metrics(log), stages=stages[-1] if stages else None)

        run()                                       # warm-up
        timed = run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            traced = run()
            wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels: device-side events other than the named ranges (any range,
    # also one of an older tree this script runs on), whose device entries
    # are spans over the kernels they enclose
    kernels = [e for e in events if e.key not in RANGES
               and not getattr(e, "is_user_annotation", False)
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(_device_us(e, self_only=True) for e in kernels)
    top = sorted(kernels, key=lambda e: -_device_us(e, True))[:10]
    ranges = {e.key: {"device_span_ms": _device_us(e) / 1e3,
                      "calls": e.count, "launches": 0}
              for e in events if e.key in RANGES}
    for name, n in _range_launches(prof.events()).items():
        ranges[name]["launches"] = n
    own = {}
    for name in port_kernels():
        hit = [e for e in kernels if re.search(rf"\b{name}\b", e.key)]
        own[name] = {"device_ms": sum(_device_us(e, True)
                                      for e in hit) / 1e3,
                     "calls": sum(e.count for e in hit)}
    print(json.dumps({
        "card": card, "n_reads": timed["total_reads"],
        "timed_run": {k: timed[k] for k in (
            "reads_per_sec", "mapping_seconds", "calling_seconds",
            "total_seconds", "stages")},
        "traced_run": {"wall_s": wall_s, "stages": traced["stages"],
                       "mapping_seconds": traced["mapping_seconds"],
                       "device_busy_ms": busy_us / 1e3,
                       "device_busy_share_of_mapping":
                           busy_us / 1e6 / traced["mapping_seconds"],
                       "kernel_launches": sum(e.count for e in kernels)},
        "ranges": ranges,
        "port_kernels": own,
        "top_kernels": [{"name": e.key[:80], "device_ms":
                         _device_us(e, True) / 1e3, "calls": e.count}
                        for e in top],
        "copies": {e.key: {"calls": e.count,
                           "device_ms": _device_us(e, True) / 1e3}
                   for e in kernels if e.key.startswith(("Memcpy",
                                                         "Memset"))},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
