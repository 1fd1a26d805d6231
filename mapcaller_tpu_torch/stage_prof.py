"""The stage registry: host seconds and counts of a run by layer, on when
MC_STAGE_PROF is set (to any non-empty value) at the registry's reset.

    with stage_prof.span("load"):       # host seconds under "load"
        ...
    stage_prof.count("reads_fast", n)   # a counter

While a torch.profiler runs, a span also lies inside
record_function("mc." + key), so the Chrome trace holds it as a
user_annotation on the clock of the kernels and copies. Off, a span is
one branch on a module flag and a shared null context: no clock read, no
record_function, no dict write.

The registry is reset when a MappingEngine is built and at the top of
engine.reset_run(); its sums run from there across every library of the
run. runner.run_mapping prints the line `[stage-prof] {...}` on stderr
at its end, and runner.run_calling prints it again, cumulatively, at
its end. The reset also switches the C++ host leg's stage counters
(native.prof_enable) with the flag; mapping's end adds their alignment
time as `host_align`.

Spans, each inside its parent; a parent's self time is what no child
explains:

    reset                 engine.reset_run(): host planes zeroed, native reset
    map                   runner.run_mapping whole
      load                FASTQ files read, auto compaction, native.set_input
      evidence_setup      host diff arrays, device evidence planes made
      parse               the stream's native parse of a transfer group
      submit              the group's seed+chain dispatch submitted
      collect             a batch's device output collected, its wait included
      host_cpp            the C++ host leg on a batch (pair, align, SAM,
                          evidence)
      evidence            a batch's device evidence reconciled
      finalize            engine.finalize (host-delta merge, fold, scan) and
                          mapping's closing statistics
    call                  runner.run_calling whole
      call_prep           event-map key sorts, break-point candidates, the
                          positions and prefix points to fetch
      call_device         caller scan, column fetches, NOR blocks; the
                          overflow's plane download and fold
      call_records        SUB, INS/DEL, UMR/CNV and NOR records and their
                          sort (or the host caller's); gVCF merge
      call_sv             inversion and translocation calls
      call_write          the VCF written

Counters: `batches`; `reads_fast`, `reads_slow`, `reads_nocand` (the
device's read classes, the oracle's forced SLOW reads included);
`host_align` (seconds of the C++ leg's alignment).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

from . import native

SPANS = ("parse", "submit", "collect", "host_cpp", "evidence", "reset",
         "map", "load", "evidence_setup", "finalize", "call", "call_prep",
         "call_device", "call_records", "call_sv", "call_write")
COUNTS = ("batches", "reads_fast", "reads_slow", "reads_nocand")

ON = False
_NULL = contextlib.nullcontext()
_sums: dict = {}
host_leg_ns: dict = {}     # the C++ leg's counters since the reset


def reset() -> None:
    """Zero every key, read MC_STAGE_PROF and switch the C++ counters."""
    global ON
    ON = bool(os.environ.get("MC_STAGE_PROF"))
    _sums.clear()
    _sums.update(dict.fromkeys(SPANS, 0.0))
    _sums.update(dict.fromkeys(COUNTS, 0))
    _sums["host_align"] = 0.0
    host_leg_ns.clear()
    native.prof_enable(ON)


class _Span:
    __slots__ = ("key", "rf", "t0")

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("mc." + self.key)
            self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _sums[self.key] += time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(key: str):
    return _Span(key) if ON else _NULL


def count(key: str, n: int = 1) -> None:
    if ON:
        _sums[key] += int(n)


def take_host_leg() -> None:
    """Add the C++ leg's counters since the last take (mapping's end)."""
    if not ON:
        return
    ns = native.prof_fetch()
    for k, v in ns.items():
        host_leg_ns[k] = host_leg_ns.get(k, 0) + v
    _sums["host_align"] += ns["align"] * 1e-9


def emit() -> None:
    """The line `[stage-prof] {...}` on stderr: seconds to the ms."""
    if ON:
        sys.stderr.write("\n[stage-prof] " + json.dumps(
            {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in _sums.items()}) + "\n")
