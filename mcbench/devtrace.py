"""Reading a torch.profiler trace (its Chrome-trace JSON): the device's
operations and the harness's spans inside the measured window.

The profiler arithmetic of mapcaller_tpu_torch/trace_main_path.py (device
time by kernel, busy share), kept here so that a change to the program
cannot change the yardstick, and taken over the timeline rather than
key_averages, so that the busy time is the union of what ran and idle
gaps can be labelled by what the host was doing.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "user_annotation"
HARNESS_SPANS = ("reset", "mapping", "calling")


@dataclasses.dataclass
class Trace:
    names: List[str]         # device operations, in start order
    start: np.ndarray        # float64 seconds, device operations
    end: np.ndarray
    spans: List[Tuple[str, float, float]]   # harness spans (name, start, end)
    window: Tuple[float, float]             # the measured window


def load(path: str, n_samples: int) -> Trace:
    """The trace of a window whose samples are `sample` spans: the window
    runs from the first sample's start to the end of the n_samples-th."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return from_events(events, n_samples)


def from_events(events: list, n_samples: int) -> Trace:
    dev, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]) * 1e-6,
                        (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6,
                        e.get("name", "")))
        elif cat == SPAN_CAT:
            spans.append((e.get("name", ""), float(e["ts"]) * 1e-6,
                          (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6))
    samples = sorted((s for s in spans if s[0] == "sample"),
                     key=lambda s: s[1])[:n_samples]
    if not samples:
        raise ValueError("the trace holds no sample span")
    w0, w1 = samples[0][1], samples[-1][2]
    dev.sort()
    keep = [d for d in dev if d[1] > w0 and d[0] < w1]
    return Trace([d[2] for d in keep],
                 np.array([max(d[0], w0) for d in keep], dtype=np.float64),
                 np.array([min(d[1], w1) for d in keep], dtype=np.float64),
                 [s for s in spans if s[2] > w0 and s[1] < w1 and
                  s[0] in HARNESS_SPANS], (w0, w1))


def busy_intervals(t: Trace) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, in order."""
    out: List[Tuple[float, float]] = []
    for s, e in zip(t.start.tolist(), t.end.tolist()):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_s(t: Trace) -> float:
    return float(sum(e - s for s, e in busy_intervals(t)))


def window_s(t: Trace) -> float:
    return t.window[1] - t.window[0]


def device_seconds(t: Trace) -> Dict[str, float]:
    """Device seconds by operation name, summed over the window."""
    out: Dict[str, float] = {}
    for n, s, e in zip(t.names, t.start.tolist(), t.end.tolist()):
        out[n] = out.get(n, 0.0) + (e - s)
    return out


def matching(t: Trace, names) -> Tuple[float, int]:
    """(seconds, calls) of the operations whose name holds one of `names`
    from a word's start (a kernel's name in the trace carries its
    namespace before it and its template arguments after it)."""
    pats = [re.compile(rf"(?<![A-Za-z0-9]){re.escape(n)}") for n in names]
    sec, calls = 0.0, 0
    for n, s, e in zip(t.names, t.start.tolist(), t.end.tolist()):
        if any(p.search(n) for p in pats):
            sec += e - s
            calls += 1
    return sec, calls


def idle_gaps(t: Trace, top: int = 10) -> List[Tuple[str, float]]:
    """The longest stretches of the window with nothing on the device,
    each named by the harness span its middle falls in."""
    w0, w1 = t.window
    gaps, cur = [], w0
    for s, e in busy_intervals(t):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        label = next((n for n, a, b in t.spans if a <= mid <= b), "between")
        out.append((label, e - s))
    return out


def top_ops(t: Trace, top: int = 10) -> List[Tuple[str, float]]:
    sec = device_seconds(t)
    return sorted(sec.items(), key=lambda kv: -kv[1])[:top]
