"""Arithmetic the per-layer readers (metrics/<name>.py) share."""
from __future__ import annotations

import json
import os
from typing import Optional


def per_mread(view, stage: str) -> Optional[float]:
    """Seconds of one MC_STAGE_PROF stage summed over the window's
    samples, a million reads."""
    if not view.samples or any(s["stages"] is None for s in view.samples):
        return None
    return sum(s["stages"][stage] for s in view.samples) / (view.reads / 1e6)


def kernel_names(view, name: str) -> list:
    with open(os.path.join(view.bench_dir, "metrics", name)) as f:
        return json.load(f)
