"""Small helpers shared by the kernel wrappers and the device pipeline:
input refusals, launch counters and host-to-device uploads. Imports
nothing of the package, so any module may import it."""
from __future__ import annotations

import collections

import numpy as np
import torch


def need(cond: bool, msg: str, exc=ValueError) -> None:
    """Raise exc(msg) unless cond: a wrapper's refusal of its inputs."""
    if not cond:
        raise exc(msg)


class KernelStats:
    """Launch accounting for a family of kernels: `launches[name]` counts
    launches (one per call on a CUDA tensor). The plain versions count
    nothing."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.launches = collections.Counter()


def upload(a, device) -> torch.Tensor:
    """A host array on `device`. On the card through a pinned staging
    copy, so the copy queues on the stream behind the work in flight; a
    copy from pageable memory would wait for it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
