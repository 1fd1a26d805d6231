"""Small helpers shared by the kernel wrappers and the device pipeline:
input refusals, launch counters, copies between the host and the card
and the devices of the scale axes. Imports
nothing of the package, so any module may import it."""
from __future__ import annotations

import collections
import contextlib

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


def download(tensors) -> list:
    """Host numpy copies of tensors: a card tensor through a pinned buffer
    (a copy from the card to pageable memory runs at a fraction of the
    link's rate), every copy queued on its device's current stream before
    one wait a device."""
    outs, devs = [], set()
    for t in tensors:
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            devs.add(t.device)
            t = h
        outs.append(t)
    for d in devs:
        torch.cuda.current_stream(d).synchronize()
    return [t.numpy() for t in outs]


def device_list(device, n: int, devices=None, flag: str = "-devices"):
    """The devices of a scale axis (`-devices N`, `-shards N`): an
    explicit list when given (repeats allowed: replicas or shards on one
    card), else on "cuda" the first n visible cards, raising when fewer
    are visible, and on "cpu" n CPU devices."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        need(len(devs) == n, f"{flag} {n} but {len(devs)} devices given")
        return devs
    dev = torch.device(device)
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        need(n <= visible, f"{flag} {n} but only {visible} CUDA device(s) "
                           f"visible")
        return [torch.device("cuda", i) for i in range(n)]
    need(dev.type == "cpu", f"{flag}: unsupported device {dev}")
    return [dev] * n


def issue_on(device, stream=None):
    """Context for the launches inside: on `stream` when given (its
    device too), else on `device`'s current stream; a no-op off the
    card."""
    if stream is not None:
        return torch.cuda.stream(stream)
    device = torch.device(device)
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())
