"""Tables split along their first axis over N devices (`-shards N`): the
row routing of the genome-sharded index (parallel/sharded_index.py).

A table of R rows becomes N shards of per = ceil(R / N) rows, shard s
holding rows [s * per, (s + 1) * per) on its own device, the last one
padded with zero rows. Row w lives in shard w // per at local row
w - (w // per) * per. Indexing a Routed table with a CPU index tensor is
the plain routed gather: each shard answers the indices that fall in it
and the answers are summed, so an index outside every shard reads zeros
(the reference's all-gather, local answer and psum,
mapcaller_tpu/parallel/sharded_index.py:115-132, 176-190). The CUDA
kernels read the same rows through a table of the shards' base addresses
(`pointers`), the routed instantiations in csrc/seed_scan.cu and
csrc/chain.cu.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .device_util import need


class Routed:
    """A table split into shards of `per` rows each, on their devices."""

    def __init__(self, shards: List[torch.Tensor], per: int):
        need(len(shards) >= 1 and per >= 1
             and all(t.shape[0] == per for t in shards),
             "Routed: every shard must hold `per` rows")
        self.shards = shards
        self.per = per
        self._ptrs: Dict[torch.device, torch.Tensor] = {}

    @classmethod
    def split(cls, table: torch.Tensor, devices: Sequence) -> "Routed":
        """Pad `table` to a whole number of shards and copy shard s to
        devices[s], each its own allocation."""
        n = len(devices)
        per = max(1, -(-table.shape[0] // n))
        shards = []
        for s, d in enumerate(devices):
            part = table[s * per:(s + 1) * per]
            sh = torch.zeros((per,) + tuple(table.shape[1:]),
                             dtype=table.dtype, device=torch.device(d))
            sh[:part.shape[0]].copy_(part)
            shards.append(sh)
        return cls(shards, per)

    @property
    def n(self) -> int:
        return len(self.shards)

    @property
    def shape(self):
        return (self.n * self.per,) + tuple(self.shards[0].shape[1:])

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def __getitem__(self, i: torch.Tensor) -> torch.Tensor:
        """The plain routed gather of rows i (int64, any shape)."""
        s = torch.div(i, self.per, rounding_mode="floor")
        local = i - s * self.per
        out = None
        for k, sh in enumerate(self.shards):
            mine = s == k
            rows = sh[torch.where(mine, local, 0)]
            mask = mine.reshape(mine.shape + (1,) * (rows.dim() - mine.dim()))
            part = torch.where(mask, rows, 0)
            out = part if out is None else out + part
        return out

    def pointers(self, dev: torch.device) -> torch.Tensor:
        """int64[n] base addresses of the shards, on `dev`, for a kernel
        launched there (cached per device)."""
        dev = torch.device(dev)
        if dev not in self._ptrs:
            self._ptrs[dev] = torch.tensor(
                [t.data_ptr() for t in self.shards], dtype=torch.int64,
                device=dev)
        return self._ptrs[dev]

    def check_card(self, name: str, dev: torch.device, dtype, width=None,
                   align: int = 4) -> None:
        """Refuse shards a kernel launched on `dev` cannot read: not on a
        card, of another dtype or row width, not contiguous or aligned.
        Shards on other cards need peer access (enable_peer_access)."""
        for t in self.shards:
            need(t.device.type == "cuda", f"{name}: shard on {t.device}, "
                                          f"launch on {dev}")
            need(t.dtype == dtype, f"{name}: shards must be {dtype}",
                 TypeError)
            need(width is None or (t.dim() == 2 and t.shape[1] == width),
                 f"{name}: shards must be [per, {width}]")
            need(t.is_contiguous() and t.data_ptr() % align == 0,
                 f"{name}: shards must be contiguous and {align}-byte "
                 f"aligned")


def enable_peer_access(devices: Sequence) -> None:
    """Let every CUDA device of the list read the others' memory (the
    routed kernels read shards on other cards). Raises where peer access
    between two of them is refused."""
    devs = [torch.device(d) for d in devices]
    idx = sorted({d.index if d.index is not None
                  else torch.cuda.current_device()
                  for d in devs if d.type == "cuda"})
    if len(idx) < 2:
        return
    from .seed_scan_device import _load_kernel
    lib = _load_kernel()
    for a in idx:
        for b in idx:
            if a != b:
                err = lib.mc_enable_peer_access(a, b)
                if err != 0:
                    raise RuntimeError(
                        f"-shards: cuda:{a} cannot read cuda:{b}'s memory "
                        f"(peer access refused, CUDA error {err})")
