"""Device-resident FM-index and batched Occ primitives (PyTorch).

Port of mapcaller_tpu/ops/fm_device.py (ref: src/bwt_search.cpp:8-119).
Occ is precomputed at EVERY 16-base word and interleaved as
[cntA, cntC, cntG, cntT, word, 0, 0, 0] into one int32[8] row, so an occ
query is one row gather plus a popcount over 2-bit-crumb equality masks.

Bit work: BWT words are uint32 bit patterns. Torch has no popcount and
its CPU build lacks shifts on uint32, so words are carried as int64
holding the unsigned value (0 <= w < 2^32): shifts are then logical,
NOT is masked back to 32 bits, and the popcount is the SWAR bit trick.

All row indices fit int32 for texts below 2^31 rows; index arithmetic
runs in int64 (torch's native index type) and gives the same values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.fmindex import FMIndex

M32 = 0xFFFFFFFF
M55 = 0x55555555


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding values in [0, 2^32)."""
    x = x - ((x >> 1) & M55)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the unsigned value."""
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit unsigned value -> int32 bit pattern."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


@dataclasses.dataclass
class DeviceFMIndex:
    occ_rows: torch.Tensor    # int32[nw+1, 8]: occ@word-start x4, word, pad
    L2: torch.Tensor          # int64[5]
    sa_samp: torch.Tensor     # int64[ns]
    sa_full: torch.Tensor     # int32[n+1] or int32[0] when absent
    primary: int
    seq_len: int
    genome_size: int

    @property
    def has_full_sa(self) -> bool:
        return self.sa_full.shape[0] > 0

    @property
    def device(self) -> torch.device:
        return self.occ_rows.device

    @classmethod
    def from_host(cls, idx: FMIndex, device="cuda",
                  sa_budget_bytes: int = 2 << 30) -> "DeviceFMIndex":
        """Build the device tables from the host index arrays.
        sa_budget_bytes: keep the full SA on the card (one gather per
        hit) only below this size; above it sa_resolve walks inverse-Psi
        to the 32-sampled SA."""
        if idx.seq_len >= 2**31:
            raise NotImplementedError(
                "single-device index is int32 (text < 2^31); larger texts "
                "run the x64 big-genome path under -shards N")
        n = idx.seq_len
        nw = (n + 15) // 16
        rows = np.zeros((nw + 1, 8), dtype=np.int64)
        words = np.zeros(nw, dtype=np.uint32)
        words[:] = idx.bwt_words[:nw]
        shifts = (np.arange(15, -1, -1, dtype=np.uint32) << 1)
        crumbs = (words[:, None] >> shifts[None, :]) & 3       # [nw,16]
        # crumbs beyond n are pad zeros; exclude them from counts
        valid = (np.arange(nw)[:, None] * 16 + np.arange(16)[None, :]) < n
        for c in range(4):
            cnt = ((crumbs == c) & valid).sum(axis=1)
            cum = np.zeros(nw + 1, dtype=np.int64)
            np.cumsum(cnt, out=cum[1:])
            rows[:, c] = cum
        rows[:nw, 4] = words.astype(np.int64)
        if rows[:, :4].max() >= 2**31:
            raise ValueError("occ counts exceed int32")
        rows32 = rows.astype(np.uint32).view(np.int32)
        keep_full_sa = (idx.sa_full is not None
                        and idx.sa_full.nbytes <= sa_budget_bytes)
        sa_full = (np.array(idx.sa_full, dtype=np.int32) if keep_full_sa
                   else np.zeros(0, dtype=np.int32))
        dev = torch.device(device)
        return cls(
            occ_rows=torch.from_numpy(np.ascontiguousarray(rows32)).to(dev),
            L2=torch.tensor(np.asarray(idx.L2, dtype=np.int64), device=dev),
            sa_samp=torch.tensor(np.asarray(idx.sa_samp, dtype=np.int64),
                                 device=dev),
            sa_full=torch.from_numpy(sa_full).to(dev),
            primary=int(idx.primary),
            seq_len=int(idx.seq_len),
            genome_size=int(idx.genome_size),
        )


def _keep_mask(kadj: torch.Tensor) -> torch.Tensor:
    """Low-bit mask of the crumbs at or before kadj % 16 (big-end crumb
    order), on the odd bit of each crumb."""
    crumb = (~kadj) & 0xF
    return (~((1 << (2 * crumb)) - 1)) & M55


def _eq_count(word: torch.Tensor, c: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
    """# crumbs of `word` equal to base c under `keep`."""
    nx = (~(word ^ (c * M55))) & M32
    return popcount32(nx & (nx >> 1) & keep)


def _row(fm: DeviceFMIndex, kadj: torch.Tensor):
    row = fm.occ_rows[kadj >> 4]
    return row[..., :4].to(torch.int64), as_u32(row[..., 4])


def occ4(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Batched bwt_occ4 (ref: bwt_search.cpp:49-66): counts of each base
    in BWT rows [0, k]; k == -1 gives zeros. k int64[...] -> int64[...,4].
    One 32-byte row gather per query."""
    neg = k < 0
    ksafe = torch.where(neg, 0, k)
    kadj = ksafe - (ksafe >= fm.primary).to(ksafe.dtype)
    base, word = _row(fm, kadj)
    keep = _keep_mask(kadj)
    c = torch.arange(4, dtype=torch.int64, device=k.device)
    part = _eq_count(word[..., None], c, keep[..., None])
    return torch.where(neg[..., None], 0, base + part)


def occ_one(fm: DeviceFMIndex, k: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """Batched bwt_occ for per-row base c (ref: bwt_search.cpp:25-47)."""
    is_full = k == fm.seq_len
    neg = k < 0
    ksafe = torch.where(neg | is_full, 0, k)
    kadj = ksafe - (ksafe >= fm.primary).to(ksafe.dtype)
    base4, word = _row(fm, kadj)
    c = c.to(torch.int64)
    base = base4.gather(-1, c[..., None])[..., 0]
    n = base + _eq_count(word, c, _keep_mask(kadj))
    full_val = fm.L2[c + 1] - fm.L2[c]
    return torch.where(is_full, full_val, torch.where(neg, 0, n))


def inv_psi(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Batched LF step (ref: bwt_search.cpp:101-107). One row gather:
    x = k - (k > primary) and kadj = k - (k >= primary) coincide except
    at k == primary, whose result is discarded."""
    kadj = k - (k >= fm.primary).to(k.dtype)
    base4, word = _row(fm, kadj)
    c = (word >> (((~kadj) & 0xF) << 1)) & 3
    base = base4.gather(-1, c[..., None])[..., 0]
    occ_kc = base + _eq_count(word, c, _keep_mask(kadj))
    val = fm.L2[c] + occ_kc
    return torch.where(k == fm.primary, 0, val)


def sa_resolve(fm: DeviceFMIndex, k: torch.Tensor, active: torch.Tensor,
               max_walk: int = 192):
    """Batched bwt_sa (ref: bwt_search.cpp:109-119).

    Full SA on the card: one gather, exact. Otherwise a lockstep
    inverse-Psi walk of max_walk steps until every active row index is a
    multiple of 32 (the sampled rows); lanes still unresolved are flagged
    for the host fallback. Returns (loc int64[B], resolved bool[B]).
    The plain version of the resolve in ops/chain_kernels.chain_hits."""
    if fm.has_full_sa:
        return fm.sa_full[k].to(torch.int64), active.clone()
    k_ = k.clone()
    steps = torch.zeros_like(k)
    for _ in range(max_walk):
        todo = active & ((k_ & 31) != 0)
        k_new = inv_psi(fm, torch.where(todo, k_, 32))
        k_ = torch.where(todo, k_new, k_)
        steps = steps + todo.to(steps.dtype)
    resolved = active & ((k_ & 31) == 0)
    return steps + fm.sa_samp[k_ >> 5], resolved
