"""The device-side collectives of the multichip mesh (parallel/mesh.py) on
the card: the CUDA kernels `dp_scatter_scan_kernel` and
`evidence_apply_bits_kernel` of csrc/chain.cu, and their plain PyTorch
versions.

  dp_reduce        the psum of n int32 partials of one shape: their
                   elementwise sum, on the first partial's device
                   (K1 in its sum-only mode);
  dp_scatter_scan  the reference's psum_scatter + all_gather of slice
                   totals + cumsum (mapcaller_tpu/parallel/mesh.py:165-178,
                   :451-459): Σ parts over [0, length), padded with zeros
                   to Gp = ceil(length / n) * n, cut into n slices of
                   Gp / n; slice i becomes the inclusive cumsum of its
                   elements plus the totals of slices 0 .. i-1, on
                   devices[i] (K1 twice a slice: a pass that writes the
                   slice's total, then the scan, which reads the totals of
                   the slices before it);
  apply_bits       the phase-B evidence of the reads an admit bitmask
                   selects (mesh.py:211-251, the bits unpacked as at
                   :213-214, then ops/evidence.scatter_fast_evidence),
                   added to int32 planes in place (K2).

K1 on device i reads the n partials through a table of their base
addresses, as ops/routed.Routed.pointers hands the routed kernels their
shards: partials on other cards are read as peer memory
(routed.enable_peer_access, which raises where refused); on one card with
repeats every address is on that card. Integer adds commute, so every
result equals the plain version's in every word.

Each wrapper checks its inputs, then runs the plain version for CPU
tensors and launches its kernel for CUDA tensors, counting the launch in
STATS ("dp_scatter_scan" for each K1 launch, whatever its mode;
"evidence_apply_bits" for K2), or raises. There is no fallback between
the two.
"""
from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import chain_kernels as ck
from .device_util import KernelStats, issue_on, need, upload
from .evidence import first_mate_lanes, scatter_fast_evidence

# csrc/chain.cu: threads of a K1 tile and the elements each thread scans
DP_THREADS = 256
DP_ITEMS = 8
DP_TILE = DP_THREADS * DP_ITEMS
DP_SUM, DP_TOTAL, DP_SCAN = 0, 1, 2    # K1's modes
APPLY_THREADS = 256                    # K2: reads a block, one a thread

STATS = KernelStats()

# fast-read evidence planes of genome size L (the layout of
# pipeline/device_profile.DevicePlanes without its multi plane):
# exact_diff int32[L+2], f_diff int32[4, L+2], acgt int32[4, L+1]
Planes = collections.namedtuple("Planes", "exact_diff f_diff acgt")


def zero_planes(L: int, device) -> Planes:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return Planes(z(L + 2), z(4, L + 2), z(4, L + 1))


def _on_card(name: str, tensors) -> bool:
    """True for CUDA tensors, False for CPU ones (all on one kind)."""
    kinds = {t.device.type for t in tensors}
    need(len(kinds) == 1 and kinds <= {"cpu", "cuda"},
         f"{name}: tensors on {kinds}: all on the CPU or all on cards")
    need(all(t.is_contiguous() for t in tensors),
         f"{name}: inputs must be contiguous")
    return kinds == {"cuda"}


def _check_parts(name: str, parts: Sequence[torch.Tensor]) -> int:
    need(len(parts) >= 1, f"{name}: no partials")
    shape = parts[0].shape
    for p in parts:
        need(p.dtype == torch.int32, f"{name}: partials must be int32",
             TypeError)
        need(p.shape == shape, f"{name}: partials of one shape expected")
    need(parts[0].numel() >= 1, f"{name}: empty partials")
    return parts[0].numel()


def _wait(stream, others) -> None:
    """`stream` waits for the work queued on each of `others` so far."""
    for s in others:
        if s is not None and s != stream:
            stream.wait_stream(s)


def _keep(t: torch.Tensor, streams) -> None:
    """t's memory is not reused before the work queued on `streams` (those
    on t's card) ends."""
    for s in streams:
        if s is not None and s.device == t.device:
            t.record_stream(s)


def _pointers(parts, dev) -> torch.Tensor:
    """int64[n] base addresses of the partials, on `dev`."""
    return upload(np.array([p.data_ptr() for p in parts], dtype=np.int64),
                  dev)


def _k1(dev, ptrs, n: int, lo: int, length: int, count: int, out, totals,
        slice_: int, mode: int) -> None:
    """One K1 launch on dev's current stream; the scan modes take the
    look-back scratch of that stream (ops/chain_kernels.py)."""
    scratch = ((None, 0, 0) if mode == DP_SUM else
               ck._look_back_scratch(dev, -(-count // DP_TILE)))
    ck._launch("dp_scatter_scan", dev, ptrs.data_ptr(), n, lo, length,
               count, ck._ptr(out), ck._ptr(totals), slice_, mode,
               *scratch, stats=STATS)


# ---- K1: dp_reduce and dp_scatter_scan -------------------------------------

def dp_reduce_plain(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of dp_reduce: the elementwise int32 sum of the
    partials, on the first one's device."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p.to(out.device)
    return out


def dp_reduce(parts: Sequence[torch.Tensor],
              streams: Optional[Sequence] = None) -> torch.Tensor:
    """The psum: the elementwise sum of n int32 partials of one shape, a
    new tensor on the first partial's device. On the card one K1 launch
    (sum-only mode) on that device's current stream, after it waits for
    `streams` (those the partials were written on)."""
    name = "dp_reduce"
    _check_parts(name, parts)
    if not _on_card(name, parts):
        return dp_reduce_plain(parts)
    dev = parts[0].device
    N = parts[0].numel()
    cur = torch.cuda.current_stream(dev)
    _wait(cur, streams or ())
    out = torch.empty_like(parts[0])
    for p in parts:
        _keep(p, [cur])
    _k1(dev, _pointers(parts, dev), len(parts), 0, N, N, out, None, 0,
        DP_SUM)
    return out


def _slices(length: int, n: int):
    """(per, [(lo, elements read)] a slice) of [0, length) padded to
    Gp = ceil(length / n) * n."""
    per = -(-length // n)
    return per, [(i * per, max(0, min(per, length - i * per)))
                 for i in range(n)]


def dp_scatter_scan_plain(parts: Sequence[torch.Tensor], n: int,
                          length: Optional[int] = None,
                          devices: Optional[Sequence] = None
                          ) -> List[torch.Tensor]:
    """Plain version of dp_scatter_scan on any device: the cumsum of the
    summed, zero-padded partials, cut into n slices (slice i moved to
    devices[i])."""
    length = parts[0].numel() if length is None else length
    per, _ = _slices(length, n)
    total = dp_reduce_plain([p.reshape(-1)[:length] for p in parts])
    pad = torch.zeros(per * n, dtype=torch.int32, device=total.device)
    pad[:length] = total
    cov = torch.cumsum(pad, 0, dtype=torch.int32)
    devices = devices or [total.device] * n
    return [cov[i * per:(i + 1) * per].to(devices[i]) for i in range(n)]


def dp_scatter_scan(parts: Sequence[torch.Tensor], n: int,
                    length: Optional[int] = None,
                    devices: Optional[Sequence] = None,
                    streams: Optional[Sequence] = None
                    ) -> List[torch.Tensor]:
    """The genome-sharded coverage scan of n int32 partials (flat, one
    shape): elements [0, length) of their sum (length: all of them by
    default), zero-padded to Gp = ceil(length / n) * n and cut into n
    slices of Gp / n; slice i is the inclusive int32 cumsum of its
    elements plus the totals of slices 0 .. i-1, on devices[i] (default:
    all on the first partial's device). On the card slice i is two K1
    launches on streams[i] (default: devices[i]'s current stream): a pass
    that writes the slice's total into a table on devices[0], then the
    scan, which adds the totals of the slices before it. Each pass waits
    for every stream of `streams` (the partials' and the totals' writers),
    not only its own."""
    name = "dp_scatter_scan"
    N = _check_parts(name, parts)
    length = N if length is None else length
    need(n >= 1 and 1 <= length <= N and length < 2 ** 31,
         f"{name}: needs n >= 1 and 1 <= length <= the partials' size")
    devices = [torch.device(d) for d in devices] if devices else None
    need(devices is None or len(devices) == n,
         f"{name}: {n} slices but {len(devices or ())} devices")
    if not _on_card(name, parts):
        need(devices is None or all(d.type == "cpu" for d in devices),
             f"{name}: CPU partials and slices on a card")
        return dp_scatter_scan_plain(parts, n, length, devices)
    devices = devices or [parts[0].device] * n
    need(all(d.type == "cuda" for d in devices),
         f"{name}: partials on a card and slices off it")
    streams = list(streams) if streams else [
        torch.cuda.current_stream(d) for d in devices]
    need(len(streams) == n, f"{name}: {n} slices but {len(streams)} streams")
    per, ranges = _slices(length, n)
    # allocated on slice 0's stream, which every pass below waits for: a
    # block from the caller's stream may still have that stream's pending
    # writes (a pointer-table upload) land in it
    with issue_on(devices[0], streams[0]):
        totals = torch.empty(n, dtype=torch.int32, device=devices[0])
    outs = [None] * n
    for mode in (DP_TOTAL, DP_SCAN):
        for i, (d, s) in enumerate(zip(devices, streams)):
            with issue_on(d, s):
                _wait(s, streams)
                if mode == DP_TOTAL:
                    outs[i] = torch.empty(per, dtype=torch.int32, device=d)
                for t in (*parts, totals):
                    _keep(t, [s])
                _k1(d, _pointers(parts, d), len(parts), ranges[i][0],
                    ranges[i][1], per, outs[i] if mode == DP_SCAN else None,
                    totals, i, mode)
    return outs


# ---- K2: apply_bits --------------------------------------------------------

def apply_bits_plain(planes: Planes, pd, mmp, rlens, fast_bits,
                     pair_end: bool, sign: int = 1) -> Planes:
    """Plain version of apply_bits on any device: the bitmask unpacked as
    the reference's phase B does, then scatter_fast_evidence."""
    B = pd.shape[0]
    L = planes.exact_diff.shape[0] - 2
    bidx = torch.arange(B, dtype=torch.int64, device=pd.device)
    # int32 words: the arithmetic shift keeps bit 31 after the & 1
    adm = ((fast_bits.to(torch.int64)[bidx >> 5] >> (bidx & 31)) & 1) == 1
    scatter_fast_evidence(planes.exact_diff, planes.f_diff.view(-1),
                          planes.acgt.view(-1), adm, pd, mmp, rlens,
                          first_mate_lanes(bidx, pair_end), L, 2 * L, sign)
    return planes


def apply_bits(planes: Planes, pd: torch.Tensor, mmp: torch.Tensor,
               rlens: torch.Tensor, fast_bits: torch.Tensor, pair_end: bool,
               sign: int = 1) -> Planes:
    """Add (sign +1) or retract (sign -1) the evidence of the FAST reads
    that the admit bitmask selects: read b (pd, rlens int32[B], mmp
    int32[B, 4]) when bit b % 32 of fast_bits int32[>= ceil(B/32)] word
    b // 32 is set, into planes of genome size L (exact_diff int32[L+2],
    f_diff [4, L+2], acgt [4, L+1], text length 2L) in place; pair_end
    picks the orientation plane by read-index parity. Returns planes. On
    the card one K2 launch, a thread a read. Counted as
    evidence_apply_bits."""
    name = "evidence_apply_bits"
    need(sign in (1, -1), f"{name}: sign must be +1 or -1")
    B = pd.shape[0]
    need(B >= 1 and pd.shape == (B,) and rlens.shape == (B,)
         and mmp.shape == (B, 4) and fast_bits.dim() == 1
         and fast_bits.shape[0] >= -(-B // 32),
         f"{name}: pd and rlens [B], mmp [B, 4], fast_bits [>= B/32]")
    for what, t in (("pd", pd), ("mmp", mmp), ("rlens", rlens),
                    ("fast_bits", fast_bits), *zip(Planes._fields, planes)):
        need(t.dtype == torch.int32, f"{name}: {what} must be int32",
             TypeError)
    L = planes.exact_diff.shape[0] - 2
    need(L >= 1 and planes.f_diff.shape == (4, L + 2)
         and planes.acgt.shape == (4, L + 1),
         f"{name}: planes of one genome size expected")
    ts = [pd, mmp, rlens, fast_bits, *planes]
    if not _on_card(name, ts):
        return apply_bits_plain(planes, pd, mmp, rlens, fast_bits, pair_end,
                                sign)
    need(len({t.device for t in ts}) == 1,
         f"{name}: tensors on several cards")
    dev = pd.device
    ck._launch(name, dev, *map(ck._ptr, (pd, mmp, rlens, fast_bits)), B,
               *map(ck._ptr, planes), L, int(bool(pair_end)), sign,
               stats=STATS)
    return planes
