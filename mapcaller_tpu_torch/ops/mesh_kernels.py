"""K1 and K2 on the card: the CUDA kernels `dp_scatter_scan_kernel` and
`evidence_apply_bits_kernel` of csrc/chain.cu, and their plain PyTorch
versions. K1 is the multichip mesh's collective (parallel/mesh.py); K2
is the main path's stand-alone evidence apply (pipeline/device_profile.
py) and the mesh's phase-B evidence.

  dp_reduce        the psum of n int32 partials of one shape: their
                   elementwise sum, on the first partial's device
                   (K1 in its sum-only mode);
  dp_scatter_scan  the reference's psum_scatter + all_gather of slice
                   totals + cumsum (mapcaller_tpu/parallel/mesh.py:165-178,
                   :451-459): Σ parts over [0, length), padded with zeros
                   to Gp = ceil(length / n) * n, cut into n slices of
                   Gp / n; slice i becomes the inclusive cumsum of its
                   elements plus the totals of slices 0 .. i-1, on
                   devices[i] (K1 in one pass: one launch a distinct
                   device, whose look-back over one status array of every
                   tile carries the earlier slices' totals);
  apply_bits       the evidence of the FAST reads an admit set selects,
                   added to or retracted from int32 planes in place (K2):
                   the host's admit bitmask (source "bits": the main
                   path's apply and reject correction, the mesh's phase B,
                   mesh.py:211-251, the bits unpacked as at :213-214), or
                   the chain kernel's classes (source "meta": the dense
                   undo of a speculation), then ops/evidence.
                   scatter_fast_evidence (mapcaller_tpu/pipeline/
                   device_profile.py:67-132).

K1 on device d reads the n partials through a table of their base
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
from .chain_device import CLASS_FAST
from .device_util import KernelStats, issue_on, need, upload
from .evidence import first_mate_lanes, scatter_fast_evidence

# csrc/chain.cu: threads of a K1 tile and the elements each thread scans
DP_THREADS = 512
DP_ITEMS = 8
DP_TILE = DP_THREADS * DP_ITEMS
DP_SUM, DP_SCAN = 0, 1                 # K1's modes

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


# ---- K1: dp_reduce and dp_scatter_scan -------------------------------------

def _k1(dev, ptrs, n: int, length: int, per: int, out=None, mode=DP_SUM,
        nslices: int = 0, table=None, nmine: int = 0, tiles_mine: int = 0,
        sys: bool = False, scratch=(None, None, 0, 0)) -> None:
    """One K1 launch on dev's current stream; scratch: (ticket pointer,
    status pointer, status words, epoch) of the scan mode."""
    ck._launch("dp_scatter_scan", dev, ptrs.data_ptr(), n, length, per,
               nslices, ck._ptr(table), nmine, tiles_mine, ck._ptr(out),
               mode, int(sys), *scratch, stats=STATS)


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
    _k1(dev, _pointers(parts, dev), len(parts), N, N, out)
    return out


def scan_groups(devices: Sequence) -> list:
    """K1's launches of a scan: [(device, the slices on it, ascending)], a
    launch a distinct device, in the order of their first slice."""
    groups = {}
    for i, d in enumerate(devices):
        groups.setdefault(torch.device(d), []).append(i)
    return list(groups.items())


def scan_tiles(slices: Sequence[int], per: int, tile: int) -> List[int]:
    """The tiles of `tile` elements, over the slices of `per` laid end to
    end, that a launch scanning `slices` takes: those whose first element
    lies in one of them, ascending."""
    def first(i):
        return -(-i * per // tile)
    return [T for i in slices for T in range(first(i), first(i + 1))]


def dp_scatter_scan_plain(parts: Sequence[torch.Tensor], n: int,
                          length: Optional[int] = None,
                          devices: Optional[Sequence] = None
                          ) -> List[torch.Tensor]:
    """Plain version of dp_scatter_scan on any device: the cumsum of the
    summed, zero-padded partials, cut into n slices (slice i moved to
    devices[i])."""
    length = parts[0].numel() if length is None else length
    per = -(-length // n)
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
    all on the first partial's device), ready on streams[i] (default:
    devices[i]'s current stream).

    On the card one K1 launch a distinct device (scan_groups), on the
    stream of that device's first slice (its writer), which allocates the
    device's slices; on one card, with repeats or not, one launch. The
    launches share one look-back status array, on the first device, over
    the tiles of [0, Gp); a launch takes the tiles that start in its
    slices (scan_tiles). Each writer first waits for every stream of
    `streams` (the partials' writers)."""
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
    per = -(-length // n)
    need(per * n < 2 ** 31, f"{name}: the padded length must stay below "
                            f"2^31")
    groups = scan_groups(devices)
    writer = {d: streams[sl[0]] for d, sl in groups}
    # Deadlock across launches: a tile spins on the status words of the
    # tiles before its own, which another card's launch may scan. So
    # every stream wait of the call is queued before any K1 launch: a
    # launch queued behind another launch of this call would never start.
    for d, _ in groups:
        _wait(writer[d], streams)
    # the outputs, the tables and the scratch, each allocated on the stream
    # that writes it (a block from another stream may still have that
    # stream's pending writes land in it)
    outs, plan = [None] * n, []
    d0 = devices[0]
    for d, sl in groups:
        with issue_on(d, writer[d]):
            for i in sl:
                outs[i] = torch.empty(per, dtype=torch.int32, device=d)
            for t in parts:
                _keep(t, [writer[d]])
    for d, sl in groups:
        with issue_on(d, writer[d]):
            if d == d0:
                # the status array of every tile: the first device's
                # scratch, and its epoch for every launch of the call
                ticket, words, epoch = ck._look_back_scratch(
                    d, -(-per * n // DP_TILE))
                status = (ticket + 8, words, epoch)
            else:                 # another card's launch: its own ticket
                ticket = ck._look_back_scratch(d, 1)[0]
            # every slice's base address (a tile that runs over its
            # slice's end writes the next one's first elements), then this
            # launch's slices
            table = upload(np.array([o.data_ptr() for o in outs] + sl,
                                    dtype=np.int64), d)
            plan.append((d, sl, _pointers(parts, d), table, ticket,
                         len(scan_tiles(sl, per, DP_TILE))))
    for d, sl, ptrs, table, ticket, tiles in plan:
        if tiles:
            with issue_on(d, writer[d]):
                # several cards poll the first card's status words: system
                # scope; one card keeps the faster gpu scope
                _k1(d, ptrs, len(parts), length, per, None, DP_SCAN, n,
                    table, len(sl), tiles, len(groups) > 1,
                    (ticket, *status))
    # after every launch: each writer waits for the other cards' launches
    # (a tile writes the next slice, which may be on another card, and the
    # first card's scratch, which its next launch may reuse), and each
    # slice's own stream for every writer
    if len(groups) > 1:
        for d, _ in groups:
            _wait(writer[d], writer.values())
    for i, (d, s) in enumerate(zip(devices, streams)):
        if s != writer[d]:
            s.wait_stream(writer[d])
            _keep(outs[i], [s])
    return outs


# ---- K2: apply_bits --------------------------------------------------------

SOURCES = ("bits", "meta")


def _admitted(sel, B: int, source: str, device) -> torch.Tensor:
    """bool[B]: read b's bit in the int32 words of sel (source "bits"),
    or its class in sel's low bits being FAST (source "meta")."""
    if source == "meta":
        return (sel[:B] & 3) == CLASS_FAST
    bidx = torch.arange(B, dtype=torch.int64, device=device)
    # int32 words: the arithmetic shift keeps bit 31 after the & 1
    return ((sel.to(torch.int64)[bidx >> 5] >> (bidx & 31)) & 1) == 1


def apply_bits_plain(planes, pd, mmp, rlens, sel, pair_end: bool,
                     sign: int = 1, source: str = "bits"):
    """Plain version of apply_bits on any device: the admit set unpacked as
    the reference does, then scatter_fast_evidence."""
    B = pd.shape[0]
    L = planes.exact_diff.shape[0] - 2
    adm = _admitted(sel, B, source, pd.device)
    bidx = torch.arange(B, dtype=torch.int64, device=pd.device)
    scatter_fast_evidence(planes.exact_diff, planes.f_diff.view(-1),
                          planes.acgt.view(-1), adm, pd, mmp, rlens,
                          first_mate_lanes(bidx, pair_end), L, 2 * L, sign)
    return planes


def apply_bits(planes, pd: torch.Tensor, mmp: torch.Tensor,
               rlens: torch.Tensor, sel: torch.Tensor, pair_end: bool,
               sign: int = 1, source: str = "bits"):
    """Add (sign +1) or retract (sign -1) the evidence of the admitted
    FAST reads: read b (pd, rlens int32[B], mmp int32[B, 4]) when bit
    b % 32 of sel int32[>= ceil(B/32)] word b // 32 is set (source
    "bits"), or when sel int32[>= B] (the chain kernel's packed output
    vector) holds class FAST in word b's low bits (source "meta"), into
    planes of genome size L (anything with exact_diff int32[L+2], f_diff
    [4, L+2] and acgt [4, L+1]: a Planes or a device_profile.DevicePlanes;
    text length 2L) in place; pair_end picks the orientation plane by
    read-index parity. Returns planes. On the card one K2 launch on the
    current stream, a warp an admit word, 4 lanes a read; mmp's rows must
    be 16-byte aligned there. Counted as evidence_apply_bits."""
    name = "evidence_apply_bits"
    need(sign in (1, -1), f"{name}: sign must be +1 or -1")
    need(source in SOURCES, f"{name}: source must be one of {SOURCES}")
    B = pd.shape[0]
    need(B >= 1 and pd.shape == (B,) and rlens.shape == (B,)
         and mmp.shape == (B, 4) and sel.dim() == 1
         and sel.shape[0] >= (B if source == "meta" else -(-B // 32)),
         f"{name}: pd and rlens [B], mmp [B, 4], sel [>= B/32] (bits) or "
         f"[>= B] (meta)")
    fields = [getattr(planes, f) for f in Planes._fields]
    for what, t in (("pd", pd), ("mmp", mmp), ("rlens", rlens), ("sel", sel),
                    *zip(Planes._fields, fields)):
        need(t.dtype == torch.int32, f"{name}: {what} must be int32",
             TypeError)
    L = planes.exact_diff.shape[0] - 2
    need(L >= 1 and planes.f_diff.shape == (4, L + 2)
         and planes.acgt.shape == (4, L + 1),
         f"{name}: planes of one genome size expected")
    ts = [pd, mmp, rlens, sel, *fields]
    if not _on_card(name, ts):
        return apply_bits_plain(planes, pd, mmp, rlens, sel, pair_end, sign,
                                source)
    need(len({t.device for t in ts}) == 1,
         f"{name}: tensors on several cards")
    need(mmp.data_ptr() % 16 == 0, f"{name}: mmp's rows must be 16-byte "
                                   f"aligned (one load a row)")
    bits, meta = (sel, None) if source == "bits" else (None, sel)
    ck._launch(name, pd.device, *map(ck._ptr, (pd, mmp, rlens, bits, meta)),
               B, *map(ck._ptr, fields), L, int(bool(pair_end)), sign,
               stats=STATS)
    return planes
