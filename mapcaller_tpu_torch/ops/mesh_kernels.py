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

Two more kernels of csrc/chain.cu serve the evidence planes outside the
mesh:

  apply_slice      K2's slice form (`evidence_apply_slice_kernel`): the
                   admitted FAST reads of a batch, pd int64, into one
                   shard's slice of the genome-sharded planes of the x64
                   big-genome path (pipeline/big_profile.BigDeviceEvidence,
                   mapcaller_tpu/pipeline/big_profile.py:103-187): every
                   endpoint and mismatch position clipped over the genome,
                   then added where the shard holds it;
  host_merge       the host leg's sparse slow-read deltas, the four
                   planes' (index, value) lists in one launch
                   (`host_merge_kernel`): into the single-card planes at
                   their flat indices (A5, pipeline/device_profile.
                   build_host_merge_kernel, mapcaller_tpu/pipeline/
                   device_profile.py:136-165), or into a shard's slice
                   (B4's merge, big_profile.py:189-289).

K1 on device d reads the n partials through a table of their base
addresses, as ops/routed.Routed.pointers hands the routed kernels their
shards: partials on other cards are read as peer memory
(routed.enable_peer_access, which raises where refused); on one card with
repeats every address is on that card. Integer adds commute, so every
result equals the plain version's in every word.

Each wrapper checks its inputs, then runs the plain version for CPU
tensors and launches its kernel for CUDA tensors (apply_slice and
host_merge through their kernel entries `_apply_slice_kernel` and
`_host_merge_kernel`, which take the plain version's arguments),
counting the launch in
STATS ("dp_scatter_scan" for each K1 launch, whatever its mode;
"evidence_apply_bits" for K2, "evidence_apply_slice" for its slice form,
"host_merge"), or raises. There is no fallback between the two.
"""
from __future__ import annotations

import collections
import ctypes as C
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


# ---- K2's slice form: apply_slice -------------------------------------------

def _evidence_terms(adm, pd, mmp, rlens, b_first, L: int, two_l: int):
    """The plane adds of a batch's admitted FAST reads (the contributions
    of ops/evidence.scatter_fast_evidence): a list of (plane, row, global
    position, on, value), row None for a 1-D plane. int64 positions."""
    i64 = torch.int64
    pd, rlens, mmp = pd.to(i64), rlens.to(i64), mmp.to(i64)
    ori = pd < L
    g_start = torch.clamp(torch.where(ori, pd, two_l - pd - rlens), 0, L - 1)
    end = torch.clamp(g_start + rlens, max=L)
    fpl = torch.where(b_first, torch.where(ori, 0, 3), torch.where(ori, 1, 2))
    terms = [("exact_diff", None, g_start, adm, 1),
             ("exact_diff", None, end, adm, -1),
             ("f_diff", fpl, g_start, adm, 1),
             ("f_diff", fpl, end, adm, -1)]
    for k in range(mmp.shape[1]):
        e = mmp[:, k]
        on = adm & (e >= 0)
        r = e >> 2
        p = torch.clamp(torch.where(ori, pd + r, two_l - 1 - (pd + r)), 0,
                        L - 1)
        terms += [("exact_diff", None, p, on, -1),
                  ("exact_diff", None, p + 1, on, 1),
                  ("acgt", torch.where(ori, e & 3, 3 - (e & 3)), p, on, 1)]
    return terms


def _scatter_local(planes, off: int, plane: str, row, g, on, val) -> None:
    """Add val at the global positions g that the slice [off, off + Pl)
    holds (row: the plane row of a 2-D plane)."""
    target = getattr(planes, plane)
    Pl = target.shape[-1]
    li = g - off
    ok = on & (li >= 0) & (li < Pl)
    # the other lanes add 0 at a spread of slots: many atomic adds to one
    # address serialize on the card
    lane = torch.arange(li.shape[0], dtype=li.dtype, device=li.device)
    li = torch.where(ok, li, lane % Pl)
    if row is not None:
        li = li + torch.where(ok, row, 0) * Pl
    vals = torch.where(ok, val, 0).to(torch.int32)
    target.view(-1).index_add_(0, li, vals)


def apply_slice_plain(planes, off: int, pd, mmp, rlens, bits, L: int,
                      pair_end: bool):
    """Plain version of apply_slice on any device: the reads' terms over
    the genome (_evidence_terms), each added where the slice holds it
    (_scatter_local)."""
    B = pd.shape[0]
    adm = _admitted(bits, B, "bits", pd.device)
    bidx = torch.arange(B, dtype=torch.int64, device=pd.device)
    for plane, row, g, on, val in _evidence_terms(
            adm, pd, mmp, rlens, first_mate_lanes(bidx, pair_end), L, 2 * L):
        _scatter_local(planes, off, plane, row, g, on, val)
    return planes


def apply_slice(planes, off: int, pd: torch.Tensor, mmp: torch.Tensor,
                rlens: torch.Tensor, bits: torch.Tensor, L: int,
                pair_end: bool):
    """Add the evidence of the FAST reads the admit bits select (bit b % 32 of bits int32[>= ceil(B/32)] word b //
    32), pd int64[B], mmp int32[B, 4], rlens int32[B], over a genome of L
    (a text of 2L), into one shard's slice of the planes (anything with
    exact_diff int32[Pl], f_diff and acgt int32[4, Pl]: a
    pipeline/big_profile.ShardPlanes), which holds positions [off, off +
    Pl), in place: each position is clipped over the whole genome, then
    added where the slice holds it. Returns planes. On the card one launch
    of K2's slice form on the current stream (a warp an admit word, 4
    lanes a read, over all B reads); mmp's rows must be 16-byte aligned
    there. Counted as evidence_apply_slice."""
    name = "evidence_apply_slice"
    B = pd.shape[0] if pd.dim() == 1 else 0
    need(B >= 1 and rlens.shape == (B,) and mmp.shape == (B, 4)
         and bits.dim() == 1 and bits.shape[0] >= -(-B // 32),
         f"{name}: pd and rlens [B], mmp [B, 4], bits [>= B/32]")
    _dt = (("pd", pd, torch.int64), ("mmp", mmp, torch.int32),
           ("rlens", rlens, torch.int32), ("bits", bits, torch.int32))
    fields = [getattr(planes, f) for f in Planes._fields]
    for what, t, dtype in _dt + tuple(
            (f, t, torch.int32) for f, t in zip(Planes._fields, fields)):
        need(t.dtype == dtype, f"{name}: {what} must be {dtype}", TypeError)
    Pl = planes.exact_diff.shape[-1]
    need(planes.exact_diff.shape == (Pl,) and Pl >= 1
         and planes.f_diff.shape == (4, Pl) and planes.acgt.shape == (4, Pl),
         f"{name}: a slice's planes [Pl], [4, Pl], [4, Pl] expected")
    need(L >= 1 and off >= 0, f"{name}: L >= 1 and off >= 0")
    ts = [pd, mmp, rlens, bits, *fields]
    need(len({t.device for t in ts}) == 1,
         f"{name}: tensors on several devices")
    if not _on_card(name, ts):
        return apply_slice_plain(planes, off, pd, mmp, rlens, bits, L,
                                 pair_end)
    need(mmp.data_ptr() % 16 == 0, f"{name}: mmp's rows must be 16-byte "
                                   f"aligned (one load a row)")
    return _apply_slice_kernel(planes, off, pd, mmp, rlens, bits, L,
                               pair_end)


def _apply_slice_kernel(planes, off: int, pd, mmp, rlens, bits, L: int,
                        pair_end: bool):
    """evidence_apply_slice_kernel: one launch over the B reads."""
    fields = [getattr(planes, f) for f in Planes._fields]
    ck._launch("evidence_apply_slice", pd.device,
               *map(ck._ptr, (pd, mmp, rlens, bits)), pd.shape[0],
               *map(ck._ptr, fields), int(L), int(off),
               planes.exact_diff.shape[-1], int(bool(pair_end)),
               stats=STATS)
    return planes


# ---- the host-delta merge ---------------------------------------------------

MERGE_PLANES = ("acgt", "exact_diff", "f_diff", "multi_diff")


def pack_deltas(lists) -> np.ndarray:
    """The four (int64 index, int32 value) lists as one int64 buffer for
    one upload: the N indices, then the N values as int32 pairs."""
    idx = np.concatenate([i for i, _ in lists]).astype(np.int64)
    val = np.concatenate([v for _, v in lists]).astype(np.int32)
    N = idx.size
    buf = np.zeros(N + (N + 1) // 2, dtype=np.int64)
    buf[:N] = idx
    buf[N:].view(np.int32)[:N] = val
    return buf


def unpack_deltas(buf: torch.Tensor, N: int):
    """(idx int64[N], val int32[N]) views of a pack_deltas buffer."""
    return buf[:N], buf[N:].view(torch.int32)[:N]


def host_merge_plain(planes, idx, val, ends, gstrides, off: int = 0):
    """Plain version of host_merge on any device: an index_add_ a list."""
    start = 0
    for name, end, gs in zip(MERGE_PLANES, ends, gstrides):
        plane = getattr(planes, name)
        x, v = idx[start:end], val[start:end]
        start = end
        ls = plane.shape[-1]
        row = torch.div(x, gs, rounding_mode="floor")
        li = x - row * gs - off
        ok = (li >= 0) & (li < ls)
        plane.view(-1).index_add_(0, (row * ls + li)[ok], v[ok])
    return planes


def host_merge(planes, deltas: torch.Tensor, ends, gstrides, off: int = 0):
    """Add the host leg's sparse deltas into the four planes of `planes`
    (acgt, exact_diff, f_diff, multi_diff: int32, 2-D [rows, ls] or 1-D
    [ls]) in place: deltas the four lists packed as pack_deltas packs
    them (int64[N + ceil(N / 2)]: the N indices, then the N int32
    values), list k ending at ends[k] (ends[3] = N); an index is row *
    gstrides[k] + position, and a row of the plane holds positions [off,
    off + ls), at row * ls + (position - off); the others are dropped.
    The single-card planes take their flat indices (gstrides their row
    strides, device_profile.merge_strides, off 0); a shard of B4 the
    single-card indices with its off. Returns planes. On the card one
    launch on the current stream, none for N = 0. Counted as
    host_merge."""
    name = "host_merge"
    fields = [getattr(planes, f) for f in MERGE_PLANES]
    ends, gstrides = [int(e) for e in ends], [int(g) for g in gstrides]
    need(deltas.dtype == torch.int64
         and all(t.dtype == torch.int32 for t in fields),
         f"{name}: deltas int64 (pack_deltas), the planes int32", TypeError)
    need(len(ends) == 4 and len(gstrides) == 4
         and all(0 <= a <= b for a, b in zip([0] + ends[:3], ends))
         and min(gstrides) >= 1 and off >= 0
         and all(t.dim() in (1, 2) and t.shape[-1] >= 1 for t in fields),
         f"{name}: four lists ending at ends, gstrides >= 1, off >= 0")
    N = ends[-1]
    need(deltas.dim() == 1 and deltas.shape[0] == N + (N + 1) // 2,
         f"{name}: deltas must be pack_deltas' buffer of the N = {N} "
         f"entries")
    idx, val = unpack_deltas(deltas, N)
    ts = [deltas, *fields]
    need(len({t.device for t in ts}) == 1,
         f"{name}: tensors on several devices")
    if not _on_card(name, ts):
        return host_merge_plain(planes, idx, val, ends, gstrides, off)
    return _host_merge_kernel(planes, idx, val, ends, gstrides, off)


def _host_merge_kernel(planes, idx, val, ends, gstrides, off: int = 0):
    """host_merge_kernel: one launch, a thread an entry; none for N =
    0."""
    if ends[-1]:
        fields = [getattr(planes, f) for f in MERGE_PLANES]
        L4 = C.c_longlong * 4
        ck._launch("host_merge", idx.device, idx.data_ptr(), val.data_ptr(),
                   L4(*ends), (C.c_void_p * 4)(*(t.data_ptr()
                                                 for t in fields)),
                   L4(*gstrides), L4(*(t.shape[-1] for t in fields)),
                   int(off), stats=STATS)
    return planes
