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
                   planes' (index, value) lists, each strictly
                   increasing, cut on the host into segments, one a
                   (shard, list, row), by one np.searchsorted a list
                   (merge_segments, merge_table), and added by one launch
                   a device over every segment of its shards (a launch a
                   512 segments past 51 shards; `host_merge_kernel`): into the single-card planes at
                   their flat indices (A5, pipeline/device_profile.
                   build_host_merge_kernel, mapcaller_tpu/pipeline/
                   device_profile.py:136-165), or into the slices of the
                   shards a device holds (B4's merge, big_profile.py:
                   189-289).

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
# csrc/chain.cu: entries a thread's unit (the lists are padded to whole
# units), segments a launch stages, int64 words of a segment's (and a
# run's) record
MERGE_ITEMS = 8
MERGE_MAX_SEGS = 512
SEG_WORDS = 4


def _padded(N: int) -> int:
    return -(-N // MERGE_ITEMS) * MERGE_ITEMS


def pack_deltas(lists) -> np.ndarray:
    """The four (int64 index, int32 value) lists as one int64 buffer for
    one upload: the N indices, then the N values as int32 pairs, each part
    padded with zeros to a whole number of the kernel's units (Np =
    ceil(N / 8) * 8 entries), so both lie on 16 bytes."""
    idx = np.concatenate([i for i, _ in lists]).astype(np.int64)
    val = np.concatenate([v for _, v in lists]).astype(np.int32)
    N = idx.size
    Np = _padded(N)
    buf = np.zeros(Np + Np // 2, dtype=np.int64)
    buf[:N] = idx
    buf[Np:].view(np.int32)[:N] = val
    return buf


def unpack_deltas(buf, N: int):
    """(idx int64[N], val int32[N]) views of a pack_deltas buffer (numpy
    or torch)."""
    Np = _padded(N)
    vals = buf[Np:Np + Np // 2]
    vals = (vals.view(np.int32) if isinstance(vals, np.ndarray)
            else vals.view(torch.int32))
    return buf[:N], vals[:N]


def _rows(plane) -> int:
    return plane.shape[0] if plane.dim() == 2 else 1


def merge_segments(idx: np.ndarray, ends, gstrides, shards) -> np.ndarray:
    """The host-delta merge's segments: idx int64[N] the four lists in
    order (list k ends at ends[k], each strictly increasing), an index
    row * gstrides[k] + position; shards [(off, rows, lstrides)], rows[k]
    and lstrides[k] list k's plane's rows and row stride in the shard,
    each row holding positions [off, off + lstrides[k]) -> int64[S, 4],
    S = len(shards) * sum(rows), a row a (shard, list, row) in that order:
    (g0, g1, sub, word): the entries [g0, g1) of the list lie in that
    row's positions the shard holds, entry x adds at word x - sub of
    the row, the row starting at word `word` of the shard's plane. One
    np.searchsorted a list over every boundary row * gstride + off (and
    the end of the held positions, at most the row's end)."""
    starts = [0] + list(ends[:3])
    per = {}
    for k in range(4):
        gs = gstrides[k]
        parts = []
        for off, rows, ls in shards:
            r = np.arange(rows[k], dtype=np.int64)
            a = r * gs + off
            parts.append((a, np.maximum(a, r * gs + min(off + ls[k], gs)),
                          r * ls[k]))
        bounds = np.concatenate([x for a, b, _ in parts for x in (a, b)])
        cut = starts[k] + np.searchsorted(idx[starts[k]:ends[k]], bounds)
        at = 0
        for j, (a, b, word) in enumerate(parts):
            n = a.size
            per[j, k] = np.stack([cut[at:at + n], cut[at + n:at + 2 * n], a,
                                  word], axis=1)
            at += 2 * n
    return np.concatenate([per[j, k] for j in range(len(shards))
                           for k in range(4)]).astype(np.int64)


def merge_table(segs: np.ndarray, bases: np.ndarray):
    """The kernel's records (csrc/chain.cu MergeSeg, MergeRun) from
    merge_segments' rows and each row's plane base address (bytes) ->
    (segments int64[S, 4]: g0, g1, sub, the address of the row's first
    word, the nonempty ones in order of g0; runs int64[R, 4]: w0, ubase,
    a, b, each a run [a, b) of consecutive segments' entries, its units
    of MERGE_ITEMS entries w0, w0 + 1, ... of the launch, unit w the
    lists' unit w + ubase; W, the launch's units)."""
    g0, g1, sub, word = segs.T
    keep = np.nonzero(g1 > g0)[0]
    keep = keep[np.argsort(g0[keep], kind="stable")]
    seg = np.stack([g0[keep], g1[keep], sub[keep],
                    (bases + 4 * word)[keep]], axis=1).astype(np.int64)
    if not keep.size:
        return seg, np.zeros((0, 4), np.int64), 0
    # a run starts where a segment does not begin at the last one's end
    new = np.concatenate([[True], seg[1:, 0] != seg[:-1, 1]])
    a = seg[new, 0]
    b = seg[np.concatenate([new[1:], [True]]), 1]
    u0 = a // MERGE_ITEMS
    cnt = -(-b // MERGE_ITEMS) - u0
    w0 = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    runs = np.stack([w0, u0 - w0, a, b], axis=1).astype(np.int64)
    return seg, runs, int(cnt.sum())


def merge_launches(segs: np.ndarray, bases: np.ndarray,
                   cap: int = MERGE_MAX_SEGS):
    """merge_table's records cut into launches of at most `cap` segments
    (what a launch stages in shared memory): the nonempty segments in
    order of g0, `cap` at a time, each launch with its own runs -> [(seg,
    runs, W)], no launch without units. One launch up to cap segments
    (on one card, 51 shards of 10 rows)."""
    keep = np.nonzero(segs[:, 1] > segs[:, 0])[0]
    keep = keep[np.argsort(segs[keep, 0], kind="stable")]
    out = [merge_table(segs[c], bases[c])
           for c in np.split(keep, range(cap, keep.size, cap))]
    return [t for t in out if t[2]]


def host_merge_plain(shards, idx, val, ends, gstrides):
    """Plain version of host_merge on any device: for each shard an
    index_add_ a list (idx, val host tensors, moved to the planes'
    device)."""
    for planes, off in shards:
        start = 0
        for name, end, gs in zip(MERGE_PLANES, ends, gstrides):
            plane = getattr(planes, name)
            x = idx[start:end].to(plane.device)
            v = val[start:end].to(plane.device)
            start = end
            ls = plane.shape[-1]
            row = torch.div(x, gs, rounding_mode="floor")
            li = x - row * gs - off
            ok = (li >= 0) & (li < ls)
            plane.view(-1).index_add_(0, (row * ls + li)[ok], v[ok])
    return shards


def host_merge(shards, deltas, ends, gstrides):
    """Add the host leg's sparse deltas into the four planes (acgt,
    exact_diff, f_diff, multi_diff: int32, 2-D [rows, ls] or 1-D [ls]) of
    every shard of `shards` [(planes, off)], all on one device, in place:
    deltas the four lists packed as pack_deltas packs them, on the host
    (numpy, or a CPU tensor), list k ending at ends[k] (ends[3] = N),
    each strictly increasing; an index is row * gstrides[k] + position,
    and a shard's plane row holds positions [off, off + ls), at
    row * ls + (position - off); the others are dropped. The single-card
    planes take their flat indices (gstrides their row strides,
    device_profile.merge_strides, one shard at off 0); B4 the single-card
    indices and the shards a device holds. Returns shards. On the card
    the lists and the segments (merge_segments, merge_table) go up in
    one copy and one launch adds every entry of every shard (past
    MERGE_MAX_SEGS segments, 51 shards on one card, a launch a
    MERGE_MAX_SEGS of them); nothing for N = 0. Counted as host_merge."""
    name = "host_merge"
    shards = [(p, int(off)) for p, off in shards]
    fields = [getattr(p, f) for p, _ in shards for f in MERGE_PLANES]
    ends, gstrides = [int(e) for e in ends], [int(g) for g in gstrides]
    if torch.is_tensor(deltas):
        need(deltas.device.type == "cpu",
             f"{name}: deltas must be on the host (pack_deltas' buffer)")
        deltas = deltas.numpy()
    need(deltas.dtype == np.int64
         and all(t.dtype == torch.int32 for t in fields),
         f"{name}: deltas int64 (pack_deltas), the planes int32", TypeError)
    need(len(shards) >= 1 and len(ends) == 4 and len(gstrides) == 4
         and all(0 <= a <= b for a, b in zip([0] + ends[:3], ends))
         and min(gstrides) >= 1 and min(off for _, off in shards) >= 0
         and all(t.dim() in (1, 2) and t.shape[-1] >= 1 for t in fields),
         f"{name}: four lists ending at ends, gstrides >= 1, offs >= 0")
    N = ends[-1]
    Np = _padded(N)
    need(deltas.ndim == 1 and deltas.shape[0] == Np + Np // 2,
         f"{name}: deltas must be pack_deltas' buffer of the N = {N} "
         f"entries")
    idx, val = unpack_deltas(deltas, N)
    need(all((x[1:] > x[:-1]).all()
             for x in (idx[a:b] for a, b in zip([0] + ends[:3], ends))),
         f"{name}: each list must be strictly increasing")
    need(len({t.device for t in fields}) == 1,
         f"{name}: planes on several devices")
    if not _on_card(name, fields):
        return host_merge_plain(shards, torch.from_numpy(idx),
                                torch.from_numpy(val), ends, gstrides)
    return _host_merge_kernel(shards, torch.from_numpy(idx),
                              torch.from_numpy(val), ends, gstrides)


def _host_merge_kernel(shards, idx, val, ends, gstrides):
    """host_merge_kernel: the lists and the segment records in one
    buffer, one copy to the planes' device, one launch over every
    segment of the shards (merge_launches: one a MERGE_MAX_SEGS
    segments); none for N = 0."""
    N = ends[-1]
    if not N:
        return shards
    dev = getattr(shards[0][0], MERGE_PLANES[0]).device
    segs = merge_segments(idx.numpy(), ends, gstrides, [
        (off, [_rows(getattr(p, f)) for f in MERGE_PLANES],
         [getattr(p, f).shape[-1] for f in MERGE_PLANES])
        for p, off in shards])
    bases = np.array([getattr(p, f).data_ptr()
                      for p, _ in shards for f in MERGE_PLANES
                      for _ in range(_rows(getattr(p, f)))], dtype=np.int64)
    launches = merge_launches(segs, bases)
    if not launches:
        return shards
    Np = _padded(N)
    tables = np.concatenate([np.concatenate([seg.reshape(-1),
                                             runs.reshape(-1)])
                             for seg, runs, _ in launches])
    host = torch.empty(Np + Np // 2 + tables.size, dtype=torch.int64,
                       pin_memory=dev.type == "cuda")
    h = host.numpy()
    h[:N] = idx.numpy()
    h[N:Np] = 0
    vals = h[Np:Np + Np // 2].view(np.int32)
    vals[:N] = val.numpy()
    vals[N:] = 0
    h[Np + Np // 2:] = tables
    buf = host.to(dev, non_blocking=True)
    at = Np + Np // 2
    for seg, runs, W in launches:
        _merge_launch(buf, Np, at, seg.shape[0], runs.shape[0],
                      *runs[0, 1:], W)
        at += seg.size + runs.size
    return shards


def _merge_launch(buf, Np: int, at: int, nseg: int, nrun: int, ubase0: int,
                  a0: int, b0: int, W: int) -> None:
    """A launch of host_merge_kernel on buf (the lists padded to Np
    entries, then the launches' tables): its nseg segment records at
    word `at` of buf, its nrun run records after them, run 0's ubase and
    entries [a0, b0), W units."""
    base = buf.data_ptr()
    seg = base + 8 * at
    ck._launch("host_merge", buf.device, base, base + 8 * Np, seg,
               int(nseg), seg + 8 * SEG_WORDS * nseg, int(nrun), int(ubase0),
               int(a0), int(b0), int(W), stats=STATS)
