"""The calling phase's device programs on the card: the CUDA kernels of
`csrc/calling.cu` and their plain PyTorch versions.

  evidence_finalize  the finalize fold of the evidence planes (A5,
                     pipeline/device_profile.build_finalize_kernel): the
                     int32 prefixes of the exact, orientation and multi
                     diff rows, the allele counts with the exact coverage
                     credited to the reference base, capped, the capped
                     multi counts, the coverage and its int64 prefix, in
                     one launch of persistent blocks, each tile's rows
                     staged in shared memory at once; the reference codes
                     from the text words when asked. Its slice form
                     (carries of the slices before, a local coverage
                     prefix) is B4's per-shard fold
                     (pipeline/big_profile.BigDeviceEvidence._fold);
  caller_scan        the caller scan (A6, calling/scan_device.
                     build_scan_kernel): block depths, candidates and gap /
                     CNV run starts compacted in position order, the
                     counts; two memsets and one launch, staged as the
                     finalize's. Its slice form (a valid length, the run
                     state at the seam before) is B4's per-shard scan;
  caller_fetch       the evidence columns at sparse positions, the
                     coverage prefix at sparse points and block depths,
                     into one int64 buffer for one copy to the host (A6,
                     build_fetch_kernel); one launch;
  nor_blocks         the gVCF NOR blocks (A6, build_nor_kernel): one
                     launch of persistent blocks; a tile writes the
                     segments inside it, and a segment across tiles is
                     combined in a per-stream scratch of epoch-tagged
                     words and written by the last of its tiles;
  caller_fetch_slice the fetch's slice form, B4's fetch (pipeline/
                     big_profile.BigDeviceEvidence.fetch_columns,
                     ShardedBlockDepth.gather): one launch over every
                     shard a device holds, the elements in the caller's
                     order, each answered by the shard a search over the
                     shards' first positions finds, a point's prefix the
                     shard's inclusive coverage prefix after the earlier
                     shards' totals; the same body as caller_fetch (a
                     warp a column at 32 positions, the tile's columns
                     staged and stored 16 bytes at a time);
  nor_blocks_slice   the NOR blocks' slice form, B4's NOR a shard
                     (BigDeviceEvidence.nor_blocks): the minima of a
                     shard's valid positions keyed by the global breaks,
                     as local positions.

Each wrapper checks its inputs, then runs the plain version for CPU
tensors and the kernel entry (`_finalize_kernel`, `_scan_kernel`,
`_fetch_kernel`, `_nor_kernel`, `_fetch_slice_kernel`,
`_nor_slice_kernel`, which take the plain version's arguments) for CUDA
tensors, counting the launch in STATS, or raises.
There is no fallback between the two. The plain versions are the port's
eager PyTorch of these programs; chip_smoke.py holds each kernel equal to
its plain version on the card, in every word.
"""
from __future__ import annotations

import collections
import ctypes as C

import numpy as np
import torch

from .device_util import KernelStats, need

MAX_ALLELE_COUNT = 4095
BLOCK_SIZE = 100
CAND_CAP = 1 << 17
RUN_CAP = 1 << 20
INT32_MAX = 0x7FFFFFFF
DUMP = 4096          # dump slots past a compacted table (plain version)
# csrc/calling.cu: positions a finalize tile and a scan tile, int64 words
# of a tile's look-back slot
FIN_TILE = 2560
SCAN_TILE = 3200
SLOT_WORDS = 16
FETCH_TILE = 128     # positions a fetch block
FETCH_MAX_SHARDS = 16   # shards a slice-form fetch launch takes
_EPOCHS = 1 << 30    # the look-back's flag tags: 1 .. 2^30 - 1

# the finalize: acgt, F int32[4, n], multi, cov int32[n], cov_prefix int64
# (n + 1 with its leading cov_in, else n), codes int32[n] (the reference
# codes it used), carry int64[7] (the exact, four orientation and multi
# prefixes at n - 1 as int32 values, and the coverage prefix at n - 1)
Final = collections.namedtuple("Final", "acgt F multi cov cov_prefix codes "
                                        "carry")
# the scan: block_depth int32[ceil(n / 100)], cand_idx int32[CAND_CAP],
# run_start, run_val int32[RUN_CAP] (-1, -1, 0 past the counts), small
# int64[4] = (n_cand, n_runs, n_aligned, total_cov), seam int32[1] (the
# run state at n - 1, for the slice after)
Scan = collections.namedtuple("Scan", "block_depth cand_idx run_start "
                                      "run_val small seam")

STATS = KernelStats()
_lib = None
# per (device, stream): [scratch int64[SLOT_WORDS * (1 + tiles)], the last
# epoch] of the finalize's and the scan's look-back, as chain_kernels keeps
# its own
_scratch = {}
# per (device, stream): [scratch int64[3 * cap], the last epoch] of the NOR
# blocks: the minima and the edges' arrivals of up to cap segments
_nor_scratch = {}


def _load_kernel():
    global _lib
    if _lib is None:
        from ..toolchain import ensure_cuda
        lib = C.CDLL(ensure_cuda("calling"))
        P, I, LL = C.c_void_p, C.c_int, C.c_longlong
        for name, args in (
                ("mc_evidence_finalize", [P, I, P, P, I, P, P, P, P, LL, I]
                 + [P] * 5 + [I, P, P, P, I, I, P]),
                ("mc_caller_scan", [P, I, P, P, P, I, I, I, C.c_float, I]
                 + [P] * 6 + [I, I, P]),
                ("mc_caller_fetch", [P] * 7 + [I] * 4 + [P, P]),
                ("mc_nor_blocks", [P, I, P, I, P, I, I, P, P, I, I, P]),
                ("mc_caller_fetch_slice", [P, I, LL, P, I, I, I, P, P]),
                ("mc_nor_blocks_slice", [P, I, P, I, P, I, I, LL, P, P, I,
                                         I, P]),
                ("mc_calling_geometry", [I, P])):
            fn = getattr(lib, name)
            fn.restype = C.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _launch(name: str, dev: torch.device, *args) -> None:
    """One call of mc_<name> on dev's current stream, counted in STATS;
    raises if CUDA refused it."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(_load_kernel(), "mc_" + name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {err})")
    STATS.launches[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def geometry(dev) -> dict:
    """The finalize's, the scan's and the NOR blocks' launch geometry on
    CUDA device dev: {kernel: positions a tile, threads a block, tiles
    staged a block, bytes of dynamic shared memory a block (ptxas does not
    report it), blocks an SM, SMs}; a launch runs min(tiles, blocks an SM
    x SMs) persistent blocks."""
    keys = ("tile", "threads", "stages", "dynamic_smem_bytes",
            "blocks_an_sm", "sms")
    out = {}
    for which, name in enumerate(("evidence_finalize", "caller_scan",
                                  "nor_blocks")):
        buf = (C.c_int * len(keys))()
        with torch.cuda.device(dev):
            err = _load_kernel().mc_calling_geometry(which, buf)
        if err != 0:
            raise RuntimeError(f"{name}: no launch geometry (error {err})")
        out[name] = dict(zip(keys, buf))
    return out


def _on_card(name: str, tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; refuses a mix of
    devices, non-contiguous inputs and any other device."""
    tensors = [t for t in tensors if t is not None]
    devs = {t.device for t in tensors}
    need(len(devs) == 1, f"{name}: tensors on several devices {devs}")
    need(all(t.is_contiguous() for t in tensors),
         f"{name}: inputs must be contiguous")
    dev = devs.pop()
    need(dev.type in ("cpu", "cuda"), f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _dtype(name: str, t, dtype, what: str) -> None:
    need(t.dtype == dtype, f"{name}: {what} must be {dtype}", TypeError)


def _look_back(dev: torch.device, tiles: int):
    """(pointer, tiles, epoch) of the look-back scratch of dev's current
    stream for a launch of `tiles` tiles, with the next epoch."""
    key = dev, torch.cuda.current_stream(dev).cuda_stream
    sc = _scratch.get(key)
    if sc is None or sc[0].shape[0] // SLOT_WORDS - 1 < tiles \
            or sc[1] + 1 >= _EPOCHS:
        # zeroed flags hold epoch 0, which no launch uses
        sc = _scratch[key] = [torch.zeros(
            SLOT_WORDS * (1 + max(tiles, 1024)), dtype=torch.int64,
            device=dev), 0]
    sc[1] += 1
    return sc[0].data_ptr(), sc[0].shape[0] // SLOT_WORDS - 1, sc[1]


def _nor_words(dev: torch.device, nseg: int):
    """(pointer, cap, epoch) of the NOR scratch of dev's current stream for
    a launch of nseg segments, with the next epoch: its words of earlier
    epochs read as empty segments, so no launch clears it. A new zeroed
    scratch when it is too small or the epochs run out."""
    key = dev, (torch.cuda.current_stream(dev).cuda_stream
                if dev.type == "cuda" else 0)
    sc = _nor_scratch.get(key)
    if sc is None or sc[0].shape[0] // 3 < nseg or sc[1] + 1 >= _EPOCHS:
        # zeroed words hold epoch 0, which no launch uses
        sc = _nor_scratch[key] = [torch.zeros(
            3 * max(nseg, 1 << 14), dtype=torch.int64, device=dev), 0]
    sc[1] += 1
    return sc[0].data_ptr(), sc[0].shape[0] // 3, sc[1]


# ---- evidence_finalize ----------------------------------------------------

def ref_codes_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    """Forward-genome codes int32[n] from the text words (int64 holding
    uint32, 16 crumbs per word in bwa order)."""
    words = words[:(n + 15) // 16]
    sh = (15 - torch.arange(16, dtype=torch.int64, device=words.device)) * 2
    crumbs = (words[:, None] >> sh[None, :]) & 3
    return crumbs.reshape(-1)[:n].to(torch.int32)


def evidence_finalize_plain(acgt, exact_diff, f_diff, multi_diff, n: int,
                            codes=None, words=None, carry=None, cov_in=0,
                            lead=True) -> Final:
    """Plain version of evidence_finalize on any device."""
    i32 = torch.int32
    if words is not None:
        codes = ref_codes_plain(words, n)
    exact = torch.cumsum(exact_diff[:n], 0, dtype=i32)
    rc = codes[:n]
    # one 1-D scan per plane: a scan along the rows of a [4, L] tensor
    # runs one CUDA block per row
    F = torch.stack([torch.cumsum(f_diff[k, :n], 0, dtype=i32)
                     for k in range(4)])
    cm = torch.cumsum(multi_diff[:n], 0, dtype=i32)
    if carry is not None:         # the prefixes of the slices before
        c = carry[:6].to(i32)
        exact, F, cm = exact + c[0], F + c[1:5, None], cm + c[5]
    base = torch.arange(4, dtype=rc.dtype, device=rc.device)[:, None]
    acgt = acgt[:, :n] + torch.where(base == rc[None, :], exact[None, :], 0)
    acgt = torch.clamp(acgt, max=MAX_ALLELE_COUNT)
    multi = torch.clamp(cm, max=MAX_ALLELE_COUNT)
    cov = acgt.sum(0, dtype=i32)
    csum = torch.cumsum(cov, 0, dtype=torch.int64) + int(cov_in)
    cov_prefix = torch.cat([torch.full((1,), int(cov_in), dtype=torch.int64,
                                       device=cov.device), csum]) \
        if lead else csum
    carry_out = torch.cat([torch.cat([exact[-1:], F[:, -1], cm[-1:]]).to(
        torch.int64), csum[-1:]])
    return Final(acgt, F, multi, cov, cov_prefix, rc, carry_out)


def _finalize_kernel(acgt, exact_diff, f_diff, multi_diff, n: int,
                     codes=None, words=None, carry=None, cov_in=0,
                     lead=True) -> Final:
    """evidence_finalize_kernel: one launch over ceil(n / FIN_TILE)
    tiles."""
    dev = exact_diff.device

    def out(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    fin = Final(out(4, n), out(4, n), out(n), out(n),
                out(n + 1 if lead else n, dtype=torch.int64),
                out(n) if words is not None else codes[:n],
                out(7, dtype=torch.int64))
    # cov_prefix[1:] takes the inclusive prefix, [0] the leading cov_in
    cpre = fin.cov_prefix.data_ptr() + (8 if lead else 0)
    _launch("evidence_finalize", dev, acgt.data_ptr(), acgt.stride(0),
            exact_diff.data_ptr(), f_diff.data_ptr(), f_diff.stride(0),
            multi_diff.data_ptr(), None if words is not None else _ptr(codes),
            _ptr(words), _ptr(carry), int(cov_in), n, *map(_ptr, fin[:4]),
            cpre, int(lead), _ptr(fin.codes) if words is not None else None,
            fin.carry.data_ptr(), *_look_back(dev, -(-n // FIN_TILE)))
    return fin


def evidence_finalize(acgt, exact_diff, f_diff, multi_diff, n: int,
                      codes=None, words=None, carry=None, cov_in=0,
                      lead=True) -> Final:
    """The finalize fold of positions [0, n) of the planes acgt int32[4,
    >= n], exact_diff int32[>= n], f_diff int32[4, >= n], multi_diff
    int32[>= n], with the reference codes `codes` int32[>= n] or those of
    the text words `words` int64[>= ceil(n / 16)] -> Final. The slice
    form: carry int64[7] (a slice's Final.carry: the six int32 prefixes
    come in, or none for 0), cov_in (the coverage prefix coming in) and
    lead (cov_prefix with its leading cov_in, n + 1 long, else the
    inclusive prefix, n long). Counted as evidence_finalize."""
    name = "evidence_finalize"
    need(n >= 1 and (codes is None) != (words is None),
         f"{name}: n >= 1 and one of codes and words")
    for what, t, rows in (("acgt", acgt, 4), ("exact_diff", exact_diff, 0),
                          ("f_diff", f_diff, 4), ("multi_diff", multi_diff, 0)):
        _dtype(name, t, torch.int32, what)
        need(t.shape[:-1] == ((rows,) if rows else ()) and t.shape[-1] >= n,
             f"{name}: {what} must be int32[{f'{rows}, ' if rows else ''}>= n]")
    if codes is not None:
        _dtype(name, codes, torch.int32, "codes")
        need(codes.dim() == 1 and codes.shape[0] >= n,
             f"{name}: codes must be int32[>= n]")
    else:
        _dtype(name, words, torch.int64, "words")
        need(words.dim() == 1 and words.shape[0] >= (n + 15) // 16,
             f"{name}: words must be int64[>= ceil(n / 16)]")
    if carry is not None:
        _dtype(name, carry, torch.int64, "carry")
        need(carry.shape == (7,), f"{name}: carry must be int64[7]")
    args = (acgt, exact_diff, f_diff, multi_diff, n, codes, words, carry,
            cov_in, lead)
    if not _on_card(name, [acgt, exact_diff, f_diff, multi_diff, codes,
                           words, carry]):
        return evidence_finalize_plain(*args)
    need(n <= 1 << 30, f"{name}: the kernel takes n <= 2^30")
    return _finalize_kernel(*args)


# ---- caller_scan ------------------------------------------------------------

def _compact(mask, dest, vals, cap, fill, spread):
    # unselected positions store into a dump region past the table,
    # spread by position: millions of stores to one address serialize on
    # the card
    out = torch.full((cap + DUMP,), fill, dtype=torch.int32,
                     device=mask.device)
    slot = torch.where(mask, torch.clamp(dest, max=cap), cap + spread)
    return out.scatter_(0, slot, vals)[:cap]


def caller_scan_plain(acgt, multi, cov, ref_codes, min_allele_depth,
                      freq_base, somatic: bool, valid=None,
                      seam=None) -> Scan:
    """Plain version of caller_scan on any device."""
    L = cov.shape[0]
    nb = (L + BLOCK_SIZE - 1) // BLOCK_SIZE
    i32 = torch.int32
    dev = cov.device
    pos = torch.arange(L, dtype=i32, device=dev)
    # the slice form: positions past the valid length hold no coverage, no
    # candidate and no run
    vmask = None if valid is None or valid >= L else pos < valid
    if vmask is not None:
        cov = torch.where(vmask, cov, 0)
    pad = nb * BLOCK_SIZE - L
    covp = torch.cat([cov, torch.zeros(pad, dtype=i32, device=dev)])
    sums = covp.reshape(nb, BLOCK_SIZE).sum(1, dtype=i32)
    block_depth = torch.where(sums > 0, sums // BLOCK_SIZE, 0)

    ad = int(min_allele_depth)
    if somatic:
        cov_thr = torch.full((L,), ad, dtype=i32, device=dev)
    else:
        bd_pos = block_depth[:, None].expand(nb, BLOCK_SIZE).reshape(-1)[:L]
        cov_thr = torch.clamp(bd_pos >> 1, min=ad)
    rc = ref_codes[:L]
    nonref_max = torch.full((L,), -1, dtype=i32, device=dev)
    for c in range(4):
        nonref_max = torch.maximum(nonref_max,
                                   torch.where(rc == c, -1, acgt[c]))
    # conservative superset of max(ceil_f64(cov*freq_base), ad): the
    # float32 product minus 1 covers rounding differences. The factor
    # is a float32 value, and a float32 tensor times a Python scalar
    # multiplies in float32
    fb = float(np.float32(freq_base))
    sup_thr = torch.clamp((cov.to(torch.float32) * fb).to(i32) - 1, min=ad)
    cand_mask = (cov >= cov_thr) & (nonref_max >= sup_thr)
    multi_on = multi > 0
    if vmask is not None:
        cand_mask, multi_on = cand_mask & vmask, multi_on & vmask
    dest = torch.cumsum(cand_mask, 0, dtype=torch.int64) - 1
    n_cand = cand_mask.sum()
    spread = pos.to(torch.int64) % DUMP
    cand_idx = _compact(cand_mask, dest, pos, CAND_CAP, -1, spread)

    # gap/CNV run boundaries (ref: cpp:632-651 semantics, on the host)
    state = torch.where(cov > 0, 2, torch.where(multi_on, 1, 0)).to(i32)
    first = (torch.ones(1, dtype=torch.bool, device=dev) if seam is None
             else state[:1] != seam)
    newrun = torch.cat([first, state[1:] != state[:-1]])
    if vmask is not None:
        newrun = newrun & vmask
    rdest = torch.cumsum(newrun, 0, dtype=torch.int64) - 1
    n_runs = newrun.sum()
    run_start = _compact(newrun, rdest, pos, RUN_CAP, -1, spread)
    run_val = _compact(newrun, rdest, state, RUN_CAP, 0, spread)

    aligned = cov > 0
    n_aligned = aligned.sum()
    total_cov = torch.where(aligned, cov, 0).sum(dtype=torch.int64)
    small = torch.stack([n_cand, n_runs, n_aligned, total_cov])
    return Scan(block_depth, cand_idx, run_start, run_val, small,
                state[-1:])


def _scan_kernel(acgt, multi, cov, ref_codes, min_allele_depth, freq_base,
                 somatic: bool, valid=None, seam=None) -> Scan:
    """caller_scan_kernel: two memsets (the tables' fills) and one launch
    over ceil(L / SCAN_TILE) tiles."""
    L = cov.shape[0]
    dev = cov.device
    tables = torch.empty(CAND_CAP + 2 * RUN_CAP, dtype=torch.int32,
                         device=dev)
    out = Scan(torch.empty((L + BLOCK_SIZE - 1) // BLOCK_SIZE,
                           dtype=torch.int32, device=dev),
               tables[:CAND_CAP], tables[CAND_CAP:CAND_CAP + RUN_CAP],
               tables[CAND_CAP + RUN_CAP:],
               torch.empty(4, dtype=torch.int64, device=dev),
               torch.empty(1, dtype=torch.int32, device=dev))
    _launch("caller_scan", dev, acgt.data_ptr(), acgt.stride(0),
            multi.data_ptr(), cov.data_ptr(), ref_codes.data_ptr(), L,
            L if valid is None else max(0, min(int(valid), L)),
            int(min_allele_depth), float(np.float32(freq_base)),
            int(bool(somatic)), _ptr(seam), out.block_depth.data_ptr(),
            tables.data_ptr(), out.small.data_ptr(), out.seam.data_ptr(),
            *_look_back(dev, -(-L // SCAN_TILE)))
    return out


def caller_scan(acgt, multi, cov, ref_codes, min_allele_depth, freq_base,
                somatic: bool, valid=None, seam=None) -> Scan:
    """The caller scan of positions [0, L) (acgt int32[4, L] finalized,
    multi, cov int32[L], ref_codes int32[>= L]) under min_allele_depth
    and the float32 freq_base -> Scan. The slice form: valid (positions at
    or past it count as uncovered, not multi-hit, and are no candidate
    and no run start; default L) and seam (int32[1], the run state just
    before position 0: a slice's Scan.seam; none: position 0 starts a
    run). Counted as caller_scan."""
    name = "caller_scan"
    need(cov.dim() == 1 and cov.shape[0] >= 1, f"{name}: cov must be [L]")
    L = cov.shape[0]
    for what, t, shape in (("acgt", acgt, (4, L)), ("multi", multi, (L,)),
                           ("cov", cov, (L,))):
        _dtype(name, t, torch.int32, what)
        need(t.shape == shape, f"{name}: {what} must be int32{list(shape)}")
    _dtype(name, ref_codes, torch.int32, "ref_codes")
    need(ref_codes.dim() == 1 and ref_codes.shape[0] >= L,
         f"{name}: ref_codes must be int32[>= L]")
    if seam is not None:
        _dtype(name, seam, torch.int32, "seam")
        need(seam.shape == (1,), f"{name}: seam must be int32[1]")
    args = (acgt, multi, cov, ref_codes, min_allele_depth, freq_base,
            somatic, valid, seam)
    if not _on_card(name, [acgt, multi, cov, ref_codes, seam]):
        return caller_scan_plain(*args)
    need(L <= 1 << 30, f"{name}: the kernel takes L <= 2^30")
    return _scan_kernel(*args)


# ---- caller_fetch -----------------------------------------------------------

def caller_fetch_plain(acgt, multi, F, cov, cov_prefix, idx, P: int, Q: int,
                       block_depth=None) -> torch.Tensor:
    """Plain version of caller_fetch on any device."""
    L = cov.shape[0]
    p = torch.clamp(idx[:P], 0, L - 1)
    cols = torch.stack([acgt[0][p], acgt[1][p], acgt[2][p], acgt[3][p],
                        multi[p], F[0][p], F[1][p], F[2][p], F[3][p],
                        cov[p]], dim=1)
    pref = cov_prefix[torch.clamp(idx[P:P + Q], 0, L)]
    parts = [cols.reshape(-1).to(torch.int64), pref]
    if idx.shape[0] > P + Q:
        parts.append(block_depth[idx[P + Q:]].to(torch.int64))
    return torch.cat(parts)


def _fetch_kernel(acgt, multi, F, cov, cov_prefix, idx, P: int, Q: int,
                  block_depth=None) -> torch.Tensor:
    """caller_fetch_kernel: one launch (the fetch body over one shard)."""
    nbd = idx.shape[0] - P - Q
    out = torch.empty(10 * P + Q + nbd, dtype=torch.int64, device=idx.device)
    if out.numel():
        _launch("caller_fetch", idx.device, acgt.data_ptr(), multi.data_ptr(),
                F.data_ptr(), cov.data_ptr(), cov_prefix.data_ptr(),
                _ptr(block_depth) if nbd else None, idx.data_ptr(),
                cov.shape[0], P, Q, nbd, out.data_ptr())
    return out


def caller_fetch(acgt, multi, F, cov, cov_prefix, idx, P: int, Q: int,
                 block_depth=None) -> torch.Tensor:
    """The finalized planes (acgt, F int32[4, L], multi, cov int32[L],
    cov_prefix int64[L + 1]) read at idx int64[P + Q + nbd]: P positions
    (clamped to [0, L)), Q prefix points (clamped to [0, L]) and nbd
    blocks (each below the length of block_depth int32, needed when nbd >
    0) -> int64[10 P + Q + nbd]: each position's columns (A, C, G, T,
    multi, F1, R2, F2, R1, cov), the prefix values, the block depths.
    Counted as caller_fetch."""
    name = "caller_fetch"
    need(cov.dim() == 1 and cov.shape[0] >= 1, f"{name}: cov must be [L]")
    L = cov.shape[0]
    for what, t, shape in (("acgt", acgt, (4, L)), ("F", F, (4, L)),
                           ("multi", multi, (L,)), ("cov", cov, (L,))):
        _dtype(name, t, torch.int32, what)
        need(t.shape == shape, f"{name}: {what} must be int32{list(shape)}")
    _dtype(name, cov_prefix, torch.int64, "cov_prefix")
    need(cov_prefix.shape == (L + 1,), f"{name}: cov_prefix must be "
                                       f"int64[L + 1]")
    _dtype(name, idx, torch.int64, "idx")
    need(idx.dim() == 1 and 0 <= P and 0 <= Q and P + Q <= idx.shape[0],
         f"{name}: idx must be int64[P + Q + nbd]")
    nbd = idx.shape[0] - P - Q
    if nbd:
        need(block_depth is not None, f"{name}: blocks without block_depth")
        _dtype(name, block_depth, torch.int32, "block_depth")
    args = (acgt, multi, F, cov, cov_prefix, idx, P, Q, block_depth)
    if not _on_card(name, [acgt, multi, F, cov, cov_prefix, idx,
                           block_depth if nbd else None]):
        return caller_fetch_plain(*args)
    return _fetch_kernel(*args)


# ---- nor_blocks -------------------------------------------------------------

def nor_blocks_plain(cov, emitted, brk_sorted, nseg: int) -> torch.Tensor:
    """Plain version of nor_blocks on any device (emitted in any order)."""
    L = cov.shape[0]
    dev = cov.device
    pos = torch.arange(L, dtype=torch.int64, device=dev)
    em_mask = torch.zeros(L, dtype=torch.bool, device=dev)
    em_mask[torch.clamp(emitted, 0, L - 1)] = True
    normal = (cov > 0) & ~em_mask
    key = torch.searchsorted(brk_sorted, pos, right=True)
    seg = torch.where(normal, torch.clamp(key, max=nseg - 1), nseg - 1)

    def seg_min(vals):
        out = torch.full((nseg,), INT32_MAX, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, seg, torch.where(
            normal, vals.to(torch.int32), INT32_MAX), "amin")

    first = seg_min(pos)
    mincov = seg_min(cov)
    covf = cov[torch.clamp(first, 0, L - 1).to(torch.int64)]
    return torch.cat([first, mincov, covf])


def _nor_kernel(cov, emitted, brk_sorted, nseg: int) -> torch.Tensor:
    """nor_blocks_kernel: one launch."""
    out = torch.empty(3 * nseg, dtype=torch.int32, device=cov.device)
    _launch("nor_blocks", cov.device, cov.data_ptr(), cov.shape[0],
            emitted.data_ptr(), emitted.shape[0], brk_sorted.data_ptr(),
            brk_sorted.shape[0], nseg, out.data_ptr(),
            *_nor_words(cov.device, nseg))
    return out


def nor_blocks(cov, emitted, brk_sorted, nseg: int) -> torch.Tensor:
    """The gVCF NOR blocks (ref: VariantCalling.cpp:652-661 via the RLE
    formulation of caller._identify_variants_gvcf_vec): a position is
    normal when covered (cov int32[L] > 0) and not among emitted (int64,
    clamped to [0, L); sorted for the kernel); its key is the number of
    breaks (brk_sorted int64, sorted) at or before it, its segment
    min(key, nseg - 1). -> int32[3 * nseg]: each segment's first normal
    position and least coverage (INT32_MAX for a segment with none) and
    the coverage at its clamped first position. Counted as nor_blocks."""
    name = "nor_blocks"
    need(cov.dim() == 1 and cov.shape[0] >= 1 and nseg >= 1,
         f"{name}: cov must be [L], L >= 1, and nseg >= 1")
    _dtype(name, cov, torch.int32, "cov")
    for what, t in (("emitted", emitted), ("brk_sorted", brk_sorted)):
        _dtype(name, t, torch.int64, what)
        need(t.dim() == 1, f"{name}: {what} must be 1-D")
    if not _on_card(name, [cov, emitted, brk_sorted]):
        return nor_blocks_plain(cov, emitted, brk_sorted, nseg)
    need(cov.shape[0] < 1 << 31 and nseg <= 1 << 29,
         f"{name}: the kernel takes L < 2^31 and nseg <= 2^29")
    return _nor_kernel(cov, emitted, brk_sorted, nseg)



# ---- the slice forms of the fetch and the NOR blocks (B4) -------------------

def _fetch_owner(firsts, x):
    """The shard of each x: the last whose first position (or block) is
    at or before it, shard 0 before every shard (the kernel's search)."""
    return torch.clamp(torch.searchsorted(firsts, x, right=True) - 1, min=0)


def caller_fetch_slice_plain(shards, offs, before, idx, P: int, Q: int,
                             L: int, block_depths=None) -> torch.Tensor:
    """Plain version of caller_fetch_slice on any device."""
    dev = idx.device
    offs_t = torch.tensor([int(o) for o in offs], dtype=torch.int64,
                          device=dev)
    lens = [sh[3].shape[0] for sh in shards]
    out = torch.zeros(idx.shape[0] + 9 * P, dtype=torch.int64, device=dev)
    p = torch.clamp(idx[:P], 0, L - 1)
    q = torch.clamp(idx[P:P + Q], 0, L)
    b = idx[P + Q:]
    po, qo = _fetch_owner(offs_t, p), _fetch_owner(offs_t, q)
    bo = _fetch_owner(torch.div(offs_t, BLOCK_SIZE, rounding_mode="floor"),
                      b)
    cols = out[:10 * P].view(P, 10)
    pref = out[10 * P:10 * P + Q]
    depths = out[10 * P + Q:]
    for s, ((acgt, F, multi, cov, ccov), off, n) in enumerate(
            zip(shards, offs, lens)):
        m = po == s
        lp = torch.clamp(p[m] - int(off), 0, n - 1)
        cols[m] = torch.stack(
            [acgt[0][lp], acgt[1][lp], acgt[2][lp], acgt[3][lp], multi[lp],
             F[0][lp], F[1][lp], F[2][lp], F[3][lp], cov[lp]],
            dim=1).to(torch.int64)
        m = qo == s
        lq = torch.clamp(q[m] - int(off), 0, n)
        pref[m] = int(before[s]) + torch.where(
            lq == 0, 0, ccov[torch.clamp(lq - 1, min=0)])
        m = bo == s
        if m.any():
            depths[m] = block_depths[s][b[m] - int(off) // BLOCK_SIZE].to(
                torch.int64)
    return out


def _fetch_slice_kernel(shards, offs, before, idx, P: int, Q: int, L: int,
                        block_depths=None) -> torch.Tensor:
    """caller_fetch_slice_kernel: one launch over every shard."""
    nbd = idx.shape[0] - P - Q
    out = torch.empty(10 * P + Q + nbd, dtype=torch.int64, device=idx.device)
    if out.numel():
        table = (C.c_longlong * (9 * len(shards)))(*(
            v for s, (acgt, F, multi, cov, ccov) in enumerate(shards)
            for v in (acgt.data_ptr(), multi.data_ptr(), F.data_ptr(),
                      cov.data_ptr(), ccov.data_ptr(),
                      block_depths[s].data_ptr() if nbd else 0,
                      int(offs[s]), int(before[s]), cov.shape[0])))
        _launch("caller_fetch_slice", idx.device, table, len(shards), int(L),
                idx.data_ptr(), P, Q, nbd, out.data_ptr())
    return out


def caller_fetch_slice(shards, offs, before, idx, P: int, Q: int, L: int,
                       block_depths=None) -> torch.Tensor:
    """The finalized slices of a device's shards, in order of their first
    positions: shards[s] = (acgt, F int32[4, Pl_s], multi, cov int32[Pl_s],
    ccov int64[Pl_s] its inclusive coverage prefix), holding genome
    positions [offs[s], offs[s] + Pl_s) (offs in order, apart, multiples
    of 100), before[s] the coverage of the genome's shards before it, read
    at idx int64[P + Q + nbd] in the caller's order: P genome positions
    (clamped to [0, L - 1]), Q prefix points (clamped to [0, L]) and nbd
    genome blocks (block_depths[s] int32, needed when nbd > 0). Each
    element's shard is the last whose first position (block) is at or
    before it; its index in the shard is clamped to the shard (a
    position to [0, Pl_s), a point to [0, Pl_s]): a point q reads
    before[s] + ccov[q - offs[s] - 1], or before[s] at offs[s]. ->
    int64[10 P + Q + nbd], laid out as caller_fetch's. On the card one
    launch; counted as caller_fetch_slice."""
    name = "caller_fetch_slice"
    n = len(shards)
    need(n >= 1 and len(offs) == n and len(before) == n,
         f"{name}: a shard's offs and before for each shard")
    ts = [idx]
    for acgt, F, multi, cov, ccov in shards:
        need(cov.dim() == 1 and cov.shape[0] >= 1,
             f"{name}: cov must be [Pl]")
        Pl = cov.shape[0]
        for what, t, shape in (("acgt", acgt, (4, Pl)), ("F", F, (4, Pl)),
                               ("multi", multi, (Pl,)), ("cov", cov, (Pl,))):
            _dtype(name, t, torch.int32, what)
            need(t.shape == shape,
                 f"{name}: {what} must be int32{list(shape)}")
        _dtype(name, ccov, torch.int64, "ccov")
        need(ccov.shape == (Pl,), f"{name}: ccov must be int64[Pl]")
        ts += [acgt, F, multi, cov, ccov]
    offs = [int(o) for o in offs]
    ends = [o + sh[3].shape[0] for o, sh in zip(offs, shards)]
    need(offs[0] >= 0 and all(o % BLOCK_SIZE == 0 for o in offs)
         and all(a <= b for a, b in zip(ends[:-1], offs[1:])) and L >= 1,
         f"{name}: shards in order, apart, on whole blocks; L >= 1")
    _dtype(name, idx, torch.int64, "idx")
    need(idx.dim() == 1 and 0 <= P and 0 <= Q and P + Q <= idx.shape[0],
         f"{name}: idx must be int64[P + Q + nbd]")
    nbd = idx.shape[0] - P - Q
    if nbd:
        need(block_depths is not None and len(block_depths) == n,
             f"{name}: blocks without each shard's block depths")
        for t in block_depths:
            _dtype(name, t, torch.int32, "block_depths")
        ts += list(block_depths)
    args = (shards, offs, before, idx, P, Q, L, block_depths)
    if not _on_card(name, ts):
        return caller_fetch_slice_plain(*args)
    need(n <= FETCH_MAX_SHARDS and max(ends[s] - offs[s] for s in range(n))
         < 1 << 31, f"{name}: the kernel takes at most {FETCH_MAX_SHARDS} "
                    f"shards of Pl < 2^31")
    return _fetch_slice_kernel(*args)


def nor_blocks_slice_plain(cov, valid: int, emitted, brk_sorted, nseg: int,
                           off: int) -> torch.Tensor:
    """Plain version of nor_blocks_slice on any device."""
    dev = cov.device
    pos = torch.arange(cov.shape[0], dtype=torch.int64, device=dev)
    em_mask = torch.zeros(cov.shape[0], dtype=torch.bool, device=dev)
    em_mask[torch.clamp(emitted - off, 0, valid - 1)] = True
    normal = (pos < valid) & (cov > 0) & ~em_mask
    key = torch.searchsorted(brk_sorted, pos + off, right=True)
    seg = torch.where(normal, torch.clamp(key, max=nseg - 1), nseg - 1)

    def seg_min(vals):
        out = torch.full((nseg,), INT32_MAX, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, seg, torch.where(
            normal, vals.to(torch.int32), INT32_MAX), "amin")

    first = seg_min(pos)
    mincov = seg_min(cov)
    covf = cov[torch.clamp(first, 0, valid - 1).to(torch.int64)]
    return torch.cat([first, mincov, covf])


def _nor_slice_kernel(cov, valid: int, emitted, brk_sorted, nseg: int,
                      off: int) -> torch.Tensor:
    """nor_blocks_slice_kernel: one launch."""
    out = torch.empty(3 * nseg, dtype=torch.int32, device=cov.device)
    _launch("nor_blocks_slice", cov.device, cov.data_ptr(), int(valid),
            emitted.data_ptr(), emitted.shape[0], brk_sorted.data_ptr(),
            brk_sorted.shape[0], nseg, int(off), out.data_ptr(),
            *_nor_words(cov.device, nseg))
    return out


def nor_blocks_slice(cov, valid: int, emitted, brk_sorted, nseg: int,
                     off: int) -> torch.Tensor:
    """The gVCF NOR blocks over one shard of the genome-sharded planes:
    cov int32[Pl] the shard's coverage, whose local position p is the
    genome's off + p and is normal when p < valid (1 <= valid <= Pl: the
    shard's positions below L), covered and not among emitted (int64, the
    shard's own excluded positions, global, sorted, each in [off, off +
    valid)); its key is the number of breaks (brk_sorted int64, global,
    sorted) at or before off + p, its segment min(key, nseg - 1). ->
    int32[3 * nseg]: each segment's first normal local position and least
    coverage (INT32_MAX for a segment with none here) and the coverage at
    its first local position clamped to [0, valid). Counted as
    nor_blocks_slice."""
    name = "nor_blocks_slice"
    need(cov.dim() == 1 and 1 <= valid <= cov.shape[0] and nseg >= 1
         and off >= 0, f"{name}: cov must be [Pl], 1 <= valid <= Pl, "
                       f"nseg >= 1 and off >= 0")
    _dtype(name, cov, torch.int32, "cov")
    for what, t in (("emitted", emitted), ("brk_sorted", brk_sorted)):
        _dtype(name, t, torch.int64, what)
        need(t.dim() == 1, f"{name}: {what} must be 1-D")
    if not _on_card(name, [cov, emitted, brk_sorted]):
        return nor_blocks_slice_plain(cov, valid, emitted, brk_sorted, nseg,
                                      off)
    need(cov.shape[0] < INT32_MAX and nseg <= 1 << 29,
         f"{name}: the kernel takes Pl < 2^31 - 1 and nseg <= 2^29")
    return _nor_slice_kernel(cov, valid, emitted, brk_sorted, nseg, off)
