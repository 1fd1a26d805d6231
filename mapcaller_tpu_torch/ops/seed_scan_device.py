"""The greedy-MEM seed scans on the card: the CUDA kernels
`csrc/seed_scan.cu` and their plain PyTorch versions.

Device form of the seeding hot loop (ref: src/bwt_search.cpp:121-164,
BWT_Search). Three entry points on tensors:

  seed_scan3  the occ3 scan (ops/fm3_device.DeviceFM3) with the fused
              prefix skip, one thread per read, or with 0 < lanes < B
              `lanes` threads that take reads from a queue (the compacted
              scan's contract);
  seed_scan3_routed  the occ3 scan over a genome-sharded table (`-shards
              N`, parallel/sharded_index.ShardedFM3), each row read from
              its shard; a lane group per read (the lanes share each
              step's row loads and sums), no prefix skip;
  seed_scan3_big  the same over the x64 big-genome table (big_x64 under
              `-shards N`, parallel/big_index.BigShardedFM3): rows of
              counts relative to their shard plus its int64 base counts,
              int64 interval state and row indices, a lane group per
              read;
  seed_scan1  the 1-step scan over the occ4 rows (ops/fm_device.
              DeviceFMIndex), on 2-bit packed codes or, with has_n, on
              byte codes whose N ends an extension.

Each returns the plain scans' tuple (n_seeds, s_rpos, s_len, s_x0,
s_freq, overflow), int64 and bool as they are, and with_iters also each
read's step count and the index rows it gathered. On a CUDA tensor a
call is one launch on the current stream, with no host sync, or it
raises; on a CPU tensor it runs the plain version (seed_scan3_plain,
seed_scan3_routed_plain, seed_scan3_big_plain, seed_scan1_plain:
`fm_search._seed_scan3`,
`_seed_scan3_compact` or `_seed_scan`). There is no fallback between the
two.
"""
from __future__ import annotations

import ctypes as C

import torch

from .device_util import KernelStats, need


STATS = KernelStats()
_lib = None


def _load_kernel():
    global _lib
    if _lib is None:
        from ..toolchain import ensure_cuda
        lib = C.CDLL(ensure_cuda("seed_scan"))
        lib.mc_seed_scan3.restype = C.c_int
        lib.mc_seed_scan3.argtypes = ([C.c_void_p] * 5 + [C.c_int] * 15
                                      + [C.c_void_p] * 7)
        lib.mc_seed_scan3_routed.restype = C.c_int
        lib.mc_seed_scan3_routed.argtypes = ([C.c_void_p, C.c_int]
                                             + [C.c_void_p] * 4
                                             + [C.c_int] * 12
                                             + [C.c_void_p] * 6)
        lib.mc_seed_scan3_big.restype = C.c_int
        lib.mc_seed_scan3_big.argtypes = ([C.c_void_p, C.c_longlong]
                                          + [C.c_void_p] * 5
                                          + [C.c_int] * 4
                                          + [C.c_longlong] * 3
                                          + [C.c_int] * 5
                                          + [C.c_void_p] * 6)
        lib.mc_enable_peer_access.restype = C.c_int
        lib.mc_enable_peer_access.argtypes = [C.c_int, C.c_int]
        lib.mc_seed_scan1.restype = C.c_int
        lib.mc_seed_scan1.argtypes = ([C.c_void_p] * 4 + [C.c_int] * 6
                                      + [C.c_void_p] * 6)
        _lib = lib
    return _lib


def _check(name, table, row_width, codes, width, rlens, max_len, max_seeds):
    """Device, dtype, shape, contiguity and alignment of a scan's inputs;
    table None (a routed scan, whose shards are checked on the card)
    checks the reads only."""
    need(max_len >= 16 and max_len % 16 == 0,
          f"{name}: max_len {max_len} must be a multiple of 16")
    need(max_seeds >= 1, f"{name}: max_seeds must be >= 1")
    need(codes.dtype == torch.uint8 and rlens.dtype == torch.int32,
          f"{name}: codes uint8 and rlens int32 expected", TypeError)
    need(codes.dim() == 2 and codes.shape[1] == width and rlens.dim() == 1
          and rlens.shape[0] == codes.shape[0],
          f"{name}: codes must be uint8[B, {width}] and rlens int32[B]")
    ts = (codes, rlens) if table is None else (table, codes, rlens)
    devs = {t.device for t in ts}
    need(len(devs) == 1, f"{name}: tensors on several devices {devs}")
    need(all(t.is_contiguous() for t in ts),
          f"{name}: inputs must be contiguous")
    # the kernel reads reads as 32-bit words
    need(codes.data_ptr() % 4 == 0, f"{name}: codes must be 4-byte aligned")
    if table is None:
        return
    need(table.dtype == torch.int32, f"{name}: rows int32 expected",
          TypeError)
    need(table.dim() == 2 and table.shape[1] == row_width,
          f"{name}: table rows must be int32[n, {row_width}]")
    # the kernel loads rows as 16-byte vectors
    need(table.data_ptr() % 16 == 0, f"{name}: rows must be 16-byte "
                                      f"aligned")


def _outputs(B: int, S: int, dev):
    """Kernel outputs; every element is written by the kernel."""
    n_seeds = torch.empty(B, dtype=torch.int64, device=dev)
    tab = torch.empty((4, B, S), dtype=torch.int64, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    counts = torch.empty((2, B), dtype=torch.int32, device=dev)
    return n_seeds, tab, overflow, counts


def _result(n_seeds, tab, overflow, counts, with_iters):
    """counts: each read's steps and row gathers."""
    out = (n_seeds, tab[0], tab[1], tab[2], tab[3], overflow)
    return out + tuple(counts.to(torch.int64)) if with_iters else out


def _launch(name: str, entry: str, dev, B: int, S: int, with_iters: bool,
            *args):
    """One scan launch on dev's current stream: the outputs allocated, the
    C entry called with args, then the outputs' pointers and the stream,
    and counted as name; raises if CUDA refused it. B == 0 launches
    nothing."""
    n_seeds, tab, overflow, counts = _outputs(B, S, dev)
    if B:
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = getattr(_load_kernel(), entry)(
                *args, n_seeds.data_ptr(), tab.data_ptr(),
                overflow.data_ptr(), counts[0].data_ptr(),
                counts[1].data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA kernel launch failed (error "
                               f"{err})")
        STATS.launches[name] += 1
    return _result(n_seeds, tab, overflow, counts, with_iters)


def seed_scan3_plain(fm3, packed, rlens, max_len: int, max_seeds: int,
                     lanes: int = 0, with_iters: bool = False):
    """Plain PyTorch version of seed_scan3 on any device: the lockstep
    scan, or with 0 < lanes < B the compacted one (which counts no steps,
    so with_iters refuses it)."""
    from . import fm_search as fs
    B = packed.shape[0]
    words = fs._read_words_le(packed)
    if 0 < lanes < B:
        need(not with_iters, "seed_scan3: the compacted plain scan counts "
                              "no steps")
        return fs._seed_scan3_compact(fm3, words, rlens, B, lanes, max_len,
                                      max_seeds)
    return fs._seed_scan3(
        fm3, lambda p: fs._word_codes(words, p), rlens, B, max_len,
        max_seeds, key_fn=(lambda p: fs._word_key(words, p, fm3.pfx_k))
        if fm3.pfx_k else None, with_iters=with_iters)


def seed_scan3_routed_plain(sfm3, packed, rlens, max_len: int,
                            max_seeds: int, with_iters: bool = False):
    """Plain version of seed_scan3_routed on any device: the lockstep
    scan with every row gathered from its shard (parallel/sharded_index.
    routed_gather3)."""
    from ..parallel.sharded_index import routed_gather3
    from . import fm_search as fs
    words = fs._read_words_le(packed)
    return fs._seed_scan3(
        sfm3, lambda p: fs._word_codes(words, p), rlens, packed.shape[0],
        max_len, max_seeds, with_iters=with_iters, gather_fn=routed_gather3)


def seed_scan3_big_plain(bfm, packed, rlens, max_len: int, max_seeds: int,
                         with_iters: bool = False):
    """Plain version of seed_scan3_big on any device: the lockstep scan in
    int64 with every row gathered from its shard and its shard's base
    counts added (parallel/big_index.big_routed_gather3)."""
    from ..parallel.big_index import big_routed_gather3
    from . import fm_search as fs
    words = fs._read_words_le(packed)
    return fs._seed_scan3(
        bfm, lambda p: fs._word_codes(words, p), rlens, packed.shape[0],
        max_len, max_seeds, with_iters=with_iters,
        gather_fn=big_routed_gather3)


def seed_scan1_plain(fm, codes, rlens, max_len: int, max_seeds: int,
                     has_n: bool, with_iters: bool = False):
    """Plain PyTorch version of seed_scan1 on any device."""
    from . import fm_search as fs
    if has_n:
        bidx = torch.arange(codes.shape[0], dtype=torch.int64,
                            device=codes.device)

        def codes_fn(pos):
            return codes[bidx, pos].to(torch.int64)
    else:
        words = fs._read_words_le(codes)

        def codes_fn(pos):
            return fs._word_codes(words, pos)
    return fs._seed_scan(fm, codes_fn, rlens, codes.shape[0], max_len,
                         max_seeds, has_n, with_iters=with_iters)


def seed_scan3(fm3, packed: torch.Tensor, rlens: torch.Tensor, max_len: int,
               max_seeds: int, lanes: int = 0, with_iters: bool = False):
    """The occ3 scan of a batch of 2-bit reads: packed uint8[B, max_len/4]
    (base q of a byte at bits 2q), rlens int32[B]. lanes in (0, B):
    `lanes` threads stream through the reads. Returns the plain scans'
    tuple, plus each read's steps and row gathers with_iters. A CPU
    tensor runs seed_scan3_plain."""
    from .fm_search import scan3_cap
    B = packed.shape[0]
    _check("seed_scan3", fm3.occ3_rows, 72, packed, max_len // 4, rlens,
           max_len, max_seeds)
    compact = 0 < lanes < B
    if packed.device.type == "cpu":
        return seed_scan3_plain(fm3, packed, rlens, max_len, max_seeds,
                                lanes, with_iters)
    need(packed.device.type == "cuda",
          f"seed_scan3: unsupported device {packed.device}")
    fm = fm3.fm
    need(fm3.c3_first.dtype == torch.int32 and fm.L2.dtype == torch.int64
          and fm3.c3_first.device == packed.device
          and fm.L2.device == packed.device,
          "seed_scan3: c3_first int32 and L2 int64 on the batch's device")
    dev = packed.device
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)
    return _launch("seed_scan3", "mc_seed_scan3", dev, B, max_seeds,
                   with_iters,
                   fm3.occ3_rows.data_ptr(), fm3.c3_first.data_ptr(),
                   fm.L2.data_ptr(), packed.data_ptr(), rlens.data_ptr(), B,
                   lanes if compact else 0, max_len, max_seeds,
                   scan3_cap(max_len, max_seeds), int(fm.primary),
                   int(fm3.row_p1), int(fm3.row_p2), int(fm3.t0), int(fm3.t1),
                   int(fm3.tail1), int(fm3.tail2a), int(fm3.tail2b),
                   int(fm3.pfx_base), int(fm3.pfx_k), nxt.data_ptr())


def seed_scan3_routed(sfm3, packed: torch.Tensor, rlens: torch.Tensor,
                      max_len: int, max_seeds: int, with_iters: bool = False):
    """The occ3 scan over a genome-sharded table (parallel/sharded_index.
    ShardedFM3, whose occ3 is an ops/routed.Routed table): a lane group
    per read, each row read from its shard through the shards' base
    addresses; no fused prefix skip and no lanes mode. Inputs and outputs
    as seed_scan3. A CPU tensor runs seed_scan3_routed_plain. Counted as
    seed_scan3_routed."""
    from .fm_search import scan3_cap
    name = "seed_scan3_routed"
    B = packed.shape[0]
    _check(name, None, 72, packed, max_len // 4, rlens, max_len, max_seeds)
    need(sfm3.pfx_base == 0, f"{name}: the routed scan has no prefix skip")
    if packed.device.type == "cpu":
        need(all(sh.device.type == "cpu" for sh in sfm3.occ3.shards),
              f"{name}: CPU reads and shards on a card")
        return seed_scan3_routed_plain(sfm3, packed, rlens, max_len,
                                       max_seeds, with_iters)
    need(packed.device.type == "cuda",
          f"{name}: unsupported device {packed.device}")
    dev = packed.device
    sfm3.occ3.check_card(name, dev, torch.int32, 72, align=16)
    need(sfm3.c3_first.dtype == torch.int32 and sfm3.L2.dtype == torch.int64
          and sfm3.c3_first.device == dev and sfm3.L2.device == dev,
          f"{name}: c3_first int32 and L2 int64 on the batch's device")
    return _launch(name, "mc_seed_scan3_routed", dev, B, max_seeds,
                   with_iters, sfm3.occ3.pointers(dev).data_ptr(),
                   sfm3.occ3.per, sfm3.c3_first.data_ptr(),
                   sfm3.L2.data_ptr(), packed.data_ptr(), rlens.data_ptr(),
                   B, max_len, max_seeds, scan3_cap(max_len, max_seeds),
                   int(sfm3.primary), int(sfm3.row_p1), int(sfm3.row_p2),
                   int(sfm3.t0), int(sfm3.t1), int(sfm3.tail1),
                   int(sfm3.tail2a), int(sfm3.tail2b))


def seed_scan3_big(bfm, packed: torch.Tensor, rlens: torch.Tensor,
                   max_len: int, max_seeds: int, with_iters: bool = False):
    """The occ3 scan over the x64 big-genome table (parallel/big_index.
    BigShardedFM3: bfm.occ3 a Routed table of int32 rows relative to their
    shard; bfm.base3x the shards' base tables (parallel/big_index.
    base_table of the base counts base3), c3_first and L2, int64 on the
    batch's device; the row constants Python ints, which may pass 2^31):
    a lane group per read with int64 interval state, each row read from
    its shard and its shard's base added; no prefix skip. Inputs and outputs
    as seed_scan3. A CPU tensor runs seed_scan3_big_plain (over base3).
    Counted as seed_scan3_big."""
    from ..parallel.big_index import B3X
    from .fm_search import scan3_cap
    name = "seed_scan3_big"
    B = packed.shape[0]
    _check(name, None, 72, packed, max_len // 4, rlens, max_len, max_seeds)
    if packed.device.type == "cpu":
        need(all(sh.device.type == "cpu" for sh in bfm.occ3.shards),
             f"{name}: CPU reads and shards on a card")
        return seed_scan3_big_plain(bfm, packed, rlens, max_len, max_seeds,
                                    with_iters)
    need(packed.device.type == "cuda",
         f"{name}: unsupported device {packed.device}")
    dev = packed.device
    bfm.occ3.check_card(name, dev, torch.int32, 72, align=16)
    need(all(t.dtype == torch.int64 and t.device == dev
             and t.is_contiguous()
             for t in (bfm.base3x, bfm.c3_first, bfm.L2)),
         f"{name}: base3x, c3_first and L2 int64 on the batch's device",
         TypeError)
    need(bfm.base3x.dim() == 2 and bfm.base3x.shape[1] == B3X
         and bfm.base3x.shape[0] >= bfm.occ3.n
         and bfm.base3x.data_ptr() % 16 == 0,
         f"{name}: base3x must be int64[n, {B3X}], 16-byte aligned")
    return _launch(name, "mc_seed_scan3_big", dev, B, max_seeds, with_iters,
                   bfm.occ3.pointers(dev).data_ptr(), bfm.occ3.per,
                   bfm.base3x.data_ptr(), bfm.c3_first.data_ptr(),
                   bfm.L2.data_ptr(), packed.data_ptr(), rlens.data_ptr(), B,
                   max_len, max_seeds, scan3_cap(max_len, max_seeds),
                   int(bfm.primary), int(bfm.row_p1), int(bfm.row_p2),
                   int(bfm.t0), int(bfm.t1), int(bfm.tail1), int(bfm.tail2a),
                   int(bfm.tail2b))


def seed_scan1(fm, codes: torch.Tensor, rlens: torch.Tensor, max_len: int,
               max_seeds: int, has_n: bool, with_iters: bool = False):
    """The 1-step scan: with has_n byte codes uint8[B, max_len] (N = 4
    ends an extension and is skipped as a start), else 2-bit packed
    uint8[B, max_len/4]; rlens int32[B]. Returns the plain scans' tuple,
    plus each read's steps and row gathers with_iters. A CPU tensor runs
    seed_scan1_plain."""
    from .fm_search import scan1_cap
    B = codes.shape[0]
    _check("seed_scan1", fm.occ_rows, 8, codes,
           max_len if has_n else max_len // 4, rlens, max_len, max_seeds)
    if codes.device.type == "cpu":
        return seed_scan1_plain(fm, codes, rlens, max_len, max_seeds, has_n,
                                with_iters)
    need(codes.device.type == "cuda",
          f"seed_scan1: unsupported device {codes.device}")
    need(fm.L2.dtype == torch.int64 and fm.L2.device == codes.device,
          "seed_scan1: L2 int64 on the batch's device")
    dev = codes.device
    return _launch("seed_scan1", "mc_seed_scan1", dev, B, max_seeds,
                   with_iters,
                   fm.occ_rows.data_ptr(), fm.L2.data_ptr(), codes.data_ptr(),
                   rlens.data_ptr(), B, int(has_n), max_len, max_seeds,
                   scan1_cap(max_len, max_seeds), int(fm.primary))
