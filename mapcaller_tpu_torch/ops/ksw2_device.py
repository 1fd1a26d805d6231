"""Batched ksw2 gapped DP on the card: the CUDA kernel `csrc/ksw2.cu`
and its plain PyTorch version.

Device form of the `-alg ksw2` aligner (ref: src/ksw2_alignment.cpp:
70-248 ksw_extz2_sse; host oracle in ops/ksw2_host.py). The SSE
kernel's anti-diagonal difference DP is elementwise within a diagonal:
the state u, v, x, y is int8 and wraps like the 16-lane SSE code, each
diagonal r updates the columns of its 16-aligned window [st, en], and
the signed/unsigned max/min mix of the original is reproduced on the
int8 bit patterns. The reversed query is right-aligned in a width-M
buffer (qbuf[M-qlen+k] = query[qlen-1-k]), so the query base of column t
on diagonal r is qbuf[M-1-r+t] for every pair. Direction flags per
(diagonal, column) feed ksw_backtrack (ksw2_alignment.cpp:25-68), whose
ops come back as 2-bit codes (0=M, 1=D, 2=I, 3=past the start) packed 16
per 32-bit word, little end first.

`ksw2_ops` is the one entry point on tensors. On a CUDA tensor it
launches the hand-written kernel (fill and backtrack in one launch, the
direction flags in shared memory, nothing allocated but the words; its
launch geometry from `ksw2_geometry`) or raises; on a CPU tensor it runs
`ksw2_ops_plain`, the same function in PyTorch tensor ops: one vectorised
step per diagonal, then one per backtrack step.
"""
from __future__ import annotations

import collections
import ctypes as C
import functools
from typing import List, Tuple

import numpy as np
import torch

from .nw_device import _encode_side, _pack_ops

_Q = 2
_E = 1
_QE = _Q + _E
_QE2 = 2 * _QE
_MAX_SC = 1 + _QE2
_WILD = 4
# limits of csrc/ksw2.cu: lanes a pair, columns a lane holds (NC <=
# KERNEL_GROUP * KERNEL_MAX_CHUNK), threads a block and dynamic shared
# memory a block (the 48 KB a block gets without opting in)
KERNEL_GROUP = 32
KERNEL_MAX_CHUNK = 8
KERNEL_MAX_THREADS = 128
KERNEL_MAX_SMEM = 49152


class KernelStats:
    """Launch accounting for the ksw2 kernel: `launches` counts kernel
    launches (one per `ksw2_ops` call on a CUDA tensor), `pairs` the
    pairs they aligned and `shapes` the (B, M, N) of each launch. The
    plain version counts nothing."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.pairs = 0
        self.shapes = collections.Counter()


STATS = KernelStats()
_lib = None


def _load_kernel():
    global _lib
    if _lib is None:
        from ..toolchain import ensure_cuda
        lib = C.CDLL(ensure_cuda("ksw2"))
        lib.mc_ksw2_ops.restype = C.c_int
        lib.mc_ksw2_ops.argtypes = ([C.c_void_p] * 4 + [C.c_int] * 7
                                    + [C.c_void_p] * 2)
        lib.mc_ksw2_resident.restype = C.c_int
        lib.mc_ksw2_resident.argtypes = [C.c_int] * 3 + [C.c_void_p]
        _lib = lib
    return _lib


def _bounds(qlen: int, tlen: int, r: int) -> Tuple[int, int, int, int]:
    """Per-diagonal window (ref: ksw2_alignment.cpp:140-158).
    Returns (st0, en0, st, en): logical and 16-aligned bounds."""
    w = max(qlen, tlen)
    st, en = 0, tlen - 1
    st = max(st, r - qlen + 1, (r - w + 1) >> 1)
    en = min(en, r, (r + w) >> 1)
    st0, en0 = st, en
    return st0, en0, st // 16 * 16, (en + 16) // 16 * 16 - 1


def ksw2_pair_cells(M: int, N: int) -> int:
    """Window cells of all the diagonals of the pair (M, N), the most of
    any pair of the tier: the flag cells of one pair."""
    return sum(b[3] - b[2] + 1 for b in (_bounds(M, N, r)
                                         for r in range(M + N - 1)))


def ksw2_pair_bytes(M: int, N: int) -> int:
    """Shared memory of one pair in csrc/ksw2.cu, each part 16-aligned: the
    staged query, the flag rows (window-relative, back to back, a nibble
    a cell) and their offset table of a uint16 a diagonal."""
    up16 = lambda n: (n + 15) // 16 * 16  # noqa: E731
    return (up16(M) + up16(ksw2_pair_cells(M, N) // 2)
            + up16(2 * (M + N - 1)))


@functools.lru_cache(maxsize=None)
def ksw2_geometry(M: int, N: int) -> Tuple[int, int, int]:
    """Launch geometry of csrc/ksw2.cu for an M x N tier: (chunk = columns
    a lane, pairs a block, dynamic shared memory bytes). Lane l of a pair's
    KERNEL_GROUP lanes owns the columns k * KERNEL_GROUP + l of the N + 16
    wide state. A block holds up to KERNEL_MAX_THREADS threads, fewer
    where the pairs' shared memory would pass KERNEL_MAX_SMEM (at tier
    192, two pairs). Raises ValueError for what the kernel cannot take."""
    NC = N + 16
    if M < 1 or N < 16 or N % 16:
        raise ValueError(f"ksw2_ops: {M}x{N} is not a tier the kernel "
                         f"takes")
    chunk = -(-NC // KERNEL_GROUP)
    if chunk > KERNEL_MAX_CHUNK:
        raise ValueError(f"ksw2_ops: N={N} outside the kernel's limits "
                         f"(N + 16 <= {KERNEL_GROUP * KERNEL_MAX_CHUNK})")
    per_pair = ksw2_pair_bytes(M, N)
    pairs = KERNEL_MAX_THREADS // KERNEL_GROUP
    while pairs > 1 and pairs * per_pair > KERNEL_MAX_SMEM:
        pairs -= 1
    smem = pairs * per_pair
    if smem > KERNEL_MAX_SMEM:
        raise ValueError(f"ksw2_ops: {M}x{N} needs {smem} B of shared "
                         f"memory a block (at most {KERNEL_MAX_SMEM})")
    return chunk, pairs, smem


def _backtrack_abs(p: np.ndarray, qlen: int, tlen: int) -> str:
    """ksw_backtrack over absolute-column flags (ref: cpp:25-68)."""
    i, j = tlen - 1, qlen - 1
    state = 0
    cigar = []
    while i >= 0 and j >= 0:
        r = i + j
        st0, en0, st, en = _bounds(qlen, tlen, r)
        force_state = -1
        if i < st:
            force_state = 2
        if i > en:
            force_state = 1
        tmp = int(p[r, i]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            cigar.append("M")
            i -= 1
            j -= 1
        elif state in (1, 3):
            cigar.append("D")
            i -= 1
        else:
            cigar.append("I")
            j -= 1
    if i >= 0:
        cigar.append("D" * (i + 1))
    if j >= 0:
        cigar.append("I" * (j + 1))
    return "".join(cigar)


def _i8(x: torch.Tensor) -> torch.Tensor:
    """Wrap int32 values to int8 (two's complement), held as int32."""
    return ((x + 128) & 255) - 128


def _window(r, qlen, tlen):
    """(st0, en0, st, en) of diagonal r per pair (int64[B] each), as
    _bounds."""
    w = torch.maximum(qlen, tlen)
    st0 = torch.clamp(torch.maximum(r - qlen + 1, (r - w + 1) >> 1), min=0)
    en0 = torch.minimum(torch.clamp(tlen - 1, max=r), (r + w) >> 1)
    return st0, en0, st0 // 16 * 16, (en0 + 16) // 16 * 16 - 1


def ksw2_flags_plain(qbuf: torch.Tensor, target: torch.Tensor,
                     qlen: torch.Tensor, tlen: torch.Tensor) -> torch.Tensor:
    """The DP fill: direction flags uint8[B, M+N-1, NC] of every pair,
    N = NC - 16 (build_ksw2_kernel of the reference package); zeros
    outside each diagonal's window."""
    B, M = qbuf.shape
    NC = target.shape[1]
    N = NC - 16
    dev = qbuf.device
    i32 = torch.int32
    idx = torch.arange(NC, dtype=torch.int64, device=dev)[None, :]
    ql = qlen.to(torch.int64)[:, None]
    tl = tlen.to(torch.int64)[:, None]
    tgt = target.to(i32)
    q = qbuf.to(i32)
    u = torch.zeros((B, NC), dtype=i32, device=dev)
    v, x, y, s8 = (torch.zeros_like(u) for _ in range(4))
    last_st = torch.full((B, 1), -1, dtype=torch.int64, device=dev)
    last_en = last_st.clone()
    flags = torch.zeros((B, M + N - 1, NC), dtype=torch.uint8, device=dev)
    for r in range(M + N - 1):
        st0, en0, st, en = _window(r, ql, tl)
        # x1/v1 at column st: the previous diagonal's column st-1 if it
        # lay inside the previous window (ref: cpp:159-165)
        xs = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        vs = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)
        inside = (last_st <= st - 1) & (st - 1 <= last_en) & (st > 0)
        at_st = idx == st
        xt1 = torch.where(at_st, torch.where(inside, xs, 0), xs)
        vt1 = torch.where(at_st, torch.where(
            inside, vs, torch.where(st > 0, 0, _Q if r > 0 else 0)), vs)
        # if en >= r: y[r] = 0; u[r] = r ? Q : 0  (ref: cpp:163-165)
        set_r = (en >= r) & (idx == r)
        y = torch.where(set_r, 0, y)
        u = torch.where(set_r, _Q if r > 0 else 0, u)
        # scores over st0-aligned 16-blocks (ref: cpp:167-176); s8
        # persists, so cells in [st, st0) read stale scores as in C
        stq = q[:, torch.clamp(M - 1 - r + idx[0], 0, M - 1)]
        blk_end = st0 + ((en0 - st0) // 16 + 1) * 16
        blk = (idx >= st0) & (idx < blk_end) & (st0 <= en0)
        sval = torch.where((tgt == _WILD) | (stq == _WILD), 0,
                           torch.where(tgt == stq, 1, -1))
        s8 = torch.where(blk, sval, s8)
        # core recurrence over [st, en] (ref: cpp:184-199)
        z = _i8(s8 + _QE2)
        a = _i8(xt1 + vt1)
        b = _i8(y + u)
        d = (a > z).to(i32)
        z = torch.maximum(z, a)
        d = torch.where(b > z, 2, d)
        # max on the uint8 patterns, capped: always 0..MAX_SC
        z = torch.clamp(torch.maximum(z & 255, b & 255), max=_MAX_SC)
        u_new = _i8(z - vt1)
        v_new = _i8(z - u)
        z = _i8(z - _Q)
        a = _i8(a - z)
        b = _i8(b - z)
        d = d | torch.where(a > 0, 0x08, 0) | torch.where(b > 0, 0x10, 0)
        m = (idx >= st) & (idx <= en)
        u = torch.where(m, u_new, u)
        v = torch.where(m, v_new, v)
        x = torch.where(m, torch.clamp(a, min=0), x)
        y = torch.where(m, torch.clamp(b, min=0), y)
        flags[:, r] = torch.where(m, d, 0).to(torch.uint8)
        last_st, last_en = st, en
    return flags


def ksw2_backtrack_plain(flags: torch.Tensor, qlen: torch.Tensor,
                         tlen: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """ksw_backtrack on every pair (build_ksw2_traceback of the reference
    package) -> 2-bit ops packed int32[B, ceil16(M+N)/16]."""
    B, ND, NC = flags.shape
    dev = flags.device
    flat = flags.reshape(B, -1).to(torch.int64)
    ql = qlen.to(torch.int64)
    tl = tlen.to(torch.int64)
    i, j = tl - 1, ql - 1
    state = torch.zeros_like(ql)
    steps = (M + N + 15) // 16 * 16
    ops = torch.empty((B, steps), dtype=torch.int64, device=dev)
    for k in range(steps):
        in_main = (i >= 0) & (j >= 0)
        active = (i >= 0) | (j >= 0)
        r = i + j
        _, _, st, en = _window(r, ql, tl)
        force = torch.where(i < st, 2, torch.where(i > en, 1, -1))
        at = torch.clamp(r * NC + i, 0, ND * NC - 1)
        tmp = torch.where(force < 0, flat.gather(1, at[:, None])[:, 0], 0)
        s = torch.where(state == 0, tmp & 7, torch.where(
            ((tmp >> (state + 2)) & 1) == 0, 0, state))
        s = torch.where(s == 0, tmp & 7, s)
        s = torch.where(force >= 0, force, s)
        # outside the main rectangle: drain the remaining D's / I's
        s = torch.where(in_main, s, torch.where(i >= 0, 1, 2))
        op = torch.where(~active, 3, torch.where(
            s == 0, 0, torch.where((s == 1) | (s == 3), 1, 2)))
        i = torch.where(active & (op <= 1), i - 1, i)
        j = torch.where(active & ((op == 0) | (op == 2)), j - 1, j)
        state = torch.where(in_main, s, state)
        ops[:, k] = op
    return _pack_ops(ops)


def ksw2_ops_plain(qbuf: torch.Tensor, target: torch.Tensor,
                   qlen: torch.Tensor, tlen: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same inputs and output as
    `ksw2_ops`. Holds the full flag tensor [B, M+N-1, NC]."""
    M = qbuf.shape[1]
    N = target.shape[1] - 16
    return ksw2_backtrack_plain(ksw2_flags_plain(qbuf, target, qlen, tlen),
                                qlen, tlen, M, N)


def ksw2_resident_pairs(chunk: int, pairs: int, smem: int) -> int:
    """Pairs that one SM of the current card holds at once at a launch
    geometry (ksw2_geometry's tuple): blocks resident x pairs a block. A
    launch of more than this times the SM count runs in waves."""
    blocks = C.c_int(0)
    err = _load_kernel().mc_ksw2_resident(chunk, pairs, smem,
                                          C.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ksw2_resident_pairs: CUDA error {err}")
    return blocks.value * pairs


def _check(qbuf, target, qlen, tlen) -> None:
    if qbuf.dim() != 2 or target.dim() != 2 or qlen.dim() != 1 \
            or tlen.dim() != 1:
        raise ValueError("ksw2_ops: qbuf/target must be 2-D, qlen/tlen 1-D")
    B = qbuf.shape[0]
    if target.shape[0] != B or qlen.shape[0] != B or tlen.shape[0] != B:
        raise ValueError("ksw2_ops: batch sizes differ")
    if qbuf.dtype != torch.uint8 or target.dtype != torch.uint8:
        raise TypeError("ksw2_ops: qbuf/target must be uint8 codes")
    if qlen.dtype != torch.int32 or tlen.dtype != torch.int32:
        raise TypeError("ksw2_ops: qlen/tlen must be int32 lengths")
    devs = {qbuf.device, target.device, qlen.device, tlen.device}
    if len(devs) != 1:
        raise ValueError(f"ksw2_ops: tensors on several devices {devs}")
    NC = target.shape[1]
    if NC % 16 or NC < 32 or qbuf.shape[1] < 1:
        raise ValueError("ksw2_ops: target width NC must be a multiple of "
                         "16 (N + 16 for a tier N) and M >= 1")


def ksw2_ops(qbuf: torch.Tensor, target: torch.Tensor, qlen: torch.Tensor,
             tlen: torch.Tensor) -> torch.Tensor:
    """Batched ksw2 extz2 DP with backtrack.
    qbuf uint8[B, M] reversed queries right-aligned, target uint8[B, NC]
    (NC = N + 16 for a tier N, a multiple of 16), codes with 4 = N
    (scores 0) and pad 0; qlen, tlen int32[B] lengths (1 <= qlen <= M,
    1 <= tlen <= N). Returns words int32[B, ceil16(M+N)/16], the uint32
    bit patterns of the packed ops.

    A CUDA tensor launches csrc/ksw2.cu on the current stream; a CPU
    tensor runs the plain version. There is no fallback between the
    two."""
    _check(qbuf, target, qlen, tlen)
    if qbuf.device.type == "cpu":
        return ksw2_ops_plain(qbuf, target, qlen, tlen)
    if qbuf.device.type != "cuda":
        raise ValueError(f"ksw2_ops: unsupported device {qbuf.device}")
    B, M = qbuf.shape
    NC = target.shape[1]
    N = NC - 16
    chunk, pairs, smem = ksw2_geometry(M, N)
    dev = qbuf.device
    qbuf = qbuf.contiguous()
    target = target.contiguous()
    qlen = qlen.contiguous()
    tlen = tlen.contiguous()
    words = torch.empty((B, (M + N + 15) // 16), dtype=torch.int32, device=dev)
    if B == 0:
        return words
    lib = _load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mc_ksw2_ops(qbuf.data_ptr(), target.data_ptr(),
                          qlen.data_ptr(), tlen.data_ptr(), B, M, N, NC,
                          chunk, pairs, smem, words.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ksw2_ops: CUDA kernel launch failed (error "
                           f"{err})")
    STATS.launches += 1
    STATS.pairs += B
    STATS.shapes[(B, M, N)] += 1
    return words


def _replay_ops(s1: str, s2: str, words: np.ndarray) -> Tuple[str, str]:
    """Host reconstruction of the '-'-padded strings from packed ops
    (walked from the end of both sequences)."""
    i, j = len(s2) - 1, len(s1) - 1
    cigar = []
    k = 0
    while i >= 0 or j >= 0:
        d = (int(words[k >> 4]) >> ((k & 15) * 2)) & 3
        cigar.append("MDI"[d])
        if d == 0:
            i -= 1
            j -= 1
        elif d == 1:
            i -= 1
        else:
            j -= 1
        k += 1
    a1 = list(s1)
    a2 = list(s2)
    for pos, ch in enumerate(reversed(cigar)):
        if ch == "D":
            a1.insert(pos, "-")
        elif ch == "I":
            a2.insert(pos, "-")
    return "".join(a1), "".join(a2)


def ksw2_align_batch(pairs: List[Tuple[str, str]], M: int = 192,
                     N: int = 192, return_ops: bool = False, device="cuda"):
    """Align (s1=query, s2=target) pairs on `device` and return
    '-'-padded strings bit-identical to ops/ksw2_host.ksw2_alignment (or,
    with return_ops, the packed op words uint32[len, ceil16(M+N)/16]).
    N must be a multiple of 16 (the DP tiers are)."""
    if N % 16:
        raise ValueError(f"ksw2_align_batch: N={N} is not a multiple of 16")
    if not all(0 < len(s1) <= M and 0 < len(s2) <= N for s1, s2 in pairs):
        raise ValueError(f"ksw2_align_batch: a pair is empty or exceeds the "
                         f"{M}x{N} tier")
    B = len(pairs)
    qbuf, ql = _encode_side([a for a, _ in pairs], M, B, reverse=True, pad=0)
    tgt, tl = _encode_side([b for _, b in pairs], N + 16, B, pad=0)
    dev = torch.device(device)
    words = ksw2_ops(*(torch.from_numpy(a).to(dev) for a in (qbuf, tgt, ql,
                                                              tl)))
    words = words.cpu().numpy().view(np.uint32)
    if return_ops:
        return words
    return [_replay_ops(s1, s2, words[k]) for k, (s1, s2) in enumerate(pairs)]
