"""Batched gapped-extension (NW) DP on the card: the CUDA kernel
`csrc/nw.cu` and its plain PyTorch version.

Device form of the reference's default aligner (ref:
src/nw_alignment.cpp:18-83; scoring contract in ops/nw_host.py: x2-scaled
integers, match +2 / mismatch -2, OPEN -2, EXTEND -1, NEW -3), producing
bit-identical traceback decisions: 2-bit ops (0=diag, 1=left/'-' in s1,
2=up/'-' in s2, 3=past the start) packed 16 per 32-bit word, little end
first, plus the x2-scaled score at (m, n).

`nw_ops` is the one entry point on tensors. On a CUDA tensor it launches
the hand-written kernel (a group of lanes per pair sweeping the rows in
the cummax form, direction bits in shared memory, traceback in the same
kernel; launch geometry from `nw_geometry`) or raises; on a CPU tensor
it runs `nw_ops_plain`, the same function in PyTorch tensor ops — the
vectorised row sweep with one cummax per DP row (the collapse of the
coupled horizontal-gap recurrence, see `_row_sweep`) followed by a
vectorised traceback.
"""
from __future__ import annotations

import collections
import ctypes as C
from typing import List, Tuple

import numpy as np
import torch

MAXPEN = -131072
OPENG = -2
EXTG = -1
NEWG = -3
# limits of csrc/nw.cu (MAX_N, MAX_CHUNK, MAX_SMEM and the 256-thread
# launch bound), which refuses a geometry outside them
KERNEL_MAX_N = 256          # longest second side: lanes * chunk >= N
KERNEL_MAX_CHUNK = 8        # columns per lane, 2 direction bits each in a uint16
KERNEL_MAX_SMEM = 232448    # dynamic shared memory a block can use
KERNEL_MAX_THREADS = 256
BLOCK_SMEM_TARGET = 100 * 1024   # two blocks per SM at the largest tiers


class KernelStats:
    """Launch accounting for the NW kernel: `launches` counts kernel
    launches (one per `nw_ops` call on a CUDA tensor), `pairs` the pairs
    they aligned and `shapes` the (B, M, N) of each launch. The plain
    version counts nothing."""

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
        lib = C.CDLL(ensure_cuda("nw"))
        lib.mc_nw_ops.restype = C.c_int
        lib.mc_nw_ops.argtypes = ([C.c_void_p] * 4 + [C.c_int] * 7
                                  + [C.c_void_p] * 3)
        _lib = lib
    return _lib


def _row_sweep(c1_row, c2, t_prev, s_prev, i: int):
    """One DP row, vectorised over the batch.
    c1_row int32[B, 1] codes of s1[i-1]; c2 int32[B, N].
    Returns (t_cur, r_cur, s_cur, dirs) over columns 0..N.

    With E=EXTEND > NEW the coupled row recurrence
        r[j] = max(r[j-1]+E, s[j-1]+NEW),  s[j] = max(diag[j], r[j], t[j])
    collapses (c[j] = max(diag[j], t[j])) to one affine max-plus chain
        r[j] = NEW + (j-1)*E + cummax_{k<j} (c[k] - k*E)."""
    B, N = c2.shape
    dev = c2.device
    j = torch.arange(N + 1, dtype=torch.int32, device=dev)[None, :]
    s_b0 = OPENG + i * EXTG                    # column-0 boundary
    match = torch.where(c1_row == c2, 2, -2).to(torch.int32)
    t_cur = torch.maximum(t_prev + EXTG, s_prev + NEWG)
    t_cur[:, 0] = s_b0
    diag = s_prev[:, :-1] + match
    c = torch.cat([torch.full((B, 1), s_b0, dtype=torch.int32, device=dev),
                   torch.maximum(diag, t_cur[:, 1:])], dim=1)
    cm = torch.cummax(c - j * EXTG, dim=1).values
    r_cur = NEWG + (j - 1) * EXTG + torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=dev), cm[:, :-1]],
        dim=1)
    r_cur[:, 0] = MAXPEN
    s_cur = torch.maximum(r_cur, c)
    s_cur[:, 0] = s_b0
    dirs = torch.where(s_cur == r_cur, 1, torch.where(s_cur == t_cur, 2, 0))
    return t_cur, r_cur, s_cur, dirs.to(torch.int8)


def _pack_ops(ops: torch.Tensor) -> torch.Tensor:
    """int64[B, ND] 2-bit ops -> int32[B, ND/16] words (uint32 bit
    patterns), op k at bits 2*(k%16) of word k//16."""
    B, ND = ops.shape
    sh = 2 * torch.arange(16, dtype=torch.int64, device=ops.device)
    w = (ops.reshape(B, ND // 16, 16) << sh).sum(dim=2)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def nw_ops_plain(c1: torch.Tensor, c2: torch.Tensor, m: torch.Tensor,
                 n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same inputs and outputs as
    `nw_ops`. Holds the full int8 direction matrix [B, M+1, N+1]."""
    B, M = c1.shape
    N = c2.shape[1]
    dev = c1.device
    a = c1.to(torch.int32)
    q = c2.to(torch.int32)
    mi = m.to(torch.int64)
    ni = n.to(torch.int64)
    j = torch.arange(N + 1, dtype=torch.int32, device=dev)[None, :]
    t = torch.where(j == 0, 0, MAXPEN).to(torch.int32).expand(B, N + 1)
    s = torch.where(j == 0, 0, OPENG + j * EXTG).to(torch.int32).expand(
        B, N + 1)
    score = torch.full((B,), MAXPEN, dtype=torch.int32, device=dev)
    dirs = torch.empty((B, M + 1, N + 1), dtype=torch.int8, device=dev)
    dirs[:, 0] = (j > 0).to(torch.int8)        # row 0: every j > 0 is left
    for i in range(1, M + 1):
        t, _r, s, d = _row_sweep(a[:, i - 1:i], q, t, s, i)
        dirs[:, i] = d
        at_n = s.gather(1, ni[:, None])[:, 0]
        score = torch.where(mi == i, at_n, score)
    # traceback from (m, n); finished lanes emit op 3
    ND = M + N
    flat = dirs.reshape(B, -1)
    i_ = mi.clone()
    j_ = ni.clone()
    ops = torch.empty((B, ND), dtype=torch.int64, device=dev)
    for k in range(ND):
        done = (i_ <= 0) & (j_ <= 0)
        d = flat.gather(1, (i_ * (N + 1) + j_)[:, None])[:, 0].to(torch.int64)
        d = torch.where(done, 3, d)
        i_ = torch.where(done | (d == 1), i_, i_ - 1)
        j_ = torch.where(done | (d == 2), j_, j_ - 1)
        ops[:, k] = d
    return _pack_ops(ops), score


def nw_geometry(M: int, N: int) -> Tuple[int, int, int, int]:
    """Launch geometry of csrc/nw.cu for an M x N tier: (lanes per pair,
    chunk = columns 1..N per lane, pairs per block, dynamic shared memory
    bytes). The fewest lanes (8, 16 or 32) that hold N in chunks of at
    most KERNEL_MAX_CHUNK columns: a row's cross-lane scan costs more
    than its cells, so wide chunks and 2 or 4 pairs to a warp at the
    small tiers are faster. Then up to 256 threads a block, fewer where
    the block's direction bits (M rows x threads x 2 B) would pass
    BLOCK_SMEM_TARGET."""
    if N > KERNEL_MAX_N or M < 0 or N < 0:
        raise ValueError(f"nw_ops: N={N} outside the kernel's "
                         f"0..{KERNEL_MAX_N}")
    lanes = 8
    while lanes < 32 and -(-N // lanes) > KERNEL_MAX_CHUNK:
        lanes *= 2
    chunk = max(1, -(-N // lanes))
    threads = KERNEL_MAX_THREADS
    while threads > 32 and M * threads * 2 > BLOCK_SMEM_TARGET:
        threads -= 32
    smem = M * threads * 2
    if smem > KERNEL_MAX_SMEM:
        raise ValueError(f"nw_ops: M={M} needs {smem} B of shared memory")
    return lanes, chunk, threads // lanes, smem


def _check(c1, c2, m, n) -> None:
    if c1.dim() != 2 or c2.dim() != 2 or m.dim() != 1 or n.dim() != 1:
        raise ValueError("nw_ops: c1/c2 must be 2-D, m/n 1-D")
    B = c1.shape[0]
    if c2.shape[0] != B or m.shape[0] != B or n.shape[0] != B:
        raise ValueError("nw_ops: batch sizes differ")
    if c1.dtype != torch.uint8 or c2.dtype != torch.uint8:
        raise TypeError("nw_ops: c1/c2 must be uint8 codes")
    if m.dtype != torch.int32 or n.dtype != torch.int32:
        raise TypeError("nw_ops: m/n must be int32 lengths")
    devs = {c1.device, c2.device, m.device, n.device}
    if len(devs) != 1:
        raise ValueError(f"nw_ops: tensors on several devices {devs}")
    if (c1.shape[1] + c2.shape[1]) % 16:
        raise ValueError("nw_ops: M + N must be a multiple of 16")


def nw_ops(c1: torch.Tensor, c2: torch.Tensor, m: torch.Tensor,
           n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched NW with traceback.
    c1 uint8[B, M], c2 uint8[B, N] codes (pad 4); m, n int32[B] lengths
    (0 <= m <= M, 0 <= n <= N). Returns (words int32[B, (M+N)/16] —
    uint32 bit patterns of the packed ops — and score int32[B]).

    A CUDA tensor launches csrc/nw.cu on the current stream; a CPU tensor
    runs the plain version. There is no fallback between the two."""
    _check(c1, c2, m, n)
    if c1.device.type == "cpu":
        return nw_ops_plain(c1, c2, m, n)
    if c1.device.type != "cuda":
        raise ValueError(f"nw_ops: unsupported device {c1.device}")
    B, M = c1.shape
    N = c2.shape[1]
    lanes, chunk, pairs, smem = nw_geometry(M, N)
    c1 = c1.contiguous()
    c2 = c2.contiguous()
    m = m.contiguous()
    n = n.contiguous()
    words = torch.empty((B, (M + N) // 16), dtype=torch.int32,
                        device=c1.device)
    score = torch.empty(B, dtype=torch.int32, device=c1.device)
    if B == 0:
        return words, score
    lib = _load_kernel()
    stream = torch.cuda.current_stream(c1.device).cuda_stream
    err = lib.mc_nw_ops(c1.data_ptr(), c2.data_ptr(), m.data_ptr(),
                        n.data_ptr(), B, M, N, lanes, chunk, pairs, smem,
                        words.data_ptr(), score.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nw_ops: CUDA kernel launch failed (error {err})")
    STATS.launches += 1
    STATS.pairs += B
    STATS.shapes[(B, M, N)] += 1
    return words, score


def _replay_ops(s1: str, s2: str, words: np.ndarray):
    """Host reconstruction of the '-'-padded strings from packed ops."""
    a1 = list(s1)
    a2 = list(s2)
    i, j = len(s1), len(s2)
    k = 0
    while i > 0 or j > 0:
        d = (int(words[k >> 4]) >> ((k & 15) * 2)) & 3
        if d == 1:
            a1.insert(i, "-")
            j -= 1
        elif d == 2:
            a2.insert(j, "-")
            i -= 1
        else:
            i -= 1
            j -= 1
        k += 1
    return "".join(a1), "".join(a2)


def _encode_side(strs: List[str], width: int, B: int, reverse: bool = False,
                 pad: int = 4):
    """Vectorized 2-bit encode of variable-length strings into a padded
    [B, width] code matrix (pad value 4) + int32 lengths."""
    from ..dna import NT4_TABLE
    bufs = [s.encode() for s in strs]
    lens = np.fromiter((len(b) for b in bufs), np.int32, len(bufs))
    out = np.full((B, width), pad, dtype=np.uint8)
    if bufs:
        codes = NT4_TABLE[np.frombuffer(b"".join(bufs), dtype=np.uint8)]
        row = np.repeat(np.arange(len(bufs)), lens)
        col = np.arange(codes.size) - np.repeat(
            np.cumsum(lens, dtype=np.int64) - lens, lens)
        if reverse:          # right-aligned, reversed (ksw2 query layout)
            out[row, width - 1 - col] = codes
        else:
            out[row, col] = codes
    m = np.zeros(B, dtype=np.int32)
    m[:len(bufs)] = lens
    return out, m


def nw_align_batch(pairs: List[Tuple[str, str]], M: int = 192, N: int = 192,
                   return_ops: bool = False, device="cuda"):
    """Align a list of (s1, s2) pairs on `device` and return '-'-padded
    strings, bit-identical to ops/nw_host.nw_alignment (or, with
    return_ops, the packed op words uint32[len, (M+N)/16] and the
    scores)."""
    B = len(pairs)
    if not all(len(s1) <= M and len(s2) <= N for s1, s2 in pairs):
        raise ValueError(f"nw_align_batch: a pair exceeds the {M}x{N} tier")
    c1, m = _encode_side([a for a, _ in pairs], M, B)
    c2, n = _encode_side([b for _, b in pairs], N, B)
    dev = torch.device(device)
    words_t, score_t = nw_ops(torch.from_numpy(c1).to(dev),
                              torch.from_numpy(c2).to(dev),
                              torch.from_numpy(m).to(dev),
                              torch.from_numpy(n).to(dev))
    words = words_t.cpu().numpy().view(np.uint32)
    score = score_t.cpu().numpy()
    if return_ops:
        return words, score
    return [_replay_ops(s1, s2, words[k])
            for k, (s1, s2) in enumerate(pairs)], score
