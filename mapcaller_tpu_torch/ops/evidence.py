"""Shared fast-read evidence scatter (PyTorch port of
mapcaller_tpu/ops/evidence.py; ref: AlignmentProfile.cpp:41-119 via the
diff design in pipeline/device_profile.py).

One admitted FAST read contributes: exact-coverage range endpoints at
[g_start, end), an orientation-plane (F1/R2/F2/R1) range, and per
mismatch a coverage hole + a read-base point add. All contributions are
commutative integer adds, so the same code serves the stand-alone apply,
the folded chain-kernel apply (speculative, corrected later) and the
sparse reject correction (sign=-1), and each plane takes every
(index, value) pair of a call in one `index_add_`. The planes keep the
reference's +1/+2 dump slots (the layout), which nothing here writes.
"""
from __future__ import annotations

import torch


def first_mate_lanes(bidx: torch.Tensor, pair_end: bool) -> torch.Tensor:
    """b_first for batch lanes `bidx`: mates interleave even/odd in a
    paired-end batch, so first mates are the even lanes; every lane of a
    single-end batch."""
    if pair_end:
        return (bidx & 1) == 0
    return torch.ones_like(bidx, dtype=torch.bool)


def scatter_fast_evidence(exact, fd, acgt, adm, pd, mmp, rlens, b_first,
                          L: int, two_l: int, sign: int = 1):
    """exact int32[L+2], fd flat int32[4*(L+2)], acgt flat int32[4*(L+1)],
    updated in place and returned; adm bool[N], pd/rlens int[N],
    mmp int[N, S] packing (r << 2 | base), -1 empty
    (ops/chain_device.classify_reads); b_first bool[N].

    Masked-out lanes add 0, so every index stays in range and nothing
    here waits for the device. They add it at a spread of slots of their
    own (lane-dependent), not at one dump slot: tens of thousands of
    atomic adds to a single address serialize on the card. Index
    arithmetic runs in int64: admitted lanes hold the same values as the
    reference's int32 arithmetic, masked lanes (pd = INT32_MAX for reads
    without hits) cannot overflow."""
    i64 = torch.int64
    pd, rlens, mmp = pd.to(i64), rlens.to(i64), mmp.to(i64)
    S = torch.full((), sign, dtype=exact.dtype, device=exact.device)
    zero = torch.zeros_like(S)
    lane = torch.arange(pd.shape[0], dtype=i64, device=pd.device)
    pieces = {"e": ([], [], exact.shape[0]), "f": ([], [], fd.shape[0]),
              "a": ([], [], acgt.shape[0])}

    def add(plane, on, index, value):
        idx, val, size = pieces[plane]
        idx.append(torch.where(on, index, (lane * 7 + len(idx)) % size))
        val.append(torch.where(on, value, zero))

    ori = pd < L
    g_start = torch.clamp(torch.where(ori, pd, two_l - pd - rlens), 0, L - 1)
    end = torch.clamp(g_start + rlens, max=L)
    fpl = torch.where(b_first, torch.where(ori, 0, 3), torch.where(ori, 1, 2))
    add("e", adm, g_start, S)
    add("e", adm, end, -S)
    add("f", adm, fpl * (L + 2) + g_start, S)
    add("f", adm, fpl * (L + 2) + end, -S)
    for k in range(mmp.shape[1]):
        e = mmp[:, k]
        on = adm & (e >= 0)
        r = e >> 2
        base = e & 3
        p = torch.clamp(torch.where(ori, pd + r, two_l - 1 - (pd + r)), 0,
                        L - 1)
        add("e", on, p, -S)
        add("e", on, p + 1, S)
        pb = torch.where(ori, base, 3 - base)
        add("a", on, pb * (L + 1) + p, S)
    for plane, target in (("e", exact), ("f", fd), ("a", acgt)):
        idx, val, _ = pieces[plane]
        if idx:
            target.index_add_(0, torch.cat(idx), torch.cat(val))
    return exact, fd, acgt
