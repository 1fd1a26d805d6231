"""The port's NW DP (mapcaller_tpu_torch/ops/nw_device.py) against the
reference package's Pallas kernel (interpret mode on the CPU): packed op
words and scores must be equal exactly, at the tiers the stream path
uses. On CPU tensors `nw_ops` runs its plain PyTorch version, the same
function the CUDA kernel csrc/nw.cu computes on the card; the kernel's
launch geometry (`nw_geometry`) is checked here against the limits the
CUDA source states."""
import os
import re

import numpy as np
import pytest
import torch

from mapcaller_tpu.ops import nw_device as jax_nw
from mapcaller_tpu_torch.dna import decode
from mapcaller_tpu_torch.ops import nw_device
from mapcaller_tpu_torch.ops.nw_host import nw_alignment

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py


def _mutated_pair(rng, m):
    base = rng.integers(0, 4, size=m).astype(np.uint8)
    s2 = []
    for b in base:
        r = rng.random()
        if r < 0.08:
            continue                              # deletion
        if r < 0.16:
            s2.append(int(rng.integers(0, 4)))    # insertion
        s2.append((int(b) + 1) % 4 if r < 0.24 else int(b))
    return decode(base), decode(np.array(s2, dtype=np.uint8))


def _pairs(tier, n, seed):
    """Random mutated pairs within the tier, plus the edge cases: empty
    sides (m=0 or n=0), sides exactly at the tier's edge, and second
    sides of k*chunk - 1, k*chunk and k*chunk + 1 bases, which end on
    either side of the kernel's per-lane column chunks."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a, b = _mutated_pair(rng, int(rng.integers(1, tier - 4)))
        pairs.append((a[:tier], b[:tier]))
    edge = decode(rng.integers(0, 4, size=tier).astype(np.uint8))
    pairs += [("", ""), ("", "ACGT"), ("ACG", ""), ("A", "A"), ("A", "C"),
              (edge, edge), (edge, edge[::-1]), (edge, edge[:tier // 2]),
              (edge[1:], edge), ("AC", "ACGTACGT"), ("G", "TTTT")]
    lanes, chunk, _, _ = nw_device.nw_geometry(tier, tier)
    for k in (1, 2, lanes - 1, lanes):
        for e in (k * chunk - 1, k * chunk, k * chunk + 1):
            if e <= tier:
                a, b = _mutated_pair(rng, tier)
                pairs.append((a[:tier], (b + edge)[:e]))
    return pairs


@pytest.mark.parametrize("tier", [32, 48, 96, 192])
def test_ops_words_and_scores_equal_pallas(tier):
    pairs = _pairs(tier, 30, seed=tier)
    _, _, per_block, _ = nw_device.nw_geometry(tier, tier)
    assert len(pairs) % per_block != 0       # a ragged last block
    want_w, want_s = jax_nw.nw_align_batch(pairs, M=tier, N=tier, tile=8,
                                           interpret=True, return_ops=True)
    got_w, got_s = nw_device.nw_align_batch(pairs, M=tier, N=tier,
                                            return_ops=True, device="cpu")
    assert got_w.dtype == np.uint32
    assert got_w.shape == (len(pairs), 2 * tier // 16)
    np.testing.assert_array_equal(got_w, np.asarray(want_w))
    np.testing.assert_array_equal(got_s, np.asarray(want_s))


def test_strings_equal_host_oracle():
    pairs = _pairs(48, 60, seed=7)
    got, _ = nw_device.nw_align_batch(pairs, M=48, N=48, device="cpu")
    for (s1, s2), aln in zip(pairs, got):
        assert aln == nw_alignment(s1, s2), (s1, s2)


def test_plain_version_counts_no_launch():
    before = nw_device.STATS.launches
    nw_device.nw_align_batch(_pairs(32, 4, seed=3), M=32, N=32,
                             return_ops=True, device="cpu")
    assert nw_device.STATS.launches == before


@pytest.mark.parametrize("bad", ["dtype", "batch", "tier"])
def test_nw_ops_checks_inputs(bad):
    B, M, N = 4, 32, 32
    c1 = torch.zeros((B, M), dtype=torch.uint8)
    c2 = torch.zeros((B, N), dtype=torch.uint8)
    m = torch.full((B,), 3, dtype=torch.int32)
    n = torch.full((B,), 3, dtype=torch.int32)
    if bad == "dtype":
        c1 = c1.to(torch.int32)
    elif bad == "batch":
        n = n[:2]
    else:
        c2 = c2[:, :N - 1]
    with pytest.raises((TypeError, ValueError)):
        nw_device.nw_ops(c1, c2, m, n)


def _cuda_limits():
    """The limits csrc/nw.cu states: its constexpr ints and the thread
    count of its __launch_bounds__."""
    with open(os.path.join(os.path.dirname(nw_device.__file__), "..",
                           "csrc", "nw.cu")) as f:
        src = f.read()
    lim = {k: int(v) for k, v in
           re.findall(r"constexpr int (MAX_\w+) = (\d+);", src)}
    lim["THREADS"] = int(re.search(r"__launch_bounds__\((\d+)\)",
                                   src).group(1))
    return lim


def test_wrapper_limits_equal_cuda_source():
    assert _cuda_limits() == {"MAX_N": nw_device.KERNEL_MAX_N,
                              "MAX_CHUNK": nw_device.KERNEL_MAX_CHUNK,
                              "MAX_SMEM": nw_device.KERNEL_MAX_SMEM,
                              "THREADS": nw_device.KERNEL_MAX_THREADS}


@pytest.mark.parametrize("tier", [32, 48, 96, 192, 256])
def test_nw_geometry_within_kernel_limits(tier):
    lanes, chunk, per_block, smem = nw_device.nw_geometry(tier, tier)
    lim = _cuda_limits()
    threads = lanes * per_block
    assert lanes in (8, 16, 32)
    assert lanes * chunk >= tier                 # columns 1..N covered
    assert 1 <= chunk <= lim["MAX_CHUNK"] == 8   # 2 bits each in a uint16
    assert threads % 32 == 0 and 32 <= threads <= lim["THREADS"]
    assert smem == tier * threads * 2 <= lim["MAX_SMEM"] == 232448
    assert smem <= nw_device.BLOCK_SMEM_TARGET


def test_nw_geometry_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        nw_device.nw_geometry(32, nw_device.KERNEL_MAX_N + 8)
