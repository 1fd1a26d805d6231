"""The port's NW DP (mapcaller_tpu_torch/ops/nw_device.py) against the
reference package's Pallas kernel (interpret mode on the CPU): packed op
words and scores must be equal exactly, at the tiers the stream path
uses. On CPU tensors `nw_ops` runs its plain PyTorch version, the same
function the CUDA kernel csrc/nw.cu computes on the card."""
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
    sides (m=0 or n=0) and sides exactly at the tier's edge."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a, b = _mutated_pair(rng, int(rng.integers(1, tier - 4)))
        pairs.append((a[:tier], b[:tier]))
    edge = decode(rng.integers(0, 4, size=tier).astype(np.uint8))
    pairs += [("", ""), ("", "ACGT"), ("ACG", ""), ("A", "A"), ("A", "C"),
              (edge, edge), (edge, edge[::-1]), (edge, edge[:tier // 2]),
              (edge[1:], edge), ("AC", "ACGTACGT"), ("G", "TTTT")]
    return pairs


@pytest.mark.parametrize("tier", [32, 48])
def test_ops_words_and_scores_equal_pallas(tier):
    pairs = _pairs(tier, 30, seed=tier)
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
