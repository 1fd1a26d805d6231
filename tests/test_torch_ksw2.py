"""The port's ksw2 DP (mapcaller_tpu_torch/ops/ksw2_device.py) against
the reference package: the plain PyTorch version's flags and packed op
words equal the reference's XLA fill and backtrack exactly at the tiers
the stream path uses; the batch aligner's strings equal the host oracle's;
and the `-alg ksw2` stream with device DP writes the reference's SAM and
VCF and the port's own scalar run's. On CPU tensors `ksw2_ops` runs its
plain version, the same function the CUDA kernel csrc/ksw2.cu computes on
the card."""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapcaller_tpu import runner as jax_runner
from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.ops import ksw2_device as jax_ksw2
from mapcaller_tpu.ops.ksw2_host import ksw2_alignment
from mapcaller_tpu_torch import runner
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.dna import decode
from mapcaller_tpu_torch.ops import ksw2_device
from mapcaller_tpu_torch.ops.nw_device import _encode_side

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mutated_pair(rng, m):
    """A random query of m bases and a target with substitutions,
    insertions and deletions (tests/test_ksw2_device.py's generator)."""
    base = rng.integers(0, 4, size=m).astype(np.uint8)
    s2 = []
    for b in base:
        r = rng.random()
        if r < 0.08:
            continue
        if r < 0.16:
            s2.append(int(rng.integers(0, 4)))
        s2.append((int(b) + 1) % 4 if r < 0.24 else int(b))
    return decode(base), decode(np.array(s2 or [0], dtype=np.uint8))


def _tier_pairs(tier, n, seed):
    """n pairs with both sides in 1..tier and about 5% N bases, plus the
    edges: single bases, sides at the tier's edge, very unequal sides."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a, b = _mutated_pair(rng, int(rng.integers(1, tier + 1)))
        a, b = a[:tier], b[:tier]
        a = "".join("N" if rng.random() < 0.05 else c for c in a)
        b = "".join("N" if rng.random() < 0.05 else c for c in b)
        pairs.append((a, b))
    edge = decode(rng.integers(0, 4, size=tier).astype(np.uint8))
    pairs += [("A", "A"), ("A", "C"), ("N", "G"), (edge, edge),
              (edge, edge[::-1]), (edge, edge[:1]), (edge[:1], edge),
              (edge[: tier // 3], edge), ("ACGTNACGT", "ACGTACGT")]
    return pairs


@pytest.mark.parametrize("tier", [32, 48, 96])
def test_ops_flags_and_words_equal_reference(tier):
    """The reference's build_ksw2_kernel + build_ksw2_traceback (XLA on
    the CPU) and the port's plain fill and backtrack, on the same encoded
    pairs: the flag tensor and the packed words equal exactly."""
    pairs = _tier_pairs(tier, 60, seed=tier)
    B = len(pairs)
    NC = tier + 16
    qbuf, ql = _encode_side([a for a, _ in pairs], tier, B, reverse=True,
                            pad=0)
    tgt, tl = _encode_side([b for _, b in pairs], NC, B, pad=0)
    want_p = jax_ksw2.build_ksw2_kernel(tier, tier)(
        jnp.asarray(qbuf), jnp.asarray(tgt), jnp.asarray(ql), jnp.asarray(tl))
    want_w = np.asarray(jax_ksw2.build_ksw2_traceback(tier, tier)(
        want_p, jnp.asarray(ql), jnp.asarray(tl)))
    args = [torch.from_numpy(a) for a in (qbuf, tgt, ql, tl)]
    flags = ksw2_device.ksw2_flags_plain(*args)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(want_p))
    words = ksw2_device.ksw2_ops(*args)          # CPU tensors: plain
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want_w)


def test_align_batch_equal_host_oracle(rng):
    """tests/test_ksw2_device.py's random and edge pairs, the wildcard
    pair included, at tier 96: the strings equal ksw2_alignment's."""
    pairs = []
    for _ in range(150):
        m = int(rng.integers(1, 60))
        pairs.append(_mutated_pair(rng, m))
    pairs += [("A", "A"), ("A", "C"), ("ACGT", "ACGT"), ("AAAA", "AA"),
              ("AC", "ACGTACGT"), ("G", "TTTT"), ("ACGTNACGT", "ACGTACGT")]
    got = ksw2_device.ksw2_align_batch(pairs, M=96, N=96, device="cpu")
    for (s1, s2), (a1, a2) in zip(pairs, got):
        assert (a1, a2) == ksw2_alignment(s1, s2), (s1, s2)


def test_align_batch_limits():
    with pytest.raises(ValueError, match="multiple of 16"):
        ksw2_device.ksw2_align_batch([("A", "A")], M=40, N=40, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        ksw2_device.ksw2_align_batch([("", "A")], M=32, N=32, device="cpu")


def test_kernel_limits_equal_cuda_source():
    """The wrapper's limits are the ones csrc/ksw2.cu checks."""
    with open(os.path.join(REPO, "mapcaller_tpu_torch", "csrc",
                           "ksw2.cu")) as f:
        src = f.read()
    for name, want in (("MAX_CHUNK", ksw2_device.KERNEL_MAX_CHUNK),
                       ("MAX_M", ksw2_device.KERNEL_MAX_M)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == want, name


@pytest.fixture(scope="module")
def divergent(tmp_path_factory):
    """tests/test_device_extension.py's divergent reads (dense mismatch
    blocks, 4-bp deletions, 5-bp insertions) as files, and the reference
    package's SAM and VCF with its device ksw2 DP (XLA on the CPU)."""
    d = str(tmp_path_factory.mktemp("torch_ksw2"))
    rng = np.random.default_rng(5)
    L = 30000
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        f.write(f">chr1\n{decode(codes)}\n")
    fq = os.path.join(d, "d.fq")
    RL = 100
    with open(fq, "w") as f:
        for k, p in enumerate(range(100, L - 200, 37)):
            c = codes[p:p + RL].copy()
            if k % 3 == 0:
                j = 30 + (k % 25)
                c[j:j + 6] = (c[j:j + 6] + 1 + rng.integers(0, 3, 6)) % 4
            elif k % 3 == 1:
                c = np.concatenate([codes[p:p + 40],
                                    codes[p + 44:p + 44 + RL - 40]])[:RL]
            else:
                ins = rng.integers(0, 4, 5).astype(np.uint8)
                c = np.concatenate([codes[p:p + 50], ins,
                                    codes[p + 50:p + RL - 5]])[:RL]
            f.write(f"@d{k}\n{decode(c)}\n+\n{'I' * RL}\n")
    prefix = os.path.join(d, "idx")
    build_index(fa, prefix)
    inputs = dict(index_prefix=prefix, read_files1=[fq], use_nw=False,
                  batch_size=512, stream_batch_size=512, max_read_len=128,
                  prefix_skip_k=6, compact_factor=1)
    cfg = JaxConfig(device_extension=True, sam_file=os.path.join(d, "j.sam"),
                    vcf_file=os.path.join(d, "j.vcf"),
                    log_file=os.path.join(d, "j.log"), **inputs)
    assert jax_runner.run_pipeline(cfg, "mapcaller") == 0
    with open(cfg.sam_file) as f, open(cfg.vcf_file) as g:
        return d, inputs, (f.read(), g.read())


@pytest.mark.parametrize("device_extension", [True, False])
def test_ksw2_stream_equal_reference(divergent, monkeypatch,
                                     device_extension):
    """-alg ksw2 through the port's stream on the CPU: with device DP
    every DP batch goes through ksw2_ops (its plain version here), with
    scalar DP none does; both write the reference's SAM and VCF."""
    d, inputs, want = divergent
    pairs = []
    plain = ksw2_device.ksw2_ops_plain

    def counted(qbuf, *a):
        pairs.append(qbuf.shape[0])
        return plain(qbuf, *a)

    monkeypatch.setattr(ksw2_device, "ksw2_ops_plain", counted)
    tag = f"t{device_extension}"
    cfg = Config(device="cpu", device_extension=device_extension,
                 sam_file=os.path.join(d, f"{tag}.sam"),
                 vcf_file=os.path.join(d, f"{tag}.vcf"),
                 log_file=os.path.join(d, f"{tag}.log"), **inputs)
    assert runner.run_pipeline(cfg, "mapcaller") == 0
    with open(cfg.sam_file) as f, open(cfg.vcf_file) as g:
        assert (f.read(), g.read()) == want
    assert (sum(pairs) > 100) == device_extension
