"""The grouped submit of the port's stream (mapcaller_tpu_torch/pipeline/
stream.py with DeviceBackend.submit_chain_group / resolve_chain_group and
MultiDeviceBackend's), the default path of both packages, on the CPU where
the kernels' plain versions run. Genomes and reads are built with numpy
(the toy genome is absent); stream batches of 256 reads, so a run has
several groups and a partial last one:

  * the port's default stream (groups of stream.TRANSFER_GROUP = 4)
    against the JAX package's default stream (stream_group 4), SAM and
    VCF bytes, and with the group set to 1 (one batch a submit) against
    the same bytes; the seed+chain dispatch's uploads and downloads
    counted (2 and 1 a group, or a batch);
  * -devices 2 on CPU replicas, grouped and not: whole groups round-robin,
    each replica's batches counting the members of its groups; and the
    folded apply under -devices 2, one batch a submit;
  * depth x group past the 16-slot parser ring (after
    tests/test_ring_guard.py): the defaults' bytes;
  * a tier rerun of a dense member inside a group, against the reference;
  * resolve_chain_group idempotent, a member collected before its group is
    resolved raising, and each member equal to the same batch submitted
    alone (submit_chain: a resolved group of one, two uploads and one
    download);
  * groups of one under fold_evidence and -shards, none with
    device_chain=False (a spy on submit_chain_group), and a group of more
    than one batch raising under -shards.

Every comparison is exact."""
import functools
import os

import numpy as np
import pytest
import torch

from mapcaller_tpu import runner as jax_runner
from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu_torch import runner
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.dna import decode
from mapcaller_tpu_torch.index.fmindex import load_index
from mapcaller_tpu_torch.parallel.devices import MultiDeviceBackend
from mapcaller_tpu_torch.pipeline import device_profile, stream
from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
from mapcaller_tpu_torch.simulator import write_planted_dataset

torch.set_num_threads(1)   # small tensor ops: see test_torch_e2e.py
# pinned on both sides: knobs whose value the packages pick by platform
RUN = dict(batch_size=256, stream_batch_size=256, max_read_len=128,
           prefix_skip_k=6, compact_factor=1)
N_PAIRS = 1200             # 2,400 reads: 10 batches, groups of 4, 4 and 2


def _files(d, tag):
    return dict(sam_file=os.path.join(d, f"{tag}.sam"),
                vcf_file=os.path.join(d, f"{tag}.vcf"),
                log_file=os.path.join(d, f"{tag}.log"))


def _read(cfg):
    with open(cfg.sam_file) as f, open(cfg.vcf_file) as g:
        return f.read(), g.read()


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """The planted paired-end dataset (20 kb genome, numpy-built), its
    index (built by the reference package, loaded by both) and the
    reference's SAM and VCF from its default stream (stream_group 4)."""
    d = str(tmp_path_factory.mktemp("torch_stream_group"))
    fa, f1, f2 = write_planted_dataset(d, n_pairs=N_PAIRS)
    prefix = os.path.join(d, "idx")
    build_index(fa, prefix)
    inputs = dict(index_prefix=prefix, read_files1=[f1], read_files2=[f2])
    jcfg = JaxConfig(**inputs, **RUN, **_files(d, "jax"))
    assert jcfg.stream_group == 4
    assert jax_runner.run_pipeline(jcfg, "mapcaller") == 0
    return d, inputs, _read(jcfg)


class Spy:
    """Records the size of every DeviceBackend.submit_chain_group call in
    a run and keeps the backend the runner made."""

    def __init__(self, monkeypatch):
        self.groups, self.backend = [], None
        group = DeviceBackend.submit_chain_group

        def spy_group(be, parts, *a, **k):
            self.groups.append(len(parts))
            return group(be, parts, *a, **k)

        make_engine = runner.make_engine

        def make(idx, cfg):
            eng = make_engine(idx, cfg)
            self.backend = eng.backend
            return eng

        monkeypatch.setattr(DeviceBackend, "submit_chain_group", spy_group)
        monkeypatch.setattr(runner, "make_engine", make)


def _run(planted, monkeypatch, tag, group=None, **flags):
    """The port's stream on the CPU with `flags`, and stream.TRANSFER_GROUP
    set to `group` when given -> ((SAM, VCF), the spy)."""
    d, inputs, _ = planted
    spy = Spy(monkeypatch)
    if group is not None:
        monkeypatch.setattr(stream, "TRANSFER_GROUP", group)
    cfg = Config(device="cpu", **inputs, **dict(RUN, **flags),
                 **_files(d, tag))
    assert runner.run_pipeline(cfg, "mapcaller") == 0
    return _read(cfg), spy


@pytest.mark.parametrize("group", [4, 1])
def test_stream_group_equals_reference(planted, monkeypatch, group):
    """With the default group of 4 the port's stream submits groups of 4,
    4 and 2 batches, each with one upload of its codes, one of its read
    lengths and one download; with 1 it submits the 10 batches one at a
    time (2 uploads and a download each). Both write the reference's
    grouped bytes."""
    assert stream.TRANSFER_GROUP == 4
    got, spy = _run(planted, monkeypatch, f"g{group}", group=group)
    assert got == planted[2]
    be = spy.backend
    if group == 4:
        assert spy.groups == [4, 4, 2]
        assert (be.n_uploads, be.n_downloads) == (2 * 3, 3)
    else:
        assert spy.groups == [1] * 10
        assert (be.n_uploads, be.n_downloads) == (2 * 10, 10)


@pytest.mark.parametrize("group", [4, 1])
def test_devices_grouped_round_robin(planted, monkeypatch, group):
    """-devices 2 on CPU replicas: grouped, whole groups go round-robin
    (4 and 2 batches to replica 0, 4 to replica 1); a replica's batches
    count the members of its groups. Both settings write the reference's
    bytes."""
    got, spy = _run(planted, monkeypatch, f"dev_g{group}", group=group,
                    devices=2)
    assert got == planted[2]
    be = spy.backend
    assert isinstance(be, MultiDeviceBackend)
    if group == 4:
        assert spy.groups == [4, 4, 2]
        assert be.groups == [2, 1] and be.batches == [6, 4]
        assert [b.n_downloads for b in be.bes] == [2, 1]
        assert (be.n_uploads, be.n_downloads) == (6, 3)
    else:
        assert be.groups == be.batches == [5, 5]
        assert (be.n_uploads, be.n_downloads) == (20, 10)


def test_devices_fold_evidence(planted, monkeypatch):
    """The folded apply under -devices 2: one batch a submit, each folded
    into its replica's planes (MultiDeviceBackend.submit_chain_group hands
    the replica's evidence on), and the reference's bytes."""
    device_profile.STATS.reset()
    got, spy = _run(planted, monkeypatch, "dev_fold", devices=2,
                    fold_evidence=True)
    assert got == planted[2]
    assert spy.groups == [1] * 10
    assert spy.backend.batches == [5, 5]
    assert device_profile.STATS.folded == 10


@pytest.mark.parametrize("group,depth", [(4, 30), (1, 30), (8, 14)])
def test_depth_group_past_ring(planted, monkeypatch, group, depth):
    """stream_pipeline_depth x the group past the 16-slot parser ring
    (after the reference's tests/test_ring_guard.py:59-84): the depth
    clamps to the ring less the group, and the bytes equal the
    defaults'."""
    got, spy = _run(planted, monkeypatch, f"ring_g{group}d{depth}",
                    group=group, stream_pipeline_depth=depth)
    assert got == planted[2]
    assert spy.groups == [group] * (10 // group) + (
        [10 % group] if 10 % group else [])


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """Five single-end batches of 256 reads on a 9.5 kb genome with a
    500-base unit three times (the reference's repeat-rich fixture): the
    second batch lies inside the repeat, so its slow hits overflow the
    buffer and it reruns at the larger tier inside the first group. The
    reference's SAM and VCF from its default stream."""
    d = str(tmp_path_factory.mktemp("torch_stream_dense"))
    rng = np.random.default_rng(33)
    unit = rng.integers(0, 4, 500).astype(np.uint8)
    genome = np.concatenate([rng.integers(0, 4, 4000).astype(np.uint8),
                             unit, unit, unit,
                             rng.integers(0, 4, 4000).astype(np.uint8)])
    fa = os.path.join(d, "rep.fa")
    with open(fa, "w") as f:
        f.write(f">chr1\n{decode(genome)}\n")
    fq = os.path.join(d, "m.fq")
    with open(fq, "w") as f:
        for k in range(5 * 256):
            if 256 <= k < 512:
                p = int(rng.integers(4000, 4000 + 3 * 500 - 100))
            else:
                p = int(rng.integers(0, len(genome) - 100))
            c = genome[p:p + 100].copy()
            if k % 11 == 5:
                c[50] = (c[50] + 1) % 4
            f.write(f"@m{k}\n{decode(c)}\n+\n{'I' * 100}\n")
    prefix = os.path.join(d, "idx")
    build_index(fa, prefix)
    inputs = dict(index_prefix=prefix, read_files1=[fq])
    jcfg = JaxConfig(**inputs, **RUN, **_files(d, "jax"))
    assert jax_runner.run_pipeline(jcfg, "mapcaller") == 0
    return d, inputs, _read(jcfg)


def test_tier_rerun_inside_group(dense, monkeypatch):
    """The dense member reruns at tier 18 from its own rows of the group
    upload, and the stand-alone evidence apply reads the rerun's outputs:
    the bytes equal the reference's grouped stream."""
    device_profile.STATS.reset()
    got, spy = _run(dense, monkeypatch, "dense")
    assert spy.groups == [4, 1]
    assert spy.backend.n_tier_reruns > 0
    assert device_profile.STATS.applies == 5
    assert got == dense[2]


# ---- the backend's grouped submit, directly --------------------------------

def _pack(mat):
    packed = np.zeros((mat.shape[0], mat.shape[1] // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    return packed


def _batches(idx, g, B, bucket=128, seed=5):
    """g batches of B reads of 100 bases from the genome (one with rlen
    -1 in each: a host-fallback read) -> [(packed, rlens)], the codes."""
    rng = np.random.default_rng(seed)
    genome = idx.ref.ref_sequence_codes()
    parts, codes = [], []
    for _ in range(g):
        mat = np.zeros((B, bucket), dtype=np.uint8)
        rlens = np.full(B, 100, dtype=np.int32)
        for b in range(B):
            p = int(rng.integers(0, genome.size - 100))
            mat[b, :100] = genome[p:p + 100]
        rlens[3] = -1
        parts.append((_pack(mat), rlens))
        codes.append(mat)
    return parts, codes


def test_resolve_idempotent_and_collect_before_raises(planted):
    """A member collected before its group is resolved raises, without
    reading the buffer; resolving twice changes nothing; every member
    shares the group's one buffer and collects what the same batch
    submitted alone collects."""
    idx = load_index(planted[1]["index_prefix"])
    be = DeviceBackend(idx, Config(device="cpu", **RUN))
    parts, codes = _batches(idx, 3, 64)
    tokens, group = be.submit_chain_group(parts, 128)
    assert (be.n_uploads, be.n_downloads) == (2, 1)
    fn = [functools.partial(lambda c, i: c[i, :100], c) for c in codes]
    with pytest.raises(RuntimeError, match="not resolved"):
        be.collect_chain(tokens[1], 64, fn[1])
    be.resolve_chain_group(group)
    hosts = [t.host for t in tokens]
    be.resolve_chain_group(group)
    assert all(t.host is h for t, h in zip(tokens, hosts))
    base = group.host.data_ptr()
    assert [t.host.data_ptr() - base for t in tokens] == [
        4 * i * group.stride for i in range(3)]
    for t, (packed, rlens), f in zip(tokens, parts, fn):
        assert t.dev.untyped_storage().data_ptr() == base
        alone = be.submit_chain(packed, rlens, 128)
        want = be.collect_chain(alone, 64, f)
        for w, g in zip(want, be.collect_chain(t, 64, f)):
            np.testing.assert_array_equal(g, w)
        assert t.fb_neg[3] and t.rl_dev[3] == 0


def test_submit_chain_is_group_of_one(planted):
    """submit_chain is a transfer group of one batch, resolved at submit:
    two uploads, one download, its host slice set, and the same outputs as
    the same batch as a member of a larger group."""
    idx = load_index(planted[1]["index_prefix"])
    be = DeviceBackend(idx, Config(device="cpu", **RUN))
    parts, codes = _batches(idx, 2, 64, seed=9)
    token = be.submit_chain(*parts[1], 128)
    assert (be.n_uploads, be.n_downloads) == (2, 1)
    assert token.group.resolved and token.group.tokens == [token]
    assert token.host is not None
    tokens, group = be.submit_chain_group(parts, 128)
    be.resolve_chain_group(group)
    fn = functools.partial(lambda c, i: c[i, :100], codes[1])
    for w, g in zip(be.collect_chain(tokens[1], 64, fn),
                    be.collect_chain(token, 64, fn)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("flags", [dict(fold_evidence=True),
                                   dict(index_shards=2),
                                   dict(device_chain=False)],
                         ids=["fold", "shards", "unchained"])
def test_grouping_off(planted, monkeypatch, flags):
    """The folded apply and -shards submit groups of one batch, and host
    chaining submits no group (the reference's rule); all write the same
    bytes."""
    got, spy = _run(planted, monkeypatch, "off_" + "_".join(flags), **flags)
    assert spy.groups == ([] if "device_chain" in flags else [1] * 10)
    assert got == planted[2]


def test_group_raises_under_shards(planted):
    """Under -shards a group of two batches raises (it would build
    single-card kernels and bypass the sharded index, the reference's
    reason), and a group of one takes the sharded path."""
    idx = load_index(planted[1]["index_prefix"])
    be = DeviceBackend(idx, Config(device="cpu", index_shards=2, **RUN))
    parts, _ = _batches(idx, 2, 32)
    with pytest.raises(RuntimeError, match="bypass the sharded-index path"):
        be.submit_chain_group(parts, 128)
    assert be.sharded_invocations == 0
    tokens, group = be.submit_chain_group(parts[:1], 128)
    assert group is None and len(tokens) == 1
    assert be.sharded_invocations == 1
