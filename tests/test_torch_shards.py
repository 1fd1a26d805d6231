"""`-shards N` in the port (mapcaller_tpu_torch/parallel/sharded_index.py)
on the CPU: the occ3 rows and the SA split over N CPU shards, every row
fetch routed to its shard (ops/routed.py). Held against the reference
package's genome-sharded index on its virtual CPU mesh (templates:
tests/test_mesh.py's sharded tests) and against one device: the shard
layout and the routed row arithmetic at the shard edges, the occ3 rows
built a shard at a time, the routed scan,
the routed SA gather and walk, the production chain stage through
submit_chain / collect_chain with 2, 3 and 8 shards (slow reads with
several hits each), a tier rerun, the sampled-SA walk inside the chain
stage, and a full stream run. Every sharded run counts its sharded
dispatches (sharded_invocations > 0): a batch sent through the
single-card kernels would write the same bytes. Integers compare exactly.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.index.packer import PackedReference
from mapcaller_tpu.ops.fm3_device import DeviceFM3 as JaxFM3
from mapcaller_tpu.ops.fm_device import DeviceFMIndex as JaxFM
from mapcaller_tpu.parallel.mesh import make_mesh
from mapcaller_tpu.parallel.sharded_index import (build_sharded_sa_resolve,
                                                  build_sharded_seed_scan)
from mapcaller_tpu.parallel.sharded_index import \
    shard_occ3_rows as jax_shard_occ3_rows
from mapcaller_tpu.pipeline.device_backend import DeviceBackend as JaxBackend
from mapcaller_tpu_torch import runner
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.ops import chain_kernels as ck
from mapcaller_tpu_torch.ops import seed_scan_device as ssd
from mapcaller_tpu_torch.ops.chain_device import ChainCtx
from mapcaller_tpu_torch.ops.fm3_device import DeviceFM3
from mapcaller_tpu_torch.ops.fm_device import DeviceFMIndex, sa_resolve
from mapcaller_tpu_torch.ops.fm_search import (MIN_SEED_LEN,
                                               build_seed_chain_kernel)
from mapcaller_tpu_torch.ops.routed import Routed
from mapcaller_tpu_torch.parallel.sharded_index import (ShardedChainKernel,
                                                        build_shard_index,
                                                        replicate_ctx,
                                                        shard_index,
                                                        shard_occ3_rows)
from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
from test_devices import _make_dataset
import test_torch_seed_scan as tss

torch.set_num_threads(1)
CPU = torch.device("cpu")
OUT = ("cls", "pd", "mm", "rplast", "cscore", "counts", "rpos", "gpos",
       "slen")


def _pack(mat):
    packed = np.zeros((mat.shape[0], mat.shape[1] // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    return packed


def _index(codes):
    return build_index(None, packed=PackedReference(
        ["chr1"], [len(codes)], [0], codes, []))


def _put(mesh, a, *spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_shard_layout_and_edges(n):
    """The port's shards of the occ3 rows and of the SA equal the
    reference's padded split (shard_occ3_rows, the backend's pad_split)
    on a genome whose row counts do not divide by n; the routed gather
    reads rows rps - 1 and rps (either side of each shard edge), the last
    real row and the padded tail of the last shard as a numpy mirror of
    the kernels' arithmetic (s = w // rps, local = w - s * rps) says."""
    codes = np.random.default_rng(5).integers(0, 4, 9009).astype(np.uint8)
    idx = _index(codes)
    jfm3 = JaxFM3.from_host(idx)
    fm3 = DeviceFM3.from_host(idx, DeviceFMIndex.from_host(idx, device=CPU),
                              pfx_k=0)
    rows = fm3.occ3_rows.numpy()
    occ3 = shard_occ3_rows(fm3, [CPU] * n)
    jslices, jrps = jax_shard_occ3_rows(jfm3, n)
    assert occ3.per == jrps and rows.shape[0] % n
    assert np.array_equal(np.stack([t.numpy() for t in occ3.shards]),
                          np.asarray(jslices))
    sa = fm3.fm.sa_full.numpy()
    rsa = Routed.split(fm3.fm.sa_full, [CPU] * n)
    sps = -(-sa.shape[0] // n)
    assert rsa.per == sps and sa.shape[0] % n
    for table, r, per in ((rows, occ3, jrps), (sa, rsa, sps)):
        nrows = table.shape[0]
        edges = sorted({w for s in range(1, n) for w in (s * per - 1,
                                                         s * per)}
                       | {0, nrows - 1, nrows, n * per - 1})
        w = np.array(edges, dtype=np.int64)
        # the mirror: shard and local row, as the kernels compute them
        s = w // per
        local = w - s * per
        pad = np.concatenate([table, np.zeros((n * per - nrows,)
                                              + table.shape[1:],
                                              table.dtype)])
        want = pad.reshape((n, per) + table.shape[1:])[s, local]
        got = r[torch.from_numpy(w)].numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got[w < nrows], table[w[w < nrows]])
        assert not got[w >= nrows].any()          # the padded tail
        # out of every shard: zeros, as the reference's psum answers
        assert not r[torch.tensor([-1, n * per])].numpy().any()


@pytest.mark.parametrize("device_sa", [True, False])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_built_shards_equal_split(n, device_sa):
    """The backend builds the occ3 rows one shard at a time
    (build_shard_index: from the resident full SA, each chunk's counts
    continuing the last one's; or from the host table, uploaded a shard
    at a time) and never the whole table on one device: every shard, its
    padded tail and the constants equal the split of the whole built
    table, and the reference's slices."""
    codes = np.random.default_rng(6).integers(0, 4, 9009).astype(np.uint8)
    idx = _index(codes)
    fm = DeviceFMIndex.from_host(idx, device=CPU,
                                 sa_budget_bytes=(2 << 30) if device_sa
                                 else 0)
    assert fm.has_full_sa == device_sa
    fm3 = DeviceFM3.from_host(idx, fm, pfx_k=0)
    want = shard_index(fm3, [CPU] * n)[CPU]
    got = build_shard_index(idx, fm, [CPU] * n)[CPU]
    jslices, jrps = jax_shard_occ3_rows(JaxFM3.from_host(idx), n)
    assert got.occ3.per == want.occ3.per == jrps
    assert fm3.occ3_rows.shape[0] % n
    for a, b, j in zip(got.occ3.shards, want.occ3.shards, np.asarray(jslices)):
        assert torch.equal(a, b) and np.array_equal(a.numpy(), j)
    assert torch.equal(got.c3_first, want.c3_first)
    for k in ("row_p1", "row_p2", "t0", "t1", "tail1", "tail2a", "tail2b",
              "pfx_k", "pfx_base"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("sa_full", "occ_rows", "sa_samp"):
        a, b = getattr(got.fm, k), getattr(want.fm, k)
        if isinstance(b, Routed):
            assert all(torch.equal(x, y) for x, y in zip(a.shards, b.shards))
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("n, G, max_seeds", [
    (2, 0, None), (8, 0, None), (2, 8, None), (8, 16, 1), (8, 32, None)],
    ids=["2", "8", "2-G8", "8-G16-overflow", "8-G32"])
def test_routed_scan_equals_reference(n, G, max_seeds):
    """The plain routed scan (seed_scan3_routed on CPU tensors, every row
    gathered from its shard) against the reference's
    build_sharded_seed_scan on n mesh devices, and against the unrouted
    scan: the same seed tables (template tests/test_mesh.py:70). With G,
    the routed kernel's lane-group form at G lanes a read
    (tests/test_torch_seed_scan.py mirror_scan3_group, its partials reduced
    by the xor-shuffle tree) equals its thread mirror and the plain routed
    scan in every output, steps and row gathers too, on reads of 0-17
    bases, full-length reads and 60-base ones, with a seed table of 1 that
    overflows; some of its fetches read a shard's first or last row."""
    rng = np.random.default_rng(17)
    L = 12000
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    idx = _index(codes)
    jfm3 = JaxFM3.from_host(idx)
    B, MAXLEN = 16, 64
    BG = B * n
    text = idx.ref.fwd_rc_codes()
    mat = np.zeros((BG, MAXLEN), dtype=np.uint8)
    rlens = np.full(BG, 60, dtype=np.int32)
    if G:                                    # short and full-length reads
        rlens[::9] = np.resize([0, 15, 16, 17], len(rlens[::9]))
        rlens[4::7] = MAXLEN
    for b in range(BG):
        ln = int(rlens[b])
        p = int(rng.integers(0, idx.genome_size - 60))
        r = text[p:p + ln].copy()
        if b % 3 == 0 and ln:
            j = int(rng.integers(0, ln))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        mat[b, :ln] = r
    packed = _pack(mat)
    mesh = make_mesh(n)
    slices, _ = jax_shard_occ3_rows(jfm3, n)
    step = build_sharded_seed_scan(jfm3, mesh, n, MAXLEN, B)
    want = jax.device_get(step(_put(mesh, slices, "dp", None, None),
                               _put(mesh, packed, "dp", None),
                               _put(mesh, rlens, "dp")))
    fm3 = DeviceFM3.from_host(idx, DeviceFMIndex.from_host(idx, device=CPU),
                              pfx_k=0)
    sfm3 = shard_index(fm3, [CPU] * n)[CPU]
    S = max_seeds or MAXLEN // (MIN_SEED_LEN + 1) + 2
    args = (torch.from_numpy(packed), torch.from_numpy(rlens), MAXLEN, S)
    ssd.STATS.reset()
    got = ssd.seed_scan3_routed(sfm3, *args, with_iters=bool(G))
    flat = ssd.seed_scan3(fm3, *args, with_iters=bool(G))
    assert not ssd.STATS.launches            # CPU: the plain versions
    if max_seeds is None:                    # the reference's table size
        for k, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g.numpy().astype(np.int64),
                                  np.asarray(w).astype(np.int64)), k
    for k, (g, f) in enumerate(zip(got, flat)):
        assert np.array_equal(g.numpy(), f.numpy()), k
    assert int(got[0].sum()) > BG // 2       # seeds found
    if not G:
        return
    fetch = tss.RoutedFetch([t.numpy() for t in sfm3.occ3.shards],
                            sfm3.occ3.per)
    thread = tss.mirror_scan3(fm3, packed, rlens, MAXLEN, S)
    group = tss.mirror_scan3_group(fetch, tss.scan3_consts(sfm3), packed,
                                   rlens, MAXLEN, S, G)
    tss._equal(group, thread)
    tss._equal(group, got)
    assert fetch.edge_rows > 0
    assert (rlens < MIN_SEED_LEN).any() and (rlens == MAXLEN).any()
    assert bool(got[5].any()) == (max_seeds is not None)


def test_routed_sa_equals_reference():
    """The routed SA resolve (ops/fm_device.sa_resolve over Routed
    tables): the inverse-Psi walk over sharded occ4 rows and sampled SA
    against the reference's build_sharded_sa_resolve on 8 mesh devices
    (template tests/test_mesh.py:145), and the routed full-SA gather
    against the SA itself."""
    rng = np.random.default_rng(29)
    L = 9000
    idx = _index(rng.integers(0, 4, size=L).astype(np.uint8))
    jfm = JaxFM.from_host(idx)
    n = 8
    mesh = make_mesh(n)
    BG = 16 * n

    def pad_split(a):
        a = np.asarray(a)
        per = -(-a.shape[0] // n)
        pad = np.zeros((n * per,) + a.shape[1:], dtype=a.dtype)
        pad[:a.shape[0]] = a
        return pad.reshape((n, per) + a.shape[1:])

    ks = rng.integers(1, idx.seq_len, size=BG).astype(np.int32)
    fn = build_sharded_sa_resolve(jfm, mesh, n, 16)
    loc, resolved = jax.device_get(fn(
        _put(mesh, pad_split(jfm.occ_rows), "dp", None, None),
        _put(mesh, pad_split(np.asarray(jfm.sa_samp).astype(np.int32)),
             "dp", None),
        _put(mesh, ks, "dp"), _put(mesh, np.ones(BG, bool), "dp")))
    fm = DeviceFMIndex.from_host(idx, device=CPU)
    rfm = dataclasses.replace(
        fm, occ_rows=Routed.split(fm.occ_rows, [CPU] * n),
        sa_samp=Routed.split(fm.sa_samp, [CPU] * n), sa_full=fm.sa_full[:0])
    k = torch.from_numpy(ks).to(torch.int64)
    act = torch.ones(BG, dtype=torch.bool)
    got_loc, got_res = sa_resolve(rfm, k, act)      # 192 steps, as JAX
    res = np.asarray(resolved)
    assert np.array_equal(got_res.numpy(), res)
    assert np.array_equal(got_loc.numpy()[res], np.asarray(loc)[res])
    assert res.sum() >= int(0.95 * BG)
    # the same walk unrouted
    flat_loc, flat_res = sa_resolve(dataclasses.replace(
        fm, sa_full=fm.sa_full[:0]), k, act)
    assert torch.equal(flat_loc, got_loc) and torch.equal(flat_res, got_res)
    # full SA: one routed gather
    rfull = dataclasses.replace(fm, sa_full=Routed.split(fm.sa_full,
                                                         [CPU] * 3))
    got_loc, got_res = sa_resolve(rfull, k, act)
    assert torch.equal(got_loc, fm.sa_full[k].to(torch.int64))
    assert bool(got_res.all())


def _chain_batch(seed, codes, B=256, bucket=128):
    """Reads of 100 bases: exact, SNP (fast with a mismatch) and 2-bp
    deletions, as tests/test_mesh.py:195 makes them."""
    rng = np.random.default_rng(seed)
    mat = np.zeros((B, bucket), np.uint8)
    rlens = np.full(B, 100, np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(codes) - 102))
        r = codes[p:p + 100].copy()
        if i % 3 == 1:
            r[33] = (r[33] + 1) % 4
        if i % 9 == 4:
            r = np.concatenate([r[:50], codes[p + 52:p + 102]])[:100]
        mat[i, :100] = r
    return mat, rlens, _pack(mat)


@pytest.fixture(scope="module")
def repeat_genome():
    """30 kb with a 400-bp repeat (slow reads with several hits), its
    index built by the reference package; a batch of 256 reads; the
    one-device outputs of the reference's backend."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=30000).astype(np.uint8)
    codes[20000:20400] = codes[5000:5400]
    idx = _index(codes)
    mat, rlens, packed = _chain_batch(21, codes)
    cfg = JaxConfig(sam_file="x", vcf_file="v", log_file="l")
    be = JaxBackend(idx, cfg)
    want = be.collect_chain(be.submit_chain(packed, rlens, 128), 256,
                            lambda i: mat[i, :100])
    return idx, mat, rlens, packed, want


def _port_chain(idx, packed, rlens, mat, shards, tier=2):
    cfg = Config(device="cpu", index_shards=shards, prefix_skip_k=6)
    be = DeviceBackend(idx, cfg)
    out = be.collect_chain(be.submit_chain(packed, rlens, 128, tier),
                           packed.shape[0], lambda i: mat[i, :100])
    return be, out


@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_chain_equals_reference(repeat_genome, n):
    """submit_chain / collect_chain with index_shards = n: the port's
    sharded chain stage (n CPU shards, n x B/n reads, the 256-read batch
    padded to 96 x 3 for n = 3) against the reference's sharded backend
    on n mesh devices, its one-device backend and the port's one device,
    in every output; slow reads with several hits each, whose hits the
    port packs shard by shard in hit order and the reference sorts by
    read on the host (template tests/test_mesh.py:195)."""
    idx, mat, rlens, packed, want = repeat_genome
    jcfg = JaxConfig(sam_file="x", vcf_file="v", log_file="l",
                     index_shards=n)
    jbe = JaxBackend(idx, jcfg)
    jout = jbe.collect_chain(jbe.submit_chain(packed, rlens, 128), 256,
                             lambda i: mat[i, :100])
    assert jbe.sharded_invocations > 0
    ck.STATS.reset()
    ssd.STATS.reset()
    be, out = _port_chain(idx, packed, rlens, mat, n)
    _, one = _port_chain(idx, packed, rlens, mat, 0)
    assert be.sharded_invocations == 1 and be.shard_devs == [CPU] * n
    assert not ck.STATS.launches and not ssd.STATS.launches
    for a, b, c, d, name in zip(out, jout, want, one, OUT):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
        assert np.array_equal(np.asarray(a), np.asarray(c)), name
        assert np.array_equal(np.asarray(a), np.asarray(d)), name
    counts = np.asarray(out[5])
    assert (counts >= 2).sum() >= 5             # several slow hits a read


def test_sharded_tier_rerun(repeat_genome):
    """A hit-buffer overflow on the sharded path reruns the sharded stage
    at tier 18 (the backend rebuilds it by its key), with the one-device
    rerun's outputs (template tests/test_mesh.py:373)."""
    rng = np.random.default_rng(47)
    unit = rng.integers(0, 4, 400).astype(np.uint8)
    genome = np.concatenate([rng.integers(0, 4, 3000).astype(np.uint8),
                             unit, unit, unit, unit,
                             rng.integers(0, 4, 3000).astype(np.uint8)])
    idx = _index(genome)
    B = 256
    mat = np.zeros((B, 128), np.uint8)
    rlens = np.full(B, 100, np.int32)
    for i in range(B):
        p = int(rng.integers(3000, 3000 + 4 * 400 - 100))
        mat[i, :100] = genome[p:p + 100]
    packed = _pack(mat)
    jbe = JaxBackend(idx, JaxConfig(sam_file="x", vcf_file="v",
                                    log_file="l", index_shards=8))
    jout = jbe.collect_chain(jbe.submit_chain(packed, rlens, 128), B,
                             lambda i: mat[i, :100])
    outs = []
    for shards in (0, 8):
        be, out = _port_chain(idx, packed, rlens, mat, shards)
        assert be.n_tier_reruns >= 1 or be.n_full_fallbacks >= 1
        outs.append(out)
    assert ("schain", 128, 18, B) in be._kernels
    assert be.sharded_invocations == 1
    for a, b, c, name in zip(outs[1], outs[0], jout, OUT):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
        assert np.array_equal(np.asarray(a), np.asarray(c)), name


def test_sharded_chain_sampled_sa_walk():
    """Without the full SA the sharded chain stage walks inverse-Psi over
    the sharded occ4 rows and sampled SA: equal to the single-card
    kernel's walk in every output, the overflow flags included
    (template tests/test_mesh.py:290)."""
    rng = np.random.default_rng(43)
    codes = rng.integers(0, 4, size=24000).astype(np.uint8)
    idx = _index(codes)
    fm = DeviceFMIndex.from_host(idx, device=CPU)
    fm3 = DeviceFM3.from_host(idx, fm, pfx_k=0)
    fm_s = dataclasses.replace(fm, sa_full=fm.sa_full[:0])
    fm3_s = dataclasses.replace(fm3, fm=fm_s)
    ctx = ChainCtx.from_host(idx, device=CPU)
    B, bucket, n = 128, 128, 4
    mat = np.zeros((B, bucket), np.uint8)
    rlens = np.full(B, 100, np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(codes) - 100))
        r = codes[p:p + 100].copy()
        if i % 4 == 1:
            r[25] = (r[25] + 1) % 4
        mat[i, :100] = r
    pk, rl = torch.from_numpy(_pack(mat)), torch.from_numpy(rlens)
    single = build_seed_chain_kernel(fm3_s, ctx, bucket, B)
    want = single.collect(single(pk, rl)[0])
    devs = [CPU] * n
    sfm3s = shard_index(fm3_s, devs)
    assert not sfm3s[CPU].fm.has_full_sa
    assert isinstance(sfm3s[CPU].fm.occ_rows, Routed)
    kern = ShardedChainKernel(sfm3s, replicate_ctx(ctx, devs), devs,
                              bucket, B)
    got = kern.collect(kern(pk, rl)[0])
    for a, b in zip(got[:10], want[:10]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert got[10] == want[10]


def _jax_sharded_stream(jidx, f1, f2, d, shards):
    """The reference package's stream with index_shards on its virtual
    mesh -> (SAM body lines, VCF lines without ##, sharded dispatches)."""
    from mapcaller_tpu.pipeline.engine import MappingEngine as JaxEngine
    from mapcaller_tpu.pipeline.stream import run_stream_mapping
    from mapcaller_tpu.runner import run_calling
    cfg = JaxConfig(sam_file=str(d / "jax.sam"), vcf_file=str(d / "jax.vcf"),
                    log_file=str(d / "jax.log"), index_shards=shards,
                    batch_size=256, stream_batch_size=256, max_read_len=128)
    be = JaxBackend(jidx, cfg)
    engine = JaxEngine(jidx, cfg, backend=be)
    cfg.read_files1, cfg.read_files2 = [f1], [f2]
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    engine.finalize()
    run_calling(engine, cfg, "test-shards")
    with open(cfg.vcf_file) as f:
        vcf = [ln for ln in f.read().splitlines() if not ln.startswith("##")]
    return "".join(parts).splitlines(), vcf, be.sharded_invocations


def test_sharded_stream_equals_one_device(tmp_path):
    """The full stream with -shards 3 (three CPU shards, through the
    runner) writes the one-device SAM and VCF bytes and the reference
    package's index_shards=3 bytes, with the evidence planes fed by the
    sharded stage's pd and mmp; every batch went through the sharded
    stage, on both sides."""
    jidx, f1, f2 = _make_dataset(tmp_path, n_pairs=600, dup_block=8)
    prefix = str(tmp_path / "idx")
    jidx.save(prefix)
    jsam, jvcf, jinv = _jax_sharded_stream(jidx, f1, f2, tmp_path, 3)
    assert jinv > 0
    made = []
    orig = runner.make_engine

    def spy(idx, cfg):
        made.append(orig(idx, cfg))
        return made[-1]

    res = []
    for shards in (0, 3):
        cfg = Config(device="cpu", index_prefix=prefix, read_files1=[f1],
                     read_files2=[f2], index_shards=shards,
                     batch_size=256, stream_batch_size=256, max_read_len=128,
                     sam_file=str(tmp_path / f"s{shards}.sam"),
                     vcf_file=str(tmp_path / f"s{shards}.vcf"),
                     log_file=str(tmp_path / f"s{shards}.log"))
        runner.make_engine = spy
        try:
            assert runner.run_pipeline(cfg, "mapcaller") == 0
        finally:
            runner.make_engine = orig
        with open(cfg.sam_file) as f, open(cfg.vcf_file) as g:
            res.append((f.read(), g.read()))
    be = made[-1].backend
    assert be.index_shards == 3 and be.shard_devs == [CPU] * 3
    assert be.sharded_invocations > 0
    # no batch went through a single-card chain kernel
    assert [k[0] for k in be._kernels] == ["schain"]
    assert res[1] == res[0]
    assert sum(not ln.startswith("#") for ln in res[0][1].splitlines()) >= 3
    assert [ln for ln in res[1][0].splitlines()
            if not ln.startswith("@")] == jsam
    assert [ln for ln in res[1][1].splitlines()
            if not ln.startswith("##")] == jvcf


def test_routed_wrappers_refuse():
    """The routed wrappers refuse what their kernels do not take, on CPU
    tensors too: a prefix-skip table, SA tables that are not routed,
    shards of unequal length; a routed table refuses a kernel's dtype
    or row width on the card (checked before any launch)."""
    codes = np.random.default_rng(3).integers(0, 4, 4000).astype(np.uint8)
    idx = _index(codes)
    fm = DeviceFMIndex.from_host(idx, device=CPU)
    fm3 = DeviceFM3.from_host(idx, fm, pfx_k=0)
    sfm3 = shard_index(fm3, [CPU] * 2)[CPU]
    packed = torch.zeros((32, 32), dtype=torch.uint8)
    rlens = torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="prefix skip"):
        ssd.seed_scan3_routed(dataclasses.replace(sfm3, pfx_base=8),
                              packed, rlens, 128, 9)
    seeds = ssd.seed_scan3_routed(sfm3, packed, rlens, 128, 9)
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], 256)
    with pytest.raises(TypeError, match="routed"):
        ck.chain_hits_routed(fm, scan, *seeds[:5], 256)
    hits = ck.chain_hits_routed(sfm3.fm, scan, *seeds[:5], 256)
    assert not bool(hits.valid.any())          # no read, no hit
    with pytest.raises(ValueError, match="per"):
        Routed([torch.zeros((3, 8)), torch.zeros((2, 8))], 3)
    with pytest.raises(ValueError, match="shard on cpu"):
        sfm3.occ3.check_card("k", torch.device("cuda", 0), torch.int32, 72)
