"""The x64 big-genome path of the port (`big_x64` under `-shards N`:
mapcaller_tpu_torch/parallel/big_index.py, pipeline/big_profile.py and the
64-bit kernels seed_scan3_big, chain_hits_big and chain_classify_pack_big)
on the CPU, where no kernel runs. Held against the reference package's
x64 path on its virtual 8-device CPU mesh (templates:
tests/test_big_index.py, tests/test_big_chain.py) and against the port's
own single-card path:

  * the shard-relative occ3 rows, base counts, int64 SA shards and
    constants, built a shard at a time, against the reference's
    build_occ3_64 and shard_rows;
  * the plain 64-bit scan and hits against build_big_seed_hits_kernel
    with 2, 4 and 8 shards; the plain big_routed_gather3 with base counts
    above 2^31 against the reference's inside jax.enable_x64;
  * submit/collect with 8 shards (pd int64) and a tier rerun against the
    reference's x64 backend and the port's single card; classify with
    int64 locations against int32;
  * the whole stream with big_x64 against the reference's big stream and
    the port's single card in SAM and VCF bytes: the default, -gvcf,
    -monomorphic, -somatic and min_allele_depth=3; the genome-sharded
    plane layout, and no single-card table on the backend;
  * the refusals: a text above 2^31 rows without shards, and the 64-bit
    wrappers given tensors of the wrong dtype or device;
  * a scalar mirror of each 64-bit kernel's thread against its plain
    version, the scan and hits also in coordinates shifted past 2^31 (the
    shards reached through a pointer table with zero shards before them,
    as chip_smoke.py's shifted check places them on the card).

Every comparison is exact: the values are integers."""
import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mapcaller_tpu.config import Config as JaxConfig
from mapcaller_tpu.index.fmindex import build_index
from mapcaller_tpu.index.occ3 import build_occ3_64 as jax_build_occ3_64
from mapcaller_tpu.index.packer import PackedReference
from mapcaller_tpu.ops import chain_device as jcd
from mapcaller_tpu.parallel import big_index as jbig
from mapcaller_tpu.parallel.mesh import make_mesh
from mapcaller_tpu.pipeline.device_backend import DeviceBackend as JaxBackend
from mapcaller_tpu_torch import runner
from mapcaller_tpu_torch.config import Config
from mapcaller_tpu_torch.ops import chain_device as tcd
from mapcaller_tpu_torch.ops import chain_kernels as ck
from mapcaller_tpu_torch.ops import fm_search as tfs
from mapcaller_tpu_torch.ops import seed_scan_device as ssd
from mapcaller_tpu_torch.ops.chain_device import ChainCtx
from mapcaller_tpu_torch.ops.fm3_device import DeviceFM3
from mapcaller_tpu_torch.ops.fm_device import DeviceFMIndex
from mapcaller_tpu_torch.ops.routed import Routed
from mapcaller_tpu_torch.parallel import big_index as tbig
from mapcaller_tpu_torch.pipeline import device_profile
from mapcaller_tpu_torch.pipeline.big_profile import BigDeviceEvidence
from mapcaller_tpu_torch.pipeline.device_backend import DeviceBackend
import test_torch_chain_kernels as tck
import test_torch_seed_scan as tss
from test_devices import _make_dataset

torch.set_num_threads(1)
CPU = torch.device("cpu")
OUT = ("cls", "pd", "mm", "rplast", "cscore", "counts", "rpos", "gpos",
       "slen")
INT64_MAX = 0x7FFFFFFFFFFFFFFF
MAXLEN = 64
S64 = MAXLEN // (tfs.MIN_SEED_LEN + 1) + 2


def _pack(mat):
    packed = np.zeros((mat.shape[0], mat.shape[1] // 4), dtype=np.uint8)
    for j in range(4):
        packed |= (mat[:, j::4] & 3) << (2 * j)
    return packed


def _index(codes, names=("chr1",)):
    lens = [len(codes)] if len(names) == 1 else [len(codes) // 2] * 2
    offs = [0] if len(names) == 1 else [0, len(codes) // 2]
    return build_index(None, packed=PackedReference(list(names), lens, offs,
                                                    codes, []))


def _put(mesh, a, *spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))


def _big(idx, n, chunk_rows=tbig.BUILD_CHUNK_ROWS):
    """The port's x64 tables over n CPU shards."""
    ctx = ChainCtx.from_host(idx, device=CPU)
    return tbig.build_big_index(idx, {CPU: ctx}, [CPU] * n,
                                chunk_rows)[CPU], ctx


@pytest.fixture(scope="module")
def toy():
    """12 kb (the reference's template genome) and 64-base reads from
    it, a third with a substitution."""
    rng = np.random.default_rng(17)
    idx = _index(rng.integers(0, 4, size=12000).astype(np.uint8))
    text = idx.ref.fwd_rc_codes()
    BG = 128
    mat = np.zeros((BG, MAXLEN), dtype=np.uint8)
    rlens = np.full(BG, 60, dtype=np.int32)
    for b in range(BG):
        p = int(rng.integers(0, idx.genome_size - 60))
        r = text[p:p + 60].copy()
        if b % 3 == 0:
            j = int(rng.integers(0, 60))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        mat[b, :60] = r
    return idx, _pack(mat), rlens


# ---- the index --------------------------------------------------------------

@pytest.mark.parametrize("n,chunk_rows", [(2, tbig.BUILD_CHUNK_ROWS),
                                          (3, 7), (8, tbig.BUILD_CHUNK_ROWS)])
def test_big_index_equals_reference(toy, n, chunk_rows):
    """Shard-relative occ3 rows built a shard at a time on the shards (in
    chunks of chunk_rows rows, each continuing the last one's counts)
    equal the reference's build_occ3_64 split by its shard_rows (the
    padded rows zero), base3 its base counts (zero for shards past the
    table), base3x their base tables, c3_first and the constants its;
    absolute = base3[shard] + relative is the port's int32 occ3 table
    (template tests/test_big_index.py:27); the int64 SA shards are the SA
    padded and split along the occ3 rows (16 entries a row)."""
    idx = toy[0]
    bfm, _ = _big(idx, n, chunk_rows)
    text = idx.ref.fwd_rc_codes()
    sa64 = idx.sa_full.astype(np.int64)
    nw3, per, sps = tbig.big_layout(idx.seq_len, n)
    tab = jax_build_occ3_64(sa64, text, words_per_shard=per)
    slices, rps = jbig.shard_rows(tab.rows, n)
    mine, mrps = tbig.shard_rows(np.asarray(tab.rows), n)
    assert bfm.occ3.per == rps == mrps == per and np.array_equal(mine, slices)
    for s in range(n):
        assert np.array_equal(bfm.occ3.shards[s].numpy(), slices[s]), s
    base3 = np.zeros((n, 64), dtype=np.int64)
    base3[:tab.base3.shape[0]] = tab.base3
    assert np.array_equal(bfm.base3.numpy(), base3)
    assert np.array_equal(bfm.base3x.numpy(), _base_table(base3))
    assert np.array_equal(bfm.c3_first.numpy(), tab.c3_first)
    for k in ("row_p1", "row_p2", "t0", "t1", "tail1", "tail2a", "tail2b"):
        assert getattr(bfm, k) == getattr(tab, k), k
    assert bfm.primary == int(idx.primary) and bfm.seq_len == idx.seq_len
    flat = DeviceFM3.from_host(idx, DeviceFMIndex.from_host(idx, device=CPU),
                               pfx_k=0).occ3_rows.numpy()
    rel = np.concatenate([t.numpy() for t in bfm.occ3.shards])[:nw3]
    shard = np.arange(nw3) // per
    assert np.array_equal(bfm.base3.numpy()[shard] + rel[:, :64], flat[:, :64])
    assert np.array_equal(rel[:, 64:], flat[:, 64:])
    sa = np.concatenate([t.numpy() for t in bfm.sa.shards])
    assert bfm.sa.per == sps and sa.shape[0] == n * sps
    n_sa = sa64.shape[0]
    assert np.array_equal(sa[:n_sa], sa64) and not sa[n_sa:].any()


# ---- the scan and the hits --------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_big_scan_hits_equal_reference(toy, n):
    """The plain 64-bit scan and hits of each shard's reads (seed_scan3_big
    and chain_hits_big on CPU tensors: int64 state, shard-relative rows
    plus base3, the int64 SA routed) against the reference's
    build_big_seed_hits_kernel on n mesh devices (template
    tests/test_big_index.py:48) and the unrouted int32 scan."""
    idx, packed, rlens = toy
    B = packed.shape[0] // n
    bfm, _ = _big(idx, n)
    mesh = make_mesh(n)
    text = idx.ref.fwd_rc_codes()
    sa64 = idx.sa_full.astype(np.int64)
    nw3, per, _ = tbig.big_layout(idx.seq_len, n)
    tab = jax_build_occ3_64(sa64, text, words_per_shard=per)
    occ, _ = jbig.shard_rows(tab.rows, n)
    base3 = np.zeros((n, 64), dtype=np.int64)
    base3[:tab.base3.shape[0]] = tab.base3
    sas, _ = jbig.shard_rows(sa64, n)
    statics = dict(primary=int(idx.primary), row_p1=tab.row_p1,
                   row_p2=tab.row_p2, t0=tab.t0, t1=tab.t1, tail1=tab.tail1,
                   tail2a=tab.tail2a, tail2b=tab.tail2b)
    with jax.enable_x64(True):
        fn = jbig.build_big_seed_hits_kernel(mesh, n, MAXLEN, B, statics)
        want = [np.asarray(x) for x in jax.device_get(fn(
            _put(mesh, occ, "dp", None, None), _put(mesh, base3, None, None),
            _put(mesh, tab.c3_first, None),
            _put(mesh, np.asarray(idx.L2, np.int64), None),
            _put(mesh, sas, "dp", None), _put(mesh, packed, "dp", None),
            _put(mesh, rlens, "dp")))]
    flat3 = DeviceFM3.from_host(idx, DeviceFMIndex.from_host(idx, device=CPU),
                                pfx_k=0)
    H = 4 * B
    ssd.STATS.reset()
    ck.STATS.reset()
    for s in range(n):
        sl = slice(s * B, (s + 1) * B)
        pk, rl = torch.from_numpy(packed[sl]), torch.from_numpy(rlens[sl])
        seeds = ssd.seed_scan3_big(bfm, pk, rl, MAXLEN, S64)
        flat = ssd.seed_scan3(flat3, pk, rl, MAXLEN, S64)
        for k, (g, w, f) in enumerate(zip(seeds, want[:6], flat)):
            assert np.array_equal(g.numpy(), w[sl].astype(g.numpy().dtype)), k
            assert torch.equal(g, f), k
        scan = ck.chain_scan_seeds(seeds[4], seeds[0], H)
        hits = ck.chain_hits_big(bfm, scan, *seeds[:5], H)
        assert hits.loc.dtype == torch.int64
        hs = slice(s * H, (s + 1) * H)
        hit_read, hit_rpos, hit_len, hit_loc, hit_valid = want[6:11]
        valid = hits.valid.numpy()
        assert np.array_equal(valid, hit_valid[hs])
        assert np.array_equal(hits.read.numpy()[valid] + s * B,
                              hit_read[hs][valid])
        for got, w in ((hits.rpos, hit_rpos), (hits.len, hit_len),
                       (hits.loc, hit_loc)):
            assert np.array_equal(got.numpy()[valid], w[hs][valid])
        assert not hits.unresolved.any()
    assert not ssd.STATS.launches and not ck.STATS.launches
    assert int(want[0].sum()) > packed.shape[0] // 2


def test_big_gather_above_2_31(toy):
    """The plain big_routed_gather3 over synthetic rows whose base counts
    pass 2^31 (up to 2^40) against the reference's big_routed_gather3 in
    jax.enable_x64 on 8 mesh devices: every query's int64 counts, symbol
    bytes and in-row offset, at and around each shard edge, past the
    table (zero rows plus the last shard's base) and at random."""
    n, per = 8, 5
    rng = np.random.default_rng(40)
    rows = rng.integers(0, 1 << 20, size=(n * per, 72)).astype(np.int32)
    base3 = rng.integers(1 << 31, 1 << 40, size=(n, 64)).astype(np.int64)
    edges = sorted({w for s in range(1, n) for w in (s * per - 1, s * per)}
                   | {0, n * per - 1, n * per, n * per + 3})
    w = np.concatenate([np.array(edges), rng.integers(0, n * per, 64 - len(
        edges))]).astype(np.int64)
    i = (w << 4) | rng.integers(0, 16, size=w.size)
    mesh = make_mesh(n)

    def device_fn(occ_local, b3, q):
        bfm = jbig.BigShardedFM3(
            occ3_local=occ_local[0], base3=b3, c3_first=b3[0], L2=b3[0, :5],
            rows_per_shard=per, n_shards=n, primary=0, row_p1=0, row_p2=0,
            t0=0, t1=0, tail1=0, tail2a=0, tail2b=0)
        return jbig.big_routed_gather3(bfm, q)

    with jax.enable_x64(True):
        fn = jax.jit(jax.shard_map(
            device_fn, mesh=mesh,
            in_specs=(P("dp", None, None), P(None, None), P("dp")),
            out_specs=(P("dp", None), P("dp", None), P("dp"))))
        want = [np.asarray(x) for x in jax.device_get(fn(
            _put(mesh, rows.reshape(n, per, 72), "dp", None, None),
            _put(mesh, base3, None, None), _put(mesh, i, "dp")))]
    bfm = types.SimpleNamespace(
        occ3=Routed([torch.from_numpy(rows[s * per:(s + 1) * per])
                     for s in range(n)], per),
        base3=torch.from_numpy(base3))
    got = tbig.big_routed_gather3(bfm, torch.from_numpy(i))
    assert want[0].dtype == np.int64 and (want[0] >= 1 << 31).all()
    for g, wnt in zip(got, want):
        assert np.array_equal(g.numpy(), wnt.astype(np.int64))


# ---- the chain stage --------------------------------------------------------

def _chain_batch(seed, codes, B=256, bucket=128):
    """Reads of 100 bases: exact, SNP (fast with a mismatch) and 2-bp
    deletions, as tests/test_big_chain.py:37 makes them."""
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


def _chain(idx, packed, rlens, mat, shards=0, big=False, jax_side=False):
    """collect_chain of one batch by the reference's backend (jax_side)
    or the port's -> (outputs, backend, token)."""
    if jax_side:
        be = JaxBackend(idx, JaxConfig(sam_file="x", vcf_file="v",
                                       log_file="l", index_shards=shards,
                                       big_x64=big))
    else:
        be = DeviceBackend(idx, Config(device="cpu", index_shards=shards,
                                       big_x64=big, prefix_skip_k=6))
    tok = be.submit_chain(packed, rlens, 128)
    out = be.collect_chain(tok, packed.shape[0], lambda i: mat[i, :100])
    return out, be, tok


def test_big_chain_equals_reference():
    """submit_chain / collect_chain with big_x64 and 8 shards: every
    output equal to the reference's x64 backend on 8 mesh devices and to
    the port's single card (template tests/test_big_chain.py:28); pd is
    int64 in the token and the outputs; slow reads with several hits
    (packed shard by shard in hit order, the reference sorts by read);
    no single-card table is built and only the 64-bit kernels' plain
    versions ran (no launch on the CPU)."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=30000).astype(np.uint8)
    codes[20000:20400] = codes[5000:5400]
    idx = _index(codes)
    mat, rlens, packed = _chain_batch(21, codes)
    want, jbe, _ = _chain(idx, packed, rlens, mat, 8, True, jax_side=True)
    assert jbe.big_x64 and jbe.sharded_invocations == 1
    one, _, _ = _chain(idx, packed, rlens, mat)
    ssd.STATS.reset()
    ck.STATS.reset()
    got, be, tok = _chain(idx, packed, rlens, mat, 8, True)
    assert be.big and be.sharded_invocations == 1
    assert be.fm is None and be._fm3 is None and be._sharded is None
    assert tok.pd.dtype == torch.int64 and got[1].dtype == np.int64
    assert not ssd.STATS.launches and not ck.STATS.launches
    for a, b, c, name in zip(got, want, one, OUT):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
        assert np.array_equal(np.asarray(a), np.asarray(c)), name
    assert (np.asarray(got[5]) >= 2).sum() >= 5


def test_big_tier_rerun():
    """A hit-buffer overflow on the x64 path reruns its sharded stage at
    tier 18, with the single card's and the reference's x64 outputs."""
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
    want, _, _ = _chain(idx, packed, rlens, mat, 8, True, jax_side=True)
    one, _, _ = _chain(idx, packed, rlens, mat)
    got, be, _ = _chain(idx, packed, rlens, mat, 8, True)
    assert be.n_tier_reruns >= 1 or be.n_full_fallbacks >= 1
    assert ("schain", 128, 18, B) in be._kernels
    for a, b, c, name in zip(got, one, want, OUT):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
        assert np.array_equal(np.asarray(a), np.asarray(c)), name


def test_classify_int64_matches_int32():
    """classify_reads is dtype-generic (template tests/test_big_chain.py:
    112): int64 hit locations classify as int32 ones do; the diagonal of
    a read without kept hits is the dtype's largest value, as the
    reference's with int64 in jax.enable_x64; every other output equal."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=4096).astype(np.uint8)
    idx = _index(codes)
    ctx = ChainCtx.from_host(idx, device=CPU)
    jctx = jcd.ChainCtx.from_host(idx)
    Bn, rlen, max_len = 32, 100, 128
    mat = np.zeros((Bn, max_len), np.uint8)
    locs = []
    for i in range(Bn):
        p = int(rng.integers(0, len(codes) - rlen))
        mat[i, :rlen] = codes[p:p + rlen]
        if i % 2:
            mat[i, 40] = (mat[i, 40] + 1) % 4
        locs.append(p)
    words = ck.read_words_bwa(torch.from_numpy(_pack(mat)), max_len)
    rl = torch.full((Bn,), rlen, dtype=torch.int64)
    hr = torch.arange(Bn, dtype=torch.int64)
    rp = torch.zeros(Bn, dtype=torch.int64)
    hl = torch.full((Bn,), 30, dtype=torch.int64)
    keep = torch.ones(Bn, dtype=torch.bool)
    keep[5] = False                           # read 5: no kept hit
    res = {dt: tcd.classify_reads(ctx, words, rl, hr, rp, hl,
                                  torch.tensor(locs, dtype=dt), keep,
                                  max_len)
           for dt in (torch.int32, torch.int64)}
    with jax.enable_x64(True):
        jres = jcd.classify_reads(
            jctx, jnp.asarray(words.numpy().astype(np.uint32)),
            jnp.asarray(rl.numpy().astype(np.int32)),
            jnp.asarray(hr.numpy().astype(np.int32)),
            jnp.asarray(rp.numpy().astype(np.int32)),
            jnp.asarray(hl.numpy().astype(np.int32)),
            jnp.asarray(np.asarray(locs, np.int64)),
            jnp.asarray(keep.numpy()), max_len)
    assert int(res[torch.int32][1][5]) == tcd.INT32_MAX
    assert int(res[torch.int64][1][5]) == INT64_MAX
    assert np.asarray(jres[1]).dtype == np.int64
    for k, name in enumerate(("cls", "pd", "mm", "rplast", "cscore", "mmp")):
        a, b = res[torch.int32][k].numpy(), res[torch.int64][k].numpy()
        sel = np.arange(Bn) != 5 if name == "pd" else slice(None)
        assert np.array_equal(a[sel], b[sel]), name
        assert np.array_equal(b, np.asarray(jres[k]).astype(np.int64)), name
    assert (res[torch.int64][0].numpy() == tcd.CLASS_FAST).sum() >= Bn // 4


# ---- the stream and the sharded planes --------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_big")
    jidx, f1, f2 = _make_dataset(d, n_pairs=600, dup_block=8)
    prefix = str(d / "idx")
    jidx.save(prefix)
    return d, jidx, f1, f2, prefix


STREAM = dict(batch_size=256, stream_batch_size=256, max_read_len=128)


def _jax_stream(jidx, f1, f2, d, tag, **kw):
    """The reference's stream with big_x64 and 8 shards on its mesh ->
    (SAM body lines, VCF lines without ##, its evidence)."""
    from mapcaller_tpu.pipeline.engine import MappingEngine as JaxEngine
    from mapcaller_tpu.pipeline.stream import run_stream_mapping
    from mapcaller_tpu.runner import run_calling
    cfg = JaxConfig(sam_file=str(d / f"j{tag}.sam"),
                    vcf_file=str(d / f"j{tag}.vcf"),
                    log_file=str(d / f"j{tag}.log"), index_shards=8,
                    big_x64=True, **STREAM, **kw)
    be = JaxBackend(jidx, cfg)
    engine = JaxEngine(jidx, cfg, backend=be)
    cfg.read_files1, cfg.read_files2 = [f1], [f2]
    parts = []
    run_stream_mapping(engine, cfg, time.time(), parts.append)
    engine.finalize()
    run_calling(engine, cfg, "test-big")
    with open(cfg.vcf_file) as f:
        vcf = [ln for ln in f.read().splitlines() if not ln.startswith("##")]
    assert be.big_x64 and be.sharded_invocations > 0
    return "".join(parts).splitlines(), vcf


def _port_stream(dataset, tag, shards=0, big=False, **kw):
    """The port's stream through the runner -> (SAM, VCF text, backend,
    evidence)."""
    d, _, f1, f2, prefix = dataset
    made, evs = [], []
    make_engine = runner.make_engine
    make_ev = device_profile.make_device_evidence

    def spy_engine(idx, cfg):
        made.append(make_engine(idx, cfg))
        return made[-1]

    def spy_ev(*a):
        evs.append(make_ev(*a))
        return evs[-1]

    cfg = Config(device="cpu", index_prefix=prefix, read_files1=[f1],
                 read_files2=[f2], index_shards=shards, big_x64=big,
                 sam_file=str(d / f"{tag}.sam"),
                 vcf_file=str(d / f"{tag}.vcf"),
                 log_file=str(d / f"{tag}.log"), **STREAM, **kw)
    runner.make_engine = spy_engine
    device_profile.make_device_evidence = spy_ev
    try:
        assert runner.run_pipeline(cfg, "mapcaller") == 0
    finally:
        runner.make_engine = make_engine
        device_profile.make_device_evidence = make_ev
    with open(cfg.sam_file) as f, open(cfg.vcf_file) as g:
        return f.read(), g.read(), made[-1].backend, evs[-1]


MODES = {"default": {}, "gvcf": dict(gvcf=True),
         "monomorphic": dict(monomorphic=True), "somatic": dict(somatic=True),
         "ad3": dict(min_allele_depth=3)}


@pytest.mark.parametrize("mode", list(MODES))
def test_big_stream_equals_reference(dataset, mode):
    """The whole stream with big_x64 and 8 shards (the chain stage on the
    64-bit plain versions, the evidence on genome-sharded planes: apply,
    merge, finalize with carries, the scan across seams, fetch, NOR and
    the plane download) writes the reference's big-stream bytes on its
    8-device mesh (templates tests/test_big_chain.py:73, :206; its goldens
    need the toy genome, so the reference runs here) and the port's
    single-card bytes, in each calling mode."""
    d, jidx, f1, f2, _ = dataset
    kw = MODES[mode]
    jsam, jvcf = _jax_stream(jidx, f1, f2, d, mode, **kw)
    sam, vcf, be, ev = _port_stream(dataset, f"big_{mode}", 8, True, **kw)
    one = _port_stream(dataset, f"one_{mode}", **kw)
    assert be.big and be.sharded_invocations > 0
    assert isinstance(ev, BigDeviceEvidence)
    assert {k[0] for k in be._kernels} == {"schain"}
    assert (sam, vcf) == one[:2]
    assert [ln for ln in sam.splitlines() if not ln.startswith("@")] == jsam
    assert [ln for ln in vcf.splitlines() if not ln.startswith("##")] == jvcf
    assert sum(not ln.startswith("#") for ln in vcf.splitlines()) >= 3


def test_big_planes_layout(dataset):
    """The memory contract of the x64 path (template
    tests/test_big_chain.py:219): every plane is split along the genome,
    Pl a multiple of 400 and Pg = n Pl >= L + 2, each shard holding
    [.., Pl] of each plane and of each finalize output; the backend holds
    no single-card table (no 1-step rows, int32 occ3 table or whole SA)
    and its shards hold 1/n of the occ3 rows and of the SA."""
    _, _, be, ev = _port_stream(dataset, "layout", 4, True)
    n, L = 4, ev.L
    assert ev.n == n and ev.Pl % 400 == 0 and ev.Pg == n * ev.Pl
    assert ev.Pg >= L + 2 and (n - 1) * ev.Pl < L + 2
    assert [sp.off for sp in ev.planes] == [s * ev.Pl for s in range(n)]
    for sp in ev.planes:
        assert sp.acgt.shape == sp.f_diff.shape == (4, ev.Pl)
        assert sp.exact_diff.shape == sp.multi_diff.shape == (ev.Pl,)
    outs, tots = ev.finalize()
    assert len(outs) == n and tots.shape == (n,)
    for acgt, F, multi, cov, ccov in outs:
        assert acgt.shape == F.shape == (4, ev.Pl)
        assert multi.shape == cov.shape == ccov.shape == (ev.Pl,)
        assert ccov.dtype == torch.int64
    assert be.fm is None and be._fm3 is None and be._sharded is None
    bfm = next(iter(be._big[0].values()))
    nw3, per, sps = tbig.big_layout(be.idx.seq_len, n)
    assert bfm.occ3.per == per and bfm.sa.per == sps
    assert all(t.shape == (per, 72) for t in bfm.occ3.shards)
    assert all(t.shape == (sps,) for t in bfm.sa.shards)
    assert n * sps >= be.idx.seq_len + 1 and (n - 1) * per < nw3


# ---- refusals ---------------------------------------------------------------

def test_big_text_without_shards_raises():
    """A text of 2^31 rows or more raises without -shards, with the
    reference's message, before any table is built (the reference builds
    its single-chip index first, mapcaller_tpu/pipeline/device_backend.py:
    30 against :84-87; the stub index has no tables to build)."""
    stub = types.SimpleNamespace(seq_len=1 << 31, sa_full=None)
    for kw in (dict(), dict(big_x64=True), dict(big_x64=True,
                                                 index_shards=1)):
        with pytest.raises(ValueError, match="exceeds 2\\^31 rows; run with "
                                             "-shards N"):
            DeviceBackend(stub, Config(device="cpu", **kw))


def _valid_big(toy, n=2):
    idx, packed, rlens = toy
    bfm, ctx = _big(idx, n)
    pk, rl = torch.from_numpy(packed[:64]), torch.from_numpy(rlens[:64])
    seeds = ssd.seed_scan3_big(bfm, pk, rl, MAXLEN, S64)
    scan = ck.chain_scan_seeds(seeds[4], seeds[0], 256)
    hits = ck.chain_hits_big(bfm, scan, *seeds[:5], 256)
    n32, n64 = ck.big_out_sizes(64, 32)
    return dict(bfm=bfm, ctx=ctx, pk=pk, rl=rl, seeds=seeds, scan=scan,
                hits=hits, out=torch.empty(n32, dtype=torch.int32),
                wide=torch.empty(n64, dtype=torch.int64))


def _call(which, a):
    if which == "scan":
        return ssd.seed_scan3_big(a["bfm"], a["pk"], a["rl"], MAXLEN, S64)
    if which == "hits":
        return ck.chain_hits_big(a["bfm"], a["scan"], *a["seeds"][:5], 256)
    return ck.chain_classify_pack_big(
        a["ctx"], a["pk"], a["rl"], a["scan"].off, a["hits"], a["seeds"][5],
        MAXLEN, a["out"], a["wide"], 32)


@pytest.mark.parametrize("which,bad,exc,match", [
    ("scan", "rlens_int64", TypeError, "rlens int32"),
    ("scan", "meta_device", ValueError, "unsupported device"),
    ("hits", "sa_not_routed", TypeError, "routed"),
    ("hits", "meta_device", ValueError, "unsupported device"),
    ("classify", "loc_int32", TypeError, "hits.loc must be torch.int64"),
    ("classify", "wide_int32", TypeError, "wide must be torch.int64"),
    ("classify", "meta_device", ValueError, "several devices")])
def test_big_wrappers_refuse(toy, which, bad, exc, match):
    """The 64-bit wrappers refuse a wrong dtype, an SA that is not routed
    and a device that is neither the CPU nor a card, before any launch."""
    a = _valid_big(toy)
    if bad == "rlens_int64":
        a["rl"] = a["rl"].to(torch.int64)
    elif bad == "sa_not_routed":
        a["bfm"] = dataclasses.replace(a["bfm"], sa=a["bfm"].sa.shards[0])
    elif bad == "loc_int32":
        a["hits"] = a["hits"]._replace(loc=a["hits"].loc.to(torch.int32))
    elif bad == "wide_int32":
        a["wide"] = a["wide"].to(torch.int32)
    elif which == "scan":
        a["pk"], a["rl"] = a["pk"].to("meta"), a["rl"].to("meta")
    elif which == "hits":
        a["seeds"] = tuple(t.to("meta") for t in a["seeds"])
        a["scan"] = ck.SeedScan(*(t.to("meta") for t in a["scan"]))
    else:
        a["out"], a["wide"] = a["out"].to("meta"), a["wide"].to("meta")
    with pytest.raises(exc, match=match):
        _call(which, a)


# ---- scalar mirrors of the 64-bit kernels' threads --------------------------

def _base_table(base3):
    """A shard's base table as csrc/seed_scan.cu reads it (numpy, by its
    definition): the 64 base counts, at 64 + w the sum of those with
    rev3(d) < w (w in 0..64), at 132 + c the sum of those with d & 3 == c."""
    out = np.zeros((base3.shape[0], tbig.B3X), dtype=np.int64)
    out[:, :64] = base3
    for w in range(65):
        out[:, tbig.B3X_REV + w] = base3[:, tss.REV3 < w].sum(axis=1)
    for c in range(4):
        out[:, tbig.B3X_GRP + c] = base3[:, c::4].sum(axis=1)
    return out


class _Shards64:
    """The 64-bit kernels' routed reads: entry r of a table from pointer
    table entry r // per at local entry r - s * per, and its shard's base
    table row; `lead` entries before the real shards point at zeros (the
    shifted placement: the text as if it began lead * rows-a-shard rows
    later) and count their reads."""

    def __init__(self, shards, per, base3x=None, lead=0):
        self.shards, self.per, self.lead = shards, per, lead
        self.base3x = base3x
        self.shape = ((lead + len(shards)) * per,)
        self.lead_reads = 0

    def entry(self, r):
        s = r // self.per
        if s < self.lead:
            self.lead_reads += 1
            return None, s
        return self.shards[s - self.lead][r - s * self.per], s - self.lead

    def row3(self, i):
        """ShardRows64 at occ3 index i: (the row's relative counts, its
        symbols, m, its shard's base table row)."""
        row, s = self.entry(i >> 4)
        if row is None:
            z = np.zeros(tbig.B3X, np.int64)
            return z[:64], np.zeros(16, np.int64), i & 15, z
        return (row[:64].astype(np.int64),
                np.ascontiguousarray(row[64:68]).view(np.uint8).astype(
                    np.int64), i & 15, self.base3x[s])

    def __getitem__(self, r):            # RoutedSa64.sa
        row, _ = self.entry(int(r))
        return 0 if row is None else int(row)


def mirror_scan3_big(rows, k, packed, rlens, max_len, S):
    """seed_scan3_big_kernel's thread, one read after another: the occ3
    machine of tests/test_torch_seed_scan.py's mirror_scan3 without the
    prefix skip, each row from rows.row3 (its shard-relative counts, and
    its shard's base table: the base count, the base's rev3 order sum and
    group sums, one entry each), the state and row indices unbounded
    integers (int64 on the card).
    k: the constants (L2, c3_first, primary, row_p1, row_p2, t0, t1,
    tail1, tail2a, tail2b)."""
    def sums3(i, d, w):
        cnt, syms, m, b = rows.row3(i)
        base = int(cnt[d]) + int(b[d])
        rs = int(cnt[tss.REV3 < w].sum()) + int(b[tbig.B3X_REV + w])
        for q in range(m):
            sym = int(syms[q])
            base += sym == d
            r3 = 63 - ((sym & 3) * 16 + (sym & 12) + (sym >> 4))
            rs += sym < 64 and r3 < w
        return base, rs

    def occ1_4(i):
        cnt, syms, m, b = rows.row3(i)
        g = [int(cnt[c::4].sum()) + int(b[tbig.B3X_GRP + c])
             for c in range(4)]
        for q in range(m):
            if syms[q] < 64:
                g[int(syms[q]) & 3] += 1
        g[k.t0] += i > k.row_p1
        g[k.t1] += i > k.row_p2
        return g

    all_words = packed.view("<u4")
    cap = tfs.scan3_cap(max_len, S)
    out = tss._Tables(packed.shape[0], S)
    last = max_len - 1
    L2 = k.L2
    for r in range(packed.shape[0]):
        words, rlen, st = all_words[r], int(rlens[r]), tss._state()
        it = 0
        while it < cap:
            if not st["in_ext"]:
                if st["pos"] >= rlen - tss.MIN:
                    break
                c = tss._word_code(words, min(st["pos"], last))
                st.update(x0=L2[c] + 1, x1=L2[3 - c] + 1,
                          x2=L2[c + 1] - L2[c], ext_pos=st["pos"] + 1,
                          start=st["pos"], in_ext=True, replay=False)
            elif st["ext_pos"] >= rlen:
                out.finalize(r, st)
            else:
                ep, x0, x1, x2 = st["ext_pos"], st["x0"], st["x1"], st["x2"]
                e0 = tss._word_code(words, min(ep, last))
                if not st["replay"] and ep + 3 <= rlen:
                    e1 = tss._word_code(words, min(ep + 1, last))
                    e2 = tss._word_code(words, min(ep + 2, last))
                    d = (3 - e2) * 16 + (3 - e1) * 4 + (3 - e0)
                    w = e0 * 16 + e1 * 4 + e2
                    tk, rk = sums3(x1, d, w)
                    tl, rl = sums3(x1 + x2, d, w)
                    st["g"] += 2
                    if tl - tk <= 0:
                        st["replay"] = True
                    else:
                        lo, hi = x1, x1 + x2
                        cmp1 = k.tail1 <= e0
                        cmp2 = (k.tail2a < e0
                                or (k.tail2a == e0 and k.tail2b <= e1))
                        adj = ((lo <= k.primary < hi)
                               + ((lo <= k.row_p1 < hi) and cmp1)
                               + ((lo <= k.row_p2 < hi) and cmp2))
                        st.update(x0=x0 + adj + (rl - rk),
                                  x1=k.c3_first[d] + tk, x2=tl - tk,
                                  ext_pos=ep + 3)
                else:
                    tk, tl = occ1_4(x1), occ1_4(x1 + x2)
                    st["g"] += 2
                    ok2 = [tl[c] - tk[c] for c in range(4)]
                    ci = 3 - e0
                    if ok2[ci] <= 0:
                        out.finalize(r, st)
                    else:
                        adj = x1 <= k.primary and x1 + x2 - 1 >= k.primary
                        st.update(x0=x0 + adj + sum(ok2[ci + 1:]),
                                  x1=L2[ci] + 1 + tk[ci], x2=ok2[ci],
                                  ext_pos=ep + 1)
            it += 1
        out.store(r, st, it)
    return out.result()


def _consts(bfm, shift=0):
    """The 64-bit scan's constants, every row index moved by shift."""
    return types.SimpleNamespace(
        L2=[int(x) + shift for x in bfm.L2.numpy()],
        c3_first=[int(x) + shift for x in bfm.c3_first.numpy()],
        primary=bfm.primary + shift, row_p1=bfm.row_p1 + shift,
        row_p2=bfm.row_p2 + shift, t0=bfm.t0, t1=bfm.t1, tail1=bfm.tail1,
        tail2a=bfm.tail2a, tail2b=bfm.tail2b)


@pytest.fixture(scope="module")
def mirror_case():
    """3 shards of a 12 kb genome with a 300-bp repeat, 128 reads of 60
    bases (from the repeat: SLOW reads with several hits; with a 2-bp
    deletion; with a substitution) scanned by the plain 64-bit scan (with
    its step and row counts), and the lead shards of a shift past 2^31:
    C = the least multiple of 16 per (a shard's rows of text) at or above
    2^31."""
    rng = np.random.default_rng(19)
    codes = rng.integers(0, 4, size=12000).astype(np.uint8)
    codes[8000:8300] = codes[2000:2300]
    idx = _index(codes)
    mat = np.zeros((128, MAXLEN), dtype=np.uint8)
    for b in range(128):
        p = int(rng.integers(2000, 2200) if b % 4 == 0
                else rng.integers(0, len(codes) - 64))
        r = codes[p:p + 62].copy()
        if b % 4 == 1:
            r = np.concatenate([r[:30], r[32:62]])
        elif b % 4 == 2:
            r[25] = (r[25] + 1) % 4
        mat[b, :60] = r[:60]
    packed, rlens = _pack(mat), np.full(128, 60, dtype=np.int32)
    bfm, ctx = _big(idx, 3)
    pk, rl = torch.from_numpy(packed), torch.from_numpy(rlens)
    plain = ssd.seed_scan3_big_plain(bfm, pk, rl, MAXLEN, S64,
                                     with_iters=True)
    lead = -(-(1 << 31) // (16 * bfm.occ3.per))
    return dict(bfm=bfm, ctx=ctx, pk=pk, rl=rl, packed=packed, rlens=rlens,
                plain=plain, lead=lead, C=lead * 16 * bfm.occ3.per)


@pytest.mark.parametrize("shifted, G, max_seeds", [
    (False, 0, None), (True, 0, None), (False, 8, None), (True, 16, 1),
    (False, 32, None)],
    ids=["False", "True", "False-G8", "True-G16-overflow", "False-G32"])
def test_scan3_big_mirror_equal_plain(mirror_case, shifted, G, max_seeds):
    """The scan kernel's thread over the routed shard-relative rows plus
    base3 equals the plain 64-bit scan in every output, its steps and row
    counts too; placed past 2^31 (rows, L2, c3_first and the correction
    rows moved by C), s_x0 is exactly C more, everything else equal, and
    no row below the shift is read. With G, on the same reads with some
    cut to 0-17 bases and some run to full length (and a seed table of 1
    that overflows), the kernel's lane-group form at G lanes a read
    (tests/test_torch_seed_scan.py mirror_scan3_group: int32 partials of
    the shard-relative rows reduced by the xor-shuffle tree, the base
    counts added after) equals the thread in every output; some of its
    fetches read a shard's first or last row."""
    m = mirror_case
    bfm = m["bfm"]
    C = m["C"] if shifted else 0
    rows = _Shards64([t.numpy() for t in bfm.occ3.shards], bfm.occ3.per,
                     _base_table(bfm.base3.numpy()),
                     lead=m["lead"] if shifted else 0)
    rlens, plain, S = m["rlens"], m["plain"], S64
    if G:
        rlens = rlens.copy()
        rlens[::9] = np.resize([0, 15, 16, 17], len(rlens[::9]))
        rlens[4::7] = MAXLEN
        S = max_seeds or S64
        plain = ssd.seed_scan3_big_plain(bfm, m["pk"], torch.from_numpy(rlens),
                                         MAXLEN, S, with_iters=True)
    k = _consts(bfm, C)
    got = mirror_scan3_big(rows, k, m["packed"], rlens, MAXLEN, S)
    names = tfs._SEED_KEYS + ("iters", "rows")
    assert C == 0 or C >= 1 << 31
    for name, g, w in zip(names, got, plain):
        w = w.numpy().astype(np.int64)
        if name == "s_x0":
            n = plain[0].numpy()
            used = np.arange(S)[None, :] < n[:, None]
            assert np.array_equal(g[used], w[used] + C), name
            assert not g[~used].any()
        else:
            assert np.array_equal(g.astype(np.int64), w), name
    assert rows.lead_reads == 0
    assert int(plain[0].sum()) > 64
    if not G:
        return
    edges = []

    def fetch(i):
        edges.append((i >> 4) % rows.per in (0, rows.per - 1))
        return rows.row3(i)

    group = tss.mirror_scan3_group(fetch, k, m["packed"], rlens, MAXLEN, S,
                                   G)
    tss._equal(group, got)
    assert any(edges) and rows.lead_reads == 0
    assert (rlens < tss.MIN).any() and (rlens == MAXLEN).any()
    assert bool(plain[5].any()) == (max_seeds is not None)


@pytest.mark.parametrize("shifted", [False, True])
def test_hits_big_mirror_equal_plain(mirror_case, shifted):
    """The hits kernel's blocks (tests/test_torch_chain_kernels.py's
    mirror_hits) over the routed int64 SA equal chain_hits_big's plain
    version; with the seeds' rows and the SA placed past 2^31 (x0 + C,
    the SA's pointer table after lead zero entries), every valid hit
    equal, its location too. The invalid slots read row 32 (the
    reference's pad row), below the shift: the zero shard, so their
    location is 0 there (nothing reads it: keep and valid are 0), and no
    valid hit reads below the shift."""
    m = mirror_case
    bfm = m["bfm"]
    n_seeds, rpos, slen, x0, freq = m["plain"][:5]
    H = 4 * m["packed"].shape[0]
    scan = ck.chain_scan_seeds_plain(freq, n_seeds, H)
    want = ck.chain_hits_big_plain(bfm, scan.off, n_seeds, rpos, slen, x0,
                                   freq, H)
    C = m["C"] if shifted else 0
    sa = _Shards64([t.numpy() for t in bfm.sa.shards], bfm.sa.per,
                   lead=C // bfm.sa.per)
    tfm = types.SimpleNamespace(
        occ_rows=torch.zeros((1, 8), dtype=torch.int32),
        L2=bfm.L2, sa_samp=torch.zeros(1, dtype=torch.int64),
        sa_full=types.SimpleNamespace(numpy=lambda: sa),
        primary=bfm.primary + C)
    x0n = x0.numpy().astype(object) + C
    got, unres, _ = tck.mirror_hits(
        tfm, scan.off.numpy(), scan.start.numpy(), n_seeds.numpy(),
        rpos.numpy(), slen.numpy(), x0n, freq.numpy(), H)
    valid = want.valid.numpy()
    for f in ("read", "rpos", "len", "loc", "valid", "keep"):
        w = getattr(want, f).numpy().astype(np.int64)
        if f == "loc" and shifted:
            assert not got[f][~valid].any()
            w = np.where(valid, w, 0)
        assert np.array_equal(got[f], w), f
    assert not unres.any()
    assert sa.lead_reads == (int((~valid).sum()) if shifted else 0)
    assert valid.sum() > 100 and (~valid).any()


def test_classify_pack_big_mirror_equal_plain(mirror_case):
    """The classify+pack kernel's tiles, lanes and look-back
    (tests/test_torch_chain_kernels.py's mirror_classify_pack, its empty
    slot INT64_MAX) equal chain_classify_pack_big's plain version: meta1,
    hit_w, the count and overflow words and the totals in the int32
    vector, pd and the packed hits' locations in the int64 side output,
    and mmp; a read without hits keeps INT64_MAX as its pd."""
    m = mirror_case
    bfm, ctx = m["bfm"], m["ctx"]
    n_seeds, rpos, slen, x0, freq, overflow = m["plain"][:6]
    Bn = m["packed"].shape[0]
    H, H2 = 4 * Bn, Bn // 4
    scan = ck.chain_scan_seeds_plain(freq, n_seeds, H)
    hits = ck.chain_hits_big_plain(bfm, scan.off, n_seeds, rpos, slen, x0,
                                   freq, H)
    # read 7 keeps no hit: its pd is the empty slot's
    hits = hits._replace(keep=hits.keep & (hits.read != 7))
    n32, n64 = ck.big_out_sizes(Bn, H2)
    out = torch.full((n32,), -7, dtype=torch.int32)
    wide = torch.full((n64,), -7, dtype=torch.int64)
    mmp = ck.chain_classify_pack_big_plain(ctx, m["pk"], m["rl"], scan.off,
                                           hits, overflow, MAXLEN, out, wide,
                                           H2)
    hd = {f: getattr(hits, f).numpy() for f in ("read", "rpos", "len", "loc",
                                                "valid", "keep")}
    got, gmmp, _ = tck.mirror_classify_pack(
        ctx, m["packed"], m["rlens"], scan.off.numpy(), hd,
        hits.unresolved.numpy(), overflow.numpy(), MAXLEN, H2,
        pd_empty=INT64_MAX)
    o, w = out.numpy().astype(np.int64), wide.numpy()
    tail = Bn // 2 + Bn // 32 + 2              # counts2, overflow, totals
    assert np.array_equal(got[:Bn], o[:Bn])                    # meta1
    assert np.array_equal(got[Bn:2 * Bn], w[:Bn])              # pd
    assert np.array_equal(got[2 * Bn:2 * Bn + H2], o[Bn:Bn + H2])
    assert np.array_equal(got[2 * Bn + H2:2 * Bn + 2 * H2], w[Bn:])
    assert np.array_equal(got[2 * Bn + 2 * H2:], o[Bn + H2:Bn + H2 + tail])
    assert np.array_equal(gmmp, mmp.numpy())
    assert int(w[7]) == INT64_MAX
    cls = o[:Bn] & 3
    assert (cls == tcd.CLASS_SLOW).any() and (cls == tcd.CLASS_FAST).any()
