"""Device batch runner: seeding + chaining on the card for the stream
mapping engine (PyTorch port of mapcaller_tpu/pipeline/device_backend.py,
with the surface pipeline/stream.py uses).

Runs the seed/chain kernel (ops/fm_search.py) per parsed batch and hands
the classified reads and the slow reads' hits back to the host pipeline;
with device_chain=False the packed seed kernel hands back every kept hit
for host chaining instead (submit_packed / collect_packed), and the
non-native path seeds lists of reads (submit / collect). The occ3 scans
run when the occ3 table fits the card beside the working set and the
index has its full SA, else the 1-step scan over the occ4 rows. With
cfg.index_shards = N > 1 the chain dispatch runs genome-sharded over N
devices (parallel/sharded_index.py): the occ3 rows and the SA in shards,
each device mapping its N-th of a batch with the routed kernels. With
cfg.big_x64 (or a text of 2^31 - 2 rows or more) and N > 1 it runs the
x64 big-genome path (parallel/big_index.py): shard-relative occ3 rows,
an int64 SA in shards and the 64-bit kernels, and no single-card table;
as in the reference, host chaining, the non-native path and an index
without its full SA take the single-card kernels there instead (a text
below 2^31 rows), with the evidence still in the genome-sharded planes.
Reads the fixed-capacity kernels flag as overflowed (seed table, SA walk,
hit buffer) are re-seeded with the host oracle and spliced in, as in the
reference package: that splice is part of its capacity contract.

A single-card seed+chain submit is a transfer group (submit_chain_group;
submit_chain is a group of one): g batches' codes and read lengths go up
in one copy each, each batch's kernels run on its rows of them, and their
packed outputs, written into one device buffer, come down in one copy;
resolve_chain_group hands each batch its slice of that copy before the
batch is collected. The stream groups 4 batches where the reference does
(pipeline/stream.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..index.fmindex import FMIndex
from ..ops.chain_device import CLASS_SLOW, ChainCtx
from ..ops.device_util import device_list, upload
from ..ops.fm3_device import DeviceFM3
from ..ops.fm_device import DeviceFMIndex
from ..ops.fm_search import (build_seed_chain_kernel, build_seed_kernel,
                              build_seed_kernel_packed)
from ..ops.routed import enable_peer_access
from ..parallel.big_index import BigShardedChainKernel, build_big_index
from ..parallel.sharded_index import (ShardedChainKernel,
                                      build_shard_index, replicate_ctx)
from .device_profile import STATS as EVIDENCE_STATS
from .seeding import identify_simple_pairs


@dataclasses.dataclass
class ChainToken:
    """One submitted batch. collect_chain swaps in a tier rerun's kernel,
    outputs, pd and mmp, so the evidence step reads the same
    classification the host admitted from."""
    kernel: object
    dev: torch.Tensor          # packed output vector (fm_search layout)
    fb_neg: np.ndarray         # host-fallback reads (negative rlen)
    packed_dev: torch.Tensor
    rl_dev: torch.Tensor       # int32[B] read lengths, fallback reads 0
    bucket: int
    rlens: np.ndarray
    pd: torch.Tensor           # int32[B] diagonals of FAST reads
    mmp: torch.Tensor          # int32[B, MM_SLOTS] packed mismatches
    # (dev, pd, mmp) of a dispatch that applied every device-FAST read's
    # evidence speculatively (fold_evidence), else None
    spec: Optional[tuple] = None
    # the classes of the first collected dispatch, host copy
    cls0: Optional[np.ndarray] = None
    # `dev` on its way to the host (pinned) and the event that marks its
    # arrival; on the CPU `dev` itself and None. A single-card batch gets
    # both when its transfer group is resolved, a sharded one at submit
    host: Optional[torch.Tensor] = None
    ready: Optional[object] = None
    group: Optional["ChainGroup"] = None


@dataclasses.dataclass
class ChainGroup:
    """A transfer group (DeviceBackend.submit_chain_group): the packed
    outputs of its batches in one device buffer, a slot of `stride` int32
    words each, on their way to the host in one copy."""
    tokens: List[ChainToken]
    stride: int
    host: torch.Tensor         # the buffer's host copy (pinned on the card)
    ready: Optional[object]    # the event of that copy; None on the CPU
    resolved: bool = False


class DeviceBackend:
    BUCKETS = (128, 192, 256)
    n_devices = 1

    # stream buffers and temporaries of the seed/chain kernel
    _WORKSPACE = 1_500_000_000
    # device evidence: 40 B/genome base of planes plus 48 B/base of
    # finalize outputs (cov_prefix in int64); the reference charges the
    # same 88 B/base
    _EVIDENCE_B_PER_BASE = 88
    # memory the prefix-skip depth choice leaves free on the card
    _PFX_RESERVE = 500_000_000

    def __init__(self, idx: FMIndex, cfg: Config, device=None,
                 shard_devices=None):
        """device: this backend's device (default cfg.device; a replica
        of parallel/devices.MultiDeviceBackend names its own).
        shard_devices: under cfg.index_shards = N > 1, the N devices of
        the shards (repeats allowed, as [cuda:0] * N on one card); by
        default the first N visible cards, or N CPU devices on the CPU."""
        self.idx = idx
        self.cfg = cfg
        self.device = torch.device(device if device is not None
                                   else cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Config.device is cuda but no CUDA device is visible; pass "
                "device='cpu' to run the plain PyTorch versions")
        # genome-sharded occ3 index over N devices (parallel/
        # sharded_index.py): the chain stage of each batch runs on the
        # shards, each mapping B/N of its reads
        self.index_shards = int(getattr(cfg, "index_shards", 0) or 0)
        # the x64 big-genome path (parallel/big_index.py): forced by
        # cfg.big_x64, automatic once the fwd+rc text passes the int32 row
        # format (the reference's index types are uint64, ref:
        # src/BWT_Index/bwt.h:44); it runs genome-sharded only
        self.big_x64 = bool(getattr(cfg, "big_x64", False)) or (
            idx.seq_len >= (1 << 31) - 2)
        if (self.big_x64 and self.index_shards <= 1
                and idx.seq_len >= (1 << 31) - 2):
            raise ValueError(
                "genome text exceeds 2^31 rows; run with -shards N "
                "(genome-sharded x64 index) on an N-device mesh")
        self.big = self.big_x64 and self.index_shards > 1
        self.shard_devs = (device_list(self.device, self.index_shards,
                                       shard_devices, "-shards")
                           if self.index_shards > 1 else [])
        self._sharded = None
        self._big = None
        # sharded chain dispatches: a routing escape (a sharded batch
        # sent through the single-card kernels) writes the same bytes, so
        # parity alone cannot catch it; the tests assert this is > 0
        self.sharded_invocations = 0
        self.batch = cfg.batch_size
        self.max_len = cfg.max_read_len
        self._kernels = {}
        self._fm3 = None
        self._chain_ctx = None
        # device chaining/classification in the stream path; off: hit
        # downloads + host chaining (submit_packed)
        self.chain_enabled = cfg.device_chain
        # capacity-overflow observability (repeat-rich genomes)
        self.n_tier_reruns = 0
        self.n_full_fallbacks = 0
        self.n_oracle_reads = 0
        # host-device copies the seed+chain dispatch issued: the codes and
        # read lengths up (2 a batch, or 2 a transfer group), the packed
        # output down (1 a batch, or 1 a group); tier reruns copy nothing
        # up and download their output apart. Counted on the CPU too,
        # where the same calls copy nothing
        self.n_uploads = 0
        self.n_downloads = 0
        if self.big:
            # the shards hold the index (_big_setup) and the evidence
            # planes (pipeline/big_profile). The x64 chain stage needs the
            # full SA; without it, and for host chaining and the
            # non-native path, batches take the single-card kernels over
            # the 1-step rows (the reference's rule, mapcaller_tpu/
            # pipeline/device_backend.py:72-75): only then is a
            # single-card table built
            self._fm3_ok = idx.sa_full is not None
            single = not (self._fm3_ok and cfg.device_chain
                          and cfg.use_native)
            if single and idx.seq_len >= 2 ** 31:
                raise NotImplementedError(
                    "big_x64: host chaining, the non-native path and an "
                    "index without its full SA run on the single-card "
                    "1-step index, which is int32 (text < 2^31 rows); the "
                    "reference cannot build it for this text either")
            self.fm = (DeviceFMIndex.from_host(idx, device=self.device)
                       if single else None)
            self.device_evidence_ok = True
            self.pfx_k = 0
            return
        self.fm = DeviceFMIndex.from_host(idx, device=self.device)
        # the occ3 scans need the full SA and the 3-step table beside
        # the working set; else the 1-step scan over the occ4 rows
        if self.index_shards > 1:
            # the sharded chain stage is the occ3 path; row indices and
            # counts stay int32 (texts below 2^31 rows; beyond, ROADMAP
            # slice 3), each shard at most 2^29 rows' worth of text
            self._fm3_ok = idx.sa_full is not None and idx.seq_len < min(
                self.index_shards * (1 << 29), (1 << 31) - 2)
        else:
            self._fm3_ok = (idx.sa_full is not None
                            and idx.seq_len < (1 << 31) - 2
                            and self._occ3_fits(idx))
        # evidence planes on the card when they fit beside the seeding
        # tables; else the C++ host diff arrays (runner logs the choice)
        self.device_evidence_ok = self._device_evidence_fits(idx)
        # the prefix-skip depth from the same free memory, before the
        # stream places the evidence planes: _prefix_skip_k charges them
        # itself, so a reading taken after them would count them twice
        self.pfx_k = self._prefix_skip_k()

    def _mem_bytes(self) -> Optional[int]:
        """Free device memory from the CUDA runtime; None on the CPU,
        where no budget applies."""
        if self.device.type != "cuda":
            return None
        free, _total = torch.cuda.mem_get_info(self.device)
        return int(free)

    def _occ3_fits(self, idx) -> bool:
        """Mapping working set with the 3-step table: occ3 (18 B/row)
        + workspace, against the free memory left after the 1-step rows
        and the full SA were placed (they are already resident)."""
        free = self._mem_bytes()
        if free is None:
            return True
        occ3 = (idx.seq_len // 16 + 2) * 288
        return occ3 + self._WORKSPACE <= free

    def _device_evidence_fits(self, idx) -> bool:
        """Evidence working set on top of mapping: the planes plus their
        finalize outputs (88 B/genome base) must fit beside the occ3 rows
        and the workspace in the free memory left after the 1-step rows
        and the full SA were placed. Beyond it the planes stay in host
        RAM (the C++ diff arrays) while seeding and chaining stay on the
        card."""
        free = self._mem_bytes()
        if free is None:
            return True
        occ3 = (idx.seq_len // 16 + 2) * 288 if self._fm3_ok else 0
        planes = self._EVIDENCE_B_PER_BASE * idx.genome_size
        return occ3 + planes + self._WORKSPACE <= free

    def _prefix_skip_k(self) -> int:
        k = int(getattr(self.cfg, "prefix_skip_k", -1))
        free = self._mem_bytes()
        if free is None:
            # identical seed sets at any depth; a small table keeps CPU
            # runs cheap
            return 6 if k < 0 else min(k, 8)
        if k >= 0:
            return k
        # auto: the K maximizing the expected skip K * (1 - e^-lambda),
        # lambda = n / 4^K (a deeper skip only pays when the genome
        # contains the K-mer; an absent entry falls back to the 1-base
        # init), among the depths whose packed table (18 B/entry, 16
        # entries per 288-B row) fits the free memory left once the occ3
        # rows, the kernel workspace and the evidence working set are
        # placed, less a reserve
        n = self.idx.seq_len
        slack = (free - (n // 16 + 2) * 288 - self._WORKSPACE
                 - self._PFX_RESERVE
                 - (self._EVIDENCE_B_PER_BASE * self.idx.genome_size
                    if self.device_evidence_ok else 0))
        best = (0.0, 0)
        for kk in range(8, 15):
            if 18 * (4 ** kk) > slack:
                break
            gain = kk * (1.0 - math.exp(-n / (4.0 ** kk)))
            if gain > best[0]:
                best = (gain, kk)
        return best[1]

    @property
    def fm3(self) -> DeviceFM3:
        if self._fm3 is None:
            tw = self.chain_ctx.text_words if self.chain_enabled else None
            self._fm3 = DeviceFM3.from_host(self.idx, self.fm,
                                            pfx_k=self.pfx_k, text_words=tw)
        return self._fm3

    @property
    def seed_fm(self):
        """The tables the packed-read scans run on: the occ3 table when
        it fits, else the 1-step rows."""
        return self.fm3 if self._fm3_ok else self.fm

    def _compact_lanes(self, B: int) -> int:
        """Scan lanes of a B-read batch under cfg.compact_factor: B / cf
        with the occ3 table and cf dividing B, else 0 (one lane per
        read)."""
        cf = max(1, int(self.cfg.compact_factor))
        return B // cf if cf > 1 and self._fm3_ok and B % cf == 0 else 0

    @property
    def chain_ctx(self) -> ChainCtx:
        if self._chain_ctx is None:
            self._chain_ctx = ChainCtx.from_host(self.idx,
                                                 device=self.device)
        return self._chain_ctx

    def dp_device_min_pairs(self) -> float:
        """Policy for cfg.device_extension == "auto": the least DP batch
        that goes to the device; inf keeps the scalar C++ aligners. On
        the CPU the plain PyTorch DP would only repeat their work. On the
        card a device DP batch needs the two-phase host leg, which costs
        more a batch than the kernel saves on the main path's batches
        (chip_smoke.py on an H100; PERF.md), and the pair count is known
        only once that leg has begun; so auto keeps the scalar aligners
        there too, and device_extension=True sends every DP batch to its
        CUDA kernel."""
        return float("inf")

    def release_index_tables(self) -> None:
        """Drop the device-resident seeding tables (occ3 rows incl.
        prefix entries, the shard tables, chain kernels) before the
        calling phase; they rebuild lazily if mapping runs again."""
        import gc
        self._kernels.clear()
        self._fm3 = None
        self._sharded = None
        self._big = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _chain_kernel_for(self, bucket: int, tier: int = 2,
                          batch: Optional[int] = None):
        B = batch or self.batch
        lanes = self._compact_lanes(B)
        key = ("chain", bucket, tier, B, lanes)
        if key not in self._kernels:
            self._kernels[key] = build_seed_chain_kernel(
                self.seed_fm, self.chain_ctx, bucket, B, slow_hits_x4=tier,
                compact_lanes=lanes)
        return self._kernels[key]

    def _sharded_setup(self):
        """Place the shard tables on their devices, once: the occ3 rows
        (without prefix rows) built on this device from its resident SA
        one shard at a time, each moved to its shard's device before the
        next (parallel/sharded_index.build_shard_index), so no device
        holds the whole table beside its shard; the SA tables split over
        the shard devices, the small tables and the chain context
        replicated on each. No host copy of a table is made."""
        if self._sharded is None:
            enable_peer_access(self.shard_devs)
            tw = self.chain_ctx.text_words if self.chain_enabled else None
            self._sharded = (
                build_shard_index(self.idx, self.fm, self.shard_devs, tw),
                replicate_ctx(self.chain_ctx, self.shard_devs))
        return self._sharded

    def _big_setup(self):
        """Place the x64 tables on the shard devices, once: each shard's
        int64 SA entries and shard-relative occ3 rows built on its own
        device a shard at a time (parallel/big_index.build_big_index), the
        chain context replicated on each. No single-card table is built."""
        if self._big is None:
            enable_peer_access(self.shard_devs)
            ctxs = replicate_ctx(self.chain_ctx, self.shard_devs)
            self._big = (build_big_index(self.idx, ctxs, self.shard_devs),
                         ctxs)
        return self._big

    def _sharded_chain_for(self, bucket: int, tier: int, batch_global: int):
        key = ("schain", bucket, tier, batch_global)
        if key not in self._kernels:
            tables, ctxs = (self._big_setup() if self.big
                            else self._sharded_setup())
            stage = BigShardedChainKernel if self.big else ShardedChainKernel
            self._kernels[key] = stage(tables, ctxs, self.shard_devs, bucket,
                                       batch_global, tier)
        return self._kernels[key]

    def _download(self, dev: torch.Tensor):
        """Start the copy of a dispatch's packed output vector (or a
        transfer group's buffer) to the host. On the card into pinned
        memory, queued behind the dispatch on the current stream, with an
        event: collecting this batch then waits for its own work only, not
        for the batches submitted after it. -> (host tensor, event or
        None)."""
        self.n_downloads += 1
        if self.device.type != "cuda":
            return dev, None
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def submit_chain(self, packed: np.ndarray, rlens: np.ndarray,
                     bucket: int, tier: int = 2, evidence=None,
                     pair_end: bool = False) -> ChainToken:
        """Run the seed/chain kernels on one parsed batch (packed uint8
        [B, bucket/4] 2-bit codes, rlens int32[B]; negative rlen =
        host-fallback read): a transfer group of one, resolved. Returns
        the token collect_chain takes; see submit_chain_group."""
        (token,), group = self.submit_chain_group(
            [(packed, rlens)], bucket, tier, evidence, pair_end)
        if group is not None:
            self.resolve_chain_group(group)
        return token

    def _upload_batch(self, packed: np.ndarray, rlens: np.ndarray):
        """The 2-bit codes and the read lengths (fallback reads 0) of a
        batch or a transfer group on the device: two copies."""
        self.n_uploads += 2
        return (upload(packed, self.device),
                upload(np.maximum(rlens, 0).astype(np.int32), self.device))

    def _dispatch(self, packed_dev, rl_dev, rlens: np.ndarray, bucket: int,
                  tier: int, evidence, pair_end: bool, out) -> ChainToken:
        """The single-card seed/chain kernels on a batch already on the
        device, its packed output written into `out` (its slot of a group
        buffer). Nothing is downloaded."""
        kernel = self._chain_kernel_for(bucket, tier,
                                        batch=int(packed_dev.shape[0]))
        planes = evidence.planes if evidence is not None else None
        dev, pd, mmp = kernel(packed_dev, rl_dev, planes=planes,
                              pair_end=pair_end, out=out)
        spec = None
        if evidence is not None:
            EVIDENCE_STATS.folded += 1
            spec = (dev, pd, mmp)
        return ChainToken(kernel, dev, rlens < 0, packed_dev, rl_dev, bucket,
                          rlens, pd, mmp, spec=spec)

    def submit_chain_group(self, parts, bucket: int, tier: int = 2,
                           evidence=None, pair_end: bool = False):
        """Submit g parsed batches as one transfer group (the stream's
        only device-chain submit; g = 1 when it does not group): the codes
        and the read lengths of the g batches go up in one copy each; each
        batch's kernels run on its rows of them, in submission order on
        the current stream, and classify+pack writes its packed output
        into the batch's slot of one group buffer (a slot rounded up to 16
        bytes); the buffer comes down in one copy into pinned memory,
        marked by one event. Returns without waiting for the card: nothing
        in the dispatch reads a device value back, so the stream's host
        leg of the batches before overlaps this group's device work.
        Collect, tier reruns and the stand-alone evidence apply are each
        batch's own.

        parts: a list of (packed uint8[B, bucket/4], rlens int32[B]), the
        same B each. evidence (a DeviceEvidence) folds the speculative
        fast-read evidence apply into each dispatch, pair_end its mates'
        rule; the caller must later run evidence.reconcile_batch(token,
        fast_bits, pair_end) for each batch (the stream folds only when
        it does not group, as the reference).

        With cfg.index_shards = N > 1 a group holds one batch (more raise:
        single-card kernels would silently bypass the sharded index),
        whose chain stage runs on the shards (parallel/sharded_index.py),
        the batch padded to a multiple of 32 N reads; the token and
        collect_chain's contract are the same. The evidence apply is not
        folded there: the token holds pd and mmp for the stand-alone
        apply, as the reference's sharded path. On the x64 big-genome path
        pd is int64.

        -> (tokens, group); resolve_chain_group(group) before collecting
        any of them (group None: the sharded path's token needs none)."""
        if self.index_shards > 1:
            if len(parts) > 1:
                raise RuntimeError(
                    "submit_chain_group: a transfer group builds single-card "
                    "kernels and would silently bypass the sharded-index "
                    "path under -shards")
            if self._fm3_ok:
                return [self._submit_sharded(*parts[0], bucket, tier)], None
        B = parts[0][0].shape[0]
        if not all(p.shape[0] == B and r.shape[0] == B for p, r in parts):
            raise ValueError("submit_chain_group: every batch of a group "
                             "must hold the same number of reads")
        packed_dev, rl_dev = self._upload_batch(
            np.concatenate([p for p, _ in parts]),
            np.concatenate([r for _, r in parts]))
        size = self._chain_kernel_for(bucket, tier, batch=B).out_size
        stride = -(-size // 4) * 4
        buf = torch.empty(len(parts) * stride, dtype=torch.int32,
                          device=self.device)
        tokens = []
        for i, (_, rlens) in enumerate(parts):
            rows = slice(i * B, (i + 1) * B)
            tokens.append(self._dispatch(
                packed_dev[rows], rl_dev[rows], rlens, bucket, tier,
                evidence, pair_end, buf[i * stride:i * stride + size]))
        host, ready = self._download(buf)
        group = ChainGroup(tokens, stride, host, ready)
        for t in tokens:
            t.group = group
        return tokens, group

    @staticmethod
    def resolve_chain_group(group: ChainGroup) -> None:
        """Give each batch of the group its slice of the group's host copy
        and the copy's event (idempotent). Waits for nothing: collecting
        a batch waits for the event."""
        if group.resolved:
            return
        for i, t in enumerate(group.tokens):
            lo = i * group.stride
            t.host = group.host[lo:lo + t.dev.shape[0]]
            t.ready = group.ready
        group.resolved = True

    def _submit_sharded(self, packed: np.ndarray, rlens: np.ndarray,
                        bucket: int, tier: int) -> ChainToken:
        n = self.index_shards
        B0 = packed.shape[0]
        BG = -(-B0 // (32 * n)) * 32 * n
        packed_p = np.zeros((BG, packed.shape[1]), dtype=packed.dtype)
        packed_p[:B0] = packed
        rl_p = np.zeros(BG, dtype=np.int32)
        rl_p[:B0] = np.maximum(rlens, 0)
        packed_dev, rl_dev = self._upload_batch(packed_p, rl_p)
        kernel = self._sharded_chain_for(bucket, tier, BG)
        dev, pd, mmp = kernel(packed_dev, rl_dev)
        self.sharded_invocations += 1
        host, ready = self._download(dev)
        return ChainToken(kernel, dev, rlens < 0, packed_dev, rl_dev, bucket,
                          rlens, pd, mmp, host=host, ready=ready)

    def collect_chain(self, token: ChainToken, n: int, read_codes_fn):
        """-> (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen).
        Overflow / too-long reads are re-seeded with the host oracle and
        forced to the SLOW class; hit-buffer overflow reruns at the
        larger tier 18. A batch raises until its transfer group is resolved
        (resolve_chain_group)."""
        if token.group is not None and not token.group.resolved:
            raise RuntimeError("collect_chain: the batch's transfer group "
                               "is not resolved (resolve_chain_group)")
        if token.ready is not None:
            token.ready.synchronize()
        (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen,
         overflow, buf_ovf) = token.kernel.collect(token.host)
        token.cls0 = cls
        if buf_ovf:
            self.n_tier_reruns += 1
            if isinstance(token.kernel, ShardedChainKernel):
                kernel2 = self._sharded_chain_for(token.bucket, 18,
                                                  token.kernel.BG)
            else:
                kernel2 = self._chain_kernel_for(token.bucket, tier=18,
                                                 batch=len(token.rlens))
            dev2, pd2, mmp2 = kernel2(token.packed_dev, token.rl_dev)
            (cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen,
             overflow, buf_ovf) = kernel2.collect(dev2)
            # the evidence step must use the SAME classification outputs
            # the host admits from
            token.kernel, token.dev = kernel2, dev2
            token.pd, token.mmp = pd2, mmp2
            if buf_ovf:   # pathological: host oracle for everything
                self.n_full_fallbacks += 1
                cls = np.full(n, CLASS_SLOW, dtype=np.int32)
                counts = np.zeros(n, dtype=np.int32)
                return self._splice_chain(
                    n, cls[:n], pd[:n], mm[:n], rplast[:n], cscore[:n],
                    counts, np.zeros(0, np.int32), np.zeros(0, np.int64),
                    np.zeros(0, np.int32), np.ones(n, dtype=bool),
                    read_codes_fn)
        fallback = overflow[:n] | token.fb_neg[:n]
        cls = cls[:n].copy()
        counts = counts[:n]
        self.n_oracle_reads += int(fallback.sum())
        if fallback.any():
            counts, rpos, gpos, slen = _drop_reads(counts, rpos, gpos, slen,
                                                   fallback)
            return self._splice_chain(n, cls, pd[:n], mm[:n], rplast[:n],
                                      cscore[:n], counts, rpos, gpos, slen,
                                      fallback, read_codes_fn)
        return (cls, pd[:n], mm[:n], rplast[:n], cscore[:n], counts,
                rpos.astype(np.int32), gpos, slen.astype(np.int32))

    def _splice_chain(self, n, cls, pd, mm, rplast, cscore, counts,
                      rpos, gpos, slen, fallback, read_codes_fn):
        cls[fallback] = CLASS_SLOW
        counts, rpos, gpos, slen = self._splice_fallback(
            n, counts, rpos, gpos, slen, fallback, read_codes_fn)
        return cls, pd, mm, rplast, cscore, counts, rpos, gpos, slen

    def _splice_fallback(self, n, counts, rpos, gpos, slen, fallback,
                         read_codes_fn):
        bounds = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=bounds[1:])
        rp_parts, gp_parts, ln_parts = [], [], []
        prev = 0
        for i in np.nonzero(fallback)[0].tolist():
            s = int(bounds[i])
            rp_parts.append(rpos[prev:s])
            gp_parts.append(gpos[prev:s])
            ln_parts.append(slen[prev:s])
            orp, ogp, oln = self._oracle_arrays(read_codes_fn(i))
            rp_parts.append(orp)
            gp_parts.append(ogp)
            ln_parts.append(oln)
            counts[i] = len(orp)
            prev = s
        rp_parts.append(rpos[prev:])
        gp_parts.append(gpos[prev:])
        ln_parts.append(slen[prev:])
        return (counts,
                np.concatenate(rp_parts).astype(np.int32),
                np.concatenate(gp_parts).astype(np.int64),
                np.concatenate(ln_parts).astype(np.int32))

    # -- packed 2-bit API without device chaining (device_chain=False) ---
    def _packed_kernel_for(self, bucket: int, tier: int = 9,
                           batch: Optional[int] = None):
        B = batch or self.batch
        lanes = self._compact_lanes(B)
        key = ("packed", bucket, tier, B, lanes)
        if key not in self._kernels:
            self._kernels[key] = build_seed_kernel_packed(
                self.seed_fm, bucket, B, hits_per_read_x4=tier,
                compact_lanes=lanes)
        return self._kernels[key]

    def submit_packed(self, packed: np.ndarray, rlens: np.ndarray,
                      bucket: int, tier: int = 9):
        """packed uint8[B, bucket/4] 2-bit codes; negative rlen =
        host-fallback read. Returns the token collect_packed takes."""
        kernel = self._packed_kernel_for(bucket, tier, batch=packed.shape[0])
        packed_dev = upload(packed, self.device)
        rl_dev = upload(np.maximum(rlens, 0).astype(np.int32),
                        self.device)
        return (kernel, kernel(packed_dev, rl_dev), rlens < 0, packed_dev,
                rl_dev, bucket, rlens)

    def collect_packed(self, token, n: int, read_codes_fn):
        """-> (counts, rpos, gpos, slen) grouped by read; overflow reads
        recomputed with the host oracle. Batch-level hit-buffer overflow
        reruns at the larger tier 18."""
        kernel, dev, fb_neg, packed_dev, rl_dev, bucket, rlens = token
        counts, rpos, gpos, slen, overflow, buf_ovf = kernel.collect(dev)
        if buf_ovf:
            self.n_tier_reruns += 1
            kernel2 = self._packed_kernel_for(bucket, tier=18,
                                              batch=len(rlens))
            counts, rpos, gpos, slen, overflow, buf_ovf = kernel2.collect(
                kernel2(packed_dev, rl_dev))
            if buf_ovf:   # pathological: host oracle for everything
                self.n_full_fallbacks += 1
                return self._splice_fallback(
                    n, np.zeros(n, dtype=np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.ones(n, dtype=bool), read_codes_fn)
        fallback = overflow[:n] | fb_neg[:n]
        counts = counts[:n]
        self.n_oracle_reads += int(fallback.sum())
        if fallback.any():
            counts, rpos, gpos, slen = _drop_reads(counts, rpos, gpos, slen,
                                                   fallback)
            return self._splice_fallback(n, counts, rpos, gpos, slen,
                                         fallback, read_codes_fn)
        return counts, rpos.astype(np.int32), gpos, slen.astype(np.int32)

    # -- per-read API of the non-native path (1-step kernel, byte codes) --
    def _kernel_for(self, bucket: int):
        key = ("seed", bucket)
        if key not in self._kernels:
            self._kernels[key] = build_seed_kernel(self.fm, bucket,
                                                   self.batch)
        return self._kernels[key]

    def seed_batch(self, codes_list: List[np.ndarray]) -> List[tuple]:
        """codes_list: per-read uint8 code arrays. Returns per-read flat
        seed arrays (rpos int32[], gpos int64[], length int32[]) with the
        PosDiff > 0 filter applied — the exact seed set of
        identify_simple_pairs, unsorted and without the sentinel."""
        return self.collect(self.submit(codes_list))

    def submit(self, codes_list: List[np.ndarray]):
        """Run device seeding for all sub-batches of `batch` reads;
        returns the token collect() takes."""
        return [self._submit_one(codes_list[lo:lo + self.batch])
                for lo in range(0, len(codes_list), self.batch)]

    def collect(self, pending) -> List[tuple]:
        out: List[tuple] = []
        for item in pending:
            out.extend(self._collect_one(item))
        return out

    def _submit_one(self, chunk: List[np.ndarray]):
        B = self.batch
        longest = max((c.shape[0] for c in chunk), default=0)
        bucket = next((b for b in self.BUCKETS
                       if b >= min(longest, self.max_len)), self.BUCKETS[-1])
        codes = np.full((B, bucket), 4, dtype=np.uint8)
        rlens = np.zeros(B, dtype=np.int32)
        fallback = [False] * len(chunk)
        for i, c in enumerate(chunk):
            if c.shape[0] > bucket:
                fallback[i] = True
                continue
            codes[i, :c.shape[0]] = c
            rlens[i] = c.shape[0]
        kernel = self._kernel_for(bucket)
        dev = kernel(torch.from_numpy(codes).to(self.device),
                     torch.from_numpy(rlens).to(self.device))
        return (kernel, dev, chunk, fallback)

    def _collect_one(self, item) -> List[tuple]:
        kernel, dev, chunk, fallback = item
        B = self.batch
        (hit_read, hit_rpos, hit_len, hit_loc, hit_valid,
         _total, overflow, buf_ovf) = kernel.collect(dev)
        if buf_ovf:
            # batch-level hit-buffer overflow: host fallback for everything
            return [self._oracle_arrays(c) for c in chunk]
        pd = hit_loc.astype(np.int64) - hit_rpos
        keep = hit_valid & (pd > 0)
        order_read = hit_read[keep]
        rp = hit_rpos[keep].astype(np.int32)
        gp = hit_loc[keep].astype(np.int64)
        ln = hit_len[keep].astype(np.int32)
        # hits are already grouped by read (flattened seed order)
        bounds = np.searchsorted(order_read, np.arange(B + 1))
        result = []
        for i, c in enumerate(chunk):
            if fallback[i] or overflow[i]:
                result.append(self._oracle_arrays(c))
            else:
                s, e = bounds[i], bounds[i + 1]
                result.append((rp[s:e], gp[s:e], ln[s:e]))
        return result

    def _oracle_arrays(self, c: np.ndarray) -> tuple:
        pairs = identify_simple_pairs(self.idx, c)[:-1]  # drop sentinel
        return (np.array([p.rPos for p in pairs], dtype=np.int32),
                np.array([p.gPos for p in pairs], dtype=np.int64),
                np.array([p.rLen for p in pairs], dtype=np.int32))


def _drop_reads(counts, rpos, gpos, slen, drop):
    """Remove the hits of the reads flagged in `drop` from per-read
    grouped hit arrays (their counts become 0), before the host oracle's
    seeds are spliced in for them."""
    bounds = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    keep = np.ones(len(rpos), dtype=bool)
    for i in np.nonzero(drop)[0].tolist():
        keep[bounds[i]:bounds[i + 1]] = False
    counts = counts.copy()
    counts[drop] = 0
    return counts, rpos[keep], gpos[keep], slen[keep]

