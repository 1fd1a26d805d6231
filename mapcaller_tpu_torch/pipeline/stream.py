"""Stream mapping driver: native parsing + device seeding, pipelined.

The hot loop never materializes per-read Python objects: the C++ runtime
parses FASTQ/FASTA batches into parser slots, hands the device a padded
2-bit code matrix, and consumes the classified reads and flat seed
arrays the device returns; the host then runs chain -> pair -> align ->
SAM -> evidence for the batch (ref: ReadMapping.cpp:416-646).

With device evidence (the default when the planes fit the card, see
DeviceBackend.device_evidence_ok), each batch's FAST reads add their
evidence to the device planes after the host leg has run its duplicate
gate (pipeline/device_profile.py), or speculatively inside the chain
dispatch under fold_evidence; SLOW reads' evidence stays in the C++ host
diff arrays and merges into the planes at finalize. With device_chain
off, the card returns every kept hit and the host chains all reads;
evidence then stays in the host diff arrays.

When the device chains, batches are submitted in transfer groups of
TRANSFER_GROUP (4, the reference package's default stream_group): one
upload of the group's codes, one of its read lengths and one download of
its packed outputs (DeviceBackend.submit_chain_group), the group's bucket
that of its longest read; each group is resolved before its first batch
is collected. As in the reference, a group holds one batch under the
folded evidence apply and under -shards, and host chaining submits one
batch at a time. With `-devices N` (parallel/devices.py) whole groups go
round-robin to N replicas, and the host leg still takes batches in
submission order.
"""
from __future__ import annotations

import gzip
import sys
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from .. import stage_prof
from ..config import Config
from ..ops.chain_device import CLASS_FAST, CLASS_NOCAND, CLASS_SLOW

# batches a transfer group where the stream groups (see the docstring): the
# reference package's default stream_group, which no caller there changes
TRANSFER_GROUP = 4


def _load_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with open(path, "rb") as f:
            return gzip.decompress(f.read())
    with open(path, "rb") as f:
        return f.read()


# cfg.compact_factor == 0 (auto): x4 lane compaction with 131,072-read
# stream batches when the input can fill enough of them that the drain
# tail amortizes (the reference package's rule: compacted lanes refill
# from a queue of unread reads, so a lockstep scan costs about the MEAN
# read's iterations instead of the most any read needs; seed sets stay
# identical). Not on the card: its scan kernel runs a thread per read,
# which does not wait for the slowest read of a batch, and at the rule's
# own geometry 32,768 lanes were slower than a thread per read on an
# H100 (chip_smoke.py's seed_scan phase; PERF.md)
_COMPACT_AUTO_FACTOR = 4
_COMPACT_AUTO_LANES = 32768


def _estimate_records(buf: bytes) -> int:
    """Record-count estimate from an exact parse of a 256 KB prefix,
    scaled by total size (exact counting would touch the whole buffer)."""
    if not buf:
        return 0
    n = 1 << 18
    sample = buf[:n]
    if buf[:1] == b"@":
        nrec = sample.count(b"\n") // 4
    else:
        nrec = sample.count(b">")
    if len(buf) <= n:
        return nrec
    return int(nrec * (len(buf) / n))


def _resolve_auto_compaction(cfg: Config, be, buf1: bytes, buf2) -> None:
    cfg.compact_factor = 1
    if not (be.chain_enabled and be._fm3_ok and be.index_shards <= 1
            and be.n_devices == 1 and be.device.type != "cuda"):
        return
    est = _estimate_records(buf1) + (_estimate_records(buf2)
                                     if buf2 is not None else 0)
    batch = _COMPACT_AUTO_FACTOR * _COMPACT_AUTO_LANES
    if est >= 6 * batch:
        cfg.compact_factor = _COMPACT_AUTO_FACTOR
        cfg.stream_batch_size = batch


def run_stream_mapping(engine, cfg: Config, t_start: float,
                       sam_sink: Optional[Callable[[str], None]] = None) -> None:
    """Requires engine.native and engine.backend. Updates engine.stats,
    engine.profile (in place via C++), engine.inv_sites/tnl_sites."""
    native = engine.native
    be = engine.backend
    use_device_evidence = (cfg.vcf_output and be.chain_enabled
                           and cfg.device_evidence and be.device_evidence_ok)
    with stage_prof.span("evidence_setup"):
        if cfg.vcf_output:
            # slow-read evidence always accumulates in the host diff arrays
            engine.enable_diff_profile()
        if use_device_evidence:
            from .device_profile import make_device_evidence
            engine.device_evidence = make_device_evidence(be, cfg,
                                                          engine.profile)
            native.set_ops_mode(True)
            # the C++ slow path writes host planes invisibly to Python:
            # register its dirtiness probe so the device merge can skip
            # its O(L) nonzero scans when every read stayed on the card
            engine.profile.dirty_probes.append(native.host_planes_dirty)
    fold_ev = (engine.device_evidence
               if use_device_evidence and cfg.fold_evidence else None)
    stats_io = np.zeros(6, dtype=np.int64)
    stats_io[5] = engine.stats.avg_dist

    for lib in range(len(cfg.read_files1)):
        f1 = cfg.read_files1[lib]
        f2 = cfg.read_files2[lib] if lib < len(cfg.read_files2) else None
        pair_end = f2 is not None or cfg.pair_interleaved
        with stage_prof.span("load"):
            buf1 = _load_bytes(f1)
            buf2 = _load_bytes(f2) if f2 is not None else None
            if cfg.compact_factor == 0:
                _resolve_auto_compaction(cfg, be, buf1, buf2)
            fastq = buf1[:1] == b"@"
            native.set_input(buf1, buf2, cfg.pair_interleaved)

        # device kernels require batch % 32 == 0 (fm_search assertions)
        sb = -(-max(cfg.stream_batch_size, 256) // 32) * 32
        # transfer grouping: one upload and one download a group. Off
        # under -shards (a group builds single-card kernels, which would
        # bypass the sharded index) and under the folded apply
        group_n = (TRANSFER_GROUP if be.chain_enabled and fold_ev is None
                   and be.index_shards <= 1 else 1)
        n_dev = getattr(be, "n_devices", 1)
        # keep `depth` device batches in flight, within the native
        # parser slot ring: a full group pushed at depth - 1 pending must
        # still fit it (a reused slot would overwrite host read data of a
        # batch still in flight — the native side refuses with an error,
        # and this cap guarantees we never hit it); at least N + 1 groups
        # with N replicas (-devices N), so every replica stays busy (the
        # reference's formula, mapcaller_tpu/pipeline/stream.py:135-149)
        n_slots = native.parser_slots
        depth = min(n_slots - max(2, group_n),
                    max(cfg.stream_pipeline_depth, group_n * (n_dev + 1)))
        slot = 0
        pending = deque()
        eof = False
        while not eof or pending:
            while not eof and len(pending) < depth:
                with stage_prof.span("parse"):
                    metas = []
                    while not eof and len(metas) < group_n:
                        n, maxlen = native.next_batch(slot, sb)
                        if n <= 0:
                            eof = True
                            break
                        metas.append((slot, n, maxlen))
                        slot = (slot + 1) % n_slots
                    if not metas:
                        break
                    longest = min(max(m[2] for m in metas), be.max_len)
                    bucket = next((b for b in be.BUCKETS if b >= longest),
                                  be.BUCKETS[-1])
                    parts = [native.batch_codes_packed(sl, bucket, sb)
                             for sl, _, _ in metas]
                with stage_prof.span("submit"):
                    if be.chain_enabled:
                        tokens, group = be.submit_chain_group(
                            parts, bucket, evidence=fold_ev,
                            pair_end=pair_end)
                    else:
                        tokens, group = [be.submit_packed(*parts[0],
                                                          bucket)], None
                for (sl, n, _), tok in zip(metas, tokens):
                    pending.append((sl, n, tok, group))
            if not pending:
                break
            pslot, pn, ptoken, pgroup = pending.popleft()
            if pgroup is not None:
                be.resolve_chain_group(pgroup)
            if be.chain_enabled:
                with stage_prof.span("collect"):
                    (cls, pd, mm, rplast, cscore, counts, rp, gp,
                     ln) = be.collect_chain(
                        ptoken, pn, lambda i, s=pslot: native.read_codes(s, i))
                if stage_prof.ON:
                    by_cls = np.bincount(cls, minlength=3)
                    stage_prof.count("reads_fast", by_cls[CLASS_FAST])
                    stage_prof.count("reads_slow", by_cls[CLASS_SLOW])
                    stage_prof.count("reads_nocand", by_cls[CLASS_NOCAND])
                with stage_prof.span("host_cpp"):
                    dx = cfg.device_extension
                    if dx == "auto":
                        # the backend's policy; inf keeps the scalar aligners
                        dx = be.dp_device_min_pairs() != float("inf")
                    if dx:
                        sam_text, st = native.process_batch_cls_devdp(
                            pslot, pair_end, fastq, cls, pd, mm, rplast,
                            cscore, counts, rp, gp, ln, stats_io, cfg.use_nw)
                    else:
                        sam_text, st = native.process_batch_cls(
                            pslot, pair_end, fastq, cls, pd, mm, rplast,
                            cscore, counts, rp, gp, ln, stats_io)
                if engine.device_evidence is not None:
                    with stage_prof.span("evidence"):
                        fbits = native.fetch_fast_bits()
                        engine.device_evidence.reconcile_batch(ptoken, fbits,
                                                               pair_end)
            else:
                with stage_prof.span("collect"):
                    counts, rp, gp, ln = be.collect_packed(
                        ptoken, pn, lambda i, s=pslot: native.read_codes(s, i))
                with stage_prof.span("host_cpp"):
                    sam_text, st = native.process_batch(
                        pslot, pair_end, fastq, counts, rp, gp, ln, stats_io)
            stage_prof.count("batches")
            native.slot_release(pslot)
            engine.inv_sites.extend(st["inv"])
            engine.tnl_sites.extend(st["tnl"])
            if sam_sink is not None and sam_text:
                sam_sink(sam_text)
            sys.stderr.write(
                f"\r{int(stats_io[0])} "
                f"{'paired-end' if pair_end else 'singled-end'} reads "
                f"processed in {int(time.time() - t_start)} seconds...")

    s = engine.stats
    s.total_reads = int(stats_io[0])
    s.total_mapped = int(stats_io[1])
    s.total_paired = int(stats_io[2])
    s.total_paired_distance = int(stats_io[3])
    s.read_length_sum = int(stats_io[4])
    s.avg_dist = int(stats_io[5])
    sys.stderr.write("\n")

