"""Multi-host execution harness: torch.distributed + per-host input
shards + ONE cross-host all-reduce of the evidence planes (PyTorch port of
mapcaller_tpu/parallel/multihost.py).

Each host maps its shard of the read stream through the PRODUCTION
pipeline — native C++ parsing/pairing/slow path + the card's seed/chain
kernels + the device evidence planes (pipeline/stream.py, exactly what
the single-host CLI runs) on its own card (Config.device, "cuda" unless
the caller asks for the CPU) — evidence stays RAW (unfolded diff
endpoints), and a single sum all-reduce over the process group reduces
the planes before host 0 folds once (cap-after-sum) and runs the caller.

The collectives run over gloo on host tensors, as the reference's run
over a CPU mesh on host arrays: the planes come down to the host before
the reduction (download_raw_into), and NCCL would refuse two ranks on
one card. Several processes on one host (one card, or the CPU with
device="cpu") rehearse the exact collective code path; the 2-process
runs write the 1-process VCF byte for byte, single-end and paired-end.

Caveats mirrored from parallel/distributed.py: the PCR-duplicate gate
is per-host (shard duplicates together to preserve it); paired-end
fragment-size estimation is per-host (the reference has no multi-host
mode to define a contract against).

Event maps (indel seqs of any length, breakpoints) and discord sites
ride a second collective: a var-length int32 record stream (counts
carried once per unique event), sized by a max all-reduce across
processes, all-gathered and decoded on host 0. The word types are the
reference's: int32 planes (its psum wraps where int32 wraps, and so does
this one) and the run statistics as hi/lo int32 words summed in Python.

    python -m mapcaller_tpu_torch.parallel.multihost --pid 0 --num 2 \
        --coordinator 127.0.0.1:29500 --fasta ref.fa --reads r1.fq \
        --reads2 r2.fq --out merged.vcf [--devices N] [--device cpu]

one command per rank (--pid 0 .. --num - 1), rank 0 writing the VCF.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

AUX_WORD_CAP = 64 << 20   # 256 MB of int32 words — truncate (warn) past this
# how long a rank waits at the rendezvous and in each collective for the
# slowest rank: its mapping time less this rank's, plus the reduction
COLLECTIVE_TIMEOUT_S = 1800.0
N_STATS = 5


def _serialize_aux(profile, inv_sites, tnl_sites) -> np.ndarray:
    """Events + discord sites -> var-length int32 word stream (counts
    carried once per unique event, indel seqs of ANY length packed
    2-bit — no fixed EVENT_CAP / 8 bp limits). Records:
      [0, g, kind, count, len, seq_word...]   event (kind: 0 bp 1 ins 2 del)
      [1, g, d, k]                            discord site (k: 0 inv 1 tnl)
    (int32 words, as the reference's collectives carry them.)"""
    out = []

    def pack(g, kind, seq, count):
        words = []
        for w0 in range(0, len(seq), 15):   # 15 bases = 30 bits (int32-safe)
            s2 = 0
            for i, ch in enumerate(seq[w0:w0 + 15]):
                s2 |= "ACGT".index(ch) << (2 * i)
            words.append(s2)
        out.extend([0, g, kind, count, len(seq)] + words)

    for g, cnt in profile.break_point.items():
        pack(g, 0, "", cnt)
    for kind, table in ((1, profile.insert_map), (2, profile.delete_map)):
        for g, inner in table.items():
            for seq, cnt in inner.items():
                pack(g, kind, seq, cnt)
    for g, d in inv_sites:
        out.extend([1, g, d, 0])
    for g, d in tnl_sites:
        out.extend([1, g, d, 1])
    arr = np.asarray(out, dtype=np.int32)
    if arr.size > AUX_WORD_CAP:
        # degrade gracefully: drop whole records past the cap
        end = 0
        while end < AUX_WORD_CAP:
            step = (5 + (arr[end + 4] + 14) // 15) if arr[end] == 0 else 4
            if end + step > AUX_WORD_CAP:
                break
            end += step
        print(f"[multihost] WARNING: aux stream {arr.size} words exceeds "
              f"cap {AUX_WORD_CAP}; truncating", file=sys.stderr)
        arr = arr[:end]
    return arr


def _decode_aux(arr: np.ndarray, used: int, profile, inv_sites,
                tnl_sites) -> None:
    i = 0
    a = arr[:used].tolist()
    while i < used:
        tag = a[i]
        if tag == 0:
            g, kind, count, ln = a[i + 1:i + 5]
            nw = (ln + 14) // 15
            seq = "".join("ACGT"[(a[i + 5 + j // 15] >> (2 * (j % 15))) & 3]
                          for j in range(ln))
            i += 5 + nw
            if kind == 0:
                profile.break_point[g] = profile.break_point.get(g, 0) + count
            else:
                tbl = profile.insert_map if kind == 1 else profile.delete_map
                inner = tbl.setdefault(g, {})
                inner[seq] = inner.get(seq, 0) + count
        else:
            g, d, k = a[i + 1:i + 4]
            (inv_sites if k == 0 else tnl_sites).append((g, d))
            i += 4


def _shard_fastq(src: str, dst: str, process_id: int, num_processes: int,
                 interleaved: bool = False) -> int:
    """Write this host's read shard: record i goes to host
    (i // (2 if interleaved else 1)) % num_processes, so mates co-locate
    on one host (the pairing/rescue state is per-host, mirroring the
    reference's per-thread chunks, ReadMapping.cpp:735-736). FASTA
    records may wrap sequence over multiple lines (the 70-column format
    this repo itself writes); FASTQ is fixed 4-line. Returns the number
    of records written."""
    import gzip
    op = gzip.open if src.endswith(".gz") else open
    n_written = 0
    with op(src, "rt") as f, open(dst, "w") as out:
        first = f.read(1)
        f.seek(0)
        fastq = first == "@"
        idx_rec = 0

        def emit(rec):
            nonlocal n_written, idx_rec
            pair_ix = idx_rec // 2 if interleaved else idx_rec
            if pair_ix % num_processes == process_id:
                out.writelines(rec)
                n_written += 1
            idx_rec += 1

        if fastq:
            rec = []
            for line in f:
                rec.append(line)
                if len(rec) == 4:
                    emit(rec)
                    rec = []
        else:
            rec = []
            for line in f:
                if line.startswith(">") and rec:
                    emit(rec)
                    rec = []
                rec.append(line)
            if rec:
                emit(rec)
    return n_written


def _stat_words(st) -> np.ndarray:
    """The run statistics as hi/lo int32 words (read_length_sum is total
    mapped bases and passes int32 at ~2.1 Gbp a host): int32-safe up to
    2^60 a stat a host."""
    vals = [st.total_reads, st.total_mapped, st.total_paired,
            st.total_paired_distance, st.read_length_sum]
    return np.asarray([w for v in vals for w in (v >> 30, v & ((1 << 30) - 1))],
                      dtype=np.int32)


def _sum_stat_words(rows: np.ndarray) -> list:
    """The hosts' hi/lo stat words (rows [n, 2 * N_STATS]) summed in
    Python (arbitrary precision)."""
    sums = [0] * N_STATS
    for row in rows:
        for k in range(N_STATS):
            sums[k] += (int(row[2 * k]) << 30) | int(row[2 * k + 1])
    return sums


def run_host(process_id: int, num_processes: int, coordinator: str,
             fasta: str, reads: str, out_vcf: str, cmd_line: str,
             reads2: Optional[str] = None,
             devices: Union[int, Sequence] = 1,
             device: str = "cuda") -> dict:
    """One host process running the PRODUCTION pipeline on its read
    shard on its card (device; "cpu" only when the caller asks, no card
    raises) — native C++ parsing/pairing/slow path + the seed/chain
    kernels + the device evidence planes (pipeline/stream.py, the same
    path the single-host CLI runs) — then ONE sum all-reduce of the RAW
    diff planes (saturation applied once after the reduction,
    cap-after-sum) and, on host 0, a single finalize + caller pass.
    Reference merge analog: ReadMapping.cpp:627-643 under the real
    engine. The process group (gloo, tcp://coordinator, rank process_id
    of num_processes) waits COLLECTIVE_TIMEOUT_S at most for a rank and
    is destroyed on every exit path.

    devices > 1 composes the per-host data-parallel axis (-devices N,
    parallel/devices.py — N local cards round-robin over this host's
    stream batches, ordered host leg, per-replica planes merged locally
    before the raw download) with the cross-host all-reduce: N cards/host
    x M processes, the reference's threads-compose-trivially analog
    (ReadMapping.cpp:735-736). devices may also be an explicit device
    list (repeats allowed, as [cuda:0] * 2 on one card).

    Returns this rank's facts: its mapping device, mapping_s and the
    seconds of each collective."""
    from ..config import Config
    from ..index.fmindex import build_index
    from ..pipeline.device_backend import DeviceBackend
    from ..pipeline.engine import MappingEngine
    from ..pipeline.stream import run_stream_mapping
    from ..runner import run_calling

    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        dev_list = None if isinstance(devices, int) else list(devices)
        n_dev = devices if dev_list is None else len(dev_list)
        cfg = Config(vcf_file=out_vcf, log_file=out_vcf + ".log",
                     batch_size=256, stream_batch_size=512, max_read_len=128,
                     devices=n_dev, device=device)
        idx = build_index(fasta)
        if n_dev > 1:
            from .devices import MultiDeviceBackend
            backend = MultiDeviceBackend(idx, cfg, n_dev, devices=dev_list)
        else:
            backend = DeviceBackend(idx, cfg,
                                    device=dev_list[0] if dev_list else None)
        engine = MappingEngine(idx, cfg, backend=backend)

        # per-host input shard, mates co-located
        with tempfile.TemporaryDirectory(prefix=f"mh{process_id}_") as tmpd:
            f1 = os.path.join(tmpd, "r1.fq")
            _shard_fastq(reads, f1, process_id, num_processes,
                         interleaved=cfg.pair_interleaved)
            cfg.read_files1 = [f1]
            if reads2 is not None:
                f2 = os.path.join(tmpd, "r2.fq")
                _shard_fastq(reads2, f2, process_id, num_processes)
                cfg.read_files2 = [f2]
            t0 = time.perf_counter()
            run_stream_mapping(engine, cfg, time.time())
            facts = dict(process_id=process_id, device=str(backend.device),
                         mapping_s=time.perf_counter() - t0)

        p = engine.profile
        L = idx.genome_size
        if engine.device_evidence is not None:
            # pull the RAW (unfolded, uncapped) device planes into the host
            # diff arrays so saturation happens exactly once, globally
            engine.device_evidence.download_raw_into(p)
            engine.device_evidence = None
        if p.F1_diff is None:
            p.alloc_diffs()

        # ---- ONE all-reduce of the raw evidence planes -------------------
        # (scalar stats ride the aux all_gather instead, as hi/lo words)
        st = engine.stats
        local = torch.from_numpy(np.concatenate([
            p.acgt.reshape(-1), p.read_count,
            p.exact_diff, p.F1_diff, p.R2_diff, p.F2_diff, p.R1_diff,
            p.multi_diff]).astype(np.int32))
        t0 = time.perf_counter()
        dist.all_reduce(local, op=dist.ReduceOp.SUM)
        facts.update(allreduce_s=time.perf_counter() - t0,
                     allreduce_bytes=local.numel() * local.element_size())
        reduced = local.numpy()

        # ---- events + discord sites: var-length all_gather ---------------
        # sizes are data-dependent, so processes first agree on the max
        # via a one-word max all-reduce, then pad to that and gather
        # [used_words, stat words, stream...]
        aux_words = _serialize_aux(p, engine.inv_sites, engine.tnl_sites)
        n_words = torch.tensor([aux_words.size], dtype=torch.int32)
        t0 = time.perf_counter()
        dist.all_reduce(n_words, op=dist.ReduceOp.MAX)
        facts["allmax_s"] = time.perf_counter() - t0
        max_words = int(n_words[0])
        stat_words = _stat_words(st)
        ns = stat_words.size
        aux_local = np.zeros(1 + ns + max_words, dtype=np.int32)
        aux_local[0] = aux_words.size
        aux_local[1:1 + ns] = stat_words
        aux_local[1 + ns:1 + ns + aux_words.size] = aux_words
        aux_t = torch.from_numpy(aux_local)
        rows = [torch.empty_like(aux_t) for _ in range(num_processes)]
        t0 = time.perf_counter()
        dist.all_gather(rows, aux_t)
        facts["allgather_s"] = time.perf_counter() - t0
        gathered = torch.stack(rows).numpy()
        if process_id != 0:
            return facts

        # ---- host 0: merge raw diffs + ONE finalize + call ---------------
        L1 = L + 1
        sizes = [4 * L, L, L1, L1, L1, L1, L1, L1]
        off = 0
        parts = []
        for s in sizes:
            parts.append(reduced[off:off + s])
            off += s
        p.acgt[:] = parts[0].reshape(4, L)                 # raw point adds
        p.read_count[:] = np.minimum(parts[1], cfg.max_duplicate)
        p.exact_diff[:] = parts[2]
        p.F1_diff[:] = parts[3]
        p.R2_diff[:] = parts[4]
        p.F2_diff[:] = parts[5]
        p.R1_diff[:] = parts[6]
        p.multi_diff[:] = parts[7]
        (st.total_reads, st.total_mapped, st.total_paired,
         st.total_paired_distance, st.read_length_sum) = _sum_stat_words(
            gathered[:, 1:1 + ns])
        p.break_point.clear()
        p.insert_map.clear()
        p.delete_map.clear()
        engine.inv_sites.clear()
        engine.tnl_sites.clear()
        for row in gathered:
            _decode_aux(row[1 + ns:], int(row[0]), p, engine.inv_sites,
                        engine.tnl_sites)
        engine.finalize()   # folds the merged diffs ONCE (cap-after-sum)
        run_calling(engine, cfg, cmd_line)   # the host caller (planes on host)
        return facts
    finally:
        dist.destroy_process_group()


def launch_ranks(cmds: Sequence[Sequence[str]], logs, timeout: float,
                 cwd: Optional[str] = None,
                 env: Optional[dict] = None) -> list:
    """Run the ranks of one multi-host run on this host, a process a
    command, each writing its output and errors to its log (an open
    binary file), and wait for them: a rank that exits non-zero gets the
    others killed, and every rank still running after `timeout` seconds
    is killed. -> the ranks' exit codes."""
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            procs.append(subprocess.Popen(cmd, cwd=cwd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if (time.time() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=30)
    return [p.returncode for p in procs]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--num", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--fasta", required=True)
    ap.add_argument("--reads", required=True)
    ap.add_argument("--reads2", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices", type=int, default=1,
                    help="local data-parallel cards per host (-devices N)")
    ap.add_argument("--device", default="cuda",
                    help="torch device this host maps on (Config.device); "
                         "cpu runs the plain versions of the kernels")
    args = ap.parse_args()
    run_host(args.pid, args.num, args.coordinator, args.fasta, args.reads,
             args.out, "multihost-test", reads2=args.reads2,
             devices=args.devices, device=args.device)


if __name__ == "__main__":
    main()
