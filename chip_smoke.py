#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mapcaller_tpu_torch) on one NVIDIA
card: builds the kernels from the sources in the checkout, holds every
hand-written kernel against its plain PyTorch version, drives the main
path end to end and checks what comes out.

    python3 chip_smoke.py

Phases, one JSON line each on stdout (any failure raises and the process
exits non-zero):
  env        card name and power limit (nvidia-smi), torch and CUDA
  build      nvcc for csrc/*.cu and g++ for the C++ host leg, in parallel
  kernels    the CUDA NW kernel equals its plain version exactly at every
             DP tier (32, 48, 96, 192), with its time, the plain
             version's time and the bound
  small_e2e  a 20 kb planted dataset: the port on cuda and on cpu write
             byte-identical SAM and VCF
  main_path  100,000 read pairs on a 4.6 Mb genome through
             `python -m mapcaller_tpu_torch.cli` (in process), with the
             NW kernel's launches counted; then the same run with the
             scalar C++ DP must give byte-identical SAM and VCF
Then the kernel table line ({"kernels": [...]}, timed at the main path's
own DP shapes), the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

Needs one CUDA card, nvcc and g++. Refuses to run without a card.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIERS = (32, 48, 96, 192)
H100_BYTES_S = 3.35e12            # HBM3 rate, H100 SXM data sheet
# int32 issue rate: 64 INT32 lanes per SM (half the 128 FP32 lanes whose
# 67 TFLOP/s counts an FMA as 2), 132 SMs at the 1.98 GHz boost clock
H100_INT32_OPS_S = 132 * 64 * 1.98e9
NW_OPS_PER_CELL = 10              # see csrc/nw.cu


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, reps, warmup=3):
    """Median time of fn() over `reps` runs, each bracketed by CUDA
    events, after `warmup` runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nw_inputs(B, M, seed):
    """B random pairs for an M x M tier on the card: lengths uniform in
    [0, M] with the edges (0 and M) forced on the first pairs, s2 a
    mutated copy of s1 on most pairs."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    m = rng.integers(0, M + 1, size=B).astype(np.int32)
    n = rng.integers(0, M + 1, size=B).astype(np.int32)
    m[:4], n[:4] = [0, M, 0, M], [0, M, M, 0]
    c1 = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
    c2 = c1.copy()
    mut = rng.random((B, M)) < 0.1
    c2[mut] = rng.integers(0, 4, size=int(mut.sum()))
    c2[::5] = rng.integers(0, 4, size=c2[::5].shape)
    cols = np.arange(M)[None, :]
    c1[cols >= m[:, None]] = 4
    c2[cols >= n[:, None]] = 4
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(x).to(dev) for x in (c1, c2, m, n))


def nw_bound_ms(c1, c2, m, n):
    """Least time for the function on these inputs: the larger of the
    int32 operations its cells need and the bytes it must move."""
    B, M = c1.shape
    N = c2.shape[1]
    cells = int(((m.long() + 1) * (n.long() + 1)).sum())
    ops = NW_OPS_PER_CELL * cells
    nbytes = B * (M + N) + 8 * B + 4 * B * (M + N) // 16 + 4 * B
    return 1e3 * max(ops / H100_INT32_OPS_S, nbytes / H100_BYTES_S), \
        ("operations" if ops / H100_INT32_OPS_S >= nbytes / H100_BYTES_S
         else "bytes")


def check_nw(nw, B, M, seed, reps):
    """Kernel vs plain version on the card at (B, M, M): exact equality,
    then times. Returns the measurement dict."""
    import torch
    args = nw_inputs(B, M, seed)
    launches = nw.STATS.launches
    kw, ks = nw.nw_ops(*args)
    pw, ps = nw.nw_ops_plain(*args)
    torch.cuda.synchronize()
    err = max(int((kw.long() - pw.long()).abs().max()),
              int((ks.long() - ps.long()).abs().max()))
    if err != 0 or not torch.equal(kw, pw) or not torch.equal(ks, ps):
        raise AssertionError(f"NW kernel != plain version at B={B} M={M} "
                             f"(max_abs_err {err})")
    ms = cuda_ms(lambda: nw.nw_ops(*args), reps)
    plain_ms = cuda_ms(lambda: nw.nw_ops_plain(*args), 3, warmup=1)
    bound, by = nw_bound_ms(*args)
    return dict(B=B, M=M, N=M, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by,
                launches=nw.STATS.launches - launches)


def same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def run_small_e2e(work):
    """Port on cuda vs port on cpu, default flags, planted 20 kb set."""
    from mapcaller_tpu_torch import runner
    from mapcaller_tpu_torch.config import Config
    from mapcaller_tpu_torch.index.fmindex import build_index
    from mapcaller_tpu_torch.ops import nw_device
    from mapcaller_tpu_torch.simulator import write_planted_dataset
    d = os.path.join(work, "small")
    os.makedirs(d)
    fa, f1, f2 = write_planted_dataset(d)
    build_index(fa, os.path.join(d, "idx"))
    outs = {}
    for dev in ("cuda", "cpu"):
        launches = nw_device.STATS.launches
        cfg = Config(device=dev, index_prefix=os.path.join(d, "idx"),
                     read_files1=[f1], read_files2=[f2],
                     stream_batch_size=1024,
                     sam_file=os.path.join(d, f"{dev}.sam"),
                     vcf_file=os.path.join(d, f"{dev}.vcf"),
                     log_file=os.path.join(d, f"{dev}.log"))
        if runner.run_pipeline(cfg, "mapcaller small_e2e") != 0:
            raise RuntimeError(f"small_e2e run on {dev} failed")
        outs[dev] = (cfg.sam_file, cfg.vcf_file,
                     nw_device.STATS.launches - launches)
    sam_ok = same_bytes(outs["cuda"][0], outs["cpu"][0])
    vcf_ok = same_bytes(outs["cuda"][1], outs["cpu"][1])
    with open(outs["cuda"][1]) as f:
        n_var = sum(1 for ln in f if not ln.startswith("#"))
    emit("small_e2e", sam_identical=sam_ok, vcf_identical=vcf_ok,
         variants=n_var, nw_launches_cuda=outs["cuda"][2],
         nw_launches_cpu=outs["cpu"][2])
    if not (sam_ok and vcf_ok and n_var > 0 and outs["cuda"][2] > 0
            and outs["cpu"][2] == 0):
        raise AssertionError("small_e2e: cuda and cpu outputs differ, no "
                             "variants, or the NW kernel did not run")


def last_metrics(log):
    with open(log) as f:
        return json.loads([ln for ln in f if ln.startswith("{")][-1])


def run_main_path(work, card):
    import torch
    from mapcaller_tpu_torch import cli, runner
    from mapcaller_tpu_torch.ops import nw_device
    from mapcaller_tpu_torch.simulator import write_ecoli_set
    d = os.path.join(work, "main")
    os.makedirs(d)
    t0 = time.time()
    fa, r1, r2 = write_ecoli_set(d)
    idx = os.path.join(d, "mci")
    if cli.main(["mapcaller", "index", fa, idx]) != 0:
        raise RuntimeError("index build failed")
    setup_s = time.time() - t0
    sam, vcf, log = (os.path.join(d, x) for x in ("out.sam", "out.vcf",
                                                  "job.log"))
    argv = ["mapcaller", "-i", idx, "-f", r1, "-f2", r2, "-sam", sam,
            "-vcf", vcf, "-log", log]
    # run 1: default flags, through the CLI a user calls
    torch.cuda.reset_peak_memory_stats()
    nw_device.STATS.reset()
    if cli.main(argv) != 0:
        raise RuntimeError("main path run failed")
    launches = nw_device.STATS.launches
    pairs = nw_device.STATS.pairs
    shapes = dict(nw_device.STATS.shapes)
    peak = torch.cuda.max_memory_allocated()
    m1 = last_metrics(log)
    os.replace(sam, sam + ".devdp")
    os.replace(vcf, vcf + ".devdp")
    # run 2: the same command with the scalar C++ DP
    cfg = cli.parse_args(argv)
    cfg.device_extension = False
    nw_device.STATS.reset()
    if runner.run_pipeline(cfg, " ".join(argv)) != 0:
        raise RuntimeError("scalar-DP run failed")
    m2 = last_metrics(log)
    sam_ok = same_bytes(sam, sam + ".devdp")
    vcf_ok = same_bytes(vcf, vcf + ".devdp")
    emit("main_path", card=card, setup_s=setup_s,
         reads=m1["total_reads"], reads_per_s=m1["reads_per_sec"],
         mapping_s=m1["mapping_seconds"], calling_s=m1["calling_seconds"],
         total_s=m1["total_seconds"],
         mapped_pct=100.0 * m1["mapped"] / max(m1["total_reads"], 1),
         variants=m1["variant_counts"],
         n_oracle_reads=m1["n_oracle_reads"],
         n_tier_reruns=m1["n_tier_reruns"],
         nw_launches=launches, nw_pairs=pairs,
         nw_shapes={f"{b}x{m}x{n}": c for (b, m, n), c in shapes.items()},
         peak_mem_bytes=peak,
         scalar_dp_reads_per_s=m2["reads_per_sec"],
         scalar_dp_mapping_s=m2["mapping_seconds"],
         scalar_dp_nw_launches=nw_device.STATS.launches,
         sam_identical=sam_ok, vcf_identical=vcf_ok)
    if not (launches > 0 and pairs > 0 and sam_ok and vcf_ok
            and nw_device.STATS.launches == 0):
        raise AssertionError("main_path: NW kernel not launched, or device "
                             "DP and scalar DP outputs differ")
    return launches, shapes


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device visible; this smoke "
                         "run needs an NVIDIA card\n")
        return 2
    sys.path.insert(0, HERE)
    from mapcaller_tpu_torch import toolchain
    from mapcaller_tpu_torch.ops import nw_device

    card = card_line()
    print(card, flush=True)
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0])

    t0 = time.time()
    toolchain.build_all()
    emit("build", seconds=time.time() - t0,
         nvcc=" ".join(toolchain.NVCC_FLAGS),
         libs=sorted(os.listdir(toolchain.BUILD_DIR)))

    for tier in TIERS:
        r = check_nw(nw_device, 4096 if tier < 192 else 2048, tier,
                     seed=tier, reps=20)
        emit("kernels", kernel="nw", card=card, **r)

    os.makedirs(toolchain.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=toolchain.BUILD_DIR) as work:
        run_small_e2e(work)
        launches, shapes = run_main_path(work, card)

    # the kernel table, timed at the main path's most used DP shape
    (B, M, _N), _ = max(shapes.items(), key=lambda kv: (kv[1], kv[0][0]))
    r = check_nw(nw_device, B, M, seed=1, reps=20)
    line = {"kernels": [{
        "name": "nw_ops", "route": "cuda",
        "source": "mapcaller_tpu_torch/csrc/nw.cu",
        "replaces": "mapcaller_tpu/ops/nw_device.py:136",
        "launches": launches, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "tolerance": 0, "shape": f"{B}x{M}x{M}"}]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
