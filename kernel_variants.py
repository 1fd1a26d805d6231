"""What chain_variants.py and ksw2_variants.py share: a kernel source
edited as text, every variant compiled at once with the port's nvcc
flags, each variant's library bound in place of the port's own in turn,
a main-path run on simulated E. coli-scale data, and the script's frame
(the card's name and power limit, then one JSON line). Needs one CUDA
card and nvcc."""
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def edit(s, old, new):
    """`s` with `old` replaced by `new`; raises if `s` does not hold it."""
    if old not in s:
        raise ValueError(f"the source no longer holds {old!r}")
    return s.replace(old, new)


def set_const(s, name, value):
    """`s` with its `constexpr int name = ...;` set to `value`."""
    cur = s.split(f"constexpr int {name} = ", 1)[1].split(";")[0]
    return edit(s, f"{name} = {cur};", f"{name} = {value};")


def build(src_path, names, variant_source, kernels, workdir):
    """Compile every variant (variant_source(name, source) -> its text)
    at once, and the port's own sources meanwhile -> {name: (library,
    {kernel: its ptxas report} for each name in `kernels`)}."""
    sys.path.insert(0, HERE)
    import chip_smoke
    from mapcaller_tpu_torch import toolchain
    with open(src_path) as f:
        src = f.read()
    procs = {}
    for n in names:
        cu = os.path.join(workdir, f"{n}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(n, src))
        lib = os.path.join(workdir, f"lib{n}.so")
        procs[n] = (lib, subprocess.Popen(
            [toolchain.nvcc_path(), *toolchain.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    toolchain.build_all()
    out = {}
    for n, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{n}: nvcc failed\n{log[-3000:]}")
        out[n] = (lib, {k: chip_smoke.ptxas_report(log, k)
                        for k in kernels})
    return out


@contextlib.contextmanager
def bound(module, lib_path):
    """The library at lib_path in place of `module`'s own (its `_lib`),
    each of the own library's entry points typed alike, until the block
    ends."""
    own = module._load_kernel()
    lib = ctypes.CDLL(lib_path)
    for fn in dir(own):
        if fn.startswith("mc_") and hasattr(lib, fn):
            getattr(lib, fn).restype = getattr(own, fn).restype
            getattr(lib, fn).argtypes = getattr(own, fn).argtypes
    module._lib = lib
    try:
        yield lib
    finally:
        module._lib = own


def main_path_argv(workdir, n_pairs):
    """Index a simulated E. coli-scale set of n_pairs read pairs
    (mapcaller_tpu_torch.simulator) -> the command line that maps and
    calls it, its outputs in workdir."""
    from mapcaller_tpu_torch import cli
    from mapcaller_tpu_torch.simulator import write_ecoli_set
    fa, r1, r2 = write_ecoli_set(workdir, n_pairs)
    idx = os.path.join(workdir, "mci")
    if cli.main(["mapcaller", "index", fa, idx]) != 0:
        raise RuntimeError("index build failed")
    return ["mapcaller", "-i", idx, "-f", r1, "-f2", r2, "-sam",
            os.path.join(workdir, "out.sam"), "-vcf",
            os.path.join(workdir, "out.vcf"), "-log",
            os.path.join(workdir, "job.log")]


def run(doc, argv, body):
    """The frame of a variants script: its usage (doc) without a card or
    a variant; else the card's line, body(variants, workdir) -> dict in a
    scratch directory of the build directory, and that dict with the
    card's line as one JSON line."""
    argv = sys.argv[1:] if argv is None else argv
    import torch
    if not torch.cuda.is_available() or not argv:
        sys.stderr.write(doc)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from mapcaller_tpu_torch import toolchain
    card = chip_smoke.card_line()
    print(card, flush=True)
    os.makedirs(toolchain.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=toolchain.BUILD_DIR) as work:
        out = body(argv, work)
    print(json.dumps(dict(card=card, **out)), flush=True)
    return 0
