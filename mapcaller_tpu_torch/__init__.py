"""MapCaller on PyTorch + CUDA: a GPU short-read mapper + variant caller.

Port of `mapcaller_tpu` (the JAX/TPU package, kept beside this one as the
reference) to PyTorch on an NVIDIA Hopper card. Module names and layout
mirror the reference package, so each counterpart sits at the same
relative path. This package imports nothing of JAX or of `mapcaller_tpu`:
it keeps its own copy of every host module it needs.

Layer map:
  index/    — offline index construction + load     (host NumPy + C++)
  io/       — FASTQ/FASTA input, SAM/VCF/BAM output
  ops/      — device code: FM-index tables, the greedy-MEM seed scan,
              chaining/classification (PyTorch tensor code) and the
              batched NW extension kernel (hand-written CUDA, csrc/nw.cu)
  pipeline/ — mapping engine + stream driver; the C++ host leg
              (native/mc_native.cpp, built by native.py) runs
              pairing, slow-path alignment, SAM and the evidence arrays
  calling/  — variant caller + SV detection (host)

Every entry point puts its tables and batches on `Config.device`
("cuda" by default; the CPU tests pass "cpu").
"""

__version__ = "0.1.0"


def tune_host_allocator() -> None:
    """Keep large numpy temporaries on the reusable glibc heap instead of
    fresh mmaps, so genome-sized array passes do not pay first-touch page
    faults on every run."""
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except OSError:
        pass
