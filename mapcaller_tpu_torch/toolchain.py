"""Build the port's native libraries at first use.

Two shared libraries, both compiled from sources in the checkout into the
git-ignored `mapcaller_tpu_torch/build/` directory:

  * libmc_native.so — the C++ host leg `native/mc_native.cpp` (shared
    with the reference package, which is never written: the reference
    loader may rebuild into `native/`, this one builds only here);
  * lib<name>.so    — each CUDA source `csrc/<name>.cu`, compiled with
    nvcc for sm_90a into a plain C interface loaded with ctypes.

A build runs once per source change: the library is rebuilt when it is
older than its source. Concurrent processes (pytest workers) serialise
on a lock file and the library is renamed into place atomically, so no
process ever loads a half-written file.
"""
from __future__ import annotations

import fcntl
import glob
import os
import shutil
import subprocess
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_SRC = os.path.join(REPO_DIR, "native", "mc_native.cpp")

# -Xptxas -v: each kernel's registers, shared memory, stack frame and
# spills, which build_all hands back
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def native_lib_path() -> str:
    return os.path.join(BUILD_DIR, "libmc_native.so")


def cuda_lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def nvcc_path() -> str:
    """nvcc from PATH, else from the toolkit at $CUDA_HOME (default
    /usr/local/cuda, the toolkit's own install prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError("nvcc not found: the CUDA kernels need the CUDA "
                            "toolkit (on PATH or under $CUDA_HOME/bin)")


def native_command(out: str) -> List[str]:
    return ["g++", *GXX_FLAGS, "-o", out, NATIVE_SRC]


def cuda_command(name: str, out: str) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC_DIR, f"{name}.cu")]


def _run(cmd: List[str]) -> None:
    """Run a compiler; on failure raise with the end of its output."""
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"({res.returncode}):\n{res.stderr[-4000:]}")


def _stale(lib: str, src: str) -> bool:
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def _build(lib: str, src: str, command) -> str:
    """Build `lib` from `src` with command(tmp_out) unless it is current."""
    if not _stale(lib, src):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _stale(lib, src):          # another process may have built it
                tmp = f"{lib}.{os.getpid()}.tmp"
                _run(command(tmp))
                os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def ensure_native() -> str:
    return _build(native_lib_path(), NATIVE_SRC, native_command)


def ensure_cuda(name: str) -> str:
    return _build(cuda_lib_path(name), os.path.join(CSRC_DIR, f"{name}.cu"),
                  lambda out: cuda_command(name, out))


def cuda_sources() -> List[str]:
    """Names of the CUDA sources, csrc/<name>.cu."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_all() -> Dict[str, str]:
    """Compile the host leg and every CUDA source at once, one compiler
    process per source, all started together (chip_smoke's build
    phase). Returns each library's compiler output by file name (for a
    CUDA source, the -Xptxas -v report); raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = [(native_lib_path(), native_command)]
    jobs += [(cuda_lib_path(n), lambda out, n=n: cuda_command(n, out))
             for n in cuda_sources()]
    procs = []
    for lib, cmd in jobs:
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs.append((lib, tmp, subprocess.Popen(
            cmd(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    outputs = {}
    for lib, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{os.path.basename(lib)}:\n{out[-4000:]}")
        else:
            os.replace(tmp, lib)
            outputs[os.path.basename(lib)] = out
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return outputs
