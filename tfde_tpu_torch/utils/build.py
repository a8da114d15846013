"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel library is one `csrc/*.cu` file with a plain C interface,
compiled at first use into `build/kernels/` beside the package (listed in
`.gitignore`) and named by a hash of its source and flags, so an edited
source never loads a stale binary. Nothing here falls back: a missing
`nvcc`, a failed compile or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_ROOT, "tfde_tpu_torch", "csrc")
BUILD_DIR = os.path.join(_ROOT, "build", "kernels")

#: sm_90a: Hopper with its arch-specific instructions (wgmma, setmaxnreg)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's kernels are built from tfde_tpu_torch/csrc at first use")


class KernelLibrary:
    """One compiled `.so`: the ctypes handle, the build seconds (0.0 when
    an up-to-date binary was reused) and nvcc's output (registers, shared
    memory and spills per kernel, from `-Xptxas -v`)."""

    def __init__(self, lib: ctypes.CDLL, path: str, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds
        self.log = log


def build_library(source: str, force: bool = False) -> KernelLibrary:
    """Compile `csrc/<source>` into `build/kernels/` (unless an identical
    build exists and `force` is false) and load it."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if force or not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)  # atomic: a reader never sees half a file
    return KernelLibrary(ctypes.CDLL(out), out, seconds, log)

