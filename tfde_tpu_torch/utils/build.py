"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel library is one `csrc/*.cu` file with a plain C interface,
compiled at first use into `build/kernels/` beside the package (listed in
`.gitignore`) and named by a hash of its source, of every local header it
includes (`#include "..."`, followed transitively) and of the flags, so an
edited source or header never loads a stale binary. Nothing here falls back: a missing
`nvcc`, a failed compile or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
#: the CUDA driver API, for cuTensorMapEncodeTiled (the TMA tensor maps): linked
#: against the toolkit's stub, the CUDA driver's libcuda.so.1 loads at run time
LINK_FLAGS = ("-lcuda",)


def _toolkit_tool(name: str) -> str:
    for cand in (shutil.which(name),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"{name} not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        f"port's kernels are built from tfde_tpu_torch/csrc at first use")


def nvcc_path() -> str:
    return _toolkit_tool("nvcc")


def _link_dirs() -> tuple:
    """-L for the toolkit's libcuda stub, beside nvcc."""
    stubs = os.path.join(os.path.dirname(os.path.dirname(nvcc_path())),
                         "lib64", "stubs")
    return ("-L" + stubs,) if os.path.isdir(stubs) else ()


def count_opcodes(sass: str, opcodes) -> dict:
    """{kernel symbol: {opcode: count}} from the text `cuobjdump -sass`
    prints: one "Function : <symbol>" section per kernel."""
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        counts[name.strip()] = {op: len(re.findall(rf"\b{op}\b", body))
                                for op in opcodes}
    return counts


def sass_counts(path: str, opcodes=("HGMMA", "UTMALDG")) -> dict:
    """`count_opcodes` of a built library: how many of each instruction
    every kernel was compiled to."""
    proc = subprocess.run([_toolkit_tool("cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True)
    return count_opcodes(proc.stdout, opcodes)


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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_digest(path: str) -> str:
    """sha256 over the source at `path`, every local header it includes
    (resolved beside the including file, each once) and the nvcc flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    seen, todo = set(), [os.path.abspath(path)]
    while todo:
        cur = todo.pop(0)
        if cur in seen:
            continue
        seen.add(cur)
        with open(cur, "rb") as f:
            text = f.read()
        digest.update(os.path.basename(cur).encode() + b"\0" + text)
        todo += [os.path.join(os.path.dirname(cur), inc.decode())
                 for inc in _LOCAL_INCLUDE.findall(text)]
    return digest.hexdigest()


def build_library(source: str, force: bool = False) -> KernelLibrary:
    """Compile `csrc/<source>` into `build/kernels/` (unless an identical
    build exists and `force` is false) and load it."""
    src = os.path.join(CSRC, source)
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"{stem}-{source_digest(src)[:16]}.so")
    seconds, log = 0.0, ""
    if force or not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src,
                               *_link_dirs(), *LINK_FLAGS],
                              capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)  # atomic: a reader never sees half a file
    return KernelLibrary(ctypes.CDLL(out), out, seconds, log)

