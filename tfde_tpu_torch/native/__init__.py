"""ctypes bindings for the native host data loader (`loader.cc`) —
counterpart of `tfde_tpu/native/__init__.py` (`_build` :34, `_get_lib`
:53, `available` :86, `crc32c` :90, `NativeBatchLoader` :101).

`loader.cc` is a copy of the JAX package's source, unchanged, so that the
two loaders give the same batches bit for bit for the same arrays and
seed. It is host C++ (no CUDA): `g++ -O3 -shared -fPIC` at first use,
into `build/native/` beside the package (listed in `.gitignore`), or into
``$TFDE_NATIVE_CACHE`` where that is set, as in the JAX package. The
library is named by a hash of its source and the compiler flags, so an
edited source never loads a stale binary.

`available()` reports whether the library built and loaded; a compile
error is logged at WARNING once and the answer is then False for the
process. A caller that leaves the choice open (``use_native=None`` in
the entry points) takes the Python pipeline (`data.pipeline.Dataset`)
when it is False. A caller that asks for the loader (`NativeBatchLoader`
itself, or ``use_native=True``) gets a RuntimeError: never the Python
pipeline in its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from tfde_tpu_torch import knobs

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loader.cc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> str:
    """Where the library for this source and these flags lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0"
                                + f.read()).hexdigest()[:16]
    cache = knobs.env_str("TFDE_NATIVE_CACHE") or BUILD_DIR
    return os.path.join(cache, f"tfde_loader-{digest}.so")


def compile_library(so: str) -> None:
    """Compile `loader.cc` into the shared library `so` with g++."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"  # processes may build at once
    subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, so)  # atomic: a reader never sees half a file


def _build() -> ctypes.CDLL:
    so = library_path()
    if not os.path.exists(so):
        compile_library(so)
    return ctypes.CDLL(so)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = _build()
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            log.warning("native loader unavailable (%s%s); callers that "
                        "leave the choice open use the Python pipeline", e,
                        ": " + detail.decode(errors="replace")[-2000:]
                        if detail else "")
            _build_failed = True
            return None
        lib.tfde_loader_create.restype = ctypes.c_void_p
        lib.tfde_loader_create.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.tfde_loader_next.restype = ctypes.c_int64
        lib.tfde_loader_next.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_void_p)]
        lib.tfde_loader_release.restype = None
        lib.tfde_loader_release.argtypes = [ctypes.c_void_p]
        lib.tfde_loader_stop.restype = None
        lib.tfde_loader_stop.argtypes = [ctypes.c_void_p]
        lib.tfde_loader_destroy.restype = None
        lib.tfde_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.tfde_crc32c.restype = ctypes.c_uint32
        lib.tfde_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
    return _lib


def available() -> bool:
    """True once the library has built and loaded (the first call builds
    it)."""
    return _get_lib() is not None


def crc32c(data: bytes) -> Optional[int]:
    """CRC-32C (Castagnoli) of `data` by the library's slice-by-8 table
    walk, or None when the library is unavailable (the caller then walks
    its own table: `observability.tensorboard`)."""
    lib = _get_lib()
    if lib is None:
        return None
    return int(lib.tfde_crc32c(bytes(data), len(data)))


class NativeBatchLoader:
    """Threaded shuffle + gather + prefetch over in-memory arrays that
    share a leading dimension.

    A per-epoch Fisher-Yates permutation (splitmix64 from seed + epoch),
    the memcpy row gather and a `depth`-deep ring of batch slots run in
    C++ threads, outside the interpreter lock. Semantics are those of
    ``Dataset.shuffle(n).repeat(repeat).batch(batch_size)``: batches run
    across epoch boundaries, and the final short batch is kept unless
    `drop_remainder`. `repeat` None repeats forever.

    Yields tuples of numpy arrays. They are views of a ring slot, valid
    only until the next ``__next__`` (which hands the slot back to the
    workers): copy or stage them before advancing, or pass `copy=True`
    for owned arrays. Raises RuntimeError when the library is
    unavailable.
    """

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        repeat: Optional[int] = None,
        drop_remainder: bool = False,
        num_threads: int = 2,
        depth: int = 4,
        copy: bool = False,
    ):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(
                "the native loader was asked for, and its library did not "
                "build or load (the WARNING logged by "
                "tfde_tpu_torch.native says why); use "
                "data.pipeline.Dataset, or leave use_native=None")
        self._lib = lib
        self._arrays = [np.ascontiguousarray(a) for a in arrays]
        if not self._arrays:
            raise ValueError("need at least one array")
        n = self._arrays[0].shape[0]
        if any(a.ndim == 0 or a.shape[0] != n for a in self._arrays):
            raise ValueError("all arrays must share the leading dimension")
        if n == 0 or batch_size < 1:
            raise ValueError(f"need rows and a batch size >= 1, got {n} "
                             f"rows and batch_size {batch_size}")
        self._batch = int(batch_size)
        self._copy = copy
        self._row_shapes = [a.shape[1:] for a in self._arrays]
        self._dtypes = [a.dtype for a in self._arrays]
        row_bytes = [int(a.strides[0]) if a.ndim > 1 else a.itemsize
                     for a in self._arrays]
        n_arr = len(self._arrays)
        ptrs = (ctypes.c_void_p * n_arr)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self._arrays])
        rb = (ctypes.c_int64 * n_arr)(*row_bytes)
        self._handle = lib.tfde_loader_create(
            n_arr, ptrs, rb, n, self._batch,
            int(drop_remainder), int(shuffle), seed,
            -1 if repeat is None else int(repeat),
            num_threads, depth,
        )
        if not self._handle:
            raise RuntimeError("tfde_loader_create failed")
        self._out = (ctypes.c_void_p * n_arr)()
        self._pending_release = False
        self._close_lock = threading.Lock()
        self._in_next = 0  # consumers currently inside the native call

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, ...]:
        # the handle is captured and the consumer counted in under the
        # lock, so a concurrent close() either sees it and defers the free
        # until it drains, or swapped the handle first and this stops here
        with self._close_lock:
            handle = self._handle
            if handle is None:
                raise StopIteration
            self._in_next += 1
        try:
            if self._pending_release:
                self._lib.tfde_loader_release(handle)
                self._pending_release = False
            rows = self._lib.tfde_loader_next(handle, self._out)
        finally:
            with self._close_lock:
                self._in_next -= 1
        if rows == 0:
            self.close()
            raise StopIteration
        out = []
        for i, (shape, dtype) in enumerate(zip(self._row_shapes,
                                               self._dtypes)):
            nbytes = int(rows) * int(np.prod(shape, dtype=np.int64)) \
                * dtype.itemsize
            buf = (ctypes.c_char * nbytes).from_address(self._out[i])
            arr = np.frombuffer(buf, dtype=dtype).reshape((int(rows),) + shape)
            out.append(arr.copy() if self._copy else arr)
        self._pending_release = True
        return tuple(out)

    def close(self) -> None:
        """Stop the workers and free the loader. Safe from a second thread
        while a consumer is anywhere in ``__next__``: stop wakes a blocked
        consumer (it gets StopIteration), the consumers drain, and only
        then is the loader freed."""
        with self._close_lock:
            handle, self._handle = self._handle, None
        if handle is None:
            return
        self._lib.tfde_loader_stop(handle)
        while True:
            with self._close_lock:
                if self._in_next == 0:
                    break
            time.sleep(0.001)
        self._lib.tfde_loader_destroy(handle)

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone
            pass
