"""TensorBoard event-file writer, dependency-free — a copy of
`tfde_tpu/observability/tensorboard.py` (`crc32c` :49, `_masked_crc`
:55, `_tfrecord` :114, `SummaryWriter` :141) for local paths, so that
the port never imports the JAX package.

It writes standard `events.out.tfevents.*` files that any TensorBoard
reads, without TensorFlow: the Event/Summary protobuf wire format and the
TFRecord framing (length + masked crc32c) are small enough to encode by
hand. The JAX package's remote log directories (`utils/fs`: gs:// and
the like) are not ported: a log directory here is a local path.

Wire formats implemented:
- protobuf varint/length-delimited encoding for
  Event{wall_time=1(double), step=2(int64), file_version=3(string),
        summary=5(Summary)} and
  Summary{value=1(repeated Value{tag=1(string), simple_value=2(float)})};
- TFRecord: <len u64le><masked-crc32c(len) u32le><data><masked-crc32c(data)>.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, Optional


# -- crc32c (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c_table(data: bytes) -> int:
    """CRC-32C of `data` by the byte-at-a-time table walk: the plain
    version of `crc32c`."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


_native_crc = None  # resolved at first use; False: probed, unavailable


def crc32c(data: bytes) -> int:
    """CRC-32C of `data`: the native library's slice-by-8 walk
    (`native.crc32c`) where it is available, else `crc32c_table`. The
    native walk is what keeps a CRC-checked TFRecord reader from being
    bound by this check (`data.streaming`)."""
    global _native_crc
    if _native_crc is None:
        from tfde_tpu_torch import native

        _native_crc = native.crc32c if native.available() else False
    if _native_crc:
        return _native_crc(data)
    return crc32c_table(data)


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding ----------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    return _bytes_field(1, _bytes_field(1, tag.encode()) + _float(2, float(value)))


def _event(
    wall_time: float,
    step: Optional[int] = None,
    file_version: Optional[str] = None,
    summary_values: Optional[Dict[str, float]] = None,
) -> bytes:
    msg = _double(1, wall_time)
    if step is not None:
        msg += _int64(2, int(step))
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if summary_values:
        body = b"".join(_summary_value(t, v) for t, v in summary_values.items())
        msg += _bytes_field(5, body)
    return msg


def _tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


# -- public writer -----------------------------------------------------------


class SummaryWriter:
    """Append-only scalar summary writer for one local logdir.

    Usage: `w = SummaryWriter(model_dir); w.scalars(step, {"loss": 0.3})`.
    Only the chief process should construct one (host-side side effects are
    chief-only, matching the reference's worker-0 TensorBoard gating,
    mnist_keras:277-280).
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s%s" % (
            int(time.time()),
            socket.gethostname(),
            filename_suffix,
        )
        self._path = os.path.join(logdir, fname)
        self._lock = threading.Lock()
        self._f = open(self._path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))
        self.flush()

    def _write(self, event_bytes: bytes) -> None:
        with self._lock:
            self._f.write(_tfrecord(event_bytes))

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        self._write(
            _event(time.time(), step=step, summary_values={k: float(v) for k, v in values.items()})
        )

    def scalar(self, step: int, tag: str, value: float) -> None:
        self.scalars(step, {tag: value})

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    @property
    def path(self) -> str:
        return self._path
