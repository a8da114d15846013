"""TFRecord file IO — counterpart of `tfde_tpu/data/tfrecord.py`
(`TFRecordWriter` :27, `write_tfrecord` :66, `read_tfrecord` :76,
`tfrecord_dataset` :116).

A TFRecord file is a sequence of records, each framed as
``<len u64le><masked-crc32c(len) u32le><data><masked-crc32c(data)>``: the
framing of TensorBoard's event files (`observability.tensorboard`, whose
`_masked_crc` and `_tfrecord` this module reuses), so the files this
writes are byte for byte the JAX package's and TensorFlow's, and each
reads the others'.

Local paths only. The JAX package routes every path through `utils/fs`,
so that ``gs://`` and ``memory://`` URLs work like files; here a path
with a scheme raises NotImplementedError (remote file systems come with
their own slice, ROADMAP).
"""

from __future__ import annotations

import io
import re
import struct
from typing import Callable, Iterable, Iterator, Optional, Sequence, Union

from tfde_tpu_torch.observability.tensorboard import _masked_crc, _tfrecord

_SCHEME = re.compile(r"^[A-Za-z][A-Za-z0-9+.-]*://")


def local_path(path: str) -> str:
    """`path` as it is; NotImplementedError for a URL (``gs://...``)."""
    if _SCHEME.match(str(path)):
        raise NotImplementedError(
            f"{path}: remote file systems (gs://, memory://, ...) are not "
            f"ported; they come with the remote file-system slice (the JAX "
            f"package's utils/fs, ROADMAP). Use a local path.")
    return path


class TFRecordWriter:
    """Write length-prefixed, crc-framed records to one local file.

    Buffers in memory and writes the file on flush/close, as the JAX
    writer does (its object stores have no append)."""

    def __init__(self, path: str):
        self._path = local_path(path)
        self._buf = io.BytesIO()
        self._closed = False

    def write(self, record: bytes) -> None:
        if self._closed:
            raise ValueError(f"writer for {self._path} is closed")
        if not isinstance(record, (bytes, bytearray, memoryview)):
            # bytes(10) would silently write ten NUL bytes with valid CRCs
            raise TypeError(
                f"record must be bytes-like, got {type(record).__name__}")
        self._buf.write(_tfrecord(bytes(record)))

    def flush(self) -> None:
        with open(self._path, "wb") as f:
            f.write(self._buf.getvalue())

    def close(self) -> None:
        if not self._closed:
            self.flush()
            self._closed = True

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_tfrecord(path: str, records: Iterable[bytes]) -> int:
    """Write all `records` to `path`; returns the record count."""
    n = 0
    with TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
            n += 1
    return n


def read_tfrecord(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield each record's payload bytes from a TFRecord file, streaming:
    peak memory is one record, not the file.

    With `verify_crc` (the default) both CRCs of every record are checked:
    a flipped bit or a truncated tail raises ValueError with the byte
    offset, never yields garbage."""
    with open(local_path(path), "rb") as f:
        off = 0
        while True:
            framing = f.read(12)
            if not framing:
                return  # clean EOF on a record boundary
            if len(framing) < 12:
                raise ValueError(
                    f"{path}: truncated record header at byte {off} "
                    f"({len(framing)} trailing bytes)")
            header = framing[:8]
            (length,) = struct.unpack("<Q", header)
            (len_crc,) = struct.unpack("<I", framing[8:])
            if verify_crc and _masked_crc(header) != len_crc:
                raise ValueError(f"{path}: length crc mismatch at byte {off}")
            body = f.read(length + 4)
            if len(body) < length + 4:
                raise ValueError(
                    f"{path}: truncated record body at byte {off} "
                    f"(need {length + 4} bytes, have {len(body)})")
            data = body[:length]
            (data_crc,) = struct.unpack("<I", body[length:])
            if verify_crc and _masked_crc(data) != data_crc:
                raise ValueError(f"{path}: data crc mismatch at byte {off}")
            yield data
            off += 12 + length + 4


def tfrecord_dataset(paths: Union[str, Sequence[str]],
                     parse_fn: Optional[Callable[[bytes], object]] = None):
    """A `data.pipeline.Dataset` over the records of one or more TFRecord
    files: files in order, records in file order (shuffle on top, the
    tf.data convention). `parse_fn` maps a payload to the element (a
    tuple of numpy values, say); identity when None. Lazy: the files are
    read on each iteration."""
    from tfde_tpu_torch.data.pipeline import Dataset

    paths = [paths] if isinstance(paths, str) else list(paths)
    for p in paths:
        local_path(p)

    def it(epoch=0):
        for p in paths:
            for rec in read_tfrecord(p):
                el = parse_fn(rec) if parse_fn is not None else rec
                yield el if isinstance(el, tuple) else (el,)

    return Dataset(it, None)
