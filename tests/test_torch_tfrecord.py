"""The port's TFRecord IO (tfde_tpu_torch.data.tfrecord) on the CPU.

- The cases of `tests/test_tfrecord.py` but the remote and tf.data ones:
  round trip, event files are TFRecord files, corruption, truncation, a
  closed writer, the Dataset over records, many files.
- The files are byte for byte the JAX writer's, and each package reads
  the other's.
- CRC-32C: the native walk, the table walk and the JAX package's agree,
  and the TensorBoard writer's `crc32c` goes through the native library.
- A path with a scheme (``gs://``, ``memory://``) raises
  NotImplementedError: remote file systems are not ported.
"""

import os
import struct

import numpy as np
import pytest

from tfde_tpu.data import tfrecord as jtfrecord
from tfde_tpu.observability import tensorboard as jtb
from tfde_tpu_torch import native
from tfde_tpu_torch.data.tfrecord import (
    TFRecordWriter, read_tfrecord, tfrecord_dataset, write_tfrecord)
from tfde_tpu_torch.observability import tensorboard as tb
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

RECORDS = [b"", b"x", b"hello world", bytes(range(256)) * 33]


def test_round_trip(tmp_path):
    path = str(tmp_path / "a.tfrecord")
    assert write_tfrecord(path, RECORDS) == 4
    assert list(read_tfrecord(path)) == RECORDS


def test_event_files_are_tfrecords(tmp_path):
    w = tb.SummaryWriter(str(tmp_path))
    w.scalars(1, {"loss": 0.5})
    w.close()
    event_file = [f for f in os.listdir(tmp_path) if "tfevents" in f][0]
    records = list(read_tfrecord(str(tmp_path / event_file)))
    assert len(records) >= 2 and b"loss" in records[1]


def test_corruption_detected(tmp_path):
    path = str(tmp_path / "b.tfrecord")
    write_tfrecord(path, [b"payload-one", b"payload-two"])
    blob = bytearray(open(path, "rb").read())
    blob[14] ^= 0xFF  # a payload byte of record 0
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="data crc mismatch"):
        list(read_tfrecord(path))
    recs = list(read_tfrecord(path, verify_crc=False))
    assert len(recs) == 2 and recs[1] == b"payload-two"
    blob[3] ^= 0x01  # the length header
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="length crc mismatch"):
        list(read_tfrecord(path))


def test_truncation_detected(tmp_path):
    path = str(tmp_path / "c.tfrecord")
    write_tfrecord(path, [b"abcdef"])
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-3])  # cut the trailing crc
    with pytest.raises(ValueError, match="truncated record body"):
        list(read_tfrecord(path))
    open(path, "wb").write(blob + blob[:5])  # half a header after a record
    with pytest.raises(ValueError, match="truncated record header"):
        list(read_tfrecord(path))


def test_writer_refuses_after_close_and_non_bytes(tmp_path):
    w = TFRecordWriter(str(tmp_path / "d.tfrecord"))
    w.write(b"one")
    with pytest.raises(TypeError, match="bytes-like"):
        w.write(10)
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.write(b"two")


def test_dataset_integration(tmp_path):
    path = str(tmp_path / "e.tfrecord")
    write_tfrecord(path, [struct.pack("<if", i, i * 0.5) for i in range(10)])

    def parse(rec):
        i, f = struct.unpack("<if", rec)
        return np.int32(i), np.float32(f)

    batches = list(iter(tfrecord_dataset(path, parse).shuffle(10, seed=0)
                        .batch(5)))
    assert len(batches) == 2
    assert sorted(np.concatenate([b[0] for b in batches]).tolist()) == \
        list(range(10))
    np.testing.assert_allclose(np.sort(np.concatenate([b[1] for b in
                                                       batches])),
                               np.arange(10) * 0.5)


def test_multiple_files(tmp_path):
    p1, p2 = str(tmp_path / "g1.tfrecord"), str(tmp_path / "g2.tfrecord")
    write_tfrecord(p1, [b"a"])
    write_tfrecord(p2, [b"b"])
    assert [e[0] for e in iter(tfrecord_dataset([p1, p2]))] == [b"a", b"b"]


def test_files_are_the_jax_writers_bytes_and_read_across(tmp_path):
    rng = np.random.default_rng(0)
    records = RECORDS + [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                         for n in (3, 64, 3073)]
    ours, theirs = str(tmp_path / "ours.tfrecord"), str(tmp_path / "j.tfrecord")
    write_tfrecord(ours, records)
    jtfrecord.write_tfrecord(theirs, records)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert list(jtfrecord.read_tfrecord(ours)) == records
    assert list(read_tfrecord(theirs)) == records


def test_crc32c_native_table_and_jax_agree():
    assert native.available()
    rng = np.random.default_rng(1)
    for n in (0, 1, 8, 13, 65536):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = tb.crc32c_table(data)
        assert native.crc32c(data) == tb.crc32c(data) == want
        assert jtb.crc32c(data) == want
        assert tb._masked_crc(data) == jtb._masked_crc(data)
    # the writer's crc is the native one once it is available
    assert tb._native_crc is native.crc32c


@pytest.mark.parametrize("url", ["gs://bucket/f.tfrecord",
                                 "memory://records/f.tfrecord"])
def test_remote_paths_are_not_ported(url):
    with pytest.raises(NotImplementedError, match="remote file"):
        TFRecordWriter(url)
    with pytest.raises(NotImplementedError, match="remote file"):
        list(read_tfrecord(url))
    with pytest.raises(NotImplementedError, match="remote file"):
        tfrecord_dataset([url])
