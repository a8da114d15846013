"""The port's streaming TFRecord loader (tfde_tpu_torch.data.streaming) on
the CPU.

- The cases of `tests/test_streaming.py`: one epoch's exact multiset, the
  final partial batch and drop_remainder, the windowed seeded shuffle,
  infinite repeat reshuffling epochs, file sharding, hosts partitioning
  the records, a corrupt record surfacing in the consumer, bad arguments,
  and a throughput floor.
- The same batches as the JAX package's `StreamingTFRecordLoader`, bit
  for bit, for the same files, seed and sizes.
- Streaming into `Estimator.train` through `device_prefetch` for a few
  steps: the loss falls.
"""

import struct
import time

import numpy as np
import pytest

from tfde_tpu.data.streaming import (
    StreamingTFRecordLoader as JStreamingTFRecordLoader)
from tfde_tpu_torch import native
from tfde_tpu_torch.data.pipeline import AutoShardPolicy
from tfde_tpu_torch.data.streaming import StreamingTFRecordLoader, shard_files
from tfde_tpu_torch.data.tfrecord import write_tfrecord
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


def _write_shards(tmp_path, n_files, rows_per_file, dim=4):
    """Each record: <i32 id><dim f32 features deterministic in id>."""
    paths, rid = [], 0
    for f in range(n_files):
        recs = []
        for _ in range(rows_per_file):
            feat = (np.arange(dim, dtype=np.float32) + rid).tobytes()
            recs.append(struct.pack("<i", rid) + feat)
            rid += 1
        p = str(tmp_path / f"part-{f:03d}.tfrecord")
        write_tfrecord(p, recs)
        paths.append(p)
    return paths, rid


def _parse(rec):
    (i,) = struct.unpack("<i", rec[:4])
    return np.int32(i), np.frombuffer(rec[4:], np.float32)


def test_one_epoch_exact_multiset(tmp_path):
    paths, n = _write_shards(tmp_path, 3, 40)
    ids, feats = [], []
    for i, f in StreamingTFRecordLoader(paths, _parse, batch_size=16,
                                        window=32, seed=1, repeat=1):
        ids.extend(i.tolist())
        feats.append(f.copy())
    assert sorted(ids) == list(range(n))
    for row_id, row in zip(ids, np.concatenate(feats)):
        np.testing.assert_array_equal(row,
                                      np.arange(4, dtype=np.float32) + row_id)


def test_final_partial_batch_and_drop_remainder(tmp_path):
    paths, _ = _write_shards(tmp_path, 1, 37)
    kept = list(StreamingTFRecordLoader(paths, _parse, batch_size=8,
                                        window=16, repeat=1))
    assert sum(b[0].shape[0] for b in kept) == 37
    assert kept[-1][0].shape[0] == 37 % 8
    dropped = list(StreamingTFRecordLoader(paths, _parse, batch_size=8,
                                           window=16, repeat=1,
                                           drop_remainder=True))
    assert all(b[0].shape[0] == 8 for b in dropped)
    assert sum(b[0].shape[0] for b in dropped) == 37 - 37 % 8


def test_shuffle_windowed_and_seeded(tmp_path):
    paths, n = _write_shards(tmp_path, 2, 64)

    def run(seed):
        return [i for b in StreamingTFRecordLoader(
            paths, _parse, batch_size=16, window=64, seed=seed, repeat=1)
            for i in b[0].tolist()]

    a, b, c = run(5), run(5), run(6)
    assert a == b and a != c and a != sorted(a)
    assert sorted(a) == list(range(n))


def test_infinite_repeat_reshuffles_epochs(tmp_path):
    paths, n = _write_shards(tmp_path, 2, 32)
    loader = StreamingTFRecordLoader(paths, _parse, batch_size=16, window=48,
                                     seed=3, repeat=None)
    flat = [i for _ in range(12) for i in next(loader)[0].tolist()]
    assert sorted(flat[:n]) == list(range(n))
    assert sorted(flat[n:2 * n]) == list(range(n))
    assert flat[:n] != flat[n:2 * n]
    loader.close()


def test_shard_files_round_robin():
    paths = [f"p{i}" for i in range(7)]
    assert shard_files(paths, 0, 3) == ["p0", "p3", "p6"]
    assert shard_files(paths, 2, 3) == ["p2", "p5"]
    union = sorted(sum((shard_files(paths, h, 3) for h in range(3)), []))
    assert union == sorted(paths)
    with pytest.raises(ValueError, match="file-shard"):
        shard_files(paths[:2], 0, 3)
    with pytest.raises(ValueError, match="host_index"):
        shard_files(paths, 3, 3)


def test_hosts_partition_records(tmp_path):
    paths, n = _write_shards(tmp_path, 4, 16)
    all_ids = []
    for h in range(2):
        ids = [i for b in StreamingTFRecordLoader(
            paths, _parse, batch_size=8, window=32, repeat=1, host_index=h,
            host_count=2) for i in b[0].tolist()]
        assert len(ids) == n // 2
        all_ids.extend(ids)
    assert sorted(all_ids) == list(range(n))


def test_corrupt_record_surfaces_in_consumer(tmp_path):
    paths, _ = _write_shards(tmp_path, 1, 8)
    raw = bytearray(open(paths[0], "rb").read())
    raw[20] ^= 0xFF
    open(paths[0], "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc"):
        list(StreamingTFRecordLoader(paths, _parse, batch_size=4, window=8,
                                     repeat=1))


def test_bad_args(tmp_path):
    paths, _ = _write_shards(tmp_path, 1, 8)
    with pytest.raises(ValueError, match="window"):
        StreamingTFRecordLoader(paths, _parse, batch_size=16, window=8)
    with pytest.raises(ValueError, match="at least one"):
        StreamingTFRecordLoader([], _parse, batch_size=4)
    with pytest.raises(ValueError, match="together"):
        StreamingTFRecordLoader(paths, _parse, batch_size=4, host_index=0)
    with pytest.raises(ValueError, match="repeat"):
        StreamingTFRecordLoader(paths, _parse, batch_size=4, repeat=-1)
    with pytest.raises(NotImplementedError, match="remote file"):
        StreamingTFRecordLoader(["gs://b/f.tfrecord"], _parse, batch_size=4)


@pytest.mark.parametrize("kw", [
    dict(batch_size=16, window=48, repeat=2),
    dict(batch_size=8, window=40, repeat=1, drop_remainder=True),
    dict(batch_size=16, window=64, repeat=3, shuffle=False),
    dict(batch_size=8, window=24, repeat=1, host_index=1, host_count=2),
])
def test_batches_equal_the_jax_loader_bit_for_bit(tmp_path, kw):
    paths, _ = _write_shards(tmp_path, 4, 25)
    ours = list(StreamingTFRecordLoader(paths, _parse, seed=9, **kw))
    theirs = list(JStreamingTFRecordLoader(paths, _parse, seed=9, **kw))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for u, v in zip(a, b, strict=True):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_streaming_into_estimator_train(tmp_path):
    """TFRecord shards -> the loader -> device_prefetch -> Estimator.train
    (a PlainCNN at lr 0.1 with momentum): the loss falls."""
    from tfde_tpu_torch.models.cnn import PlainCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.runtime.mesh import LocalMesh
    from tfde_tpu_torch.training import Estimator, RunConfig
    from tfde_tpu_torch.training.optimizers import sgd

    rng = np.random.default_rng(0)
    # learnable structure: the label is the brightest quadrant
    imgs = rng.uniform(0, 0.3, (256, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 4, 256).astype(np.int64)
    for k, q in enumerate(labels):
        imgs[k, (q // 2) * 14:(q // 2) * 14 + 14,
             (q % 2) * 14:(q % 2) * 14 + 14] += 0.7
    path = str(tmp_path / "train.tfrecord")
    write_tfrecord(path, [imgs[k].tobytes() + struct.pack("<q", labels[k])
                          for k in range(256)])

    def parse(rec):
        img = np.frombuffer(rec[:-8], np.float32).reshape(28, 28, 1)
        return img, np.asarray(struct.unpack("<q", rec[-8:]), np.int64)

    model = PlainCNN(num_classes=4, device="cpu")
    est = Estimator(model, sgd(model, 0.1, momentum=0.9),
                    MultiWorkerMirroredStrategy(mesh=LocalMesh(("data",))),
                    RunConfig(save_checkpoints_steps=None))
    state = est.train(lambda: StreamingTFRecordLoader(
        path, parse, batch_size=16, window=64, seed=0), max_steps=60,
        shard_policy=AutoShardPolicy.OFF)
    est.close()
    loss = float(est.metrics["loss"])
    # ln 4 = 1.386 is a guess among the four classes
    assert state.step == 60 and loss < 0.5 * np.log(4), loss


def test_streaming_throughput_not_pathological(tmp_path):
    """Records/s of the stream against the in-memory native loader on the
    same rows: a floor far below a healthy rate (it catches an O(n^2), a
    stall, or the CRC falling back to the Python table walk)."""
    assert native.available()
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((2048, 64), dtype=np.float32)
    path = str(tmp_path / "tp.tfrecord")
    write_tfrecord(path, [imgs[k].tobytes() for k in range(2048)])

    def parse(rec):
        return (np.frombuffer(rec, np.float32),)

    loader = StreamingTFRecordLoader(path, parse, batch_size=128, window=512,
                                     repeat=4)
    t0 = time.perf_counter()
    n = sum(b[0].shape[0] for b in loader)
    stream_rps = n / (time.perf_counter() - t0)
    ldr = native.NativeBatchLoader([imgs], 128, repeat=4)
    t0 = time.perf_counter()
    m = sum(b[0].shape[0] for b in ldr)
    mem_rps = m / (time.perf_counter() - t0)
    assert n == m == 8192
    assert stream_rps > 15_000, (stream_rps, mem_rps)
    assert stream_rps * 300 > mem_rps, (stream_rps, mem_rps)
