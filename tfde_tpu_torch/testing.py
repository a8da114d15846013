"""Multi-process helpers for the port's CPU tests and for
`chip_smoke.py`'s run across cards.

`run_ranks` runs a function on N local processes and returns what each
returned; the worker functions below are what the tests and the smoke
hand it. They live in the package, not in the test files, because a
spawned process imports the module of its function, and the test files
import JAX. Each child uses one CPU thread; a group a worker builds
rendezvouses through a `FileStore` (``file://``) or, for
`bootstrap_worker`, through `bootstrap()`'s TCP store on a port the test
picked free. Every group is destroyed in a `finally`.

`recipe` is the verify recipe through the Estimator, and
``python -m tfde_tpu_torch.testing MODEL_DIR OUT_JSON --max-steps N``
(`recipe_main`; on CUDA unless ``--device cpu``) runs it in a process of
its own, which the preemption test and `chip_smoke.py`'s lifecycle phase
interrupt by SIGTERM.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _child(fn: Callable, rank: int, args: tuple, results) -> None:
    torch.set_num_threads(1)
    try:
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, args_per_rank: Sequence[tuple],
              timeout: float = 120.0) -> list:
    """Run ``fn(rank, *args_per_rank[rank])`` in one spawned process per
    rank and return the results in rank order. `fn` must be importable
    (defined at a module's top level). Raises RuntimeError with a child's
    traceback if one fails, TimeoutError if they are not all done within
    `timeout` seconds; every child is ended before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, tuple(a), results),
                         daemon=True)
             for r, a in enumerate(args_per_rank)]
    for p in procs:
        p.start()
    out = {}
    try:
        while len(out) < len(procs):
            try:
                rank, ok, payload = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{len(procs) - len(out)} of {len(procs)} "
                                   f"ranks did not finish in {timeout} s")
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(len(procs))]


def _init_file_group(rank: int, world: int, store_path: str,
                     backend: str = "gloo") -> None:
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world)


def mesh_worker(rank: int, world: int, store_path: str) -> dict:
    """The meshes of a `world`-rank gloo group, as plain values."""
    from tfde_tpu_torch.parallel.strategies import MirroredStrategy
    from tfde_tpu_torch.runtime import mesh as mesh_lib

    _init_file_group(rank, world, store_path)
    try:
        dp = mesh_lib.data_parallel_mesh()
        two = mesh_lib.make_mesh({"tensor": world, "data": 1})
        mirrored = MirroredStrategy()
        return {
            "dp": (dp.mesh_dim_names, tuple(dp.shape),
                   dp.get_local_rank("data")),
            "two": (two.mesh_dim_names, tuple(two.shape),
                    two.mesh.tolist()),
            "mirrored": (mirrored.num_replicas, mirrored.batch_divisor,
                         mirrored.data_rank()),
        }
    finally:
        dist.destroy_process_group()


def _optimizer(model, optimizer: str, lr: float, momentum=None):
    """'sgd': sgd(lr, momentum); 'adam': the port's adamw with weight decay
    0, which is optax.adam."""
    from tfde_tpu_torch.training.optimizers import adamw, sgd

    if optimizer == "adam":
        return adamw(model, lr, weight_decay=0.0)
    return sgd(model, lr, momentum=momentum)


def _numpy_opt_state(sd: dict) -> dict:
    """{parameter index: {entry: numpy array}} of an optimizer state dict."""
    return {i: {k: v.detach().cpu().numpy().copy() for k, v in e.items()
                if isinstance(v, torch.Tensor)}
            for i, e in sd["state"].items()}


def train_cnn(model_name: str, state_dict: dict, batches: Sequence[tuple],
              lr: float, momentum: Optional[float] = None,
              eval_batches: Sequence[tuple] = (), device="cpu",
              strategy: str = "MultiWorkerMirroredStrategy",
              optimizer: str = "sgd", min_shard_elems: int = 2**14) -> dict:
    """`model_name` ('PlainCNN' or 'BatchNormCNN', dropout off) on `device`
    from `state_dict` (numpy arrays), one `make_train_step` step per
    global batch under `strategy` (MultiWorkerMirroredStrategy or
    ParameterServerStrategy with `min_shard_elems`) over the process group
    (one rank when there is none), with `optimizer` ('sgd' at `lr` and
    `momentum`, or 'adam' at `lr`), then one `make_eval_step` call per eval
    batch (images, labels, mask). Returns the per-step metrics, the eval
    sums, the final state_dict and the optimizer state in the replicated
    layout as numpy arrays, and this rank's optimizer-state bytes."""
    from tfde_tpu_torch.models.cnn import BatchNormCNN, PlainCNN
    from tfde_tpu_torch.parallel import strategies
    from tfde_tpu_torch.training.step import (
        init_state, make_eval_step, make_train_step)
    from tfde_tpu_torch.training.train_state import opt_state_bytes

    model = (BatchNormCNN(dropout_rate=0.0, device=device)
             if model_name == "BatchNormCNN" else PlainCNN(device=device))
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in state_dict.items()})
    state = init_state(model, _optimizer(model, optimizer, lr, momentum))
    strat = (strategies.ParameterServerStrategy(
        min_shard_elems=min_shard_elems)
        if strategy == "ParameterServerStrategy"
        else strategies.MultiWorkerMirroredStrategy())
    step = make_train_step(strat, state)
    history = []
    for batch in batches:
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    eval_step = make_eval_step(strat, state)
    evals = [{k: float(v) for k, v in eval_step(state, b).items()}
             for b in eval_batches]
    return {"history": history, "eval": evals,
            "state_dict": {k: v.detach().cpu().numpy().copy()
                           for k, v in model.state_dict().items()},
            "opt_state": _numpy_opt_state(state.optimizer_state_dict()),
            "opt_state_bytes": opt_state_bytes(state.tx)}


def dp_train_worker(rank: int, world: int, store_path: str, *args) -> dict:
    """`train_cnn(*args)` on rank `rank` of a `world`-rank gloo group."""
    _init_file_group(rank, world, store_path)
    try:
        return train_cnn(*args)
    finally:
        dist.destroy_process_group()


def dp_train_runs_worker(rank: int, world: int, store_path: str,
                         runs: Sequence[tuple]) -> list:
    """`train_cnn(*args, **kwargs)` for each (args, kwargs) of `runs`, in
    order, on rank `rank` of one `world`-rank gloo group."""
    _init_file_group(rank, world, store_path)
    try:
        return [train_cnn(*args, **kwargs) for args, kwargs in runs]
    finally:
        dist.destroy_process_group()


def ps_checkpoint_worker(rank: int, world: int, store_path: str,
                         directory: str, state_dict: dict,
                         batches: Sequence[tuple], first: str, second: str,
                         split: int) -> dict:
    """BatchNormCNN (dropout off) from `state_dict`, sgd(0.05, momentum
    0.9), one `make_train_step` step a global batch, on rank `rank` of a
    `world`-rank gloo group. Strategy names as `train_cnn` takes them.
    Run "whole": all `batches` under `second`. Run "resumed": the first
    `split` under `first`, a checkpoint into `directory` (rank 0 writes),
    then a fresh model and optimizer under `second` that restore it and
    take the rest; twice, restoring before the train step is built (as
    the Estimator does) and after (as `reload_from_checkpoint` does).
    Returns each run's state_dict and optimizer state (the replicated
    layout) as numpy arrays, and the step each resumed run restored."""
    from tfde_tpu_torch.checkpoint.manager import CheckpointManager
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel import strategies
    from tfde_tpu_torch.training.step import init_state, make_train_step

    def fresh():
        model = BatchNormCNN(dropout_rate=0.0, device="cpu", seed=1)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in state_dict.items()})
        return init_state(model, _optimizer(model, "sgd", 0.05, 0.9))

    def step_of(name, state):
        return make_train_step(getattr(strategies, name)(), state)

    def result(state):
        return {"state_dict": {k: v.detach().numpy().copy()
                               for k, v in state.model.state_dict().items()},
                "opt_state": _numpy_opt_state(state.optimizer_state_dict()),
                "step": state.step}

    _init_file_group(rank, world, store_path)
    try:
        out = {}
        state = fresh()
        step = step_of(second, state)
        for b in batches:
            step(state, b)
        out["whole"] = result(state)
        state = fresh()
        step = step_of(first, state)
        for b in batches[:split]:
            step(state, b)
        mngr = CheckpointManager(directory, group=dist.group.WORLD)
        mngr.save(state)
        mngr.wait()
        for order in ("restore_first", "step_first"):
            state = fresh()
            if order == "step_first":
                step = step_of(second, state)
            restored = CheckpointManager(directory).restore_latest(state)
            if order == "restore_first":
                step = step_of(second, state)
            out[order] = {"restored_at": restored.step}
            for b in batches[split:]:
                step(state, b)
            out[order].update(result(state))
        return out
    finally:
        dist.destroy_process_group()


def profile_steps(run: Callable, batches: Sequence, device) -> dict:
    """torch.profiler (host and CUDA) over ``float(run(b))`` for each batch
    b: the wall ms a step, each CUDA kernel's device ms a step and each
    host operator's self ms and calls a step, as plain values."""
    import time

    from torch.profiler import ProfilerActivity, profile

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    n = len(batches)
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            float(run(b))
        sync()
    return profile_summary(prof, n, (time.perf_counter() - t0) * 1e3 / n)


def profile_summary(prof, n: int, wall_ms: float) -> dict:
    """A finished torch.profiler `prof` over `n` steps as `profile_steps`
    returns it, with `wall_ms` the wall ms a step."""
    events = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    return {
        "wall_ms": wall_ms,
        "device": [(e.key, e.self_device_time_total / 1e3 / n)
                   for e in events if e.device_type == cuda
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)],
        "host": [(e.key, e.self_cpu_time_total / 1e3 / n, e.count // n)
                 for e in events if e.device_type == cpu],
    }


def dp_ranks_worker(rank: int, world: int, store_path: str, device_type: str,
                    parity: tuple, batch: int, steps: int, timed_from: int,
                    profiled: int = 0) -> dict:
    """Rank `rank` of a `world`-rank group: NCCL with ``cuda:<rank>`` when
    `device_type` is 'cuda' (fp32, TF32 off), else gloo on the CPU. First
    `train_cnn(*parity,
    device=...)`; then the reference recipe (BatchNormCNN, dropout 0.5 from
    a generator seeded with the rank, sgd(0.2, momentum 0.9)) on synthetic
    MNIST for `steps` global batches of `batch` x `world`, returning its
    losses and the mean ms per step from step `timed_from` + 1 to the
    last, between synchronised, barriered clock reads; then `profiled`
    more steps, which rank 0 runs under `profile_steps`."""
    import time

    from tfde_tpu_torch.data import datasets
    from tfde_tpu_torch.mnist_multiworker import global_batches
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state, make_train_step

    cuda = device_type == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
        # fp32 as the parent's run: a spawned process starts from torch's
        # defaults, under which cuDNN convolutions may run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _init_file_group(rank, world, store_path, "nccl" if cuda else "gloo")
    try:
        parity_run = train_cnn(*parity, device=device)
        (tx, ty), _ = datasets.mnist(flatten=True)
        model = BatchNormCNN(device=device, seed=0)
        state = init_state(model, sgd(model, 0.2, momentum=0.9))
        step = make_train_step(MultiWorkerMirroredStrategy(), state)
        generator = torch.Generator(device=device).manual_seed(rank)
        losses = []

        def clock():
            if cuda:
                torch.cuda.synchronize(device)
            dist.barrier()
            return time.perf_counter()

        batches = list(global_batches(tx, ty, batch * world,
                                      steps + profiled))
        for i, b in enumerate(batches[:steps]):
            if i == timed_from:
                t0 = clock()
            state, metrics = step(state, b, generator)
            losses.append(metrics["loss"])
        ms = (clock() - t0) * 1e3 / (steps - timed_from)

        def run(b):
            return step(state, b, generator)[1]["loss"]

        prof = None
        if rank == 0 and profiled:
            prof = profile_steps(run, batches[steps:], device)
        else:
            for b in batches[steps:]:
                float(run(b))
        return {"parity": parity_run, "losses": [float(x) for x in losses],
                "ms": ms, "profile": prof, "backend": dist.get_backend(),
                "device": str(device)}
    finally:
        dist.destroy_process_group()


def ps_ranks_worker(rank: int, world: int, store_path: str,
                    parity: tuple) -> dict:
    """Rank `rank` of a `world`-rank NCCL group on ``cuda:<rank>`` (fp32,
    TF32 off, cuDNN's deterministic algorithms, so that the two runs can
    be compared bit for bit): `train_cnn(*parity)` under
    ParameterServerStrategy, then under MultiWorkerMirroredStrategy.
    Returns both results."""
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _init_file_group(rank, world, store_path, "nccl")
    try:
        return {s: train_cnn(*parity, device=device, strategy=s)
                for s in ("ParameterServerStrategy",
                          "MultiWorkerMirroredStrategy")}
    finally:
        dist.destroy_process_group()


def bootstrap_worker(rank: int, env: dict, argv: list) -> dict:
    """`mnist_multiworker.main(argv)` with `env` set, so that its
    `bootstrap()` builds the group; returns the last step's metrics and
    the final parameters."""
    from tfde_tpu_torch import mnist_multiworker
    from tfde_tpu_torch.runtime import cluster

    os.environ.update(env)
    try:
        state, metrics = mnist_multiworker.main(argv)
        info = cluster.last_info()
        return {"metrics": metrics, "step": state.step,
                "world": dist.get_world_size(), "rank": dist.get_rank(),
                "backend": dist.get_backend(),
                "process_id": info.process_id,
                "params": {k: v.detach().numpy().copy()
                           for k, v in state.model.state_dict().items()}}
    finally:
        cluster.shutdown()


def feed_worker(rank: int, world: int, store_path: str, batches: list
                ) -> dict:
    """`data.device.device_prefetch` on the CPU over `batches` under each
    `AutoShardPolicy`, inline and in the background, on rank `rank` of a
    `world`-rank gloo group (MultiWorkerMirroredStrategy):
    {(policy name, "inline" or "background"): the placed leaves of each
    batch as numpy arrays}."""
    from tfde_tpu_torch.data.device import Placed, device_prefetch
    from tfde_tpu_torch.data.pipeline import AutoShardPolicy
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy

    _init_file_group(rank, world, store_path)
    try:
        out = {}
        for policy in AutoShardPolicy:
            for mode in ("inline", "background"):
                got = out[policy.name, mode] = []
                for b in device_prefetch(batches,
                                         MultiWorkerMirroredStrategy(), "cpu",
                                         policy=policy,
                                         background=mode == "background"):
                    if not isinstance(b, Placed):
                        raise TypeError(
                            f"the feed yielded a {type(b).__name__}")
                    got.append([x.numpy().copy() for x in b])
        return out
    finally:
        dist.destroy_process_group()


def checkpoint_worker(rank: int, world: int, store_path: str, directory: str,
                      state_dict: dict, batch: tuple, steps: int) -> dict:
    """BatchNormCNN (dropout off) from `state_dict` takes `steps`
    sgd(0.05, momentum 0.9) steps of the global `batch` over a `world`-rank
    gloo group, then a `CheckpointManager` over the group saves it into
    `directory` (rank 0 writes). Returns the state_dict and the momentum
    buffers as numpy arrays, and what `save` returned."""
    from tfde_tpu_torch.checkpoint.manager import CheckpointManager
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state, make_train_step

    _init_file_group(rank, world, store_path)
    try:
        model = BatchNormCNN(dropout_rate=0.0, device="cpu")
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in state_dict.items()})
        state = init_state(model, sgd(model, 0.05, momentum=0.9))
        step = make_train_step(MultiWorkerMirroredStrategy(), state)
        for _ in range(steps):
            step(state, batch)
        mngr = CheckpointManager(directory, group=dist.group.WORLD)
        saved = mngr.save(state)
        mngr.wait()
        return {"saved": saved,
                "state_dict": {k: v.numpy().copy()
                               for k, v in model.state_dict().items()},
                "momentum": [state.tx.state[p]["momentum_buffer"].numpy().copy()
                             for p in model.parameters()]}
    finally:
        dist.destroy_process_group()


def estimator_worker(rank: int, world: int, store_path: str, model_name: str,
                     state_dict: dict, train: tuple, batch: int,
                     max_steps: int, lr: float, model_dir: str,
                     test: tuple, eval_batch: int) -> dict:
    """`model_name` (dropout off) from `state_dict` trained by
    `Estimator.train` under MultiWorkerMirroredStrategy on rank `rank` of a
    `world`-rank gloo group: `Dataset.from_tensor_slices(train).shuffle(n,
    seed=0).repeat().batch(batch, drop_remainder=True)` with
    `AutoShardPolicy.OFF` (every rank the global batch, the feed its
    rows), sgd(lr), summaries every step into `model_dir` (rank 0), no
    checkpoints; then `evaluate` over `test` in batches of `eval_batch`.
    Returns the final state_dict as numpy arrays and the eval metrics."""
    from tfde_tpu_torch.data.pipeline import AutoShardPolicy, Dataset
    from tfde_tpu_torch.models.cnn import BatchNormCNN, PlainCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.lifecycle import Estimator, RunConfig
    from tfde_tpu_torch.training.optimizers import sgd

    _init_file_group(rank, world, store_path)
    try:
        model = (BatchNormCNN(dropout_rate=0.0, device="cpu")
                 if model_name == "BatchNormCNN" else PlainCNN(device="cpu"))
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in state_dict.items()})
        est = Estimator(model, sgd(model, lr), MultiWorkerMirroredStrategy(),
                        RunConfig(model_dir=model_dir, save_summary_steps=1,
                                  save_checkpoints_steps=None))
        est.train(lambda: Dataset.from_tensor_slices(train)
                  .shuffle(len(train[0]), seed=0).repeat()
                  .batch(batch, drop_remainder=True), max_steps,
                  shard_policy=AutoShardPolicy.OFF)
        metrics = est.evaluate(
            lambda: Dataset.from_tensor_slices(test).batch(eval_batch))
        est.close()
        return {"eval": metrics,
                "state_dict": {k: v.detach().numpy().copy()
                               for k, v in model.state_dict().items()}}
    finally:
        dist.destroy_process_group()


def ps_eval_worker(rank: int, world: int, store_path: str, model_dir: str,
                   state_dict: dict, train: tuple, test: tuple, batch: int,
                   steps: int) -> dict:
    """BatchNormCNN (dropout off) from `state_dict` trained by
    `Estimator.train` under ParameterServerStrategy (ZeRO-1 at
    `min_shard_elems=1024`) with `eval_strategy=MirroredStrategy()`, on
    rank `rank` of a `world`-rank gloo group: `steps` global batches of
    `batch` under `AutoShardPolicy.OFF`, sgd(0.05, momentum 0.9), a
    checkpoint at the end; `evaluate` over `test` in batches of `batch`.
    Then a fresh Estimator under ParameterServerStrategy alone restores
    the checkpoint and evaluates the same set. Returns both evals and
    whether the update was sharded."""
    from tfde_tpu_torch.data.pipeline import AutoShardPolicy, Dataset
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import (
        MirroredStrategy, ParameterServerStrategy)
    from tfde_tpu_torch.training.lifecycle import Estimator, RunConfig

    def estimator(**kw):
        model = BatchNormCNN(dropout_rate=0.0, device="cpu", seed=1)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in state_dict.items()})
        return Estimator(model, _optimizer(model, "sgd", 0.05, 0.9),
                         ParameterServerStrategy(min_shard_elems=1024),
                         RunConfig(model_dir=model_dir,
                                   save_checkpoints_steps=steps), **kw)

    def test_fn():
        return Dataset.from_tensor_slices(test).batch(batch)

    _init_file_group(rank, world, store_path)
    try:
        est = estimator(eval_strategy=MirroredStrategy())
        state = est.train(lambda: Dataset.from_tensor_slices(train)
                          .shuffle(len(train[0]), seed=0).repeat()
                          .batch(batch, drop_remainder=True), steps,
                          shard_policy=AutoShardPolicy.OFF)
        mirrored = est.evaluate(test_fn)
        sharded = state.sharded is not None
        est.close()
        fresh = estimator()
        ps = fresh.evaluate(test_fn)
        fresh.close()
        return {"mirrored": mirrored, "ps": ps, "sharded": sharded}
    finally:
        dist.destroy_process_group()


#: batches the Estimator's feed (`device_prefetch`, buffer_size 2) stages
#: ahead of the step that runs
FEED_LOOKAHEAD = 2


def recipe(model_dir: str, device="cpu", n_train: int = 60000,
           batch: int = 128, save_every: int = 100,
           kill_after: Optional[int] = None):
    """The verify recipe through the Estimator: BatchNormCNN (dropout 0.5,
    weights from seed 0) on `device`, sgd(0.2, momentum 0.9), synthetic
    MNIST (`n_train` images) through `Dataset.from_tensor_slices(train)
    .shuffle(n_train, seed=0).repeat().batch(batch, drop_remainder=True)`,
    a checkpoint every `save_every` steps into `model_dir`. Returns
    (estimator, input_fn, the step it resumes from).

    The Estimator calls `input_fn` afresh on every train() (as the JAX
    package's does), so the stream skips the batches of the steps the
    newest checkpoint holds: a resumed run reads at each step the batch an
    uninterrupted one reads there. With `kill_after=k` the stream raises
    SIGTERM in this process as the feed stages the batch FEED_LOOKAHEAD
    after step k's, which the loop sees before step k + 1: the run stops
    after step k, force-saves it and dies by the signal."""
    import itertools
    import signal

    from tfde_tpu_torch.checkpoint.manager import CheckpointManager
    from tfde_tpu_torch.data import datasets
    from tfde_tpu_torch.data.pipeline import Dataset
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.lifecycle import Estimator, RunConfig
    from tfde_tpu_torch.training.optimizers import sgd

    (tx, ty), _ = datasets.mnist(flatten=True, n_train=n_train, n_test=8)
    start = CheckpointManager(os.path.join(model_dir, "checkpoints")
                              ).latest_step or 0
    model = BatchNormCNN(device=device, seed=0)
    est = Estimator(model, sgd(model, 0.2, momentum=0.9),
                    MultiWorkerMirroredStrategy(),
                    RunConfig(model_dir=model_dir,
                              save_checkpoints_steps=save_every))
    ds = (Dataset.from_tensor_slices((tx, ty)).shuffle(n_train, seed=0)
          .repeat().batch(batch, drop_remainder=True))

    def input_fn():
        for i, b in enumerate(itertools.islice(iter(ds), start, None), start):
            if kill_after is not None and i == kill_after + FEED_LOOKAHEAD:
                signal.raise_signal(signal.SIGTERM)
            yield b

    return est, input_fn, start


def state_digest(model: torch.nn.Module) -> str:
    """sha256 over the bytes of every parameter and buffer, in name
    order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def recipe_main(argv=None) -> None:
    """``python -m tfde_tpu_torch.testing MODEL_DIR OUT_JSON [options]``:
    `recipe` trained to --max-steps in this process on --device, CUDA
    unless ``cpu`` (on CUDA: fp32 with TF32 off, cuDNN's deterministic
    algorithms, a one-rank NCCL group),
    then {"step", "resumed_from", "digest"} written to OUT_JSON. With
    --kill-after k the process dies by SIGTERM after committing step k,
    and writes nothing."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=recipe_main.__doc__)
    ap.add_argument("model_dir")
    ap.add_argument("out_json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-steps", type=int, required=True)
    ap.add_argument("--n-train", type=int, default=60000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--kill-after", type=int, default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from tfde_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        est, input_fn, start = recipe(args.model_dir, device,
                                      args.n_train, args.batch,
                                      args.save_every, args.kill_after)
        state = est.train(input_fn, args.max_steps)
        est.close()
        with open(args.out_json, "w") as f:
            json.dump({"step": state.step, "resumed_from": start,
                       "digest": state_digest(state.model)}, f)
    finally:
        if cuda:
            dist.destroy_process_group()


if __name__ == "__main__":
    recipe_main()
