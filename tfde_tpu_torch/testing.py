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


def train_cnn(model_name: str, state_dict: dict, batches: Sequence[tuple],
              lr: float, momentum: Optional[float] = None,
              eval_batches: Sequence[tuple] = (), device="cpu") -> dict:
    """`model_name` ('PlainCNN' or 'BatchNormCNN', dropout off) on `device`
    from `state_dict` (numpy arrays), one `make_train_step` SGD step per
    global batch under MultiWorkerMirroredStrategy over the process group
    (one rank when there is none), then one `make_eval_step` call per eval
    batch (images, labels, mask). Returns the per-step metrics, the eval
    sums and the final state_dict as numpy arrays."""
    from tfde_tpu_torch.models.cnn import BatchNormCNN, PlainCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import (
        init_state, make_eval_step, make_train_step)

    model = (BatchNormCNN(dropout_rate=0.0, device=device)
             if model_name == "BatchNormCNN" else PlainCNN(device=device))
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in state_dict.items()})
    state = init_state(model, sgd(model, lr, momentum=momentum))
    strategy = MultiWorkerMirroredStrategy()
    step = make_train_step(strategy, state)
    history = []
    for batch in batches:
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    eval_step = make_eval_step(strategy, state)
    evals = [{k: float(v) for k, v in eval_step(state, b).items()}
             for b in eval_batches]
    return {"history": history, "eval": evals,
            "state_dict": {k: v.detach().cpu().numpy().copy()
                           for k, v in model.state_dict().items()}}


def dp_train_worker(rank: int, world: int, store_path: str, *args) -> dict:
    """`train_cnn(*args)` on rank `rank` of a `world`-rank gloo group."""
    _init_file_group(rank, world, store_path)
    try:
        return train_cnn(*args)
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
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
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
