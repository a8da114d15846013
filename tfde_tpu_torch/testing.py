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

`FULL_WIDTH` and `FIELD_GROUPS` are the converted-checkpoint
configurations that the CPU tests and `chip_smoke.py`'s hf_serve phase
share.

`live_kv_bytes` counts a batcher's live KV cells from its tensors, the
figure its KV ledger must report.

`ADMISSION_SCENARIOS` / `admission_scenario` are the JAX package's
admission tests written against the batcher API both packages share:
the CPU tests run each on a JAX and a port batcher and compare the
outcomes, and `chip_smoke.py`'s admission phase runs them on the card.

`torch_threads(n)` runs a block with n intra-op torch threads: the CPU
tests run with one (`ONE_THREAD`), since pytest's workers share the
host's cores and torch's default of one thread a core oversubscribes
them; `DEFAULT_THREADS` is torch's own count, taken at import.

`recipe` is the verify recipe through the Estimator, and
``python -m tfde_tpu_torch.testing MODEL_DIR OUT_JSON --max-steps N``
(`recipe_main`; on CUDA unless ``--device cpu``) runs it in a process of
its own, which the preemption test and `chip_smoke.py`'s lifecycle phase
interrupt by SIGTERM.
"""

from __future__ import annotations

import contextlib
import logging
import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

#: torch's intra-op thread count before anything set it
DEFAULT_THREADS = torch.get_num_threads()


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block with `n` intra-op torch threads, then restore the
    count it found."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def live_kv_bytes(srv) -> int:
    """The bytes of the KV cells a `ContinuousBatcher`'s ledger counts as
    used, counted from its cache tensors (every plane: int8 payloads and
    scales alike): dense, each active row's committed cells; paged, each
    active row's cells past its trie-shared prefix, through its table,
    plus the trie's blocks (the JAX paged ledger's rule, which counts a
    cold row's trie-adopted blocks twice)."""
    cache = srv._cache
    planes = list(cache.planes().values())
    device = cache.keys[0].device
    total = 0
    for r, rid in enumerate(srv._req):
        if rid is None:
            continue
        c = int(srv._committed[r])
        if not srv.paged:
            total += sum(p[r, :c].numel() * p.element_size() for p in planes)
            continue
        pos = torch.arange(int(srv._shared_cells[r]), c, device=device)
        blk = cache.table[r, pos // cache.block]
        total += sum(p[blk, pos % cache.block].numel() * p.element_size()
                     for p in planes)
    if srv.paged and srv.prefix_cache is not None:
        bids, stack = [], list(srv.prefix_cache._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            bids.append(node.bid)
        ids = torch.as_tensor(bids, dtype=torch.int64, device=device)
        total += sum(p[ids].numel() * p.element_size() for p in planes)
    return total


def one_thread():
    """The CPU tests' module fixture (``pytest.fixture(autouse=True,
    scope="module")(testing.one_thread)``): the module's tests run with
    one intra-op torch thread."""
    with torch_threads(1):
        yield


# -- admission scenarios ------------------------------------------------------
# The admission tests of the JAX package (tests/test_server.py: the caps,
# the priority order, the deadline shed, forced overload, the KV-headroom
# gate and its env drill, the default-off parity, the progress stream),
# written against the batcher API the two packages share, so the same
# scenario runs on a JAX batcher and a port batcher (the CPU tests compare
# the outcomes) and on the card (chip_smoke.py's admission phase). Each
# takes `make(**kw)` (a ContinuousBatcher of one package on one model),
# that package's `admission` module and metrics registry, and a prompt; it
# raises AssertionError where the JAX test asserts, and returns the outcome
# the packages must agree on.

def _hold(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def env_set(**values):
    """Set (a str) or unset (None) environment variables for the block."""
    before = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: the admission knobs, unset around every scenario but the env drill
_ADMIT_OFF = dict(TFDE_ADMIT_MAX_QUEUE=None,
                  TFDE_ADMIT_MAX_QUEUED_TOKENS=None,
                  TFDE_ADMIT_TTFT_DEADLINE_MS=None,
                  TFDE_ADMIT_KV_HEADROOM=None,
                  TFDE_CAPACITY_BUDGET_BYTES=None)


def _rejection(srv, adm, submit) -> dict:
    """Run `submit()`, which must raise QueueFull; the rejection's
    package-independent fields (the Retry-After only as >= the floor: it
    comes from this machine's drain rate)."""
    next_id = srv._next_id
    depth = len(srv._queue)
    try:
        submit()
    except adm.QueueFull as e:
        _hold(isinstance(e, RuntimeError), "QueueFull is no RuntimeError")
        _hold(srv._next_id == next_id and len(srv._queue) == depth,
              "a rejected submit left state behind")
        body = e.as_json()
        out = {"reason": e.reason, "queue_depth": e.queue_depth,
               "queued_tokens": e.queued_tokens,
               "retry_floor": e.retry_after_s >= adm.MIN_RETRY_AFTER_S,
               "body_keys": sorted(body),
               "body_retry": body["retry_after_s"] == round(
                   e.retry_after_s, 3)}
        if e.kv is not None:
            out["kv"] = {k: e.kv[k] for k in ("headroom_rows", "rows_active",
                                              "rows_free")}
            out["kv_used"] = e.kv["used_bytes"] > 0
            _hold(body["kv"] == e.kv, "the 429 body lost the kv block")
        return out
    raise AssertionError("submit was admitted; QueueFull expected")


def _tokens(done: dict, rids) -> list:
    return [[int(t) for t in done[r]] for r in rids]


def scenario_depth_cap(make, adm, reg, p):
    srv = make(batch_size=1, max_len=48,
               admission_ctl=adm.AdmissionController(max_queue=1))
    admitted = srv.submit(p, 6)
    rej = _rejection(srv, adm, lambda: srv.submit(p, 6))
    _hold(rej["reason"] == "queue_depth" and rej["queue_depth"] == 1
          and rej["queued_tokens"] == 6, f"depth cap: {rej}")
    first = dict(srv.run())
    rid = srv.submit(p, 4)  # the queue drained: admitted now
    return {"rejection": rej, "rids": [admitted, rid],
            "tokens": _tokens(first, [admitted]) + _tokens(
                dict(srv.run()), [rid])}


def scenario_token_cap(make, adm, reg, p):
    srv = make(batch_size=1, max_len=48,
               admission_ctl=adm.AdmissionController(max_queued_tokens=10))
    a = srv.submit(p, 8)
    rej = _rejection(srv, adm, lambda: srv.submit(p, 8))
    _hold(rej["reason"] == "queued_tokens", f"token cap: {rej}")
    b = srv.submit(p, 2)  # 8 + 2 == 10: exactly at the cap is in
    done = dict(srv.run())
    _hold(sorted(done) == [a, b], "token cap: not both served")
    return {"rejection": rej, "tokens": _tokens(done, [a, b])}


def scenario_priority(make, adm, reg, p):
    srv = make(batch_size=1, max_len=48)
    blocker = srv.submit(p, 8)
    srv.step()  # the blocker holds the one row
    r_be = srv.submit(p, 3, priority="best_effort")
    r_ba = srv.submit(p, 3, priority="batch")
    r_in = srv.submit(p, 3)  # unlabeled: interactive
    depths = srv._queue.depths()
    _hold(depths == {"interactive": 1, "batch": 1, "best_effort": 1},
          f"priority lanes {depths}")
    order, done = [], {}
    while not srv.idle:
        for rid, toks in srv.step():
            order.append(rid)
            done[rid] = toks
    _hold(order == [blocker, r_in, r_ba, r_be], f"finish order {order}")
    return {"order": order,
            "tokens": _tokens(done, [blocker, r_in, r_ba, r_be])}


def scenario_deadline_shed(make, adm, reg, p):
    reg.reset("serving/shed")
    reg.reset("usage/requests")
    srv = make(batch_size=1, max_len=48)
    srv.enable_progress()
    blocker = srv.submit(p, 6)
    doomed = srv.submit(p, 5, priority="batch", ttft_deadline_ms=1.0)
    time.sleep(0.01)  # the deadline passes in the queue
    done = dict(srv.run())
    _hold(blocker in done and doomed not in done, "the doomed request ran")
    progress = srv.take_progress(doomed)
    shed = [srv.was_shed(doomed), srv.was_shed(doomed)]
    _hold(list(progress[0]) == [] and progress[1] is True,
          f"shed stream {progress}")
    _hold(shed == [True, False], f"was_shed answered {shed}")
    counters = {k: reg.get(k).value for k in (
        "serving/shed_expired", "serving/shed_batch", "serving/shed_tokens",
        "usage/requests/shed")}
    _hold(counters == {"serving/shed_expired": 1, "serving/shed_batch": 1,
                       "serving/shed_tokens": 5, "usage/requests/shed": 1},
          f"shed counters {counters}")
    _hold(srv.idle and not srv._deadline_at and not srv._priority,
          "the shed request left state behind")
    return {"tokens": _tokens(done, [blocker]), "shed": shed,
            "progress": [list(progress[0]), progress[1]],
            "counters": counters}


def scenario_forced_overload(make, adm, reg, p):
    srv = make(batch_size=1, max_len=48)
    adm.force_overload(30.0)
    try:
        _hold(adm.overload_active(), "the lever did not arm")
        rej = _rejection(srv, adm, lambda: srv.submit(p, 4))
    finally:
        adm.clear_overload()
    _hold(rej["reason"] == "forced_overload", f"overload: {rej}")
    rid = srv.submit(p, 4)
    return {"rejection": rej, "tokens": _tokens(dict(srv.run()), [rid])}


def scenario_headroom(make, adm, reg, p):
    srv = make(batch_size=2, max_len=48,
               admission_ctl=adm.AdmissionController(min_headroom_rows=2))
    admitted = srv.submit(p, 6)  # 2 free rows == the floor: in
    srv.step()                   # one row busy: 1 free < 2
    rej = _rejection(srv, adm, lambda: srv.submit(p, 6))
    _hold(rej["reason"] == "kv_headroom" and rej["kv"]["headroom_rows"] == 1
          and rej["kv"]["rows_active"] == 1 and rej["kv_used"],
          f"headroom gate: {rej}")
    first = dict(srv.run())
    rid = srv.submit(p, 4)  # the slab drained: admitted again
    return {"rejection": rej, "tokens": _tokens(first, [admitted])
            + _tokens(dict(srv.run()), [rid])}


def scenario_env_drill(make, adm, reg, p):
    with env_set(**dict(_ADMIT_OFF, TFDE_ADMIT_KV_HEADROOM="1",
                        TFDE_CAPACITY_BUDGET_BYTES="64")):
        srv = make(batch_size=2, max_len=48)
    _hold(srv._cap_model.budget_bytes == 64
          and srv._ledger.row_bytes > 64, "the drill's budget")
    rej = _rejection(srv, adm, lambda: srv.submit(p, 6))
    _hold(rej["reason"] == "kv_headroom" and rej["kv"]["headroom_rows"] == 0
          and rej["kv"]["rows_free"] == 2, f"env drill: {rej}")
    _hold(len(srv._queue) == 0 and srv.idle, "the drill queued a request")
    return {"rejection": rej}


def scenario_default_off(make, adm, reg, p):
    srv = make(batch_size=1, max_len=48)
    _hold(srv.admission.min_headroom_rows == 0
          and not srv.admission.enabled, "admission is on by default")
    rids = [srv.submit(p, 4) for _ in range(4)]  # 1 row, 3 queued: all in
    done = dict(srv.run())
    _hold(sorted(done) == rids, "default-off dropped a request")
    return {"tokens": _tokens(done, rids)}


def scenario_progress(make, adm, reg, p):
    srv = make(batch_size=2, max_len=64)
    srv.enable_progress()
    rid = srv.submit(p, 6)
    got, fin, final = [], False, {}
    while not srv.idle:
        final.update(srv.step())
        if not fin:
            toks, fin = srv.take_progress(rid)
            got.extend(int(t) for t in toks)
    _hold(fin and got == [int(t) for t in final[rid]],
          f"streamed {got} against {final.get(rid)}")
    _hold(rid not in srv._stream, "a drained stream entry stayed")
    return {"tokens": got}


ADMISSION_SCENARIOS = {
    "depth_cap": scenario_depth_cap, "token_cap": scenario_token_cap,
    "priority": scenario_priority, "deadline_shed": scenario_deadline_shed,
    "forced_overload": scenario_forced_overload,
    "headroom": scenario_headroom, "env_drill": scenario_env_drill,
    "default_off": scenario_default_off, "progress": scenario_progress}


def admission_scenario(name: str, make, adm, reg, prompt) -> dict:
    """Run scenario `name` with the admission knobs unset (the env drill
    sets its own)."""
    with env_set(**_ADMIT_OFF):
        return ADMISSION_SCENARIOS[name](make, adm, reg,
                                         np.asarray(prompt, np.int64))

#: this spawn's token (`run_ranks`), which makes every store path a
#: spawn's own
_SPAWN_TOKEN = ""


#: the three checkpoints served at their published widths, as (family for
#: `models.convert.save_converted`, `models.gpt.GPT` fields), from each
#: model's `config.json`: meta-llama/Llama-3.2-1B (1,235,814,400
#: parameters, head dim 64), Qwen/Qwen3-0.6B (596,049,920, head dim 128
#: beside hidden 1024) and google/gemma-2-2b (2,614,341,888, head dim 256;
#: its fields as `models.convert.gemma2_from_hf` sets them from that
#: config: hidden_activation gelu_pytorch_tanh, rms_norm_eps 1e-6,
#: rope_theta 10000, max_position_embeddings 8192, sliding_window 4096 on
#: the even layers, attn_logit_softcapping 50, final_logit_softcapping 30,
#: query_pre_attn_scalar 256, tied embeddings scaled by sqrt(2304))
FULL_WIDTH = {
    "Llama-3.2-1B": ("llama", dict(
        vocab_size=128256, hidden_size=2048, depth=16, num_heads=32,
        num_kv_heads=8, mlp_dim=8192, max_position=131072, position="rope",
        rope_theta=500000.0, rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192.0),
        norm="rms", mlp_act="swiglu", use_bias=False, tie_embeddings=True,
        ln_eps=1e-5)),
    "Qwen3-0.6B": ("qwen3", dict(
        vocab_size=151936, hidden_size=1024, depth=28, num_heads=16,
        num_kv_heads=8, head_dim=128, mlp_dim=3072, max_position=40960,
        position="rope", rope_theta=1000000.0, norm="rms", mlp_act="swiglu",
        use_bias=False, qk_norm=True, tie_embeddings=True, ln_eps=1e-6)),
    "Gemma-2-2B": ("gemma2", dict(
        vocab_size=256000, hidden_size=2304, depth=26, num_heads=8,
        num_kv_heads=4, head_dim=256, mlp_dim=9216, max_position=8192,
        position="rope", rope_theta=10000.0, norm="rms",
        norm_style="sandwich", mlp_act="geglu", use_bias=False,
        tie_embeddings=True, embed_scale=2304 ** 0.5, ln_eps=1e-6,
        sliding_window=4096, sliding_window_pattern="alternate",
        attn_scale=256 ** -0.5, attn_logit_cap=50.0, final_logit_cap=30.0)),
}

_SMALL = dict(vocab_size=256, depth=2, max_position=128)
_ROPE_RMS = dict(position="rope", norm="rms", mlp_act="swiglu",
                 use_bias=False)

#: one small GPT per group of the newly ported decoder fields, as (family,
#: `GPT` fields); the head dims are ones the CUDA kernels take (Phi's 80
#: through the zero padding)
FIELD_GROUPS = {
    # rms, swiglu, no bias, GQA 8 -> 2, llama3 rope scaling, untied head
    "llama": ("llama", dict(
        _SMALL, **_ROPE_RMS, hidden_size=512, num_heads=8, num_kv_heads=2,
        mlp_dim=1024, rope_scaling=("llama3", 8.0, 1.0, 4.0, 32.0),
        tie_embeddings=False, ln_eps=1e-5)),
    # qk_norm, head_dim 128 decoupled from hidden 128 / 4 heads
    "qwen3": ("qwen3", dict(
        _SMALL, **_ROPE_RMS, hidden_size=128, num_heads=4, num_kv_heads=2,
        head_dim=128, mlp_dim=256, rope_theta=1000000.0, qk_norm=True)),
    # biased q/k/v beside a bias-free out projection and MLP
    "qwen2": ("qwen2", dict(
        _SMALL, **_ROPE_RMS, hidden_size=256, num_heads=4, num_kv_heads=2,
        mlp_dim=512, qkv_bias=True, tie_embeddings=False)),
    # sandwich norms, geglu, embed_scale, attn_scale, both softcaps, the
    # alternating window, head dim 128
    "gemma2": ("gemma2", dict(
        _SMALL, **dict(_ROPE_RMS, mlp_act="geglu"), hidden_size=256,
        num_heads=4, num_kv_heads=2, head_dim=128, mlp_dim=512,
        norm_style="sandwich", embed_scale=16.0, attn_scale=256 ** -0.5,
        attn_logit_cap=4.0, final_logit_cap=3.0, sliding_window=16,
        sliding_window_pattern="alternate")),
    # one parallel LayerNorm, partial rope, untied head with a bias, head
    # dim 80 (padded to 128 on the card)
    "phi": ("phi", dict(
        _SMALL, hidden_size=320, num_heads=4, mlp_dim=640, position="rope",
        rope_dim=32, norm_style="parallel", tie_embeddings=False,
        head_bias=True, ln_eps=1e-5)),
    # a parallel residual with two LayerNorms
    "neox": ("neox", dict(
        _SMALL, hidden_size=256, num_heads=4, mlp_dim=512, position="rope",
        rope_dim=16, norm_style="parallel2", tie_embeddings=False,
        ln_eps=1e-5)),
    # multi-query attention: one KV head
    "bigcode": ("bigcode", dict(
        _SMALL, hidden_size=256, num_heads=4, num_kv_heads=1, mlp_dim=512,
        ln_eps=1e-5)),
    # relu MLP
    "opt": ("opt", dict(
        _SMALL, hidden_size=256, num_heads=4, mlp_dim=512, mlp_act="relu",
        ln_eps=1e-5)),
}


def _child(fn: Callable, rank: int, args: tuple, results, token: str
           ) -> None:
    global _SPAWN_TOKEN
    _SPAWN_TOKEN = token
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
    token = f"{os.getpid()}-{time.monotonic_ns()}"
    procs = [ctx.Process(target=_child,
                         args=(fn, r, tuple(a), results, token), daemon=True)
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
    """The `world`-rank group of a spawn, rendezvousing through a
    `FileStore` at `store_path` plus this spawn's token (a path no other
    spawn uses). gloo listens and connects on the loopback interface only
    (the ranks share a host). Should gloo's full-mesh connect fail
    ("Connection closed by peer": another process on the host can reach
    a listener's ephemeral port), the creation alone is retried once, on
    a fresh store and fresh listeners, and the retry logged; nothing else
    is retried."""
    if backend == "gloo":
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    path = f"{store_path}.{_SPAWN_TOKEN}"
    try:
        dist.init_process_group(backend, init_method=f"file://{path}",
                                rank=rank, world_size=world)
    except RuntimeError as e:
        if backend != "gloo" or not ("Connection closed by peer" in str(e)
                                     or "connectFullMesh" in str(e)):
            raise
        log.warning("rank %d: creating the gloo group failed (%s); "
                    "retrying the creation once on a fresh store", rank, e)
        dist.init_process_group(backend, init_method=f"file://{path}.retry",
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


def resnet_model(spec: dict, device="cpu") -> torch.nn.Module:
    """A `models.resnet.ResNet` from a plain (picklable) spec: its
    ``stage_sizes``, ``block`` ('BottleneckBlock' or 'BasicBlock'),
    ``num_filters``, ``dtype`` ('float32', 'bfloat16' or 'float64': an
    fp64 model also keeps fp64 weights, the reference run) and
    ``cifar_stem``."""
    from tfde_tpu_torch.models import resnet

    dtype = getattr(torch, spec["dtype"])
    model = resnet.ResNet(stage_sizes=spec["stage_sizes"],
                          block_cls=getattr(resnet, spec["block"]),
                          num_filters=spec["num_filters"], dtype=dtype,
                          cifar_stem=spec["cifar_stem"], device=device)
    return model.double() if dtype == torch.float64 else model


def train_resnet(spec: dict, state_dict: dict, batches: Sequence[tuple],
                 schedule: tuple, device="cpu") -> dict:
    """`resnet_model(spec)` on `device` from `state_dict` (numpy arrays),
    one `make_train_step` step a global batch under
    MultiWorkerMirroredStrategy over the process group (one rank without
    one), with the cifar10_resnet recipe's optimizer: sgd(momentum 0.9,
    nesterov) on ``warmup_cosine_decay_schedule(0, *schedule)`` (peak,
    warmup steps, decay steps). Returns the per-step metrics, the first
    step's gradients and the final state_dict, as numpy."""
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.optimizers import (
        sgd, warmup_cosine_decay_schedule)
    from tfde_tpu_torch.training.step import init_state, make_train_step

    model = resnet_model(spec, device)
    dtype = next(model.parameters()).dtype
    model.load_state_dict({k: torch.as_tensor(np.asarray(v), dtype=dtype)
                           for k, v in state_dict.items()})
    tx = sgd(model, warmup_cosine_decay_schedule(0.0, *schedule),
             momentum=0.9, nesterov=True)
    grads = {}

    def snapshot(optimizer, args, kwargs):
        if not grads:
            grads.update({n: p.grad.detach().cpu().numpy().copy()
                          for n, p in model.named_parameters()})

    tx.register_step_pre_hook(snapshot)
    state = init_state(model, tx)
    step = make_train_step(MultiWorkerMirroredStrategy(), state)
    history = []
    for batch in batches:
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    return {"history": history, "grads": grads,
            "state_dict": {k: v.detach().cpu().numpy().copy()
                           for k, v in model.state_dict().items()}}


def resnet_train_worker(rank: int, world: int, store_path: str,
                        *args) -> dict:
    """`train_resnet(*args)` on rank `rank` of a `world`-rank gloo
    group."""
    _init_file_group(rank, world, store_path)
    try:
        return train_resnet(*args)
    finally:
        dist.destroy_process_group()


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


def jobs_worker(rank: int, world: int, store_path: str,
                jobs: Sequence[tuple]) -> list:
    """Each (name, args, kwargs) of `jobs` in order, ``name`` a function of
    this module, on rank `rank` of one `world`-rank gloo group: one spawn
    for every multi-rank run of a test file."""
    _init_file_group(rank, world, store_path)
    try:
        return [globals()[name](*args, **kwargs) for name, args, kwargs
                in jobs]
    finally:
        dist.destroy_process_group()


def _numpy_state(state) -> dict:
    """The model's state_dict in the replicated layout as numpy arrays (a
    collective under FSDP)."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in state.model_state_dict().items()}


def _strategy(name: str, data: int = 1):
    from tfde_tpu_torch.parallel import strategies

    if name == "FSDPStrategy":
        return strategies.FSDPStrategy(data=data)
    return getattr(strategies, name)()


def vit_model(spec: dict, device="cpu") -> torch.nn.Module:
    """`models.vit.vit_tiny_test` from a plain spec: ``pool`` ('cls' or
    'gap'), ``dropout_rate``, ``image_size``, ``remat`` and ``dtype``
    ('float32', or 'float64': an fp64 model with fp64 weights, the
    reference run)."""
    from tfde_tpu_torch.models import vit

    dtype = getattr(torch, spec.get("dtype", "float32"))
    model = vit.ViT(num_classes=10, patch_size=4, embed_dim=32, depth=2,
                    num_heads=4, mlp_dim=64, dtype=dtype,
                    pool=spec.get("pool", "cls"),
                    dropout_rate=spec.get("dropout_rate", 0.0),
                    image_size=spec.get("image_size", 32),
                    remat=spec.get("remat", False), device=device)
    return model.double() if dtype == torch.float64 else model


def train_vit(spec: dict, state_dict: dict, batches: Sequence[tuple],
              schedule: tuple, weight_decay: float,
              strategy: str = "FSDPStrategy", data: int = 1,
              device="cpu") -> dict:
    """`vit_model(spec)` from `state_dict` (numpy arrays), one
    `make_train_step` step a global batch under `strategy` (FSDP with
    `data`, or a mirrored one) with the imagenet_vit recipe's optimizer:
    masked AdamW at `weight_decay` on ``warmup_cosine_decay_schedule(0,
    *schedule)``. Returns the per-step metrics, the final state_dict and
    optimizer state in the replicated layout, and this rank's element
    count of each parameter and optimizer-state bytes."""
    from torch.distributed.tensor import DTensor

    from tfde_tpu_torch.training.optimizers import (
        adamw, warmup_cosine_decay_schedule)
    from tfde_tpu_torch.training.step import init_state, make_train_step
    from tfde_tpu_torch.training.train_state import opt_state_bytes

    model = vit_model(spec, device)
    dtype = next(model.parameters()).dtype
    model.load_state_dict({k: torch.as_tensor(np.asarray(v), dtype=dtype)
                           for k, v in state_dict.items()})
    tx = adamw(model, warmup_cosine_decay_schedule(0.0, *schedule),
               weight_decay=weight_decay)
    state = init_state(model, tx)
    step = make_train_step(_strategy(strategy, data), state)
    history = []
    for batch in batches:
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    local = {n: (p.to_local() if isinstance(p, DTensor) else p).numel()
             for n, p in model.named_parameters()}
    return {"history": history, "state_dict": _numpy_state(state),
            "opt_state": _numpy_opt_state(state.optimizer_state_dict()),
            "local_numel": local, "opt_state_bytes": opt_state_bytes(tx)}


def fsdp_collectives(batch: tuple, spec: Optional[dict] = None) -> dict:
    """{host op: calls} of the all-gathers and reduce-scatters of one
    `make_train_step` step of `vit_model(spec or {})` under FSDPStrategy,
    under torch.profiler (after one unprofiled step)."""
    from torch.profiler import ProfilerActivity, profile

    from tfde_tpu_torch.training.optimizers import adamw
    from tfde_tpu_torch.training.step import init_state, make_train_step

    model = vit_model(spec or {})
    state = init_state(model, adamw(model, 1e-3))
    step = make_train_step(_strategy("FSDPStrategy"), state)
    step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    return {e.key: e.count for e in prof.key_averages()
            if e.key in ("c10d::_allgather_base_",
                         "c10d::_reduce_scatter_base_")}


def vit_checkpoint_swap(directory: str, state_dict: dict,
                        batches: Sequence[tuple], first: str,
                        second: str) -> dict:
    """`vit_model({})` from `state_dict` takes the `batches` under strategy
    `first` (masked AdamW, wd 0.05) and a `CheckpointManager` over the
    group saves it into `directory` (rank 0 writes); then a fresh model
    under `second` restores it, twice: before its train step is built
    (as the Estimator does) and after (as `reload_from_checkpoint` does).
    Returns the saved state and each restore's (its model and optimizer
    state in the replicated layout as numpy arrays, and the step), and
    the restored runs' metrics of one more step."""
    from tfde_tpu_torch.checkpoint.manager import CheckpointManager
    from tfde_tpu_torch.training.optimizers import adamw
    from tfde_tpu_torch.training.step import init_state, make_train_step

    def fresh():
        model = vit_model({})
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in state_dict.items()})
        return init_state(model, adamw(model, 1e-3, weight_decay=0.05))

    def result(state):
        return {"state_dict": _numpy_state(state), "step": state.step,
                "opt_state": _numpy_opt_state(state.optimizer_state_dict())}

    state = fresh()
    step = make_train_step(_strategy(first), state)
    for b in batches:
        step(state, b)
    mngr = CheckpointManager(directory, group=dist.group.WORLD)
    mngr.save(state)
    mngr.wait()
    out = {"saved": result(state)}
    for order in ("restore_first", "step_first"):
        state = fresh()
        if order == "step_first":
            step = make_train_step(_strategy(second), state)
        CheckpointManager(directory).restore_latest(state)
        if order == "restore_first":
            step = make_train_step(_strategy(second), state)
        out[order] = result(state)
        out[order]["next"] = {k: float(v) for k, v in
                              step(state, batches[0])[1].items()}
    return out


def vit_estimator_run(model_dir: str, state_dict: dict, train: tuple,
                      test: tuple, batch: int, max_steps: int,
                      save_every: int, strategy: str = "FSDPStrategy"
                      ) -> dict:
    """`vit_model({"dropout_rate": 0.1})` from `state_dict` trained by
    `Estimator.train` under `strategy` to `max_steps` (masked AdamW, wd
    0.05), a checkpoint every `save_every` into `model_dir`, resuming
    from its newest one: `Dataset.from_tensor_slices(train).shuffle(n,
    seed=0).repeat().batch(batch)` under `AutoShardPolicy.OFF`, skipping
    the batches of the steps the checkpoint holds (as `recipe` does);
    then `evaluate` over `test` in batches of `batch`. Returns the final
    state in the replicated layout as numpy arrays, the step it resumed
    from, the last loss and the eval metrics."""
    import itertools

    from tfde_tpu_torch.checkpoint.manager import CheckpointManager
    from tfde_tpu_torch.data.pipeline import AutoShardPolicy, Dataset
    from tfde_tpu_torch.training.lifecycle import Estimator, RunConfig
    from tfde_tpu_torch.training.optimizers import adamw

    model = vit_model({"dropout_rate": 0.1})
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in state_dict.items()})
    start = CheckpointManager(os.path.join(model_dir, "checkpoints")
                              ).latest_step or 0
    est = Estimator(model, adamw(model, 1e-3, weight_decay=0.05),
                    _strategy(strategy),
                    RunConfig(model_dir=model_dir,
                              save_checkpoints_steps=save_every))
    ds = (Dataset.from_tensor_slices(train).shuffle(len(train[0]), seed=0)
          .repeat().batch(batch, drop_remainder=True))
    state = est.train(lambda: itertools.islice(iter(ds), start, None),
                      max_steps, shard_policy=AutoShardPolicy.OFF)
    out = {"state_dict": _numpy_state(state), "step": state.step,
           "resumed_from": start, "loss": float(est.metrics["loss"]),
           "opt_state": _numpy_opt_state(state.optimizer_state_dict()),
           "eval": est.evaluate(
               lambda: Dataset.from_tensor_slices(test).batch(batch))}
    est.close()
    return out


def train_bert(state_dict: dict, batches: Sequence[tuple], schedule: tuple,
               grad_accum: int = 1, distributed: bool = True,
               device="cpu") -> dict:
    """`models.bert.bert_tiny_test` from `state_dict` (numpy arrays), one
    `make_custom_train_step(bert_mlm.mlm_loss_fn, grad_accum)` step a
    global batch (input_ids, labels), with the bert_mlm recipe's
    optimizer (masked AdamW, wd 0.01, ``warmup_cosine_decay_schedule(0,
    *schedule)``): under MultiWorkerMirroredStrategy over the process
    group (each rank its rows of the global numpy batch) when
    `distributed`, else on one device with no strategy. Returns the
    per-step metrics and the final state_dict as numpy."""
    from tfde_tpu_torch.bert_mlm import mlm_loss_fn
    from tfde_tpu_torch.models.bert import bert_tiny_test
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.optimizers import (
        adamw, warmup_cosine_decay_schedule)
    from tfde_tpu_torch.training.step import init_state, make_custom_train_step

    model = bert_tiny_test(device=device)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in state_dict.items()})
    tx = adamw(model, warmup_cosine_decay_schedule(0.0, *schedule),
               weight_decay=0.01)
    state = init_state(model, tx)
    step = make_custom_train_step(
        mlm_loss_fn, grad_accum, strategy=MultiWorkerMirroredStrategy()
        if distributed else None, state=state)
    history = []
    for ids, labels in batches:
        batch = ((np.asarray(ids), np.asarray(labels)) if distributed else
                 (torch.as_tensor(ids, device=device),
                  torch.as_tensor(labels, device=device)))
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    return {"history": history,
            "state_dict": {k: v.detach().cpu().numpy().copy()
                           for k, v in model.state_dict().items()}}


def profile_steps(run: Callable, batches: Sequence, device) -> dict:
    """torch.profiler (host and CUDA) over ``float(run(b))`` for each batch
    b: the wall ms a step, each CUDA kernel's device ms a step and each
    host operator's self ms and calls a step, as plain values."""

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


def fsdp_ranks_worker(rank: int, world: int, store_path: str,
                      args: tuple) -> dict:
    """Rank `rank` of a `world`-rank NCCL group on ``cuda:<rank>`` (fp32,
    TF32 off): `train_vit(*args)` under FSDPStrategy, with the backend
    and the device it ran on."""
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _init_file_group(rank, world, store_path, "nccl")
    try:
        out = train_vit(*args, strategy="FSDPStrategy", device=device)
        return {**out, "backend": dist.get_backend(), "device": str(device)}
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
