"""Estimator-style training lifecycle — counterpart of
`tfde_tpu/training/lifecycle.py` (`RunConfig` :70, `TrainSpec` :122,
`EvalSpec` :131, `Estimator` :140, `export_saved_model` :836,
`continuous_eval` :891, `train_and_evaluate` :954).

The `tf.estimator.train_and_evaluate` behaviour the reference relies on,
made explicit as in the JAX package: TrainSpec.max_steps bounds training
and is absolute, so a resumed run does only the remainder
(mnist_keras:255-262); EvalSpec runs the full eval set when steps=None,
no earlier than start_delay_secs after the start and at most every
throttle_secs (mnist_keras:264-275); a checkpoint every
RunConfig.save_checkpoints_steps into model_dir, restored by default on
restart (mnist_keras:245-248); scalar summaries every save_summary_steps
and steps/sec every log_step_count_steps (mnist_keras:246-247); a
SIGTERM or SIGINT during `train()` force-saves the current step and
re-raises the signal; EvalSpec's exporters (`export.serving`): the
metric-gated ones (BestExporter) after every eval, every one after the
final eval (mnist_keras:264).

What differs from the JAX package:
- the Estimator takes a torch `nn.Module` that already holds its initial
  weights (the JAX one initialises a flax module from `RunConfig.seed`),
  and one of the port's optimizers over its parameters
  (`training.optimizers`);
- dropout: the step's generator is reseeded before every update from
  (seed + 1, update count, data rank), as the JAX step folds the update
  count into ``key(seed + 1)``: a resumed run draws the masks an
  uninterrupted one draws;
- `loss_fn` and `eval_fn` take the port's custom-step signature
  ``(model, batch, generator)`` and run at one data-parallel rank only
  (the port's custom step is single-device);
- the concurrent evaluator (``eval_mode="from_checkpoint"``) evaluates a
  copy of the model, restored from the newest checkpoint, on a CUDA stream
  of its own, with no process group.

Not ported yet, each raising NotImplementedError when set to anything but
its default: LoRA (`lora`, `lora_base_params`), an item of its own;
`RunConfig.profile_steps`, `metrics_port`, `metrics_push_url`,
`metrics_push_interval` and `sentry`, the observability slice;
``grad_transport='int8'`` and ``opt_sharding='shard'``, the scale-out
slice. The JAX package's other run-time observers (the goodput ledger,
the flight recorder, memwatch, the recompile sentinel and the HLO linter)
have no switch on this API and are absent: they come with the
observability slice.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import os
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tfde_tpu_torch.checkpoint.manager import CheckpointManager
from tfde_tpu_torch.data.device import device_prefetch
from tfde_tpu_torch.data.pipeline import AutoShardPolicy
from tfde_tpu_torch.observability.tensorboard import SummaryWriter
from tfde_tpu_torch.parallel.strategies import (
    MirroredStrategy, MultiWorkerMirroredStrategy, ParameterServerStrategy,
    Strategy, check_ported)
from tfde_tpu_torch.resilience.preemption import PreemptionGuard
from tfde_tpu_torch.runtime.mesh import LocalMesh
from tfde_tpu_torch.training.step import (
    init_state, make_custom_eval_step, make_custom_train_step,
    make_eval_step, make_train_step, pad_batch_for_mesh)
from tfde_tpu_torch.training.train_state import TrainState

log = logging.getLogger(__name__)

_OBSERVABILITY = "comes with the observability slice (ROADMAP, queue 1)"
_LORA = ("comes with its own item (ROADMAP, queue 1, 'LoRA through the "
         "Estimator')")
#: the strategies whose parameters are whole on every rank: a model
#: trained under one evaluates under another
_REPLICATED_PARAMS = (MirroredStrategy, MultiWorkerMirroredStrategy,
                      ParameterServerStrategy)


@dataclasses.dataclass
class RunConfig:
    """Training-run configuration (tf.estimator.RunConfig analog,
    mnist_keras:240-248). `save_checkpoints_steps` None or 0 turns
    checkpointing, and so resume, off; summaries still go to model_dir.
    The JAX package's observability fields and gradient options are
    here with their defaults; any other value raises (module
    docstring)."""

    model_dir: Optional[str] = None
    save_summary_steps: int = 100
    log_step_count_steps: int = 100
    save_checkpoints_steps: Optional[int] = 500
    keep_checkpoint_max: int = 5
    profile_steps: Any = None
    seed: int = 0
    metrics_port: Optional[int] = None
    metrics_push_url: Optional[str] = None
    metrics_push_interval: float = 5.0
    sentry: Any = None
    grad_transport: Any = None
    opt_sharding: Any = None

    def __post_init__(self):
        for name in ("profile_steps", "metrics_port", "metrics_push_url",
                     "sentry"):
            if getattr(self, name) is not None and getattr(self, name) is not False:
                raise NotImplementedError(
                    f"RunConfig.{name} is not ported yet: it {_OBSERVABILITY}")
        if self.metrics_push_interval != 5.0:
            raise NotImplementedError(
                f"RunConfig.metrics_push_interval is not ported yet: it "
                f"{_OBSERVABILITY}")
        check_ported(self.grad_transport, self.opt_sharding)


@dataclasses.dataclass
class TrainSpec:
    """input_fn -> Dataset/iterable of (images, labels) host batches."""

    input_fn: Callable[[], Iterable]
    max_steps: int
    shard_policy: AutoShardPolicy = AutoShardPolicy.DATA


@dataclasses.dataclass
class EvalSpec:
    """The eval input and cadence, and the exporters (`export.serving`
    FinalExporter/BestExporter) `train_and_evaluate` runs."""

    input_fn: Callable[[], Iterable]
    steps: Optional[int] = None  # None = full pass (mnist_keras:271)
    name: str = "eval"
    exporters: Sequence = ()
    start_delay_secs: float = 10.0
    throttle_secs: float = 10.0


def _step_seed(seed: int, step: int, rank: int) -> int:
    """The dropout seed of update `step` on data rank `rank`."""
    return int(np.random.SeedSequence([seed + 1, step, rank])
               .generate_state(1, np.uint64)[0])


def _is_chief() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class Estimator:
    """Owns the model, the optimizer, the strategy and the run config:
    train / evaluate / predict with checkpoint-resume (the
    tf.keras.estimator.model_to_estimator capability, mnist_keras:118-119).

    `model` is a torch module holding its initial weights, on the device it
    trains on; `optimizer` one of the port's optimizers over its
    parameters (`training.optimizers`), whose schedule sets each update's
    lr. `strategy` (default `MultiWorkerMirroredStrategy`) replicates the
    model;
    `eval_strategy` evaluates under another strategy (the reference's
    `DistributeConfig(train_distribute=ParameterServerStrategy,
    eval_distribute=MirroredStrategy)`, mnist_keras_distributed.py:
    240-243): the mirrored strategies and ParameterServerStrategy (ZeRO-1)
    all hold whole parameters on every rank, so only the eval step's group
    changes. `loss_fn(model, batch, generator)
    -> (loss, metrics)` is a custom objective (the GPT path,
    `make_custom_train_step`, with `grad_accum` microbatches);
    `eval_fn(model, batch, generator) -> {metric: batch mean}` its eval
    twin (generator None), which evaluate() needs when `loss_fn` is set.
    """

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 strategy: Optional[Strategy] = None,
                 config: Optional[RunConfig] = None,
                 eval_strategy: Optional[Strategy] = None,
                 loss_fn: Optional[Callable] = None,
                 eval_fn: Optional[Callable] = None, grad_accum: int = 1,
                 lora=None, lora_base_params=None):
        if lora is not None or lora_base_params is not None:
            raise NotImplementedError(f"LoRA through the Estimator is not "
                                      f"ported yet: it {_LORA}")
        self.model = model
        self.tx = optimizer
        self.strategy = strategy or MultiWorkerMirroredStrategy()
        self.eval_strategy = eval_strategy
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.grad_accum = grad_accum
        self.config = config or RunConfig()
        if ((loss_fn is not None or eval_fn is not None)
                and self.strategy.batch_divisor > 1):
            raise NotImplementedError(
                f"loss_fn/eval_fn run on one device only: the port's custom "
                f"step is single-device, and {self.strategy.describe()} has "
                f"{self.strategy.batch_divisor} data-parallel ranks")
        self._device = next(model.parameters()).device
        self._state: Optional[TrainState] = None
        self._from_checkpoint = False
        self._ckpt: Optional[CheckpointManager] = None
        self._train_step = None
        self._eval_step = None
        self._writers: dict = {}
        #: the device feed of the last train() call (its `wait_seconds`:
        #: the time the loop waited for input)
        self.feed = None
        #: the last train step's metrics (tensors on the model's device)
        self.metrics: dict = {}

    # -- internals -----------------------------------------------------------
    def _writer(self, name: str = "") -> Optional[SummaryWriter]:
        if self.config.model_dir is None or not _is_chief():
            return None
        if name not in self._writers:
            self._writers[name] = SummaryWriter(
                os.path.join(self.config.model_dir, name))
        return self._writers[name]

    def _ckpt_mngr(self) -> Optional[CheckpointManager]:
        if self.config.model_dir is None or not self.config.save_checkpoints_steps:
            return None
        if self._ckpt is None:
            self._ckpt = CheckpointManager(
                os.path.join(self.config.model_dir, "checkpoints"),
                max_to_keep=self.config.keep_checkpoint_max,
                group=self.strategy.data_group)
        return self._ckpt

    def _ensure_state(self) -> TrainState:
        """The live state; on first use the model and optimizer as given,
        restored from model_dir's newest checkpoint when there is one
        (resume by default) — before the train step wraps the model."""
        if self._state is None:
            self._state = init_state(self.model, self.tx)
            self._from_checkpoint = False
            mngr = self._ckpt_mngr()
            if (mngr is not None
                    and mngr.restore_latest(self._state) is not None):
                self._from_checkpoint = True
        return self._state

    def _state_for_inference(self, what: str) -> TrainState:
        """The state for evaluate/predict: live if this process trained,
        else restored from model_dir (the eval-from-checkpoint flow); an
        error when neither exists."""
        if self._state is not None:
            return self._state
        state = self._ensure_state()
        if not self._from_checkpoint:
            self._state = None  # a later train() still looks for a resume
            raise RuntimeError(
                f"{what} before train(): no trained state in this process and "
                f"no checkpoint found in model_dir={self.config.model_dir!r}")
        return state

    def _eval_strat(self) -> Strategy:
        if self.eval_strategy is None:
            return self.strategy
        if not (isinstance(self.strategy, _REPLICATED_PARAMS)
                and isinstance(self.eval_strategy, _REPLICATED_PARAMS)):
            raise NotImplementedError(
                f"evaluating a {type(self.strategy).__name__}-trained model "
                f"under {type(self.eval_strategy).__name__}: only the "
                f"strategies that hold whole parameters on every rank "
                f"(the two mirrored ones, ParameterServerStrategy) are "
                f"ported")
        return self.eval_strategy

    # -- train ---------------------------------------------------------------
    def train(self, input_fn: Callable[[], Iterable], max_steps: int,
              shard_policy: AutoShardPolicy = AutoShardPolicy.DATA,
              _eval_hook: Optional[Callable[[TrainState, int], None]] = None
              ) -> TrainState:
        """Train until the update count reaches `max_steps` (absolute: a
        resumed run does only the remainder). `input_fn()` gives host
        batches: global batches under ``AutoShardPolicy.OFF``, this rank's
        under ``DATA``; they reach the step through `device_prefetch`.
        A caught SIGTERM/SIGINT ends the loop, force-saves and re-raises
        the signal."""
        cfg = self.config
        state = self._ensure_state()
        start_step = state.step
        if start_step >= max_steps:
            log.info("global step %d >= max_steps %d; nothing to do",
                     start_step, max_steps)
            return state
        if self._train_step is None:
            if self._from_checkpoint:
                log.info("resuming at step %d of %d from %s", start_step,
                         max_steps, self._ckpt.directory)
            if self.loss_fn is not None:
                self._train_step = make_custom_train_step(
                    self.loss_fn, grad_accum=self.grad_accum)
            else:
                self._train_step = make_train_step(
                    self.strategy, state, grad_accum=self.grad_accum)
        generator = torch.Generator(device=self._device)
        rank = self.strategy.data_rank()
        writer = self._writer()
        mngr = self._ckpt_mngr()
        feed = device_prefetch(input_fn(), self.strategy, self._device,
                               policy=shard_policy)
        self.feed = feed

        metrics = {}
        first = True
        t_window = time.perf_counter()
        window_step = start_step  # steps/sec windows span the steps run
        excluded = 0.0  # summary and eval seconds carved out of the window
        step = start_step
        guard = PreemptionGuard()
        with guard:
            try:
                for batch in feed:
                    if step >= max_steps or guard.fired is not None:
                        break
                    generator.manual_seed(_step_seed(cfg.seed, state.step,
                                                     rank))
                    if first:
                        # the first step (allocator warm-up, cuDNN's choice
                        # of algorithms) is timed apart from the window
                        t0 = time.perf_counter()
                        state, metrics = self._train_step(state, batch,
                                                          generator)
                        float(metrics["loss"])
                        log.info("first step: %.2fs", time.perf_counter() - t0)
                        first = False
                    else:
                        state, metrics = self._train_step(state, batch,
                                                          generator)
                    step += 1
                    if step - start_step == 1:
                        t_window = time.perf_counter()
                        window_step = step
                    if writer is not None and step % cfg.save_summary_steps == 0:
                        t_sync = time.perf_counter()
                        writer.scalars(step, {k: float(v)
                                              for k, v in metrics.items()})
                        excluded += time.perf_counter() - t_sync
                    if step % cfg.log_step_count_steps == 0 and step > window_step:
                        dt = time.perf_counter() - t_window - excluded
                        sps = (step - window_step) / dt if dt > 0 else float("inf")
                        if writer is not None:
                            writer.scalars(step, {"global_step/sec": sps})
                        log.info("step %d: %.2f steps/sec", step, sps)
                        t_window = time.perf_counter()
                        window_step = step
                        excluded = 0.0
                    if mngr is not None and step % cfg.save_checkpoints_steps == 0:
                        mngr.save(state)
                    if _eval_hook is not None:
                        t_eval = time.perf_counter()
                        _eval_hook(state, step)
                        excluded += time.perf_counter() - t_eval
            finally:
                feed.close()
            self._state = state
            self.metrics = metrics
            if mngr is not None:
                # also the preemption save: on a caught signal the loop broke
                # out, and this commits the current step before the re-raise
                mngr.save(state)
                mngr.wait()
            if writer is not None:
                writer.flush()
        guard.reraise_if_fired(step if mngr is not None else None)
        return state

    # -- evaluate ------------------------------------------------------------
    def evaluate(self, input_fn: Callable[[], Iterable],
                 steps: Optional[int] = None, name: str = "eval") -> dict:
        """Weighted metrics over the eval input (EvalSpec steps=None: the
        whole of it). Every rank iterates the same eval batches, each
        padded by `pad_batch_for_mesh` to a multiple of the strategy's
        batch divisor and masked, and evaluates its rows; the masked sums
        are added on the device over the pass and divided once. With
        `eval_fn`, the batches go in as they come (one device)."""
        custom = self.loss_fn is not None or self.eval_fn is not None
        if custom and self.eval_fn is None:
            raise RuntimeError(
                "evaluate() on a custom-loss Estimator needs eval_fn: the "
                "training loss_fn takes a generator (dropout) and cannot "
                "promise a deterministic eval — pass eval_fn=(model, batch, "
                "generator) -> {metric: batch mean}")
        state = self._state_for_inference("evaluate()")
        strat = self._eval_strat()
        if self._eval_step is None:
            self._eval_step = (make_custom_eval_step(strat, state, self.eval_fn)
                               if custom else make_eval_step(strat, state))
        batches = (input_fn() if custom else
                   (pad_batch_for_mesh(b, strat.batch_divisor)
                    for b in input_fn()))
        feed = device_prefetch(batches, strat, self._device,
                               policy=AutoShardPolicy.OFF)
        totals, n = None, 0
        try:
            for batch in feed:
                if steps is not None and n >= steps:
                    break
                m = self._eval_step(state, batch)
                totals = m if totals is None else {k: totals[k] + v
                                                   for k, v in m.items()}
                n += 1
        finally:
            feed.close()
        if totals is None:
            if custom:
                log.warning("evaluate[%s]: input_fn produced no batches", name)
                return {}
            return {"loss": float("nan"), "accuracy": float("nan")}
        totals = {k: float(v) for k, v in totals.items()}  # one sync
        if custom:
            weight = totals.pop("weight")
            results = {k: (v / weight if weight > 0 else float("nan"))
                       for k, v in totals.items()}
        else:
            weight = max(totals["weight"], 1.0)
            results = {"loss": totals["loss_sum"] / weight,
                       "accuracy": totals["correct_sum"] / weight}
        w = self._writer(name)
        if w is not None:
            w.scalars(state.step, results)
            w.flush()
        log.info("eval[%s] @ step %d: %s", name, state.step, results)
        return results

    def reload_from_checkpoint(self, newer_than: Optional[int] = None
                               ) -> Optional[int]:
        """Restore the newest checkpoint, re-reading the directory on every
        call (the continuous-eval flow); its step, or None when there is
        no checkpoint or none newer than `newer_than`."""
        mngr = self._ckpt_mngr()
        if mngr is None:
            return None
        mngr.reload()  # another process or thread writes this directory
        latest = mngr.latest_step
        if latest is None or (newer_than is not None and latest <= newer_than):
            return None
        if self._state is None:
            self._state = init_state(self.model, self.tx)
        if mngr.restore_latest(self._state) is None:
            return None
        self._from_checkpoint = True
        return self._state.step

    # -- predict -------------------------------------------------------------
    def predict(self, input_fn: Callable[[], Iterable]):
        """Yield each batch's softmax probabilities as numpy (the serving
        signature, §3.4)."""
        state = self._state_for_inference("predict()")
        for batch in input_fn():
            x = batch[0] if isinstance(batch, tuple) else batch
            with torch.no_grad():
                logits = state.model(torch.as_tensor(np.asarray(x),
                                                     device=self._device),
                                     train=False)
            yield torch.softmax(logits.float(), dim=-1).cpu().numpy()

    def export_saved_model(self, exporter, metrics: Optional[dict] = None
                           ) -> Optional[str]:
        """Run `exporter` on the live (or checkpointed) model, on the chief
        only; the artifact's directory, or None. A metric-gated exporter
        (one with `maybe_export`, BestExporter) gets `metrics` and decides;
        without metrics (no eval yet, an empty eval) it is skipped with a
        warning, since a gated export of a model never evaluated would
        break its contract."""
        state = (self._state if self._state is not None
                 else self._state_for_inference("export"))
        if not _is_chief() or self.config.model_dir is None:
            return None
        if hasattr(exporter, "maybe_export"):
            if not metrics:
                log.warning("skipping metric-gated exporter %r: no eval "
                            "metrics available", exporter.name)
                return None
            return exporter.maybe_export(self.config.model_dir, state.model,
                                         metrics)
        return exporter.export(self.config.model_dir, state.model)

    def close(self) -> None:
        if self._ckpt is not None:
            self._ckpt.close()
        for w in self._writers.values():
            w.close()
        self._writers = {}


def continuous_eval(estimator: Estimator, eval_spec: EvalSpec,
                    stop_after_step: Optional[int] = None,
                    poll_secs: Optional[float] = None,
                    idle_timeout_secs: Optional[float] = None,
                    stop_event: Optional[threading.Event] = None
                    ) -> Tuple[int, dict]:
    """Evaluator-job loop: evaluate each NEW checkpoint in model_dir as it
    appears — the reference's separate evaluator (mnist_keras_distributed
    .py:255-283). Run it from a process of its own that shares the
    trainer's model_dir, or let `train_and_evaluate(eval_mode=
    "from_checkpoint")` drive it in a thread.

    Stops when `stop_after_step` is reached, `idle_timeout_secs` pass with
    no new checkpoint, or `stop_event` is set (after a final catch-up
    pass). Returns (last evaluated step, its metrics).

    The metric-gated exporters of `eval_spec` (BestExporter) run after
    every evaluated checkpoint; the others wait for the end of training
    (the caller's final export)."""
    poll = eval_spec.throttle_secs if poll_secs is None else poll_secs
    seen, last = -1, {}
    idle_since = time.time()

    def eval_new() -> bool:
        nonlocal seen, last, idle_since
        step = estimator.reload_from_checkpoint(
            newer_than=None if seen < 0 else seen)
        if step is None or step <= seen:
            return False
        seen = step
        idle_since = time.time()
        last = estimator.evaluate(eval_spec.input_fn, eval_spec.steps,
                                  eval_spec.name)
        _run_exporters(estimator, eval_spec, last, gated_only=True)
        return True

    while True:
        eval_new()
        if stop_after_step is not None and seen >= stop_after_step:
            break
        if stop_event is not None and stop_event.is_set():
            # a checkpoint may have landed during the eval: one final
            # catch-up, so that the trainer's last save is seen
            eval_new()
            break
        if (idle_timeout_secs is not None
                and time.time() - idle_since > idle_timeout_secs):
            break
        if stop_event is not None:
            stop_event.wait(poll)
        else:
            time.sleep(poll)
    return seen, last


def train_and_evaluate(estimator: Estimator, train_spec: TrainSpec,
                       eval_spec: EvalSpec, eval_mode: str = "inline"
                       ) -> Tuple[TrainState, dict]:
    """The reference's lifecycle loop (mnist_keras:283), explicit: train to
    max_steps, evaluating at most every throttle_secs once
    start_delay_secs have passed, then a final eval, then every exporter
    (the metric-gated ones also after each eval). Returns (final state,
    final eval metrics).

    eval_mode "inline" (default): the eval runs between steps on the
    training ranks, and training pauses for it. "from_checkpoint": a
    background thread follows the checkpoints with `continuous_eval` on a
    copy of the model, so the train steps' cadence is unaffected; it needs
    model_dir and checkpointing, and one process (a multi-process
    evaluator is a job of its own running `continuous_eval`)."""
    if estimator.loss_fn is not None and estimator.eval_fn is None:
        # evaluate() would raise this after the training budget is spent
        raise RuntimeError(
            "train_and_evaluate on a custom-loss Estimator needs eval_fn "
            "(the generator-taking loss_fn cannot promise a deterministic "
            "eval)")
    if eval_mode not in ("inline", "from_checkpoint"):
        raise ValueError(f"unknown eval_mode {eval_mode!r}")
    if eval_mode == "from_checkpoint":
        return _train_with_continuous_eval(estimator, train_spec, eval_spec)

    t_start = time.time()
    last_eval = {"t": t_start}

    def eval_hook(state, step):
        now = time.time()
        if now - t_start < eval_spec.start_delay_secs:
            return
        if now - last_eval["t"] < eval_spec.throttle_secs:
            return
        last_eval["t"] = now
        m = estimator.evaluate(eval_spec.input_fn, eval_spec.steps,
                               eval_spec.name)
        _run_exporters(estimator, eval_spec, m, gated_only=True)

    state = estimator.train(train_spec.input_fn, train_spec.max_steps,
                            shard_policy=train_spec.shard_policy,
                            _eval_hook=eval_hook)
    metrics = estimator.evaluate(eval_spec.input_fn, eval_spec.steps,
                                 eval_spec.name)
    _run_exporters(estimator, eval_spec, metrics)
    return state, metrics


def _run_exporters(estimator: Estimator, eval_spec: EvalSpec, metrics: dict,
                   gated_only: bool = False) -> None:
    """Run the eval spec's exporters (only the metric-gated ones with
    `gated_only`) against `metrics`."""
    for exporter in eval_spec.exporters:
        if not gated_only or hasattr(exporter, "maybe_export"):
            estimator.export_saved_model(exporter, metrics=metrics)


def _train_with_continuous_eval(estimator: Estimator, train_spec: TrainSpec,
                                eval_spec: EvalSpec
                                ) -> Tuple[TrainState, dict]:
    cfg = estimator.config
    if cfg.model_dir is None or not cfg.save_checkpoints_steps:
        raise ValueError(
            "eval_mode='from_checkpoint' needs model_dir + "
            "save_checkpoints_steps: eval reads what the trainer checkpoints")
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError(
            "eval_mode='from_checkpoint' inside the trainer is single-process "
            "(a background thread cannot take part in the ranks' "
            "collectives); run continuous_eval() as an evaluator job instead")
    # the evaluator job: a copy of the model (and an optimizer over it, to
    # restore into), which the training thread never touches, and no group
    model, tx = copy.deepcopy((estimator.model, estimator.tx))
    evaluator = Estimator(model, tx,
                          strategy=MirroredStrategy(mesh=LocalMesh(("data",))),
                          config=cfg, loss_fn=estimator.loss_fn,
                          eval_fn=estimator.eval_fn)
    device = evaluator._device
    stop = threading.Event()
    box: dict = {}

    def loop():
        try:
            stream = contextlib.nullcontext()
            if device.type == "cuda":
                torch.cuda.set_device(device)
                stream = torch.cuda.stream(torch.cuda.Stream(device))
            stop.wait(eval_spec.start_delay_secs)
            with stream:
                box["result"] = continuous_eval(evaluator, eval_spec,
                                                stop_event=stop)
        except BaseException as e:  # surfaced to the caller after train
            box["error"] = e

    thread = threading.Thread(target=loop, daemon=True,
                              name="tfde-torch-continuous-eval")
    thread.start()
    try:
        state = estimator.train(train_spec.input_fn, train_spec.max_steps,
                                shard_policy=train_spec.shard_policy)
    finally:
        stop.set()
    thread.join(timeout=600.0)
    if thread.is_alive():
        # do not tear down under a still-running eval; leave it instead
        log.error("continuous-eval thread did not finish within 600s; "
                  "skipping evaluator teardown")
    else:
        evaluator.close()
    if "error" in box:
        raise RuntimeError("continuous evaluator failed during training"
                           ) from box["error"]
    _, metrics = box.get("result", (-1, {}))
    # the gated exporters ran after each evaluated checkpoint; this pass
    # runs the others, and skips a gated one when no eval ran (re-gating on
    # the last metrics exports nothing: the bar is strict)
    _run_exporters(estimator, eval_spec, metrics)
    return state, metrics
