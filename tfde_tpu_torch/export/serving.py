"""Serving export — counterpart of `tfde_tpu/export/serving.py`
(`export_serving` :117, `ServingModel` :164, `load_serving` :176,
`FinalExporter` :190, `BestExporter` :235).

The reference's export path (SURVEY.md §3.4): at the end of training,
`FinalExporter('exporter', serving_input_fn)` writes a SavedModel of the
inference graph on a `[None, 784]` float placeholder under
`<working_dir>/export/exporter/<timestamp>/` (mnist_keras:151-162, 264).
The artifact keeps the JAX package's layout, one directory an export:

    <dir>/<timestamp>/
      signature.json   input and output spec, framework, platforms
      params.npz       the parameters and buffers, '/'-joined keys
      model.pt2        `torch.export.save` of the serving function

The serving function is the model in eval mode followed by a softmax
(unless ``apply_softmax=False``): [N, 784] float32 -> [N, 10]
probabilities, the reference's observable signature, though the models
return logits. The batch dimension is symbolic (`torch.export.Dim`), so
one artifact serves any batch size; it is traced at a batch of 2, since
`torch.export` specialises sizes 0 and 1. The program is traced from a
CPU copy of the unwrapped module (a DDP wrapper's ``module``), where an
eval-mode forward runs no collective, and is moved to the serving
device when it is loaded (`load_serving`: the card by default, the CPU
when asked).

What `torch.export` cannot trace is refused, never replaced: on CUDA, a
model whose forward launches the ctypes-bound flash kernels
(`ops/flash_attention.py`) raises NotImplementedError, because exporting
the CPU copy would serve the plain attention in the kernels' place. The
kernels first need registering as `torch.library` custom ops (ROADMAP,
queue 1, "generative export"). `FinalExporter(savedmodel=True)` raises as
well: a TF SavedModel needs `tensorflow`, which the port does not use.
Directories are local paths (the JAX package's remote `utils/fs` is not
ported).
"""

from __future__ import annotations

import copy
import datetime
import io
import json
import logging
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from tfde_tpu_torch.ops import flash_attention as fa
from tfde_tpu_torch.utils.devices import resolve_device

log = logging.getLogger(__name__)

_FLAT_SEP = "/"
PROGRAM_FILE = "model.pt2"
#: the batch size the serving function is traced at (0 and 1 specialise)
TRACE_BATCH = 2
_CUSTOM_OPS = ("the flash kernels are not registered as torch.library "
               "custom ops yet (ROADMAP, queue 1, 'generative export')")


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{_FLAT_SEP}{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name))
        elif isinstance(value, torch.Tensor):
            flat[name] = value.detach().cpu().numpy()
        else:
            flat[name] = np.asarray(value)
    return flat


def _unflatten(flat: Mapping) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(_FLAT_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def write_params_npz(path: str, tree: Mapping) -> None:
    """The params.npz convention: a nested mapping of arrays or tensors
    written with flat '/'-joined keys."""
    buf = io.BytesIO()
    np.savez(buf, **_flatten(tree))
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def _host_vars(model: nn.Module) -> dict:
    """{"params": ..., "buffers": ...} of `model`, keyed by module path."""
    return {
        "params": {n.replace(".", _FLAT_SEP): p
                   for n, p in model.named_parameters()},
        "buffers": {n.replace(".", _FLAT_SEP): b
                    for n, b in model.named_buffers()},
    }


class _Serve(nn.Module):
    """The serving function: the model's eval-mode forward, then the
    softmax over the last dim unless `apply_softmax` is False."""

    def __init__(self, model: nn.Module, apply_softmax: bool):
        super().__init__()
        self.model = model
        self.apply_softmax = apply_softmax

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.model(x)
        if self.apply_softmax:
            return torch.softmax(logits.float(), dim=-1)
        return logits


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _refuse_flash_kernels(model: nn.Module, sample: torch.Tensor) -> None:
    """Raise NotImplementedError when `model` lies on CUDA and its forward
    launches the flash kernels (one probe forward on the card)."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        return
    before = fa.flash_forward.launches
    with torch.no_grad():
        model(sample.to(device))
    if fa.flash_forward.launches != before:
        raise NotImplementedError(
            f"cannot export {type(model).__name__} from CUDA: its forward "
            f"launches the flash attention kernels through ctypes, which "
            f"torch.export cannot trace, and the CPU copy would serve the "
            f"plain attention in their place; {_CUSTOM_OPS}")


def _write_artifact(directory: str, program, host_vars: dict,
                    signature: dict) -> str:
    """A timestamped directory under `directory` with model.pt2,
    params.npz and signature.json; returns its path."""
    stamp = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
    out_dir = os.path.join(directory, stamp)
    # two exports in one second (BestExporter's per-eval cadence) take the
    # next free stamp: numeric order keeps the newest last
    bump = 0
    while os.path.exists(out_dir):
        bump += 1
        out_dir = os.path.join(directory, str(int(stamp) + bump))
    os.makedirs(out_dir)
    torch.export.save(program, os.path.join(out_dir, PROGRAM_FILE))
    write_params_npz(os.path.join(out_dir, "params.npz"), host_vars)
    with open(os.path.join(out_dir, "signature.json"), "w") as f:
        json.dump(signature, f, indent=2)
    return out_dir


def _resolve(export_dir: str) -> str:
    """`export_dir` itself when it holds an artifact, else its newest
    timestamped subdirectory."""
    if os.path.exists(os.path.join(export_dir, "signature.json")):
        return export_dir
    entries = sorted((d for d in os.listdir(export_dir) if d.isdigit()
                      and os.path.isdir(os.path.join(export_dir, d))),
                     key=int)
    if not entries:
        raise FileNotFoundError(f"no serving artifact in {export_dir}")
    return os.path.join(export_dir, entries[-1])


def export_serving(model: nn.Module, input_shape: Sequence[Optional[int]],
                   directory: str, input_dtype: torch.dtype = torch.float32,
                   apply_softmax: bool = True) -> str:
    """Write a serving artifact of `model` (or the module a DDP wrapper
    holds) into a new timestamped directory under `directory`; returns
    that directory. `input_shape` has None for the symbolic batch dim,
    e.g. (None, 784), the reference's serving placeholder
    (mnist_keras:159); `input_dtype` may be an integer type (a token
    model's ids)."""
    if isinstance(model, DistributedDataParallel):
        model = model.module
    shape = tuple(TRACE_BATCH if d is None else int(d) for d in input_shape)
    sample = torch.zeros(shape, dtype=input_dtype)
    _refuse_flash_kernels(model, sample)
    cpu_model = copy.deepcopy(model).to("cpu").eval()
    batch = torch.export.Dim("batch", min=1)
    dynamic = {i: batch for i, d in enumerate(input_shape) if d is None}
    program = torch.export.export(_Serve(cpu_model, apply_softmax),
                                  (sample,), dynamic_shapes=(dynamic,),
                                  strict=False)
    out = next(n for n in program.graph.nodes if n.op == "output")
    val = out.args[0][0].meta["val"]
    signature = {
        "input": {"shape": [None if d is None else int(d)
                            for d in input_shape],
                  "dtype": _dtype_name(input_dtype)},
        "output": {"shape": [d if isinstance(d, int) else None
                             for d in val.shape],
                   "dtype": _dtype_name(val.dtype)},
        "apply_softmax": apply_softmax,
        "platforms": ["cpu", "cuda"],
        "framework": "tfde_tpu_torch",
    }
    out_dir = _write_artifact(directory, program, _host_vars(cpu_model),
                              signature)
    log.info("serving artifact exported -> %s", out_dir)
    return out_dir


class ServingModel:
    """A loaded artifact: `module` is the exported program on `device`;
    `predict(x)` mirrors the SavedModel signature (an array in, the
    probabilities out as numpy)."""

    def __init__(self, program, signature: dict, params: dict,
                 device: torch.device):
        self.module = program.module()
        self.signature = signature
        self.params = params
        self.device = device
        self._dtype = getattr(torch, signature["input"]["dtype"])

    def predict(self, x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x), dtype=self._dtype,
                            device=self.device)
        with torch.no_grad():
            return self.module(x).cpu().numpy()


def load_serving(export_dir: str, device=None) -> ServingModel:
    """Load a serving artifact from its timestamped directory, or from the
    parent, resolving the newest timestamp (FinalExporter keeps history).
    It serves on `device`: CUDA by default, the CPU when asked
    (`resolve_device`)."""
    device = resolve_device(device)
    path = _resolve(export_dir)
    with open(os.path.join(path, "signature.json")) as f:
        signature = json.load(f)
    if signature.get("kind") == "generate":
        raise ValueError(
            f"{path} is a generative artifact ((prompt, seed) entry point); "
            f"generative export is not ported yet (ROADMAP, queue 1, "
            f"'generative export')")
    program = torch.export.load(os.path.join(path, PROGRAM_FILE))
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten({k: z[k] for k in z.files})
    return ServingModel(program, signature, params, device)


class FinalExporter:
    """End-of-training exporter (mnist_keras:264): writes under
    `<model_dir>/export/<name>/<timestamp>/`. ``savedmodel=True`` (the
    JAX package's extra TF SavedModel) raises NotImplementedError."""

    def __init__(self, name: str, input_shape: Sequence[Optional[int]],
                 input_dtype: torch.dtype = torch.float32,
                 apply_softmax: bool = True, savedmodel: bool = False):
        if savedmodel:
            raise NotImplementedError(
                "FinalExporter(savedmodel=True) is not ported: a TF "
                "SavedModel needs tensorflow, which the port does not use "
                "(ROADMAP, queue 1, 'FinalExporter(savedmodel=True)')")
        self.name = name
        self.input_shape = tuple(input_shape)
        self.input_dtype = input_dtype
        self.apply_softmax = apply_softmax

    def export(self, model_dir: str, model: nn.Module) -> str:
        return export_serving(model, self.input_shape,
                              os.path.join(model_dir, "export", self.name),
                              input_dtype=self.input_dtype,
                              apply_softmax=self.apply_softmax)


class BestExporter(FinalExporter):
    """Metric-gated exporter (`tf.estimator.BestExporter`): exports only
    when the monitored eval metric beats the best so far. The bar persists
    in `<model_dir>/export/<name>/best_metric.json`, so a resumed run
    compares against its own history. `train_and_evaluate` runs it after
    every throttled eval (inline), after every evaluated checkpoint
    (`continuous_eval`, eval_mode='from_checkpoint'), and at the final
    eval; the newest artifact is the best."""

    def __init__(self, name: str, input_shape, metric: str = "loss",
                 higher_is_better: bool = False, **kw):
        super().__init__(name, input_shape, **kw)
        self.metric = metric
        self.higher_is_better = higher_is_better

    def maybe_export(self, model_dir: str, model: nn.Module,
                     metrics: dict) -> Optional[str]:
        """Export iff metrics[self.metric] beats the persisted best; the
        artifact's directory, or None."""
        if self.metric not in metrics:
            raise ValueError(
                f"BestExporter({self.name!r}) monitors {self.metric!r} but "
                f"the eval produced {sorted(metrics)}: set metric= to one "
                f"of those")
        val = float(metrics[self.metric])
        if not np.isfinite(val):
            # a NaN bar compares False against every later value and would
            # disable the exporter for the rest of the run
            return None
        bar_path = os.path.join(model_dir, "export", self.name,
                                "best_metric.json")
        best = None
        if os.path.exists(bar_path):
            with open(bar_path) as f:
                best = json.load(f)["value"]
        improved = best is None or not np.isfinite(best) or (
            val > best if self.higher_is_better else val < best)
        if not improved:
            return None
        out = self.export(model_dir, model)
        with open(bar_path, "w") as f:
            json.dump({"metric": self.metric, "value": val,
                       "artifact": out}, f)
        return out
