"""Serving export — counterpart of `tfde_tpu/export` (the SavedModel and
FinalExporter capability, SURVEY.md §3.4) on `torch.export`. Generative
export (`export/generative.py`) is not ported yet."""

from tfde_tpu_torch.export.serving import (  # noqa: F401
    BestExporter,
    FinalExporter,
    ServingModel,
    export_serving,
    load_serving,
)
