"""Serving export — counterpart of `tfde_tpu/export` (the SavedModel and
FinalExporter capability, SURVEY.md §3.4) on `torch.export`: one forward
pass (`serving.py`) or the whole decode loop (`generative.py`)."""

from tfde_tpu_torch.export.generative import (  # noqa: F401
    GenerativeModel,
    export_generate,
    load_generate,
)
from tfde_tpu_torch.export.serving import (  # noqa: F401
    BestExporter,
    FinalExporter,
    ServingModel,
    export_serving,
    load_serving,
)
