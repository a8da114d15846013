"""tfde_tpu_torch — the PyTorch/CUDA port of `tfde_tpu` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(`ops/`, `models/`, `inference/`, `training/`, `data/`, `utils/`) so
each module's counterpart is easy to find. It imports torch and numpy
only — never jax, flax or `tfde_tpu` — and every Pallas kernel on a
ported path is a hand-written Hopper kernel under `csrc/`, with its plain
PyTorch version beside it.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(`utils.devices.resolve_device`); without a GPU they raise instead of
falling back quietly.
"""
