"""Rotary position embeddings (RoPE) — counterpart of
`tfde_tpu/ops/rotary.py`.

Each query/key head's features rotate by an angle proportional to the
token's absolute position, so q.k depends only on the relative position.
The convention is the JAX package's "rotate half": the first and the
second half of the (rotated part of the) head dim are the two components
of each pair. The trig runs in fp32 and the result is cast back to the
input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def scale_frequencies(freqs: torch.Tensor, scaling,
                      theta: float = 10_000.0) -> torch.Tensor:
    """RoPE frequency rescaling for long-context fine-tunes. `scaling`:

    - ('linear', factor): every frequency divided by factor;
    - ('llama3', factor, low_freq_factor, high_freq_factor,
      original_max_position): wavelengths shorter than
      original_max / high_freq_factor keep their frequency, longer than
      original_max / low_freq_factor divide by factor, and the band between
      interpolates smoothly;
    - ('yarn', factor, beta_fast, beta_slow, original_max,
      attention_factor, truncate): NTK-by-parts, a linear ramp between
      extrapolation and interpolation over the feature index;
      attention_factor scales cos/sin (`rotary_angles`). `theta` is the
      base the frequencies were built with."""
    kind = scaling[0]
    if kind == "linear":
        return freqs / float(scaling[1])
    if kind == "yarn":
        _, factor, beta_fast, beta_slow, orig_max, _att, truncate = scaling
        factor = float(factor)
        dim = freqs.shape[0] * 2

        def corr_dim(num_rot: float) -> float:
            return (dim * math.log(float(orig_max)
                                   / (num_rot * 2 * math.pi))
                    ) / (2 * math.log(theta))

        low = corr_dim(float(beta_fast))
        high = corr_dim(float(beta_slow))
        if truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, dim - 1)
        if low == high:
            high += 0.001  # the HF guard against a zero-width ramp
        ramp = ((torch.arange(dim // 2, dtype=torch.float32,
                              device=freqs.device) - low)
                / (high - low)).clamp(0.0, 1.0)
        extrapolation = 1.0 - ramp
        return (freqs / factor) * (1.0 - extrapolation) \
            + freqs * extrapolation
    if kind == "llama3":
        _, factor, low_f, high_f, orig_max = scaling
        factor, low_f, high_f = float(factor), float(low_f), float(high_f)
        orig_max = float(orig_max)
        wavelen = 2.0 * math.pi / freqs
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        interpolated = (1.0 - smooth) * freqs / factor + smooth * freqs
        return torch.where(
            wavelen < orig_max / high_f, freqs,
            torch.where(wavelen > orig_max / low_f, freqs / factor,
                        interpolated))
    raise ValueError(f"rope scaling kind must be 'linear', 'llama3' or "
                     f"'yarn', got {kind!r}")


def rotary_angles(positions: torch.Tensor, dim: int,
                  theta: float = 10_000.0, scaling=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [..., dim / 2] fp32, for integer `positions`."""
    if dim % 2:
        raise ValueError(f"rotary head_dim must be even, got {dim}")
    # a Python-scalar base: a base tensor made on the card from a host
    # value would be a blocking copy on every call
    freqs = torch.pow(float(theta), -torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    if scaling is not None:
        freqs = scale_frequencies(freqs, scaling, theta)
    ang = positions.to(torch.float32)[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None and scaling[0] == "yarn":
        att = float(scaling[5])  # yarn's attention temperature
        cos, sin = cos * att, sin * att
    return cos, sin


def apply_rotary(x: torch.Tensor, positions: torch.Tensor,
                 theta: float = 10_000.0, rotary_dim: Optional[int] = None,
                 scaling=None) -> torch.Tensor:
    """Rotate x [B, S, H, D] by per-token angles; `positions` is [S] or
    [B, S] absolute positions. `rotary_dim` < D rotates only the first
    `rotary_dim` features (partial rotary) and passes the rest through."""
    d = x.shape[-1]
    if rotary_dim is not None and rotary_dim != d:
        if not 0 < rotary_dim < d:
            raise ValueError(
                f"rotary_dim {rotary_dim} must be in (0, head_dim={d}]")
        rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
        return torch.cat([apply_rotary(rot, positions, theta,
                                       scaling=scaling), rest], dim=-1)
    cos, sin = rotary_angles(positions, d, theta, scaling)
    if cos.dim() == 2:  # [S, d/2] -> [1, S, 1, d/2]
        cos, sin = cos[None, :, None], sin[None, :, None]
    else:  # [B, S, d/2] -> [B, S, 1, d/2]
        cos, sin = cos[:, :, None], sin[:, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
