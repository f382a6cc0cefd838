"""Positional encodings (counterpart of ``gke_ray_train_tpu/ops/rope.py``):
RoPE with the Llama-3.1 frequency scaling, and sinusoidal tables.
The frequency and table builders are host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     llama3_scaling: Optional[dict] = None) -> np.ndarray:
    """Inverse frequencies [head_dim//2], computed in float64, returned
    as float32.

    ``llama3_scaling``: dict (or sorted (key, value) tuples) with factor
    / low_freq_factor / high_freq_factor /
    original_max_position_embeddings — the Llama-3.1 NTK-by-parts
    rescale."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                             / head_dim))
    if llama3_scaling is not None and not isinstance(llama3_scaling, dict):
        llama3_scaling = dict(llama3_scaling)
    if llama3_scaling:
        factor = llama3_scaling["factor"]
        low = llama3_scaling["low_freq_factor"]
        high = llama3_scaling["high_freq_factor"]
        orig = llama3_scaling["original_max_position_embeddings"]
        wavelen = 2.0 * np.pi / freqs
        # three bands: high-freq kept, low-freq divided by factor,
        # middle band smoothly interpolated
        smooth = np.clip((orig / wavelen - low) / (high - low), 0.0, 1.0)
        interpolated = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = np.where(wavelen < orig / high, freqs,
                         np.where(wavelen > orig / low,
                                  freqs / factor,
                                  interpolated))
    return freqs.astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freqs: torch.Tensor) -> torch.Tensor:
    """Rotate q or k. x: [..., seq, heads, head_dim]; positions:
    [..., seq]; inv_freqs: [head_dim//2] float32 on x's device.

    Split-halves convention (first half real, second half imaginary),
    computed in fp32 and cast back."""
    dtype = x.dtype
    angles = positions[..., :, None].float() * inv_freqs   # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """Classic transformer sinusoidal PE table [max_len, d_model], fp32."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * (-np.log(10000.0) / d_model))
    table = np.zeros((max_len, d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: d_model // 2])
    return table.astype(np.float32)
