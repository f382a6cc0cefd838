"""Normalization ops (counterpart of ``gke_ray_train_tpu/ops/norms.py``).

RMSNorm in fp32 whatever the compute dtype, in the JAX op's exact
sequence: upcast, mean of squares, ``rsqrt(var + eps)``, optional
``(1 + scale)``, cast back.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
             scale_plus_one: bool = False) -> torch.Tensor:
    """y = x / rms(x) * scale, computed in fp32, cast back to x.dtype.

    ``scale_plus_one``: Gemma-style ``(1 + scale)`` parameterization."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = scale.float()
    if scale_plus_one:
        s = 1.0 + s
    return (y * s).to(dtype)
